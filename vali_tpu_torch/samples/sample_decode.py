"""Decode a clip to Surfaces on the card and compute per-frame stats.

Analogue of the reference's sample_decode_show.ipynb: decode frames into
Surfaces on the device, convert to RGB there, and read them as torch
tensors without a copy.

Usage: python -m vali_tpu_torch.samples.sample_decode [video] [gpu_id]
           [--device cuda|cpu]
"""

import torch

from . import clip_argument, command_line
from ..utils.device import device_gpu_id


def main(argv=None):
    device, args = command_line(argv, "sample_decode")
    if len(args) > 1 and device.type == "cuda":
        device = torch.device("cuda", int(args[1]))
    import vali_tpu_torch as vali

    gpu_id = device_gpu_id(device)
    with clip_argument(args) as uri:
        dec = vali.PyDecoder(uri, {}, gpu_id=max(gpu_id, 0), device=device)
        print(f"{uri}: {dec.Width}x{dec.Height} {dec.Format.name} "
              f"{dec.Framerate} fps, {dec.NumFrames} frames, "
              f"{dec.ColorSpace.name}/{dec.ColorRange.name}")

        surf = vali.Surface.Make(dec.Format, dec.Width, dec.Height,
                                 device=device)
        rgb = vali.Surface.Make(vali.PixelFormat.RGB, dec.Width, dec.Height,
                                device=device)
        cvt = vali.PySurfaceConverter(gpu_id=gpu_id)
        # The YUV420->RGB pair supports BT_601 only (NPP dispatch parity;
        # the reference's GPU path sees NV12 where BT_709 exists).
        space = (dec.ColorSpace if dec.Format == vali.PixelFormat.NV12
                 else vali.ColorSpace.BT_601)
        cc = vali.ColorspaceConversionContext(space, dec.ColorRange)

        pkt = vali.PacketData()
        n = 0
        while True:
            ok, info = dec.DecodeSingleSurface(surf, pkt)
            if not ok:
                break
            ok, info = cvt.Run(surf, rgb, cc)
            if not ok:
                raise RuntimeError(f"converting frame {n} failed: {info}")
            t = rgb.to_torch()  # a view: feed a model directly from here
            if n % 30 == 0:
                print(f"frame {n} pts={pkt.pts} "
                      f"mean RGB={t.float().mean().item():.1f}")
            n += 1
    print(f"decoded {n} frames")


if __name__ == "__main__":
    main()
