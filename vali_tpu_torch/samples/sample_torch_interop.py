"""Zero-copy tensor interop: decoded Surfaces <-> torch via views and
DLPack.

Analogue of the reference's sample_pycuda.ipynb (hand a decoded frame to
a tensor library without a copy). The port's Surfaces hold torch tensors,
so ``Surface.to_torch`` is a view; DLPack (``torch.from_dlpack``,
``Surface.from_dlpack``) is the protocol the reference exports through
Surface.__dlpack__ (PySurface.cpp:372-435), for any other library.

Usage: python -m vali_tpu_torch.samples.sample_torch_interop [video]
           [n_frames] [--device cuda|cpu]
"""

import torch

from . import clip_argument, command_line
from ..utils.device import device_gpu_id


def main(argv=None):
    device, args = command_line(argv, "sample_torch_interop")
    import vali_tpu_torch as vali

    n_frames = int(args[1]) if len(args) > 1 else 4
    gpu_id = device_gpu_id(device)
    with clip_argument(args) as uri:
        dec = vali.PyDecoder(uri, {}, gpu_id=max(gpu_id, 0), device=device)
        surf = vali.Surface.Make(dec.Format, dec.Width, dec.Height,
                                 device=device)
        rgb = vali.Surface.Make(vali.PixelFormat.RGB, dec.Width, dec.Height,
                                device=device)
        cvt = vali.PySurfaceConverter(gpu_id=gpu_id)
        # YUV420->RGB is a BT_601-only pair (NPP-parity quirk); NV12 input
        # follows the stream's own colorspace.
        space = (dec.ColorSpace if dec.Format == vali.PixelFormat.NV12
                 else vali.ColorSpace.BT_601)
        cc = vali.ColorspaceConversionContext(space, dec.ColorRange)

        conv = torch.nn.Conv2d(3, 8, 3, stride=4).to(device)
        for i in range(n_frames):
            if not dec.DecodeSingleSurface(surf)[0]:
                break
            ok, info = cvt.Run(surf, rgb, cc)
            if not ok:
                raise RuntimeError(f"converting frame {i} failed: {info}")

            # Surface -> torch, zero-copy via __dlpack__
            t = torch.from_dlpack(rgb).reshape(dec.Height, dec.Width, 3)
            if t.data_ptr() != rgb.to_torch().data_ptr():
                raise RuntimeError("DLPack export copied the Surface")
            x = t.permute(2, 0, 1).unsqueeze(0).float() / 255.0
            with torch.no_grad():
                feat = conv(x)
            print(f"frame {i}: torch {tuple(t.shape)} -> conv "
                  f"{tuple(feat.shape)} mean={feat.mean().item():+.4f}")

    # torch -> Surface (the reverse direction: wrap foreign memory)
    t = torch.randint(0, 255, (dec.Height, dec.Width * 3),
                      dtype=torch.uint8, device=device)
    back = vali.Surface.from_dlpack(t, vali.PixelFormat.RGB)
    if not torch.equal(torch.from_numpy(back.to_numpy()).reshape(t.shape),
                       t.cpu()):
        raise RuntimeError("torch -> Surface round trip differs")
    print(f"torch -> Surface round trip OK "
          f"({back.Width}x{back.Height} {back.Format.name} on "
          f"{back.device})")


if __name__ == "__main__":
    main()
