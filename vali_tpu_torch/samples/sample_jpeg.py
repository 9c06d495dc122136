"""Batch JPEG encode of decoded frames (PyNvJpegEncoder analogue).

Usage: python -m vali_tpu_torch.samples.sample_jpeg [video] [count]
           [--device cuda|cpu]

The JPEG files are written to the temporary directory.
"""

import os
import tempfile

from . import clip_argument, command_line
from ..utils.device import device_gpu_id


def main(argv=None):
    device, args = command_line(argv, "sample_jpeg")
    import vali_tpu_torch as vali

    count = int(args[1]) if len(args) > 1 else 4
    gpu_id = device_gpu_id(device)
    with clip_argument(args) as uri:
        dec = vali.PyDecoder(uri, {}, gpu_id=max(gpu_id, 0), device=device)
        cvt = vali.PySurfaceConverter(gpu_id=gpu_id)
        # The YUV420->RGB pair supports BT_601 only (NPP dispatch parity;
        # the reference's GPU path sees NV12 where BT_709 exists).
        space = (dec.ColorSpace if dec.Format == vali.PixelFormat.NV12
                 else vali.ColorSpace.BT_601)
        cc = vali.ColorspaceConversionContext(space, dec.ColorRange)
        jpeg = vali.PyNvJpegEncoder(gpu_id=gpu_id)
        ctx = jpeg.Context(90, vali.PixelFormat.RGB)

        surfaces = []
        src = vali.Surface.Make(dec.Format, dec.Width, dec.Height,
                                device=device)
        for _ in range(count):
            if not dec.DecodeSingleSurface(src)[0]:
                break
            rgb = vali.Surface.Make(vali.PixelFormat.RGB, dec.Width,
                                    dec.Height, device=device)
            ok, info = cvt.Run(src, rgb, cc)
            if not ok:
                raise RuntimeError(f"converting a frame failed: {info}")
            surfaces.append(rgb)

    blobs, info = jpeg.Run(ctx, surfaces)
    if info != vali.TaskExecInfo.SUCCESS:
        raise RuntimeError(f"JPEG encode failed: {info}")
    for i, blob in enumerate(blobs):
        path = os.path.join(tempfile.gettempdir(), f"frame_{i}.jpg")
        blob.tofile(path)
        print(f"{path}: {blob.size} bytes")


if __name__ == "__main__":
    main()
