"""Transcode: decode -> resize -> NV12 repack -> encode -> mux.

Analogue of the reference's sample_transcode.ipynb: the pixel work runs
on the device (the turbo resize: ``plane_resize``; the repack: the
converter), encode on the host. Output ending in .mp4/.mkv/.ts is muxed
with timestamps (PyMuxer); .h264/.h265 writes the raw stream.

Usage: python -m vali_tpu_torch.samples.sample_transcode [in] [out]
           [width height] [--device cuda|cpu]
"""

import os
import tempfile

import numpy as np

from . import clip_argument, command_line
from ..utils.device import device_gpu_id


def main(argv=None):
    device, args = command_line(argv, "sample_transcode")
    import vali_tpu_torch as vali
    from ..__main__ import ToNV12

    out_path = args[1] if len(args) > 1 else os.path.join(
        tempfile.gettempdir(), "transcoded.h264")
    dst_w = int(args[2]) if len(args) > 2 else 640
    dst_h = int(args[3]) if len(args) > 3 else 360
    gpu_id = device_gpu_id(device)

    with clip_argument(args) as uri:
        dec = vali.PyDecoder(uri, {}, gpu_id=max(gpu_id, 0), device=device)
        src = vali.Surface.Make(dec.Format, dec.Width, dec.Height,
                                device=device)
        # turbo resize (the banded kernel), then the NV12 repack
        to_nv12 = ToNV12(dec.Format, dst_w, dst_h, device)

        # bf=0 keeps packet order == display order so the mux step below
        # can assign sequential timestamps without parsing the bitstream
        enc = vali.PyNvEncoder(
            {"s": f"{dst_w}x{dst_h}", "bitrate": "2M", "bf": "0",
             "fps": str(int(dec.Framerate) or 30), "preset": "P4"},
            gpu_id=gpu_id, format=vali.PixelFormat.NV12)

        packet = np.zeros(0, dtype=np.uint8)
        chunks = []
        n = 0
        while dec.DecodeSingleSurface(src)[0]:
            if enc.EncodeSingleSurface(to_nv12(src), packet) and packet.size:
                chunks.append(packet.tobytes())
            n += 1
        while True:
            flush = np.zeros(0, dtype=np.uint8)
            if not enc.FlushSinglePacket(flush) or not flush.size:
                break
            chunks.append(flush.tobytes())
        fps = float(dec.Framerate) or 30.0

    if out_path.endswith((".mp4", ".mkv", ".ts")):
        with vali.PyMuxer(out_path, dst_w, dst_h, fps=fps) as mux:
            for i, pkt in enumerate(chunks):
                ok, info = mux.Mux(pkt, pts=i / fps)
                if not ok:
                    raise RuntimeError(f"muxing packet {i} failed: {info}")
    else:
        with open(out_path, "wb") as f:
            f.write(b"".join(chunks))
    print(f"transcoded {n} frames -> {out_path} "
          f"({sum(len(c) for c in chunks)} bytes)")


if __name__ == "__main__":
    main()
