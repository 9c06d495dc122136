"""HDR -> SDR transcode: 10-bit decode, on-device tone map, H.264 encode.

Synthesises a PQ-coded BT.2020 10-bit clip when no input is given, then
runs the whole path: decode yuv420p10 -> BT.2020 YCbCr->RGB at float
precision -> BT.2390 tone map to 100-nit SDR on the device -> RGB ->
YUV420 on the device -> encode the SDR result back to H.264.

Usage: python -m vali_tpu_torch.samples.sample_hdr_tonemap [hdr_video]
           [out.h264] [--device cuda|cpu]

Without arguments the synthesised clip and the output are written to
the temporary directory.
"""

import os
import tempfile

import numpy as np
import torch

from . import command_line
from ..ops import tonemap
from ..utils.device import device_gpu_id


def synthesize_hdr_clip(path, w=320, h=192, n=12):
    """PQ-coded test pattern: dim scene + bright moving highlight."""
    import vali_tpu_torch as vali

    enc = vali.PyNvEncoder({"s": f"{w}x{h}", "codec": "h264",
                            "constqp": "12"}, gpu_id=-1,
                           format=vali.PixelFormat.YUV420_10bit)
    chunks = []
    for i in range(n):
        y10 = np.full((h, w), 280, dtype=np.uint16)  # ~4 nits background
        x0 = 16 + 12 * i
        y10[40:88, x0:x0 + 48] = 820                  # ~2000 nits highlight
        u10 = np.full((h // 2, w // 2), 512, dtype=np.uint16)
        v10 = np.full((h // 2, w // 2), 512, dtype=np.uint16)
        frame = np.concatenate(
            [y10.ravel(), u10.ravel(), v10.ravel()]).view(np.uint8)
        pkt = np.ndarray(0, dtype=np.uint8)
        if enc.EncodeSingleFrame(frame, pkt):
            chunks.append(bytes(pkt))
    pkt = np.ndarray(0, dtype=np.uint8)
    while enc.FlushSinglePacket(pkt):
        chunks.append(bytes(pkt))
        pkt = np.ndarray(0, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b"".join(chunks))
    return path


def main(argv=None):
    device, args = command_line(argv, "sample_hdr_tonemap")
    import vali_tpu_torch as vali

    tmp = tempfile.gettempdir()
    uri = args[0] if args else synthesize_hdr_clip(
        os.path.join(tmp, "vali_hdr_in.h264"))
    out_path = args[1] if len(args) > 1 else os.path.join(
        tmp, "vali_sdr_out.h264")

    dec = vali.PyDecoder(uri, {}, gpu_id=-1)
    w, h = dec.Width, dec.Height
    print(f"{uri}: {w}x{h} {dec.Format.name}")
    if dec.Format != vali.PixelFormat.YUV420_10bit:
        raise SystemExit("expected a yuv420p10 HDR stream")

    ys, us, vs = [], [], []
    buf = np.ndarray(dec.HostFrameSize, dtype=np.uint8)
    cw, ch = w // 2, h // 2
    while dec.DecodeSingleFrame(buf)[0]:
        u16 = buf.view(np.uint16)
        ys.append(u16[:w * h].reshape(h, w).copy())
        us.append(u16[w * h:w * h + cw * ch].reshape(ch, cw).copy())
        vs.append(u16[w * h + cw * ch:].reshape(ch, cw).copy())
    n = len(ys)
    print(f"decoded {n} HDR frames")

    # the planes go to the device as int32 codes; nearest-neighbour
    # chroma upsample there, then the HDR pipeline
    def planes(p):
        return torch.from_numpy(np.stack(p).astype(np.int32)).to(device)

    def up(p):
        return planes(p).repeat_interleave(2, 1).repeat_interleave(2, 2)

    rgb = tonemap.bt2020_yuv_to_rgb(planes(ys), up(us), up(vs),
                                    bit_depth=10)
    sdr = tonemap.tonemap_batch(rgb, transfer="pq", peak_nits=1000.0,
                                target_nits=100.0, method="bt2390")
    print(f"tone-mapped to SDR: {tuple(sdr.shape)} {sdr.dtype}, "
          f"luma range [{sdr.min().item()}, {sdr.max().item()}]")

    # encode the SDR result (RGB -> YUV420 -> H.264; the RGB->YUV420
    # converter pair carries BT_601 like the reference's NPP dispatch)
    enc = vali.PyNvEncoder({"s": f"{w}x{h}", "codec": "h264",
                            "bitrate": "3M"}, gpu_id=-1,
                           format=vali.PixelFormat.YUV420)
    cvt = vali.PySurfaceConverter(gpu_id=device_gpu_id(device))
    cc = vali.ColorspaceConversionContext(vali.ColorSpace.BT_601,
                                          vali.ColorRange.MPEG)
    yuv = vali.Surface.Make(vali.PixelFormat.YUV420, w, h, device=device)
    chunks = []
    for i in range(n):
        rgb_surf = vali.Surface.from_torch(sdr[i].contiguous(),
                                           vali.PixelFormat.RGB)
        ok, info = cvt.Run(rgb_surf, yuv, cc)
        if not ok:
            raise RuntimeError(f"converting frame {i} failed: {info}")
        pkt = np.ndarray(0, dtype=np.uint8)
        if enc.EncodeSingleFrame(yuv.to_numpy().reshape(-1), pkt):
            chunks.append(bytes(pkt))
    pkt = np.ndarray(0, dtype=np.uint8)
    while enc.FlushSinglePacket(pkt):
        chunks.append(bytes(pkt))
        pkt = np.ndarray(0, dtype=np.uint8)
    with open(out_path, "wb") as f:
        f.write(b"".join(chunks))
    print(f"wrote SDR stream: {out_path} ({sum(map(len, chunks))} bytes)")
    print("OK")


if __name__ == "__main__":
    main()
