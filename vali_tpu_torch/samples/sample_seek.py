"""Seek sample (parity: reference sample_seek.ipynb): random access into a
clip by frame number and by timestamp, decoding into a Surface on the
device.

Usage: python -m vali_tpu_torch.samples.sample_seek [video]
           [--device cuda|cpu]
"""

from . import clip_argument, command_line
from ..utils.device import device_gpu_id


def main(argv=None):
    device, args = command_line(argv, "sample_seek")
    import vali_tpu_torch as vali

    with clip_argument(args) as uri:
        dec = vali.PyDecoder(uri, {}, gpu_id=max(device_gpu_id(device), 0),
                             device=device)
        surf = vali.Surface.Make(dec.Format, dec.Width, dec.Height,
                                 device=device)
        pkt = vali.PacketData()

        for target in (40, 10, 80):
            dec.DecodeSingleSurface(
                surf, pkt, seek_ctx=vali.SeekContext(seek_frame=target))
            landed = round(pkt.pts * dec.Timebase * dec.Framerate)
            print(f"seek frame {target}: landed on {landed} "
                  f"(pts={pkt.pts}, key={pkt.key})")

        dec.DecodeSingleSurface(surf, pkt,
                                seek_ctx=vali.SeekContext(seek_ts=1.5))
        print(f"seek 1.5s: pts={pkt.pts} -> {pkt.pts * dec.Timebase:.3f}s")


if __name__ == "__main__":
    main()
