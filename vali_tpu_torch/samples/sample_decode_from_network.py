"""Decode from a network/streaming source (parity:
sample_decode_from_network.ipynb).

Any FFmpeg-supported URL works (http(s), rtsp, rtmp, hls); the timeout
option guards against hung network I/O via the interrupt-callback
watchdog (reference Utils.cpp TimeoutHandler parity). For HLS ABR
ladders, ``preferred_width`` selects the rendition. Frames are decoded
into a Surface on the device.

Usage: python -m vali_tpu_torch.samples.sample_decode_from_network [url]
           [--device cuda|cpu]
"""

from . import clip_argument, command_line
from ..utils.device import device_gpu_id


def main(argv=None):
    device, args = command_line(argv, "sample_decode_from_network")
    import vali_tpu_torch as vali

    opts = {
        "timeout": "5000",          # ms; aborts hung network reads
        # "preferred_width": "1280",  # pick an HLS/ABR rendition
    }
    with clip_argument(args) as url:  # a local clip stands in for a URL
        dec = vali.PyDecoder(url, opts, gpu_id=max(device_gpu_id(device), 0),
                             device=device)
        print(f"{url}: {dec.Width}x{dec.Height} {dec.Format.name}")
        surf = vali.Surface.Make(dec.Format, dec.Width, dec.Height,
                                 device=device)
        n = 0
        while n < 60 and dec.DecodeSingleSurface(surf)[0]:
            n += 1
    print(f"decoded {n} frames")


if __name__ == "__main__":
    main()
