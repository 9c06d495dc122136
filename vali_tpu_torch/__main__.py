"""Command-line utility: ``python -m vali_tpu_torch <command> ...``

Commands:
  probe <url>                       stream parameters
  decode <url> [n]                  decode n frames, print stats
  transcode <in> <out.h264> [WxH]   decode -> resize -> encode, on the card
  bench                             one JSON line of the bench
                                    (``vali_tpu_torch/bench.py``)

Option:
  --device cuda|cpu                 where transcode's Surfaces live and
                                    bench runs (default cuda: the first
                                    card)

probe and decode run on the host. transcode decodes into Surfaces on the
card, resizes and converts them there, and encodes on the host; bench
times the kernels on the card. Without a CUDA device both fail unless
``--device cpu`` asks for the CPU.
"""

import sys

import numpy as np

from .utils.device import device_gpu_id


def cmd_probe(args):
    import vali_tpu_torch as vali

    for i, sp in enumerate(vali.PyDecoder.Probe(args[0])):
        print(f"stream {i}: {sp.width}x{sp.height} codec_id={sp.codec_id} "
              f"{sp.fps} fps, {sp.num_frames} frames, "
              f"{sp.color_space.name}/{sp.color_range.name}, "
              f"profile={sp.profile} level={sp.level} "
              f"bitrate={sp.bit_rate}")


def cmd_decode(args):
    import time

    import vali_tpu_torch as vali

    url = args[0]
    limit = int(args[1]) if len(args) > 1 else 0
    dec = vali.PyDecoder(url, {}, gpu_id=-1)
    print(f"{url}: {dec.Width}x{dec.Height} {dec.Format.name} "
          f"{dec.Framerate} fps {dec.ColorSpace.name}/{dec.ColorRange.name}")
    frame = np.zeros(dec.HostFrameSize, dtype=np.uint8)
    n = 0
    t0 = time.perf_counter()
    while dec.DecodeSingleFrame(frame)[0]:
        n += 1
        if limit and n >= limit:
            break
    dt = time.perf_counter() - t0
    print(f"decoded {n} frames in {dt:.2f}s = {n / dt:.1f} fps; "
          f"stats={dec.Stats}")


class ToNV12:
    """transcode's device step between decode and encode: a decoded
    Surface resized (``PySurfaceResizer`` turbo) to ``width`` x ``height``
    and, unless it is NV12 already, converted to NV12
    (``PySurfaceConverter``), on ``device``. A YUV420 source resizes in
    two ``plane_resize`` launches: Y, and U/V stacked."""

    def __init__(self, fmt, width, height, device):
        import vali_tpu_torch as vali

        gpu_id = device_gpu_id(device)
        self._rsz = vali.PySurfaceResizer(fmt, gpu_id=gpu_id, turbo=True)
        self.small = vali.Surface.Make(fmt, width, height, device=device)
        if fmt == vali.PixelFormat.NV12:
            self._cvt, self.nv12 = None, self.small
        else:
            self._cvt = vali.PySurfaceConverter(gpu_id=gpu_id)
            self.nv12 = vali.Surface.Make(vali.PixelFormat.NV12, width,
                                          height, device=device)

    def resize(self, src):
        """``src`` resized into :attr:`small`."""
        if not self._rsz.Run(src, self.small)[0]:
            raise RuntimeError("resizing a frame failed")

    def convert(self):
        """:attr:`small` converted into :attr:`nv12` (a no-op for NV12);
        returns :attr:`nv12`."""
        if self._cvt is not None and not self._cvt.Run(self.small,
                                                       self.nv12)[0]:
            raise RuntimeError("converting a frame to NV12 failed")
        return self.nv12

    def __call__(self, src):
        """``src`` resized and converted: the NV12 Surface to encode."""
        self.resize(src)
        return self.convert()


def cmd_transcode(args, device):
    """Decode into a Surface on ``device``, resize (turbo) and convert to
    NV12 there, encode on the host, write the elementary stream."""
    import vali_tpu_torch as vali

    src_url, out_path = args[0], args[1]
    if len(args) > 2:
        w, h = (int(v) for v in args[2].split("x"))
    else:
        w = h = None
    gpu_id = device_gpu_id(device)
    dec = vali.PyDecoder(src_url, {}, gpu_id=max(gpu_id, 0), device=device)
    w = w or dec.Width
    h = h or dec.Height
    step = ToNV12(dec.Format, w, h, device)
    enc = vali.PyNvEncoder({"s": f"{w}x{h}", "bitrate": "4M"},
                           gpu_id=gpu_id, format=vali.PixelFormat.NV12)
    src = vali.Surface.Make(dec.Format, dec.Width, dec.Height, device=device)
    pkt = np.zeros(0, dtype=np.uint8)
    chunks = []
    n = 0
    while dec.DecodeSingleSurface(src)[0]:
        if enc.EncodeSingleSurface(step(src), pkt) and pkt.size:
            chunks.append(pkt.tobytes())
        n += 1
    flush = np.zeros(0, dtype=np.uint8)
    if enc.Flush(flush) and flush.size:
        chunks.append(flush.tobytes())
    with open(out_path, "wb") as f:
        f.write(b"".join(chunks))
    print(f"transcoded {n} frames -> {out_path}")


def pop_device(argv):
    """(the device ``--device NAME`` names, ``argv`` without the option):
    "cuda" when the option is absent, None when it has no name."""
    argv = list(argv)
    if "--device" not in argv:
        return "cuda", argv
    i = argv.index("--device")
    if i + 1 >= len(argv):
        return None, argv
    name = argv.pop(i + 1)
    argv.pop(i)
    return name, argv


def _device(name, what):
    """The torch device ``--device`` names; None (after a message) when it
    names no device this machine has. ``what`` names the command in the
    message."""
    import torch

    if name not in ("cpu", "cuda") and not name.startswith("cuda:"):
        print(f"vali_tpu_torch: --device must be cuda, cuda:N or cpu, got "
              f"{name}", file=sys.stderr)
        return None
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"vali_tpu_torch: {what} runs on a CUDA device and this "
              f"machine has none (pass --device cpu to run it on the CPU)",
              file=sys.stderr)
        return None
    return device


def main(argv=None):
    device_name, argv = pop_device(sys.argv[1:] if argv is None else argv)
    if device_name is None or not argv:
        print(__doc__)
        return 1
    cmd, args = argv[0], argv[1:]
    if cmd == "probe":
        cmd_probe(args)
    elif cmd == "decode":
        cmd_decode(args)
    elif cmd == "transcode":
        device = _device(device_name, "transcode")
        if device is None:
            return 2
        cmd_transcode(args, device)
    elif cmd == "bench":
        device = _device(device_name, "bench")
        if device is None:
            return 2
        from .bench import report

        return report(device)
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
