"""The Surface path's rate and the resize wrappers' call times at N = 1, on
the card, for the ``vali_tpu_torch`` package of a given checkout.

Two checkouts are compared in one session by running this file once per
checkout, each in its own process (one process cannot import two packages
of one name), e.g. earlier, current, current, earlier::

    git archive <commit> | tar -x -C _chip/parent
    python vali_tpu_torch/lab/surface_ab.py --root _chip/parent \
        --tag earlier --out chiprun_out/surface_ab.jsonl
    python vali_tpu_torch/lab/surface_ab.py --root . --tag current \
        --out chiprun_out/surface_ab.jsonl

It is run as a file, not with ``-m``, so that ``--root`` decides which
package is imported. It measures, with the public entry points only:

- Surface path A (as ``chip_smoke.py``'s): 64 1080p NV12 frames uploaded
  from pageable host memory, converted to RGB and resized to 640x360 with
  ``RunAsync`` on a side stream and a ``CudaStreamEvent``; path B: 16 4K
  NV12 frames resized to 1080p (turbo), converted to YUV420, resized to
  960x540 (turbo) and downloaded. After one warm-up pass, each path runs
  ``--repeats`` times; ms a frame on the host clock, every repeat, and
  the host ms a frame of each step (the call's return; path A's last step
  waits for the side stream).
- Each resize wrapper's call at the shapes the Surface path launches it at
  (one frame a call, lanczos; plane U/V two planes a call): CUDA events
  around 5 back-to-back wrapper calls, median of 21 samples (as
  ``chip_smoke.py`` times them), and host microseconds a call over 200
  calls ending in a synchronise. Both include the wrapper's host work.

Appends one JSON line to ``--out`` (and prints it). ``--summary FILE``
instead prints, per tag of such a file, the median over its runs of each
run's median ms a frame (and the least ms a frame of any pass: host
interference only adds time), of each step's ms and of each wrapper's
times.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

B, H, W = 64, 1080, 1920
B4K, H4K, W4K = 16, 2160, 3840
SURFACE_W, SURFACE_H = 640, 360
HALF_W, HALF_H = 960, 540


def event_ms(torch, fn, samples: int = 21, calls: int = 5) -> float:
    """Median ms of one call of ``fn()``: CUDA events around ``calls``
    back-to-back calls, ``samples`` times, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn()`` over ``calls`` calls ending in
    a synchronise, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def stepped(*steps):
    """Run each (name, fn) in turn; [(name, host seconds)]. Raises where a
    step's fn returns False."""
    out = []
    for name, fn in steps:
        t0 = time.perf_counter()
        if fn() is False:
            raise AssertionError(f"surface path step {name} failed")
        out.append((name, time.perf_counter() - t0))
    return out


def measure(repeats: int) -> dict:
    import numpy as np
    import torch

    import vali_tpu_torch as vali
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.ops.nv12_resize import nv12_resize
    from vali_tpu_torch.ops.packed_resize import packed_resize
    from vali_tpu_torch.ops.plane_resize import plane_resize
    from vali_tpu_torch.ops.resize import LANCZOS
    from vali_tpu_torch.utils.device import new_stream

    F = PixelFormat
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    nv12_host = rng.integers(0, 256, (B, H * 3 // 2 * W), dtype=np.uint8)
    nv4k = torch.from_numpy(rng.integers(
        0, 256, (B4K, H4K * 3 // 2, W4K), dtype=np.uint8)).to(dev)
    cc = vali.ColorspaceConversionContext(ColorSpace.BT_709, ColorRange.MPEG)
    ok = (True, vali.TaskExecInfo.SUCCESS)

    # path A
    side = new_stream(0)
    up = vali.PyFrameUploader(gpu_id=0)
    src = vali.Surface.Make(F.NV12, W, H, gpu_id=0)
    full = vali.Surface.Make(F.RGB, W, H, gpu_id=0)
    small = vali.Surface.Make(F.RGB, SURFACE_W, SURFACE_H, gpu_id=0)
    cvt = vali.PySurfaceConverter(gpu_id=0, stream=side.handle)
    rsz = vali.PySurfaceResizer(F.RGB, gpu_id=0, stream=side.handle)
    event = vali.CudaStreamEvent(cvt.Stream, 0)

    def surface_a(i):
        return stepped(
            ("upload", lambda: up.Run(nv12_host[i], src) == ok),
            ("convert", lambda: cvt.RunAsync(src, full, cc) == ok),
            ("resize", lambda: rsz.RunAsync(full, small) == ok),
            ("event", lambda: (event.Record(), event.Wait())))

    # path B
    src4k = vali.Surface.Make(F.NV12, W4K, H4K, gpu_id=0)
    mid = vali.Surface.Make(F.NV12, W, H, gpu_id=0)
    yuv = vali.Surface.Make(F.YUV420, W, H, gpu_id=0)
    half = vali.Surface.Make(F.YUV420, HALF_W, HALF_H, gpu_id=0)
    down = vali.PySurfaceDownloader(gpu_id=0)
    rsz_nv = vali.PySurfaceResizer(F.NV12, gpu_id=0, turbo=True)
    rsz_yuv = vali.PySurfaceResizer(F.YUV420, gpu_id=0, turbo=True)
    cvt_sync = vali.PySurfaceConverter(gpu_id=0)
    host_out = np.zeros(1, np.uint8)

    def surface_b(i):
        return stepped(
            ("copy", lambda: src4k.plane_tensors()[0].copy_(nv4k[i])),
            ("resize_nv12", lambda: rsz_nv.Run(src4k, mid) == ok),
            ("convert", lambda: cvt_sync.Run(mid, yuv) == ok),
            ("resize_yuv420", lambda: rsz_yuv.Run(yuv, half) == ok),
            ("download", lambda: down.Run(half, host_out) == ok))

    rates, steps = {}, {}
    for name, run, n in (("A", surface_a, B), ("B", surface_b, B4K)):
        per_frame, step_s = [], {}
        for rep in range(repeats + 1):
            t0 = time.perf_counter()
            for i in range(n):
                for step, secs in run(i):
                    if rep:   # the first pass warms up
                        step_s[step] = step_s.get(step, 0.0) + secs
            torch.cuda.synchronize()
            if rep:
                per_frame.append((time.perf_counter() - t0) / n * 1e3)
        rates[name] = per_frame
        steps[name] = {k: v / (n * repeats) * 1e3 for k, v in step_s.items()}

    # the resize wrappers at the Surface path's N = 1 shapes
    rgb1 = torch.from_numpy(rng.integers(0, 256, (1, H, W * 3),
                                         dtype=np.uint8)).to(dev)
    y1 = torch.from_numpy(rng.integers(0, 256, (1, H, W),
                                       dtype=np.uint8)).to(dev)
    uv2 = torch.from_numpy(rng.integers(0, 256, (2, H // 2, W // 2),
                                        dtype=np.uint8)).to(dev)
    lz = dict(method=LANCZOS)
    calls = {
        "packed_resize N=1 rgb 1080p->640x360 lanczos": lambda: packed_resize(
            rgb1, src_w=W, src_h=H, dst_w=SURFACE_W, dst_h=SURFACE_H, **lz),
        "nv12_resize N=1 4k->1080p lanczos": lambda: nv12_resize(
            nv4k[:1], src_w=W4K, src_h=H4K, dst_w=W, dst_h=H, **lz),
        "plane_resize N=1 y 1080p->540p lanczos": lambda: plane_resize(
            y1, src_h=H, dst_h=HALF_H, dst_w=HALF_W, **lz),
        "plane_resize B=2 u/v 540p->270p lanczos": lambda: plane_resize(
            uv2, src_h=H // 2, dst_h=HALF_H // 2, dst_w=HALF_W // 2, **lz),
    }
    wrappers = {name: {"event_ms": event_ms(torch, fn),
                       "host_us": host_us(torch, fn)}
                for name, fn in calls.items()}
    return {"surface_ms_per_frame": rates, "step_ms_per_frame": steps,
            "wrappers": wrappers}


def summary(path: str) -> dict:
    """{tag: medians over the runs of ``path``'s lines with that tag}."""
    runs = {}
    for line in open(path):
        row = json.loads(line)
        runs.setdefault(row["tag"], []).append(row)

    def med(values):
        return statistics.median(values)

    out = {}
    for tag, rows in runs.items():
        paths = rows[0]["surface_ms_per_frame"]
        out[tag] = {
            "runs": len(rows),
            "ms_per_frame": {p: med([med(r["surface_ms_per_frame"][p])
                                     for r in rows]) for p in paths},
            "least_ms_per_frame": {p: min(min(r["surface_ms_per_frame"][p])
                                          for r in rows) for p in paths},
            "step_ms_per_frame": {
                p: {k: med([r["step_ms_per_frame"][p][k] for r in rows])
                    for k in rows[0]["step_ms_per_frame"][p]}
                for p in rows[0].get("step_ms_per_frame", {})},
            "wrappers": {
                name: {k: med([r["wrappers"][name][k] for r in rows])
                       for k in ("event_ms", "host_us")}
                for name in rows[0]["wrappers"]}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose vali_tpu_torch is measured")
    ap.add_argument("--tag", default="", help="a name for this run's line")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed passes of each Surface path")
    ap.add_argument("--out", help="append the JSON line here")
    ap.add_argument("--summary", metavar="FILE",
                    help="print the medians per tag of FILE's lines")
    args = ap.parse_args(argv)
    if args.summary:
        print(json.dumps(summary(args.summary), indent=1))
        return 0
    sys.path[0] = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        print("surface_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    row = {"tag": args.tag, "root": args.root, "device": smi,
           **measure(args.repeats)}
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
