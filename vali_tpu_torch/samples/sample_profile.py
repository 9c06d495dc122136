"""Capture a torch.profiler trace of the fused preprocess (NVTX-analogue
demo: tracing is enabled around the trace, so the program's spans
(``utils/tracing``) show up named in it, ``preprocess_batch`` with its
wrapper's phases inside, and on a card the kernel beside them).

Usage: python -m vali_tpu_torch.samples.sample_profile [out_dir]
           [--device cuda|cpu]
"""

import os
import tempfile
import time

import numpy as np
import torch

from . import command_line, synchronize

B, H, W, D = 8, 464, 848, 224
STEPS = 4
#: the program's span that names the call in the trace
SCOPE = "preprocess_batch"


def nv12_batch(device):
    """The seeded [B, H*3/2, W] uint8 NV12 batch the sample preprocesses."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, (B, H * 3 // 2, W),
                                         dtype=np.uint8)).to(device)


def profile(out_dir, device, steps=STEPS):
    """Preprocess the batch to 224x224 once outside the trace (the build
    and the tables), then ``steps`` times inside it; writes
    ``out_dir/trace.json``. Returns (the NV12 batch, the last output
    [B, 224, 224, 3], the trace's path, frames/s of the traced steps on
    the host clock)."""
    from ..core.enums import ColorRange, ColorSpace, PixelFormat
    from ..pipeline.multistream import preprocess_batch
    from ..utils import tracing

    nv12 = nv12_batch(device)

    def step():
        out = preprocess_batch((nv12,), PixelFormat.NV12, W, H, D, D,
                               ColorSpace.BT_709, ColorRange.MPEG)
        synchronize(device)
        return out

    step()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was = tracing.enable(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                out = step()
            secs = time.perf_counter() - t0
    finally:
        tracing.enable(was)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return nv12, out, path, steps * B / secs


def main(argv=None):
    device, args = command_line(argv, "sample_profile")
    out_dir = args[0] if args else os.path.join(tempfile.gettempdir(),
                                                "vali_trace")
    _, out, path, fps = profile(out_dir, device)
    print(f"{STEPS} x {B} frames {W}x{H} NV12 -> {tuple(out.shape[1:])} on "
          f"{device}: {fps:.1f} frames/s under the profiler")
    print(f"trace written to {path} (view with Perfetto or "
          f"chrome://tracing)")


if __name__ == "__main__":
    main()
