"""What the labs' A/B scripts share: views that move a frame's rows off
16-byte alignment or give them a pitch, the differing samples of two
uint8 outputs and the kernels' envelope over them, alternating timing
rounds, and each launch's device time from ``torch.profiler``."""

from __future__ import annotations

import torch

from .timing import time_ms


def padded_view(x: torch.Tensor, pad: int, off: int) -> torch.Tensor:
    """``x`` as a view of a buffer with ``pad`` more columns a row,
    starting ``off`` bytes into its rows."""
    b, rows, w = x.shape
    big = torch.zeros((b, rows, w + pad + off), dtype=x.dtype,
                      device=x.device)
    big[:, :, off:off + w] = x
    return big[:, :, off:off + w]


def differ(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Samples in which two uint8 outputs differ, and by how much."""
    d = (a.int() - b.int()).abs()
    return dict(differ=int((d > 0).sum().item()), maxdiff=int(d.max().item()))


def within_envelope(d: dict, samples: int) -> bool:
    """The kernels' uint8 envelope: 1 LSB on fewer than 1e-3 of the
    samples."""
    return d["maxdiff"] <= 1 and d["differ"] < 1e-3 * samples


def rounds(calls: dict, pairs: int) -> dict:
    """``pairs`` rounds of :func:`time_ms` of each call, the order reversed
    every other round: each call's times."""
    times = {k: [] for k in calls}
    names = list(calls)
    for i in range(pairs):
        for k in (names if i % 2 == 0 else names[::-1]):
            times[k].append(time_ms(calls[k]))
    return times


def kernel_ms(calls: dict, reps: int = 20) -> dict:
    """Each call's kernels' mean device ms by name (torch.profiler), in
    launch order."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out[name] = {e.key: e.device_time_total / e.count / 1e3
                     for e in prof.key_averages()
                     if e.count and e.device_time_total}
    return out
