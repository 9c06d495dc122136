"""What a ``--trace 1`` run reads from its profiled slice.

The harness marks its own host steps with ``torch.profiler`` spans
(``perfbench::dispatch`` around the entry call, ``perfbench::wait`` on a
batch's completion event, ``perfbench::ring`` around the choice of the
next ring slot and the event bookkeeping) and profiles a slice of the
window with CPU and CUDA activity. :class:`Slice` holds what the
per-layer readers (``metrics/``) take from it: the device operations
with their times, the host spans, the entry's host times outside the
slice, and the cell's configuration and traffic.
"""

from __future__ import annotations

import dataclasses
import subprocess
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

SPAN_PREFIX = "perfbench::"
#: batches a traced run profiles
SLICE_BATCHES = 400
#: entries of each list of the breakdown
BREAKDOWN_ENTRIES = 10

Interval = Tuple[str, float, float]   # name, start us, end us


@dataclasses.dataclass
class Slice:
    """A profiled slice of the window, on the profiler's clock (us)."""
    config: dict
    traffic: dict
    device_ops: List[Interval]          # every device operation
    spans: List[Interval]               # the harness's host spans
    dispatch_s: List[float]             # entry host times outside it
    card: str                           # the card's name and power limit
    log: Callable[[str], None] = print

    def kernels(self, pattern) -> List[Interval]:
        """The device operations whose name ``pattern`` (a compiled
        regular expression) finds."""
        return [op for op in self.device_ops if pattern.search(op[0])]

    def busy(self) -> Tuple[float, float]:
        """(seconds in which some device operation ran, seconds from the
        first operation's start to the last one's end)."""
        merged = _merged(self.device_ops)
        if not merged:
            return 0.0, 0.0
        busy = sum(e - s for s, e in merged)
        return busy * 1e-6, (merged[-1][1] - merged[0][0]) * 1e-6


def _merged(ops: List[Interval]) -> List[List[float]]:
    """The union of the operations' intervals, in order."""
    out: List[List[float]] = []
    for _, s, e in sorted(ops, key=lambda op: op[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_profile(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, harness spans) of a stopped profiler."""
    from torch.autograd import DeviceType

    device_ops, spans = [], []
    for ev in prof.events():
        iv = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.name.startswith(SPAN_PREFIX):
            # a span's device-side copy (the range of the kernels launched
            # inside it) is no device operation
            if ev.device_type != DeviceType.CUDA:
                spans.append((ev.name[len(SPAN_PREFIX):],) + iv[1:])
        elif ev.device_type == DeviceType.CUDA:
            device_ops.append(iv)
    return device_ops, spans


def breakdown(sl: Slice) -> Dict[str, list]:
    """The device operations that took most time, summed by name, and the
    longest idle gaps of the device, each named by the harness span in
    progress at its middle ("loop" where none is)."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in sl.device_ops:
        by_name[name] += (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    merged = _merged(sl.device_ops)
    gaps = []
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = (end + start) / 2
        host = [sp for sp in sl.spans if sp[1] <= mid <= sp[2]]
        gaps.append([max(host, key=lambda sp: sp[1])[0] if host else "loop",
                     (start - end) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [list(kv) for kv in ops[:BREAKDOWN_ENTRIES]],
            "idle_gaps": gaps[:BREAKDOWN_ENTRIES]}


def card_name(device_name: str) -> str:
    """The card's name with its power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "--id=0"], capture_output=True, text=True, timeout=30).stdout
        limit = out.strip().splitlines()[0] if out.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return f"{device_name} at {limit}"


def mean_us(values: List[float]) -> Optional[float]:
    """Mean of host seconds, in us; None for none."""
    return sum(values) / len(values) * 1e6 if values else None
