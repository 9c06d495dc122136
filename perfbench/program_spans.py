"""The program's own spans in a traced run's profiled slice.

The port records spans in memory on the host's monotonic clock
(``vali_tpu_torch.utils.tracing``), and while a ``torch.profiler`` records
it fills that store without adding ranges to the trace: a traced run's
store gains the calls of its profiled slice. :func:`read` takes them and

- splits the entry's host time into the op wrappers' phases: the self time
  of every ``<wrapper>.checks``, ``.tables``, ``.alloc`` and ``.launch``
  span (a ``tables.build`` inside a ``.tables`` span counts there), and
  the rest (the entry's and the wrappers' own time: routing, imports,
  ``movedim``); a ``.tables`` span with a ``tables.build`` inside is a
  miss of the table caches;
- maps the calls onto the trace's clock. Every call of batch k lies inside
  the harness's ``dispatch`` span k, so the offset from the host's clock to
  the trace's lies in ``[max_k(dispatch start - first call's start),
  min_k(dispatch end - last call's end)]``; the middle of that interval is
  taken, and only where it is at most :data:`CLOCK_US` wide.

The slice's batches are its ``dispatch`` spans. Its calls are the last ones
the store holds on the harness's thread, ``c`` a batch for the first ``c``
of 1 to :data:`MOST_CALLS` whose offset interval is not empty; where none
is, or where they made fewer launches than batches (the CPU route), there
is nothing to read. A program without the store (before its spans) has
nothing to read either.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.tracing import Slice, _merged

PHASES = ("checks", "tables", "alloc", "launch")
#: the widest offset interval, in us, that maps spans onto the trace: the
#: harness's own profiler range around the entry call leaves 10-16 us of it
#: on the host of an H100 machine
CLOCK_US = 30.0
#: entry calls a batch tried when picking the slice's calls
MOST_CALLS = 4
#: idle gaps logged, the longest first
GAPS_LOGGED = 10


@dataclasses.dataclass
class Split:
    """What the slice's program spans say (times in us)."""
    batches: int
    phase_us: Dict[str, float]     # per batch: each of PHASES and "rest"
    tables: int                    # `.tables` spans
    misses: int                    # of them, those with a build inside
    width_us: float                # the offset interval's width
    offset_us: Optional[float]     # host clock + offset = trace clock
    calls: List[Tuple[float, float]]   # entry calls on the trace's clock
    spans: List[Tuple[str, float, float]]   # every span, likewise


_last: Tuple[Optional[Slice], Optional[Split]] = (None, None)


def read(sl: Slice) -> Optional[Split]:
    """The slice's :class:`Split`, or None where it has none; made once a
    slice, which it logs."""
    global _last
    if _last[0] is not sl:
        _last = (sl, _split(sl))
    return _last[1]


def per_batch_us(sl: Slice, phase: str) -> Optional[float]:
    """Host us a batch in ``phase`` (one of PHASES or "rest")."""
    split = read(sl)
    return None if split is None else split.phase_us[phase]


def _store():
    """The program's stored spans, or None where it keeps none."""
    try:
        from vali_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = getattr(tracing, "spans", None)
    return spans() if spans else None


def _offset(dispatch, roots, c) -> Tuple[float, float]:
    """(low, high) of the offset, in ns, with ``c`` calls a batch."""
    lo, hi = float("-inf"), float("inf")
    for k, (ds, de) in enumerate(dispatch):
        first, last = roots[k * c], roots[(k + 1) * c - 1]
        lo = max(lo, ds - first.start_ns)
        hi = min(hi, de - last.end_ns)
    return lo, hi


def phase_totals(spans) -> Tuple[Dict[str, int], int, int, int]:
    """Of whole calls' spans (each call's spans share its ``call_id``):
    (ns in each of PHASES and "rest", `.tables` spans, of them those with
    a build inside, `.launch` spans)."""
    calls = defaultdict(list)
    for s in spans:
        calls[s.call_id].append(s)
    totals: Dict[str, int] = dict.fromkeys(PHASES + ("rest",), 0)
    tables = misses = launches = 0
    for group in calls.values():
        stack: list = []    # [end, phase, a `.tables` span, missed]
        for s in sorted(group, key=lambda s: (s.start_ns, -s.end_ns)):
            while stack and stack[-1][0] <= s.start_ns:
                misses += stack.pop()[3]
            phase = s.name.rpartition(".")[2]
            own = "." in s.name and phase in PHASES
            if not own:
                phase = stack[-1][1] if stack else "rest"
            dur = s.end_ns - s.start_ns
            totals[phase] += dur
            if stack:
                totals[stack[-1][1]] -= dur
            if s.name == "tables.build":
                for frame in reversed(stack):
                    if frame[2]:
                        frame[3] = True
                        break
            is_tables = own and phase == "tables"
            tables += is_tables
            launches += own and phase == "launch"
            stack.append([s.end_ns, phase, is_tables, False])
        misses += sum(frame[3] for frame in stack)
    return totals, tables, misses, launches


def _split(sl: Slice) -> Optional[Split]:
    # the harness's spans in ns of the trace's clock
    dispatch = sorted((s * 1e3, e * 1e3) for name, s, e in sl.spans
                      if name == "dispatch")
    stored = _store()
    if not dispatch or not stored:
        return None
    n = len(dispatch)
    me = threading.get_ident()
    roots = sorted((s for s in stored if s.thread == me and s.parent is None),
                   key=lambda s: s.start_ns)
    for c in range(1, MOST_CALLS + 1):
        if len(roots) < n * c:
            return None
        lo, hi = _offset(dispatch, roots[-n * c:], c)
        if lo <= hi:
            break
    else:
        return None
    roots = roots[-n * c:]
    ids = {r.call_id for r in roots}
    spans = [s for s in stored if s.thread == me and s.call_id in ids]
    totals, tables, misses, launches = phase_totals(spans)
    if launches < n:
        return None
    width = (hi - lo) * 1e-3
    offset = (lo + hi) / 2 if width <= CLOCK_US else None
    on_trace = 0.0 if offset is None else offset

    def trace_us(ns):
        return (ns + on_trace) * 1e-3
    split = Split(
        batches=n,
        phase_us={k: v * 1e-3 / n for k, v in totals.items()},
        tables=tables, misses=misses, width_us=width,
        offset_us=None if offset is None else offset * 1e-3,
        calls=[(trace_us(r.start_ns), trace_us(r.end_ns)) for r in roots],
        spans=[(s.name, trace_us(s.start_ns), trace_us(s.end_ns))
               for s in spans])
    mean_dispatch = sum(e - s for s, e in dispatch) * 1e-3 / n
    phases = ", ".join(f"{k} {v:.2f}" for k, v in split.phase_us.items())
    total = sum(split.phase_us.values())
    sl.log(f"program spans: {n} batches, {c} entry call(s) a batch; us a "
           f"batch: {phases}; sum {total:.2f} = "
           f"{100 * total / mean_dispatch:.1f} % of the dispatch span's "
           f"mean {mean_dispatch:.2f}; table caches {tables - misses} hits "
           f"of {tables}; clock offset interval {width:.3f} us wide"
           + ("" if offset is not None else
              f" (over {CLOCK_US} us: not mapped onto the trace)"))
    if offset is not None:
        _log_gaps(sl, split)
    return split


def idle_in_calls_us(sl: Slice, split: Split) -> Tuple[float, float]:
    """(us in which the device idles while the host is inside an entry
    call, us from the first device operation's start to the last one's
    end)."""
    merged = _merged(sl.device_ops)
    if not merged:
        return 0.0, 0.0
    both, i = 0.0, 0
    calls = split.calls
    for (_, end), (start, _) in zip(merged, merged[1:]):
        while i < len(calls) and calls[i][1] <= end:
            i += 1
        j = i
        while j < len(calls) and calls[j][0] < start:
            both += min(start, calls[j][1]) - max(end, calls[j][0])
            j += 1
    return both, merged[-1][1] - merged[0][0]


def _log_gaps(sl: Slice, split: Split) -> None:
    """Log the longest idle gaps of the device, each named by the
    innermost program span at its middle, else by the harness's span
    there."""
    merged = _merged(sl.device_ops)
    gaps = sorted(((start - end, (end + start) / 2) for (_, end), (start, _)
                   in zip(merged, merged[1:])), reverse=True)
    t0 = merged[0][0] if merged else 0.0
    for rank, (length, mid) in enumerate(gaps[:GAPS_LOGGED], 1):
        inside = [sp for sp in split.spans if sp[1] <= mid <= sp[2]]
        if inside:
            where = max(inside, key=lambda sp: sp[1])[0]
        else:
            host = [sp for sp in sl.spans if sp[1] <= mid <= sp[2]]
            where = ("harness " + max(host, key=lambda sp: sp[1])[0]
                     if host else "harness loop")
        sl.log(f"idle gap {rank}: {length:.1f} us at {mid - t0:.1f} us "
               f"into the slice, in {where}")
