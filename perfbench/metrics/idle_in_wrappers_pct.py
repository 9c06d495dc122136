"""idle_in_wrappers_pct: percent of the profiled slice, from the first
device operation's start to the last one's end (as ``device_idle_pct``),
in which no operation ran on the device while the host was inside an entry
call of the program: its spans mapped onto the trace's clock through the
harness's ``dispatch`` spans (``perfbench/program_spans.py``)."""

from perfbench.program_spans import idle_in_calls_us
from perfbench.program_spans import read as program_spans


def read(sl):
    split = program_spans(sl)
    if split is None or split.offset_us is None:
        return None
    idle, window = idle_in_calls_us(sl, split)
    return 100.0 * idle / window if window > 0 else None
