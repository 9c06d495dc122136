"""dispatch_tables_us: host microseconds a batch in the self time of the op
wrappers' ``<wrapper>.tables`` spans (the cached tables' and ``sm_count``'s
lookups, builds included), over the traced run's profiled slice
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_batch_us


def read(sl):
    return per_batch_us(sl, "tables")
