"""dispatch_rest_us: host microseconds a batch in the self time of the entry's
and the op wrappers' spans outside their four phases (routing, imports,
``movedim``), over the traced run's profiled slice
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_batch_us


def read(sl):
    return per_batch_us(sl, "rest")
