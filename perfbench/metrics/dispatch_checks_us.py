"""dispatch_checks_us: host microseconds a batch in the self time of the op
wrappers' ``<wrapper>.checks`` spans (argument and stride checks, the packed
colour tail), over the traced run's profiled slice
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_batch_us


def read(sl):
    return per_batch_us(sl, "checks")
