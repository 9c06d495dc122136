"""dispatch_alloc_us: host microseconds a batch in the self time of the op
wrappers' ``<wrapper>.alloc`` spans (the output's ``torch.empty``), over the
traced run's profiled slice (``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_batch_us


def read(sl):
    return per_batch_us(sl, "alloc")
