"""dispatch_launch_us: host microseconds a batch in the self time of the op
wrappers' ``<wrapper>.launch`` spans (the kernel library,
``torch.cuda.device``, the current stream, the ctypes call and its check),
over the traced run's profiled slice (``perfbench/program_spans.py``)."""

from perfbench.program_spans import per_batch_us


def read(sl):
    return per_batch_us(sl, "launch")
