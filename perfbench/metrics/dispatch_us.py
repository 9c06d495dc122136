"""dispatch_us: host microseconds of the entry call (the pipeline and op
wrappers: checks, cached tables, the output's allocation, the launches),
on the host clock without a synchronise, mean over every batch of the
traced run's window outside its profiled slice."""

from perfbench.tracing import mean_us


def read(sl):
    return mean_us(sl.dispatch_s)
