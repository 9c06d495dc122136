"""device_idle_pct: percent of the profiled slice, from the first device
operation's start to the last one's end, in which no operation ran on the
device."""


def read(sl):
    busy, window = sl.busy()
    return 100.0 * (1.0 - busy / window) if window > 0 else None
