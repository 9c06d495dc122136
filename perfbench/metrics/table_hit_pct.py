"""table_hit_pct: percent of the op wrappers' ``<wrapper>.tables`` spans in
the traced run's profiled slice with no ``tables.build`` inside, a build
being a miss of the cached tables (``perfbench/program_spans.py``)."""

from perfbench.program_spans import read as program_spans


def read(sl):
    split = program_spans(sl)
    if split is None or not split.tables:
        return None
    return 100.0 * (1.0 - split.misses / split.tables)
