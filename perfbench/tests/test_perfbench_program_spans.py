"""The readers of the program's spans on synthetic slices and stores: the
phases' self times, the table caches' hit share, the clock's offset
interval and the device's idle time inside entry calls, and nothing to
read where the interval is too wide or the calls are fewer than the
batches."""

import threading

import pytest

from perfbench import harness, program_spans
from perfbench.tracing import Slice
from vali_tpu_torch.utils import tracing

#: trace clock - host clock, us
OFFSET = 1000.0
BATCH_US = 500.0


def _span(name, start_us, end_us, parent, call_id):
    return tracing.Span(name, int(start_us * 1e3), int(end_us * 1e3), parent,
                        call_id, threading.get_ident())


def _call(t, call_id, build=False, entry="preprocess_batch",
          wrapper="nv12_preprocess"):
    """One entry call from t + 10 to t + 110 us (host clock): the wrapper
    96 us inside it, its checks 7, tables 19 (a build of 10 inside where
    ``build``), alloc 9, launch 49."""
    spans = [_span(entry, t + 10, t + 110, None, call_id),
             _span(wrapper, t + 12, t + 108, entry, call_id),
             _span(wrapper + ".checks", t + 13, t + 20, wrapper, call_id),
             _span(wrapper + ".tables", t + 21, t + 40, wrapper, call_id),
             _span(wrapper + ".alloc", t + 41, t + 50, wrapper, call_id),
             _span(wrapper + ".launch", t + 51, t + 100, wrapper, call_id)]
    if build:
        spans.append(_span("tables.build", t + 25, t + 35,
                           wrapper + ".tables", call_id))
    return spans


def _slice(dispatch, device_ops=(), logged=None):
    return Slice(config={}, traffic={}, device_ops=list(device_ops),
                 spans=[("dispatch", s, e) for s, e in dispatch],
                 dispatch_s=[], card="test",
                 log=(logged.append if logged is not None else print))


def _dispatch(n, early, late, calls=1, stride=BATCH_US):
    """Harness dispatch spans on the trace's clock enclosing ``calls``
    back-to-back entry calls a batch, opening ``early`` us before the
    first and closing ``late`` us after the last."""
    return [(k * stride + 10 + OFFSET - early,
             k * stride + 10 + 100 * calls + OFFSET + late)
            for k in range(n)]


@pytest.fixture
def store(monkeypatch):
    spans = []
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    return spans


def _read(sl, name):
    return harness.metric_reader(name).read(sl)


def test_the_phases_self_times_and_the_hit_share(store):
    for k in range(3):
        store += _call(k * BATCH_US, k, build=k == 0)
    logged = []
    sl = _slice(_dispatch(3, 2.0, 3.0), logged=logged)
    got = {p: _read(sl, f"dispatch_{p}_us")
           for p in ("checks", "tables", "alloc", "launch", "rest")}
    assert got == pytest.approx({"checks": 7, "tables": 19, "alloc": 9,
                                 "launch": 49, "rest": 4 + 12})
    assert _read(sl, "table_hit_pct") == pytest.approx(100 * (1 - 1 / 3))
    split = program_spans.read(sl)
    assert split.width_us == pytest.approx(5.0)
    assert split.offset_us == pytest.approx(OFFSET + 0.5)
    assert "100.00 =" in logged[0]


def test_a_nested_build_is_one_miss(store):
    store += _call(0, 0, build=True)
    store.append(_span("tables.build", 27, 33, "tables.build", 0))
    assert _read(_slice(_dispatch(1, 2.0, 3.0)), "table_hit_pct") == 0.0


def test_idle_inside_entry_calls(store):
    for k in range(3):
        store += _call(k * BATCH_US, k)
    ops = [("kernel", k * BATCH_US + OFFSET + 100,
            k * BATCH_US + OFFSET + 460) for k in range(3)]
    logged = []
    sl = _slice(_dispatch(3, 2.0, 3.0), ops, logged)
    # gaps (460, 600) and (960, 1100) meet calls from 510.5 and 1010.5
    assert _read(sl, "idle_in_wrappers_pct") == pytest.approx(
        100 * 2 * 89.5 / 1360)
    assert _read(sl, "device_idle_pct") == pytest.approx(100 * 280 / 1360)
    gaps = [line for line in logged if line.startswith("idle gap")]
    assert len(gaps) == 2
    assert all(g.endswith("in nv12_preprocess.tables") for g in gaps)


def test_an_interval_wider_than_the_bound_maps_nothing(store):
    for k in range(3):
        store += _call(k * BATCH_US, k)
    ops = [("kernel", OFFSET, OFFSET + 50), ("kernel", OFFSET + 900,
                                             OFFSET + 950)]
    sl = _slice(_dispatch(3, 16.0, 15.0), ops)
    assert program_spans.read(sl).width_us == pytest.approx(31.0)
    assert _read(sl, "idle_in_wrappers_pct") is None
    assert _read(sl, "dispatch_launch_us") == pytest.approx(49)


def test_an_empty_interval_reads_nothing(store):
    for k in range(3):
        store += _call(k * BATCH_US + (40 if k == 1 else 0), k)
    sl = _slice(_dispatch(3, 2.0, 3.0))
    assert program_spans.read(sl) is None
    assert _read(sl, "dispatch_checks_us") is None


def test_fewer_calls_than_batches_read_nothing(store):
    for k in range(2):
        store += _call(k * BATCH_US, k)
    sl = _slice(_dispatch(3, 2.0, 3.0))
    for name in ("dispatch_rest_us", "table_hit_pct", "idle_in_wrappers_pct"):
        assert _read(sl, name) is None


def test_calls_that_launch_nothing_read_nothing(store):
    """The CPU route: the entry's span alone."""
    for k in range(3):
        store.append(_span("preprocess_batch", k * BATCH_US + 10,
                           k * BATCH_US + 110, None, k))
    assert program_spans.read(_slice(_dispatch(3, 2.0, 3.0))) is None


def test_the_slice_is_the_last_calls_two_a_batch(store):
    """An earlier run's calls stay in the store; two entry calls a batch
    (convert, then resize) are grouped by the offset that fits."""
    store += _call(-5000, 100, build=True)
    for k in range(3):
        t = k * BATCH_US
        store += _call(t, 2 * k, entry="convert_batch", wrapper="nv12_to_rgb")
        store += _call(t + 100, 2 * k + 1, entry="resize_batch",
                       wrapper="packed_resize")
    sl = _slice(_dispatch(3, 2.0, 3.0, calls=2))
    split = program_spans.read(sl)
    assert split.batches == 3 and len(split.calls) == 6
    assert split.phase_us["launch"] == pytest.approx(98)
    assert _read(sl, "table_hit_pct") == 100.0


def test_a_program_without_the_store_reads_nothing(monkeypatch):
    monkeypatch.delattr(tracing, "spans")
    assert program_spans.read(_slice(_dispatch(3, 2.0, 3.0))) is None
