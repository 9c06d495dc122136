"""The port's spans and counters (``vali_tpu_torch/utils/tracing.py``):
off by default and free of profiler ranges there, recorded after
``enable`` and while a profiler records, bounded, with counters that lose
no update across threads; the spans of the batched entries on the CPU
here, and their wrappers' phases and launches on a card (marked ``cuda``).

This file imports no JAX, so on a machine with a card it runs alone:
``python -m pytest tests/test_torch_port_tracing.py --noconftest -q``."""

import functools
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vali_tpu_torch.core.enums import PixelFormat
from vali_tpu_torch.ops import banded
from vali_tpu_torch.ops import nv12_to_rgb as n2r
from vali_tpu_torch.ops.csc import convert_batch
from vali_tpu_torch.ops.nv12_resize import nv12_resize
from vali_tpu_torch.ops.resize import resize_batch
from vali_tpu_torch.pipeline.multistream import BatchStager, preprocess_batch
from vali_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("checks", "tables", "alloc", "launch")


@pytest.fixture
def off():
    """Tracing off and the store empty; the setting restored after."""
    was = tracing.enable(False)
    tracing.clear()
    yield
    tracing.enable(was)
    tracing.clear()


@pytest.fixture
def on(off):
    tracing.enable(True)


def _names(spans):
    return [s.name for s in spans]


@pytest.mark.parametrize("env,want", [(None, False), ("0", False),
                                      ("1", True)])
def test_the_default_is_off(env, want):
    run_env = {k: v for k, v in os.environ.items() if k != "VALI_TPU_TRACE"}
    if env is not None:
        run_env["VALI_TPU_TRACE"] = env
    out = subprocess.run(
        [sys.executable, "-c", "from vali_tpu_torch.utils import tracing; "
         "print(tracing.enable(False))"], capture_output=True, text=True,
        cwd=ROOT, env=run_env, timeout=120)
    assert out.stdout.strip() == str(want), out.stderr


def test_off_records_nothing_and_returns_the_shared_no_op(off):
    first, second = tracing.span("a"), tracing.span("b")
    assert first is second
    with first as entered:
        with second:
            pass
    assert entered is first
    assert tracing.spans() == []


def test_enable_records_name_parent_call_and_thread(on):
    def work(tag):
        with tracing.span(f"outer.{tag}"):
            with tracing.span(f"inner.{tag}"):
                pass
    worker = threading.Thread(target=work, args=("t",))
    worker.start()
    work("main")
    worker.join(timeout=30)
    assert not worker.is_alive()
    spans = {s.name: s for s in tracing.spans()}
    assert set(spans) == {"outer.t", "inner.t", "outer.main", "inner.main"}
    for tag, thread in (("t", worker.ident),
                        ("main", threading.get_ident())):
        outer, inner = spans[f"outer.{tag}"], spans[f"inner.{tag}"]
        assert outer.parent is None and inner.parent == outer.name
        assert inner.call_id == outer.call_id
        assert outer.thread == inner.thread == thread
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= \
            outer.end_ns
    assert spans["outer.t"].call_id != spans["outer.main"].call_id


def test_an_exception_closes_its_span(on):
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError
    with tracing.span("after"):
        pass
    assert _names(tracing.spans()) == ["inner", "outer", "after"]
    assert tracing.spans()[-1].parent is None


def test_the_profiler_gate_fills_the_store_without_ranges(off):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("gated"):
            torch.ones(4).add_(1)
    assert _names(tracing.spans()) == ["gated"]
    assert not [e.name for e in prof.events() if "vali::" in e.name]
    with tracing.span("after"):
        pass
    assert _names(tracing.spans()) == ["gated"]


def test_enable_makes_profiler_ranges(on):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("ranged"):
            torch.ones(4).add_(1)
    assert "vali::ranged" in [e.name for e in prof.events()]


def test_the_bound_drops_the_oldest_and_counts_them(on):
    dropped = tracing.counters().get("spans.dropped", 0)
    for i in range(tracing.CAPACITY + 5):
        with tracing.span(str(i)):
            pass
    spans = tracing.spans()
    assert len(spans) == tracing.CAPACITY
    assert spans[0].name == "5" and spans[-1].name == str(
        tracing.CAPACITY + 4)
    assert tracing.counters()["spans.dropped"] == dropped + 5
    tracing.clear()
    assert tracing.spans() == []


def test_counters_lose_no_update_across_threads():
    before = tracing.counters().get("test.stress", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            tracing.count("test.stress") for _ in range(2000)])
            for _ in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = tracing.counters()
    assert got["test.stress"] == before + 2000 * len(threads)
    tracing.count("test.stress", 3)
    assert got["test.stress"] == before + 2000 * len(threads)  # a copy
    assert tracing.counters()["test.stress"] == got["test.stress"] + 3


def test_a_traced_build_counts_and_spans_its_misses(on):
    @functools.lru_cache(maxsize=4)
    @tracing.traced_build
    def probe_table(n):
        return [n] * n

    before = tracing.counters().get("tables.built.probe_table", 0)
    with tracing.span("probe.tables"):
        assert probe_table(3) == [3, 3, 3]
    with tracing.span("probe.tables"):
        assert probe_table(3) == [3, 3, 3]
    assert tracing.counters()["tables.built.probe_table"] == before + 1
    assert [(s.name, s.parent) for s in tracing.spans()] == [
        ("tables.build", "probe.tables"), ("probe.tables", None),
        ("probe.tables", None)]


def _nv12(b=2, w=64, h=32, device="cpu"):
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.integers(
        0, 256, (b, h * 3 // 2, w), dtype=np.uint8)).to(device)


def test_each_cpu_entry_records_its_outermost_span(on):
    x = _nv12()
    preprocess_batch((x,), PixelFormat.NV12, 64, 32, 16, 16)
    rgb = convert_batch((x,), PixelFormat.NV12, PixelFormat.RGB, 64, 32)
    resize_batch(rgb, PixelFormat.RGB, 64, 32, 16, 16)
    nv12_resize(x, src_w=64, src_h=32, dst_w=32, dst_h=16)
    BatchStager(PixelFormat.NV12, 64, 32, torch.device("cpu")).run(
        list(x.numpy().reshape(2, -1)),
        lambda planes: preprocess_batch(planes, PixelFormat.NV12, 64, 32,
                                        16, 16))
    roots = [s.name for s in tracing.spans() if s.parent is None]
    assert roots == ["preprocess_batch", "convert_batch", "resize_batch",
                     "nv12_resize", "stage"]
    staged = [s for s in tracing.spans() if s.name == "preprocess_batch"]
    assert staged[-1].parent == "stage"


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launches(name):
    return tracing.counters().get("launches." + name, 0)


def _phases_under(spans, wrapper, entry):
    """{phase: count} of ``wrapper``'s phase spans; each lies in the
    wrapper's span, itself in the entry's."""
    by_call = {}
    for s in spans:
        by_call.setdefault(s.call_id, []).append(s)
    got = {}
    for group in by_call.values():
        names = {s.name: s for s in group}
        if wrapper not in names:
            continue
        assert names[wrapper].parent == (None if entry == wrapper
                                         else entry)
        for phase in PHASES:
            for s in group:
                if s.name == f"{wrapper}.{phase}":
                    assert s.parent == wrapper
                    got[phase] = got.get(phase, 0) + 1
    return got


CARD_CASES = {
    "preprocess_batch": (
        lambda x: preprocess_batch((x,), PixelFormat.NV12, 256, 144, 96, 64),
        [("nv12_preprocess", "preprocess_batch", 1)]),
    "nv12_resize": (
        lambda x: nv12_resize(x, src_w=256, src_h=144, dst_w=128, dst_h=72),
        [("nv12_resize", "nv12_resize", 1)]),
    "two_stage": (
        lambda x: resize_batch(
            convert_batch((x,), PixelFormat.NV12, PixelFormat.RGB, 256, 144),
            PixelFormat.RGB, 256, 144, 96, 64),
        [("nv12_to_rgb", "convert_batch", 2),
         ("packed_resize", "resize_batch", 1)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_entries_record_their_wrappers_phases_and_launches(dev, on, case):
    """Each phase under its wrapper, under its entry; one launch counted a
    wrapper a call; the tables, their caches emptied, built inside the
    first call's ``.tables`` spans and not in the second.
    ``nv12_to_rgb`` prepares its launch's arguments and then launches: two
    ``.launch`` spans."""
    call, wrappers = CARD_CASES[case]
    x = _nv12(4, 256, 144, dev)
    for cached in (banded.device_tables, banded.stream_preprocess_tables,
                   banded.stream_resize_tables, n2r.device_table):
        cached.cache_clear()
    before = {w: _launches(w) for w, _, _ in wrappers}
    call(x)
    torch.cuda.synchronize()
    builds = [s for s in tracing.spans() if s.name == "tables.build"]
    assert builds and all(s.parent in {f"{w}.tables" for w, _, _ in wrappers}
                          | {"tables.build"} for s in builds)
    tracing.clear()
    call(x)
    torch.cuda.synchronize()
    spans = tracing.spans()
    for wrapper, entry, launch_spans in wrappers:
        assert _phases_under(spans, wrapper, entry) == {
            "checks": 1, "tables": 1, "alloc": 1, "launch": launch_spans}
        assert _launches(wrapper) == before[wrapper] + 2
    assert "tables.build" not in _names(spans)
