"""vali_tpu_torch's bench (``vali_tpu_torch/bench.py``,
``vali_tpu_torch/bench_configs.py``) against the JAX package's root
``bench.py`` / ``bench_configs.py``, on the CPU at reduced sizes set
through the port's module constants.

Held to the reference: the config list (names, order, minimum budgets);
``run_all``'s budget rules (the cases of ``tests/test_bench_budget.py``
with the same stubbed configs give the same records); the line's keys
(``BENCH_r05.json``'s, renamed where they would mislead on the card);
the frames configs 1, 3, 4 and ``5_pipeline_64x1080p_jpeg`` count on the
same clips; and ``5_pipeline_chipside``'s dispatched batch on the same
decoded frames, within the preprocess envelope (1 LSB on < 1e-3 of the
samples). The failure rules: a native engine that cannot load turns the
engine-bound records into nulls with its reason (exit status 0); any
other exception is an ``"error"`` record and exit status 1; the
watchdog's partial line has the reference's shape and exit status 1;
without a card and without ``--device cpu`` the command exits 2."""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bench as ref_bench
import bench_configs as ref_bc
from vali_tpu_torch import bench
from vali_tpu_torch import bench_configs as bc
from vali_tpu_torch.engine import _loader
from vali_tpu_torch.utils.synth import synthesize_clip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
#: the JAX bench's keys the port renames, and the one it drops
RENAMED = {"ms_per_64frame_batch_pallas": "ms_per_64frame_batch_kernel",
           "pallas_slope_spread": "kernel_spread",
           "ms_per_64frame_batch_xla": "ms_per_64frame_batch_dense",
           "resize_4k_to_1080p_nv12_fps_xla":
               "resize_4k_to_1080p_nv12_fps_dense",
           "tunnel_h2d_gbytes_per_sec": "h2d_gbytes_per_sec",
           "tunnel_h2d_spread": "h2d_spread"}
DROPPED = {"vs_baseline"}
ENGINE_CONFIGS = ("1_sw_decode_cpu_convert", "3_transcode_4k_hevc",
                  "4_decode_preprocess_inference_e2e",
                  "5_pipeline_64x1080p_jpeg")
CLIP_848 = (192, 112, 48)    # the two clips, cut to size
CLIP_1080 = (256, 144, 8)


def port_keys(keys):
    """The JAX bench's keys under the port's names."""
    return {RENAMED.get(k, k) for k in keys if k not in DROPPED}


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """(848 stand-in, 1080 stand-in): small clips from the port's
    encoder and muxer, shared by both packages' configs."""
    d = tmp_path_factory.mktemp("bench")
    return (synthesize_clip(str(d / "a.mp4"), *CLIP_848[:2],
                            n=CLIP_848[2]),
            synthesize_clip(str(d / "b.mp4"), *CLIP_1080[:2],
                            n=CLIP_1080[2]))


def small(mp, clips):
    """Lower the port bench's sizes and hand it the small clips."""
    mp.setattr(bc, "clip_848", lambda: clips[0])
    mp.setattr(bc, "clip_1080", lambda: clips[1])
    for name, value in dict(B=2, H=CLIP_1080[1], W=CLIP_1080[0], DST=32,
                            STREAMS=4, TRANSCODE_SRC=(512, 288),
                            TRANSCODE_DST=CLIP_1080[:2]).items():
        mp.setattr(bc, name, value)
    for name, value in dict(H4K=288, W4K=512, B4R=2, B4_DENSE=1, B4=1,
                            H2D_FRAMES=2).items():
        mp.setattr(bench, name, value)


def report(device=CPU):
    """(the printed lines, exit status) of ``bench.report``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        status = bench.report(device)
    return out.getvalue().splitlines(), status


@pytest.fixture(scope="module")
def line(clips):
    """The bench's line and exit status, on the CPU at small sizes."""
    with pytest.MonkeyPatch.context() as mp:
        small(mp, clips)
        lines, status = report()
    assert len(lines) == 1, lines
    return json.loads(lines[0]), status


def test_all_configs_match_the_reference():
    assert [(n, b) for n, _, b in bc.ALL_CONFIGS] == [
        (n, b) for n, _, b in ref_bc.ALL_CONFIGS]


def _mask(obj):
    """``obj`` with the seconds of its notes masked (two runs read the
    clock at slightly different times)."""
    return json.loads(re.sub(r"-?\d+s left", "Ns left", json.dumps(obj)))


def _scenario(name, now):
    """(reference configs, port configs, run_all keywords, sinks, notes)
    of one case of the reference's budget tests; ``notes`` collects what
    the stubs saw."""
    notes = {"ref": [], "port": []}
    sinks = {"ref": None, "port": None}

    def ok(v, who):
        return lambda *a: (notes[who].append(v), {"v": v})[1]

    def both(fn):
        return fn("ref"), fn("port")

    if name == "minimum_window":   # deadline long past: still runs both
        ref, port = both(lambda w: [("a", ok(1, w), 0), ("b", ok(2, w), 0)])
        kw = dict(deadline=now - 9999)
    elif name == "mid_run_deadline":  # a config exhausts the budget

        def ref_slow():
            ref_bc._DEADLINE = time.monotonic() - 1
            return {"v": 1}

        def port_slow(device, budget):
            budget.deadline = time.monotonic() - 1
            return {"v": 1}

        ref = [("a", ref_slow, 0), ("b", ok(2, "ref"), 0)]
        port = [("a", port_slow, 0), ("b", ok(2, "port"), 0)]
        kw = dict(deadline=now + 9999)
    elif name == "min_budget_skip":
        ref, port = both(lambda w: [("pricey", ok(1, w), 100000),
                                    ("cheap", ok(2, w), 0)])
        kw = dict(deadline=now + 200)
    elif name == "error_contained":

        def boom(*a):
            raise RuntimeError("nope")

        ref, port = both(lambda w: [("a", boom, 0), ("b", ok(2, w), 0)])
        kw = {}
    elif name == "sink_progressive":  # b sees a's record in the sink

        def seen(w):
            return lambda *a: (notes[w].append(dict(sinks[w])), {"v": 2})[1]

        ref, port = both(lambda w: [("a", ok(1, w), 0), ("b", seen(w), 0)])
        sinks = {"ref": {}, "port": {}}
        kw = {}
    else:  # hard_deadline_cap: the grace window never passes the cap
        ref, port = both(lambda w: [("a", ok(1, w), 10)])
        kw = dict(deadline=now - 100, hard_deadline=now + 5)
    return ref, port, kw, sinks, notes


@pytest.mark.parametrize("name", [
    "minimum_window", "mid_run_deadline", "min_budget_skip",
    "error_contained", "sink_progressive", "hard_deadline_cap"])
def test_run_all_records_match_the_reference(monkeypatch, name):
    ref, port, kw, sinks, notes = _scenario(name, time.monotonic())
    monkeypatch.setattr(ref_bc, "ALL_CONFIGS", ref)
    monkeypatch.setattr(bc, "ALL_CONFIGS", port)
    monkeypatch.setattr(ref_bc, "_DEADLINE", None)
    msgs = {"ref": [], "port": []}
    got_ref = ref_bc.run_all(sink=sinks["ref"], progress=msgs["ref"].append,
                             **kw)
    got_port = bc.run_all(CPU, sink=sinks["port"],
                          progress=msgs["port"].append, **kw)
    assert _mask(got_port) == _mask(got_ref)
    assert notes["port"] == notes["ref"]
    assert _mask(msgs["port"]) == _mask(msgs["ref"])
    if sinks["port"] is not None:
        assert got_port is sinks["port"] and notes["port"] == [
            1, {"a": {"v": 1}}]
    if name == "error_contained":
        assert got_port["a"] == {"error": "RuntimeError: nope"}


def test_line_keys_match_bench_r05(line):
    d, status = line
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        parsed = json.load(f)["parsed"]
    assert set(d) == port_keys(parsed)
    assert set(d["configs"]) == set(parsed["configs"])
    assert status == 0 and d["device"] == "cpu"
    assert d["value"] > 0 and d["ms_per_64frame_batch_kernel"] > 0
    for name, rec in d["configs"].items():
        assert rec.get("value", 0) > 0, (name, rec)
    assert d["configs"]["5_pipeline_chipside"]["frames_from"] == "decoded"
    assert d["configs"]["5_pipeline_chipside"]["jpeg_device_ms_per_batch"] > 0
    # no device metric from a CPU run
    assert d["hbm_gbytes_per_sec"] is None and d["h2d_gbytes_per_sec"] is None


def _hevc_copy(src):
    """A stand-in for the reference's 4K HEVC synthesis: ``src`` copied."""
    def synth(path, n_frames=6):
        shutil.copyfile(src, path)
        return n_frames
    return synth


@pytest.mark.parametrize("name", ENGINE_CONFIGS)
def test_engine_configs_count_the_reference_s_frames(monkeypatch, clips,
                                                     tmp_path, name):
    small(monkeypatch, clips)
    monkeypatch.setattr(ref_bc, "clip_848", lambda: clips[0])
    monkeypatch.setattr(ref_bc, "clip_1080", lambda: clips[1])
    monkeypatch.setattr(ref_bc, "_DEADLINE", None)
    monkeypatch.setattr(bc, "STREAMS", 64)  # the reference's, fixed
    if name == "3_transcode_4k_hevc":
        src = str(tmp_path / "src.h265")
        assert bc._synthesize_hevc(src) == 6
        monkeypatch.setattr(ref_bc, "_synthesize_4k_hevc", _hevc_copy(src))
    ref = dict((n, f) for n, f, _ in ref_bc.ALL_CONFIGS)[name]()
    port = dict((n, f) for n, f, _ in bc.ALL_CONFIGS)[name](CPU, bc.Budget())
    assert port["frames"] == ref["frames"] > 0
    assert port["value"] > 0


def test_chipside_batch_matches_the_reference(monkeypatch, clips):
    """5_pipeline_chipside's dispatched batch (B = 2, dst 32, the same
    decoded frames) against the JAX pipeline's ``_dispatch_planes``."""
    small(monkeypatch, clips)
    monkeypatch.setattr(ref_bc, "clip_1080", lambda: clips[1])
    got = {"ref": [], "port": []}
    monkeypatch.setattr(ref_bc, "_slope_time", lambda fn, arg, **kw: (
        got["ref"].append(np.asarray(fn(arg))), 1e-3)[1])
    monkeypatch.setattr(bc, "time_call", lambda fn, device, **kw: (
        got["port"].append(fn()), (1.0, 0.0))[1])
    ref_rec = ref_bc.config5_pipeline_chipside(
        B=2, dst=32, sink={}, time_left=lambda: 10.0)
    rec = bc.config5_pipeline_chipside(CPU, bc.Budget(time.monotonic() + 10))
    assert "jpeg_skipped" in rec and "jpeg_skipped" in ref_rec
    assert rec["frames_from"] == "decoded" and rec["ms_per_batch"] == 1.0
    (ours,), (theirs,) = got["port"], got["ref"]
    assert ours.shape == theirs.shape == (2, 32, 32, 3)
    d = np.abs(ours.numpy().astype(int) - theirs.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_no_engine_gives_null_records_and_status_0(monkeypatch, clips):
    reason = "Failed to build the native engine: pkg-config failed"

    def missing():
        raise ImportError(reason + "\nlibavformat not found")

    small(monkeypatch, clips)
    monkeypatch.setattr(_loader, "load_native", missing)
    (text,), status = report()
    d = json.loads(text)
    why = bc.engine_missing()
    assert reason in why and status == 0
    for name in ENGINE_CONFIGS:
        assert d["configs"][name] == {"value": None, "reason": why}
    assert d["sw_decode_fps_single_stream_848x464"] is None
    assert d["configs"]["5_pipeline_chipside"]["frames_from"] == (
        f"synthetic: {why}")
    assert d["configs"]["5_pipeline_chipside"]["value"] > 0
    assert d["value"] > 0 and "aborted" not in d


def test_engine_reason_reads_the_same_on_every_call(monkeypatch):
    """The loader words its first failure and the remembered one
    differently; the reason the records carry is the build's own."""
    from vali_tpu_torch.engine import _native_build

    def fail():
        raise RuntimeError("pkg-config --cflags libavformat failed\n"
                           "Package 'libavcodec' not found")

    monkeypatch.setattr(_loader, "_native", None)
    monkeypatch.setattr(_loader, "_error", None)
    monkeypatch.setattr(_native_build, "build", fail)
    first, again = bc.engine_missing(), bc.engine_missing()
    assert first == again == (
        "the native engine cannot be built on this machine: pkg-config "
        "--cflags libavformat failed | Package 'libavcodec' not found")


def test_any_other_exception_is_an_error_and_status_1(monkeypatch, clips):
    def boom(device, budget):
        raise RuntimeError("boom")

    small(monkeypatch, clips)
    monkeypatch.setattr(bc, "config2_convert_resize", boom)
    (text,), status = report()
    d = json.loads(text)
    assert d["configs"]["2_tpu_two_stage_convert_resize"] == {
        "error": "RuntimeError: boom"}
    assert status == 1 and d["value"] > 0
    assert bench.exit_status(dict(d, configs={})) == 0


def test_watchdog_partial_line_has_the_reference_s_shape(capsys,
                                                         monkeypatch):
    exited = []
    monkeypatch.setattr(os, "_exit", exited.append)
    ref_bench.RESULT["configs"]["done_one"] = {"v": 3}
    try:
        ref_bench._emit_partial("test-reason")
        theirs = json.loads(capsys.readouterr().out)
    finally:
        ref_bench._DONE.clear()
        ref_bench.RESULT["configs"].pop("done_one", None)
        ref_bench.RESULT.pop("aborted", None)
    line = bench.Line(bench.new_result())
    line.result["configs"]["done_one"] = {"v": 3}
    bench.abort(line, "test-reason")
    ours = json.loads(capsys.readouterr().out)
    assert set(ours) == port_keys(theirs)
    assert ours["aborted"] == theirs["aborted"] == "test-reason"
    assert ours["configs"] == theirs["configs"] == {"done_one": {"v": 3}}
    assert exited == [0, 1]   # the reference exits 0, the port 1
    bench.abort(line, "again")  # printed once only
    assert capsys.readouterr().out == "" and exited == [0, 1]


@pytest.mark.parametrize("command", [["vali_tpu_torch", "bench"],
                                     ["vali_tpu_torch.bench"]])
def test_bench_without_a_card_exits_2(command):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run([sys.executable, "-m", *command],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode == 2 and res.stdout == ""
    assert "--device cpu" in res.stderr
