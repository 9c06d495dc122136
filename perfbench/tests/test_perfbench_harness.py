"""A whole run of each cell on the CPU at small sizes, with the chip's
look skipped: the result line, the traced line, and ``correct`` coming
out false with a fault planted under the timed path or with the control
in the program's place. The card tests (marker ``cuda``) run each cell
briefly on a card."""

import io
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from perfbench import compare, faults, harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEED = 2**31 + 5


@pytest.fixture
def cpu_run(small_cells, host_card):
    """One run of a cell on the CPU at small sizes."""
    def run(cell, trace=False, **kw):
        return harness.run(cell, SEED, 0.3, trace, card=host_card,
                           log=lambda s: None, **kw)
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contracts_line(cpu_run, cell):
    r = cpu_run(cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0
    assert list(r["metrics"]) == ["frames_per_s", "batch_latency_p95_ms",
                                  "setup_s"]
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_layers(cpu_run, cell):
    r = cpu_run(cell, trace=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "checks"]
    assert r["correct"] is True
    # the CPU has no device trace: only the host-clock reading is there
    assert list(r["metrics"]) == ["dispatch_us"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cpu_run, cell, fault):
    assert cpu_run(cell, wrap=faults.FAULTS[fault])["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(cpu_run, cell):
    assert cpu_run(cell, control=True)["correct"] is False


def test_a_batch_that_raises_fails_its_frames(cpu_run):
    calls = []
    traffic = harness.cell("fused_nv12_b64").traffic
    warm = (traffic["inflight"] + traffic["sampled_batches"]
            + harness.WARM_EXTRA)

    def broken(call):   # sound through the warm-up, then every batch raises
        def f(planes):
            calls.append(1)
            if len(calls) > warm:
                raise RuntimeError("planted")
            return call(planes)
        return f

    r = cpu_run("fused_nv12_b64", wrap=broken)
    assert r["correct"] is False and 0 < r["failed"] <= r["attempted"]


def test_the_result_line_comes_last(cpu_run):
    out, err = io.StringIO(), io.StringIO()
    assert harness.report(cpu_run("fused_nv12_b64"), out, err) == 0
    assert json.loads(out.getvalue().splitlines()[-1])["correct"] is True
    assert err.getvalue().splitlines()[-1].startswith(
        "check max_err_lsb.rgb: ")


@pytest.mark.parametrize("name", ["jax", "vali_tpu"])
def test_a_forbidden_module_loaded_after_the_window_gives_no_result(
        cpu_run, monkeypatch, name):
    real = compare.reference

    def loading(path_mod):   # the comparison, after the window, loads it
        monkeypatch.setitem(sys.modules, name + ".core",
                            types.ModuleType(name + ".core"))
        return real(path_mod)

    monkeypatch.setattr(compare, "reference", loading)
    result = cpu_run("fused_nv12_b64", trace=True)
    out, err = io.StringIO(), io.StringIO()
    assert harness.report(result, out, err) != 0
    assert out.getvalue() == "" and name in err.getvalue()


def test_the_command_refuses_a_machine_without_the_cards():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "fused_nv12_b64", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_on_the_card(card, cell):
    r = harness.run(cell, SEED, 1.0, True, log=lambda s: None)
    assert r["correct"] is True
    want = {m["name"] for m in harness.per_layer(harness.manifest(), cell)}
    assert set(r["metrics"]) == want
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for name, m in r["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105
