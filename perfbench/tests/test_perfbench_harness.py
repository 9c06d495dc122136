"""A whole run of each cell on the CPU at small sizes, with the chip's
look skipped: the result line, the traced line, and ``correct`` coming
out false with a fault planted under the timed path or with the control
in the program's place. The card tests (marker ``cuda``) run each cell
briefly on a card."""

import copy
import io
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from perfbench import compare, faults, harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEED = 2**31 + 5
#: the cell that the tests below add by new files alone, and its model
ADDED, MODEL = "added_i420_b64", "fused_i420_b64"


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
    # the CPU has no device trace and the program records no spans there:
    # of the cell's per-layer metrics only the host-clock readings are there
    assert list(r["metrics"]) == [
        m["name"] for m in harness.per_layer(harness.manifest(), cell)
        if m["source"] == "host_clock"]
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
def added_cell(small_cells, monkeypatch, tmp_path):
    """A copy of ``MODEL`` under the name ``ADDED``, joined as a later PR
    joins a cell: its traffic, limits and CPU sizes in new files (under
    ``tmp_path``), one more workload in a copy of the manifest, listed by
    the per-layer metrics that list ``MODEL``. Returns that manifest,
    which the harness reads afresh on every call."""
    bench = copy.deepcopy(harness.manifest())
    entry = next(w for w in bench["workloads"] if w["name"] == MODEL)
    bench["workloads"].append({**entry, "name": ADDED, "traffic": ADDED})
    for m in bench["per_layer"]:
        if MODEL in m["workloads"]:
            m["workloads"].append(ADDED)
    for kind, src in (("traffic", harness.HERE), ("limits", harness.HERE),
                      ("sizes", os.path.dirname(small_cells.dir))):
        assert not os.path.exists(os.path.join(src, kind, f"{ADDED}.json"))
        os.makedirs(tmp_path / kind)
        shutil.copy(os.path.join(src, kind, f"{MODEL}.json"),
                    tmp_path / kind / f"{ADDED}.json")

    def added_from_tmp(mod, real):   # the real reader, at tmp_path
        def read(*args):
            if args[-1] != ADDED:
                return real(*args)
            with monkeypatch.context() as m:
                m.setattr(mod, "HERE", str(tmp_path))
                return real(*args)
        return read

    monkeypatch.setattr(harness, "manifest", lambda: copy.deepcopy(bench))
    monkeypatch.setattr(harness, "load_json",
                        added_from_tmp(harness, harness.load_json))
    monkeypatch.setattr(compare, "limits",
                        added_from_tmp(compare, compare.limits))
    small_cells.dir = str(tmp_path / "sizes")
    return bench


@pytest.mark.parametrize("check", ["contracts_line", "traced_run", "control"]
                         + [f"fault.{f}" for f in sorted(faults.FAULTS)])
def test_a_cell_joins_by_new_files_alone(added_cell, cpu_run, check):
    """The CPU checks of every cell, unedited, on the added cell."""
    if check == "contracts_line":
        test_a_run_prints_the_contracts_line(cpu_run, ADDED)
    elif check == "traced_run":
        test_a_traced_run_reads_its_layers(cpu_run, ADDED)
    elif check == "control":
        test_the_control_in_the_programs_place_is_not_correct(cpu_run, ADDED)
    else:
        test_a_planted_fault_is_not_correct(cpu_run, ADDED,
                                            check.split(".", 1)[1])


def test_a_cell_no_host_clock_metric_lists_reads_none_on_the_cpu(
        added_cell, cpu_run):
    for m in added_cell["per_layer"]:
        if m["source"] == "host_clock":
            m["workloads"].remove(ADDED)
    assert all(m["source"] != "host_clock"
               for m in harness.per_layer(harness.manifest(), ADDED))
    test_a_traced_run_reads_its_layers(cpu_run, ADDED)   # reads []


def test_a_cell_without_cpu_sizes_fails_naming_the_file(added_cell,
                                                        small_cells, cpu_run):
    os.remove(os.path.join(small_cells.dir, f"{ADDED}.json"))
    with pytest.raises(pytest.fail.Exception,
                       match=f"sizes/{ADDED}.json"):
        cpu_run(ADDED)


class Handed(Exception):
    """Raised by a stand-in reference once it has seen its frames."""


@pytest.mark.parametrize("ring_on,outputs_on", [("cpu", "meta"),
                                                 ("cpu", "cpu")])
def test_the_reference_computes_on_the_outputs_device(monkeypatch, ring_on,
                                                      outputs_on):
    handed = []

    def compute(block, fmt, config, precision):
        handed.append(block)
        raise Handed

    monkeypatch.setattr(compare, "reference", lambda path_mod:
                        types.SimpleNamespace(compute=compute))
    frames = torch.zeros((2, 12, 8), dtype=torch.uint8, device=ring_on)
    outs = (torch.empty((2, 4, 4, 3), dtype=torch.uint8, device=outputs_on),)
    with pytest.raises(Handed):
        compare.gaps([(0, outs)], [(frames,)],
                     types.SimpleNamespace(OUTPUTS=("rgb",)), {},
                     {"format": "NV12"})
    (block,) = handed
    assert block[0].device == torch.device(outputs_on)
    if ring_on == outputs_on:   # the ring's own frames, not a copy
        assert block[0].data_ptr() == frames.data_ptr()


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


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_host_ring_is_compared_on_the_outputs_device(card, small_cells,
                                                       cell):
    c = harness.cell(cell)
    ring = c.frames.make_ring(c.config, c.traffic, SEED,
                              torch.device("cuda"))
    host = [tuple(p.cpu() for p in planes) for planes in ring]
    call = c.path.entry(c.config, c.traffic)
    samples = [(i, call(ring[i])) for i in range(c.traffic["inflight"] + 1)]
    torch.cuda.synchronize()
    on_host = compare.gaps(samples, host, c.path, c.config, c.traffic)
    assert on_host == compare.gaps(samples, ring, c.path, c.config,
                                   c.traffic)
    assert compare.judged(on_host, compare.limits(cell))[0]
