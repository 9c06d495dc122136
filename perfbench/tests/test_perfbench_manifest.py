"""BENCHMARK.json against the benchmark's contract, and every file a name
in it leads to."""

import importlib
import json
import os
import re

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(word) for word in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")


def test_full_check_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_are_unique_and_well_formed(key):
    names = [e["name"] for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("perfbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["name"] == c["name"]
        # only scale is cut: no size of a frame, a plane or an output
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in config
            assert not any(w in key for w in ("width", "height", "dim",
                                              "rank", "depth"))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    # the driver's limit: a quarter of the cells, rounded down, or one
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_end_to_end_metrics_are_the_three():
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "frames_per_s", "batch_latency_p95_ms", "setup_s"]


def test_configs_and_cells_refer_to_each_other():
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = harness.cell(cell)
    traffic, path = c.traffic, c.path
    assert callable(path.entry) and path.OUTPUTS
    assert callable(c.frames.make_ring)
    importlib.import_module(f"perfbench.reference.{path.REFERENCE}")
    with open(os.path.join(ROOT, "perfbench", "limits", f"{cell}.json")) as f:
        limits = json.load(f)
    assert set(limits) == {f"max_err_lsb.{o}" for o in path.OUTPUTS}
    assert traffic["ring"] >= traffic["inflight"] + 1


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_its_metrics(cell):
    layer = harness.per_layer(BENCH, cell)
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        harness.metric_reader(m["name"])
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert moved and cell in moved[0].get("workloads", CELLS)


def test_every_per_layer_metric_lists_its_cells():
    for m in BENCH["per_layer"]:
        assert m["workloads"] and len(set(m["workloads"])) == len(
            m["workloads"])


def test_per_layer_metrics_name_real_cells_and_layers():
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"pipeline and op wrappers", "kernels", "device"}
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
