"""Put the checkout's root on ``sys.path`` so that ``perfbench`` and the
program import as they do in a run, and give the CPU tests a stand-in
for the card and cells cut to small sizes.

Each cell's CPU sizes are ``sizes/<cell>.json``: ``{"config": {...},
"traffic": {...}}``, the keys of its configuration and traffic mix that
the CPU runs override. A cell without that file fails its CPU runs with
a message that names it.

Under ``pytest -n <workers>`` each worker takes its share of the CPU's
cores for PyTorch's threads: with every worker on all of them, a batch
of a few milliseconds waits on thread pools that the other workers keep
busy and takes up to a second, so that a short window retires one batch
or none."""

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import pytest  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402

#: where each cell's CPU sizes are
SIZES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "sizes")


@pytest.fixture(scope="session", autouse=True)
def share_of_the_cores():
    """Under ``pytest -n <workers>``, this worker's share of the cores for
    PyTorch's threads."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        cores = (len(os.sched_getaffinity(0))
                 if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1)
        torch.set_num_threads(max(1, cores // workers))


class CellSizes:
    """Each cell's CPU sizes, read from ``<dir>/<cell>.json``."""

    def __init__(self, directory: str = SIZES_DIR):
        self.dir = directory

    def __call__(self, name: str) -> dict:
        path = os.path.join(self.dir, f"{name}.json")
        if not os.path.exists(path):
            pytest.fail(f"cell {name!r} has no CPU sizes: write {path} with "
                        '{"config": {...}, "traffic": {...}}, the sizes its '
                        "CPU runs take", pytrace=False)
        with open(path) as f:
            sizes = json.load(f)
        if set(sizes) != {"config", "traffic"}:
            pytest.fail(f"{path} holds {sorted(sizes)}, not exactly "
                        "config and traffic", pytrace=False)
        return sizes


class HostEvent:
    """A completion event where there is no card: host work is done when
    the call returns."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class HostCard:
    """The CPU in the card's place: no context, no kernel library, events
    on the host clock, no device memory."""

    platform = "cpu"
    activities = (torch.profiler.ProfilerActivity.CPU,)
    device = torch.device("cpu")

    def open(self, log):
        return iter(())

    def name(self):
        return "cpu"

    def stream(self):
        return None

    def event(self, stream=None):
        return HostEvent()

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak(self):
        return 0

    def release(self):
        pass


@pytest.fixture
def host_card():
    return HostCard()


@pytest.fixture
def small_cells(monkeypatch):
    """harness.cell with each cell's sizes cut to its sizes file; the
    reader it returns may be pointed at another directory."""
    real, sizes = harness.cell, CellSizes()

    def cut(name, bench=None):
        c = real(name, bench)
        s = sizes(name)
        return dataclasses.replace(c, config={**c.config, **s["config"]},
                                   traffic={**c.traffic, **s["traffic"]})
    monkeypatch.setattr(harness, "cell", cut)
    return sizes
