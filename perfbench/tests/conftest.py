"""Put the checkout's root on ``sys.path`` so that ``perfbench`` and the
program import as they do in a run, and give the CPU tests a stand-in
for the card and cells cut to small sizes."""

import dataclasses
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

#: each cell's configuration and traffic cut to sizes the CPU runs fast
SMALL = {"config": {"width": 192, "height": 108, "dst_width": 32,
                    "dst_height": 24}, "traffic": {"batch": 4}}
SMALL_4K = {"config": {"width": 384, "height": 216, "dst_width": 192,
                       "dst_height": 108}, "traffic": {"batch": 2}}
SIZES = {"fused_nv12_b64": SMALL, "fused_i420_b64": SMALL,
         "two_stage_nv12_b64": SMALL, "resize_4k_nv12_b16": SMALL_4K}


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
    """harness.cell with each cell's sizes cut to ``SIZES``."""
    real = harness.cell

    def cut(name, bench=None):
        c = real(name, bench)
        s = SIZES[name]
        return dataclasses.replace(c, config={**c.config, **s["config"]},
                                   traffic={**c.traffic, **s["traffic"]})
    monkeypatch.setattr(harness, "cell", cut)
    return SIZES
