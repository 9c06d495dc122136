"""One run of one cell: set-up, the measured window, the comparison.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names its configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); the mix names its frame source
(``generators/<frames>.py``) and its path adapter (``paths/<path>.py``),
which names its reference (``reference/``); the limits of the numbers
compared are ``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``.

The window is a closed loop with ``inflight`` batches in flight: before
batch i is handed to the entry, the harness waits on the completion
event of batch i - inflight, and a batch's outputs are dropped once its
event has completed, unless the batch is one of those sampled from the
seed for the comparison. Batch i's latency runs, on the device's clock,
from an event recorded on an idle stream as the batch is handed over to
the event recorded after its last kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import random
import statistics
import sys
import time
import traceback
from collections import deque
from types import ModuleType
from typing import Callable, Dict, Iterator, List, Optional, TextIO

import torch

from . import compare, tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: warm-up batches beyond the in-flight and sampled ones
WARM_EXTRA = 4
#: share of the window that passes before a traced run's slice starts
SLICE_AT = 0.25
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "vali_tpu")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def metric_reader(name: str):
    """``metrics/<name>.py`` (a name may hold dots), loaded from its
    file."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"),
        os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """What a workload's names in ``BENCHMARK.json`` lead to."""
    workload: dict          # its entry in BENCHMARK.json
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    path: ModuleType        # paths/<the mix's path>.py
    frames: ModuleType      # generators/<the mix's frames>.py


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell of workload ``name``."""
    bench = bench or manifest()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    traffic = load_json("traffic", w["traffic"])
    return Cell(w, load_json("configs", w["config"]), traffic,
                importlib.import_module(f"perfbench.paths.{traffic['path']}"),
                importlib.import_module(
                    f"perfbench.generators.{traffic['frames']}"))


def per_layer(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics that list ``workload``."""
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def forbidden_loaded() -> List[str]:
    """Forbidden top-level modules that ``sys.modules`` holds, compared by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def report(result: dict, out: Optional[TextIO] = None,
           err: Optional[TextIO] = None) -> int:
    """Print ``result``: the numbers compared beside their limits on
    ``err``, then the result line on ``out``. The last step of a run:
    where the process has loaded JAX or the JAX package by now, it names
    them on ``err``, prints no result and returns non-zero."""
    out, err = out or sys.stdout, err or sys.stderr
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; no result",
              file=err, flush=True)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0


class Card:
    """The CUDA card a run measures on."""

    platform = "gpu"
    activities = (torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA)

    def __init__(self, index: int = 0):
        self.device = torch.device("cuda", index)

    def open(self, log: Callable[[str], None]) -> Iterator[str]:
        """Set-up on the card, naming each step as it ends: the CUDA
        context, then the product kernel library (a first run in a
        checkout builds it)."""
        from vali_tpu_torch.ops import _cuda_build

        torch.empty(1, device=self.device)
        yield "CUDA context"
        if not os.path.exists(_cuda_build.library_path()):
            log("perfbench: building the product kernel library (a first "
                "run in this checkout compiles)")
        _cuda_build.load_kernels()
        yield "kernel library"

    def name(self) -> str:
        return torch.cuda.get_device_name(self.device)

    def stream(self):
        return torch.cuda.Stream(self.device)

    def event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def sync(self) -> None:
        torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device)

    def release(self) -> None:
        torch.cuda.empty_cache()


def _no_span(name: str):
    return contextlib.nullcontext()


class Window:
    """The closed loop over the ring (see the module's docstring)."""

    def __init__(self, call: Callable, ring, traffic: dict, seed: int,
                 card: Card, log: Callable[[str], None]):
        self.call, self.ring, self.card, self.log = call, ring, card, log
        self.inflight = traffic["inflight"]
        self.keep = traffic["sampled_batches"]
        self.rng = random.Random(seed)
        self.side = card.stream()
        self.pending: deque = deque()
        self.latency_ms: List[float] = []
        self.dispatch_s: List[float] = []
        self.samples: List[tuple] = []    # (batch index, outputs)
        self.failed = 0                   # batches that raised
        self.count = 0                    # batches handed over
        self.profile = None               # (device ops, spans) of a slice
        self.span = _no_span

    def _retire(self) -> None:
        """Wait on the oldest batch in flight, read its latency and drop
        its outputs."""
        hand, done, _ = self.pending.popleft()
        done.synchronize()
        self.latency_ms.append(hand.elapsed_time(done))

    def _step(self) -> None:
        if len(self.pending) >= self.inflight:
            with self.span("wait"):
                self._retire()
        i = self.count
        with self.span("ring"):
            planes = self.ring[i % len(self.ring)]
            hand = self.card.event(self.side)
        with self.span("dispatch"):
            t = time.perf_counter()
            try:
                out = self.call(planes)
            except Exception:  # a batch that raises fails its frames
                if not self.failed:
                    self.log(traceback.format_exc())
                self.failed += 1
                out = None
            self.dispatch_s.append(time.perf_counter() - t)
        with self.span("ring"):
            done = self.card.event()
            self.pending.append((hand, done, out))
            if i < self.keep:
                self.samples.append((i, out))
            else:
                j = self.rng.randrange(i + 1)
                if j < self.keep:
                    self.samples[j] = (i, out)
        self.count += 1

    def drain(self) -> None:
        with self.span("wait"):
            while self.pending:
                self._retire()

    def warm(self) -> None:
        """Every shape and every allocator block the window uses: the ring
        once round and as many outputs alive as the window keeps."""
        alive = [self.call(self.ring[i % len(self.ring)])
                 for i in range(self.inflight + self.keep + WARM_EXTRA)]
        self.card.sync()
        del alive

    def run(self, seconds: float, trace: bool) -> Dict[str, object]:
        """Measure for ``seconds``; with ``trace`` profile a slice of
        :data:`tracing.SLICE_BATCHES` batches from :data:`SLICE_AT` of the
        window on."""
        slice_at = SLICE_AT * seconds if trace else float("inf")
        prof, first, in_slice = None, 0, range(0)
        t0 = time.perf_counter()
        while (now := time.perf_counter() - t0) < seconds:
            if prof is None and not in_slice and now >= slice_at:
                prof, first = self._start_profile(), self.count
            self._step()
            if (prof is not None
                    and self.count - first >= tracing.SLICE_BATCHES):
                prof, in_slice = None, self._stop_profile(prof, first)
        if prof is not None:
            in_slice = self._stop_profile(prof, first)
        self.drain()
        lat = self.latency_ms
        return {"seconds": time.perf_counter() - t0,
                "p95_ms": statistics.quantiles(lat, n=20)[-1]
                if len(lat) >= 2 else float("nan"),
                "slice": in_slice}

    def warm_profiler(self) -> None:
        """Start and stop the profiler once: its first start initialises
        the device tracer."""
        self._stop_profile(self._start_profile(), 0)
        self.profile = None

    def _start_profile(self):
        prof = torch.profiler.profile(activities=self.card.activities)
        prof.start()
        self.span = lambda name: torch.profiler.record_function(
            tracing.SPAN_PREFIX + name)
        return prof

    def _stop_profile(self, prof, first: int) -> range:
        """Stop ``prof`` once the batches in flight are done; keep what it
        read; the batches it covered."""
        self.drain()
        prof.stop()
        self.span = _no_span
        self.profile = tracing.read_profile(prof)
        return range(first, self.count)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        started: Optional[float] = None, card: Optional[Card] = None,
        wrap: Optional[Callable[[Callable], Callable]] = None,
        control: bool = False,
        log: Callable[[str], None] = lambda s: print(s, file=sys.stderr,
                                                     flush=True)) -> dict:
    """One run of ``workload``: the result line as a dict.

    ``started`` is the process's start on the host clock (set-up counts
    from it). ``wrap`` wraps the entry (a fault planted in the timed
    path); ``control`` puts the reference one precision down in the
    program's place. Tests pass a stand-in for the ``card``."""
    started = time.perf_counter() if started is None else started
    bench = manifest()
    c = cell(workload, bench)
    card = card or Card()
    limit = compare.limits(workload)

    phases = [("imports", time.perf_counter())]
    for step in card.open(log):
        phases.append((step, time.perf_counter()))
    ring = c.frames.make_ring(c.config, c.traffic, seed, card.device)
    card.sync()
    phases.append(("ring", time.perf_counter()))
    call = (compare.control_call(c.path, c.config, c.traffic) if control
            else c.path.entry(c.config, c.traffic))
    call = wrap(call) if wrap else call
    win = Window(call, ring, c.traffic, seed, card, log)
    win.warm()
    if trace:
        win.warm_profiler()
    card.sync()
    phases.append(("warm-up", time.perf_counter()))
    # what set-up made lives on: a full collection inside the window then
    # scans only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started
    starts = [started] + [t for _, t in phases]
    log("perfbench: set-up " + ", ".join(
        f"{name} {t - prev:.3f} s" for (name, t), prev in zip(phases, starts))
        + f"; {setup_s:.3f} s")
    card.reset_peak()

    got = win.run(seconds, trace)
    gc.unfreeze()
    peak = card.peak()
    del win.pending, call
    card.release()
    readings = compare.gaps(win.samples, ring, c.path, c.config, c.traffic)
    correct, checks = compare.judged(readings, limit)
    done = (win.count - win.failed) * c.traffic["batch"]
    dev = {"platform": card.platform, "kind": card.name(),
           "count": c.workload["chips"], "memory_peak_bytes": peak}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    extra = {}
    if not trace:
        values = {"frames_per_s": done / got["seconds"],
                  "batch_latency_p95_ms": got["p95_ms"], "setup_s": setup_s}
    else:
        device_ops, spans = win.profile
        sl = tracing.Slice(
            config=c.config, traffic=c.traffic, device_ops=device_ops,
            spans=spans,
            dispatch_s=[t for i, t in enumerate(win.dispatch_s)
                        if i not in got["slice"]],
            card=tracing.card_name(dev["kind"]), log=log)
        values = {m["name"]: metric_reader(m["name"]).read(sl)
                  for m in per_layer(bench, workload)}
        dev["busy_s"], dev["window_s"] = sl.busy()
        extra["breakdown"] = tracing.breakdown(sl)
    return {"correct": correct and win.failed == 0,
            "attempted": win.count * c.traffic["batch"],
            "failed": win.failed * c.traffic["batch"],
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items() if v is not None},
            "device": dev, **extra, "checks": checks}
