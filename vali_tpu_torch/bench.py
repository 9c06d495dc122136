"""The port's bench: ``python -m vali_tpu_torch bench [--device cpu]``
(or ``python -m vali_tpu_torch.bench``) prints ONE JSON line.

Counterpart of the JAX package's root ``bench.py``. Headline: 64 1080p
NV12 frames -> RGB -> 224x224 through the fused ``nv12_preprocess``
kernel, frames/s per card, timed with CUDA events around back-to-back
calls after warm-up (``bench_configs.time_call``). The sections run in
the JAX bench's order: the host-bound section (software decode rate,
config 1), the headline, ``5_pipeline_chipside``, config 2, the 4K NV12
-> 1080p resize kernel and its dense twin, the dense contrast of the
headline, the 4K -> 224 preprocess, the pinned H2D copy, then
``bench_configs.run_all`` for the other configs.

The JAX bench's keys are kept where they mean the same on the card and
renamed where they would not (``ms_per_64frame_batch_pallas`` ->
``ms_per_64frame_batch_kernel``, ``pallas_slope_spread`` ->
``kernel_spread``, the ``_xla`` contrasts -> ``_dense``,
``tunnel_h2d_*`` -> ``h2d_*``); ``vs_baseline`` (a TPU target) is
dropped. A number that needs the native engine is null where the engine
cannot load, its config record saying why; a section skipped for lack
of budget leaves its number null.

It runs on the first CUDA card unless ``--device cpu`` asks for the CPU
(the tests do, at sizes they lower through the module constants); a CPU
line's numbers are host timings, not device metrics. A config that
raises is recorded as ``{"error": ...}``; that, an abort, or a headline
that did not measure makes the exit status 1, the line printed all the
same. :func:`run` measures in-process and returns the line's dict;
:func:`report` adds a watchdog that prints the partial line and exits 1
if a section blocks past the budget (``VALI_BENCH_BUDGET_S``, default
460 s) + 60 s.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

import numpy as np
import torch

from . import bench_configs as bc
from .core.enums import ColorRange, ColorSpace, PixelFormat

METRIC = "64x1080p NV12->RGB->224x224 fused CSC+resize frames/sec/gpu"
BUDGET_S = 460.0
#: 4K source of the resize (B4R frames, the dense twin B4_DENSE of them)
#: and of the 4K -> 224 preprocess (B4 frames)
H4K, W4K = 2160, 3840
B4R, B4_DENSE, B4 = 16, 8, 8
#: frames of the pinned H2D copy
H2D_FRAMES = 16
#: the least budget left, in seconds, to start a timed section after
#: config 2 (each takes a few seconds on the card)
SECTION_MIN_LEFT_S = 30.0


def new_result() -> dict:
    """The line before any number landed."""
    return {"metric": METRIC, "value": None, "unit": "frames/sec/gpu",
            "configs": {}}


def _device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (else
    torch's name for it), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def _sw_decode_rate() -> dict:
    """Single-stream software decode of the 848x464 clip on the host:
    the median frames/s of 3 passes and their relative spread (null
    where the native engine cannot load)."""
    keys = ("sw_decode_fps_single_stream_848x464", "sw_decode_fps_spread")
    if bc.engine_missing():
        return dict.fromkeys(keys)
    from .engine.decoder import PyDecoder

    clip = bc.clip_848()
    rates = []
    for _ in range(3):
        dec = PyDecoder(clip, {}, gpu_id=-1)
        frame = np.zeros(dec.HostFrameSize, dtype=np.uint8)
        n = 0
        t0 = time.perf_counter()
        while dec.DecodeSingleFrame(frame)[0]:
            n += 1
        rates.append(n / (time.perf_counter() - t0))
    med = float(np.median(rates))
    return dict(zip(keys, (med, (max(rates) - min(rates)) / med)))


def _progress_logger(t_start: float):
    def progress(msg: str) -> None:
        print(f"[bench {time.monotonic() - t_start:6.1f}s] {msg}",
              file=sys.stderr, flush=True)
    return progress


def run(device, budget_s: float = BUDGET_S, result: dict | None = None,
        progress=None) -> dict:
    """Measure every section on ``device`` and return the line's dict.

    ``result`` (default :func:`new_result`) is filled as each number
    lands; ``progress(section)`` is called as each section starts (by
    default a stderr logger). Starts no watchdog and never exits, so a
    caller may run it in-process; a section's exception propagates, a
    config's is recorded in its record."""
    from .ops.fused import fused_preprocess
    from .ops.nv12_preprocess import nv12_preprocess
    from .ops.nv12_resize import nv12_resize
    from .ops.resize import resize_batch

    device = torch.device(device)
    result = new_result() if result is None else result
    t_start = time.monotonic()
    progress = progress or _progress_logger(t_start)
    budget = bc.Budget(t_start + budget_s)
    configs = result["configs"]
    cuda = device.type == "cuda"
    result["unit"] = bc.rate_unit(device)

    progress("host-bound: sw decode + config 1")
    result.update(_sw_decode_rate())
    bc.run_one(configs, "1_sw_decode_cpu_convert",
               bc.config1_decode_convert_cpu, device, budget)

    result["device"] = _device_name(device)
    progress("headline kernel")
    B, H, W, DST = bc.B, bc.H, bc.W, bc.DST
    bt709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)
    rng = np.random.default_rng(0)
    nv12_host = rng.integers(0, 256, (B, H * 3 // 2, W), dtype=np.uint8)
    nv12 = torch.from_numpy(nv12_host).to(device)
    ms, spread = bc.time_call(lambda: nv12_preprocess(
        nv12, src_w=W, src_h=H, dst_w=DST, dst_h=DST, **bt709), device)
    nbytes = nv12.nbytes + B * DST * DST * 3
    result.update({
        "value": B / ms * 1e3, "ms_per_64frame_batch_kernel": ms,
        "kernel_spread": spread,
        "hbm_gbytes_per_sec": nbytes / ms * 1e-6 if cuda else None})

    progress("config 5_pipeline_chipside")
    chipside = configs["5_pipeline_chipside"] = {}
    try:
        bc.config5_pipeline_chipside(device, budget, sink=chipside)
    except Exception as e:  # the record says so; the line goes on
        traceback.print_exc()
        chipside["error"] = f"{type(e).__name__}: {e}"[:200]
    progress("config 2_tpu_two_stage_convert_resize")
    bc.run_one(configs, "2_tpu_two_stage_convert_resize",
               bc.config2_convert_resize, device, budget)

    for key in ("resize_4k_to_1080p_nv12_fps",
                "resize_4k_to_1080p_nv12_fps_dense",
                "ms_per_64frame_batch_dense", "preprocess_4k_to_224_fps"):
        result[key] = None
    if budget.left() > SECTION_MIN_LEFT_S:
        progress("4K resize")
        nv12_4k = torch.from_numpy(rng.integers(
            0, 256, (B4R, H4K * 3 // 2, W4K), dtype=np.uint8)).to(device)
        ms, _ = bc.time_call(lambda: nv12_resize(
            nv12_4k, src_w=W4K, src_h=H4K, dst_w=W, dst_h=H), device)
        result["resize_4k_to_1080p_nv12_fps"] = B4R / ms * 1e3
        dense_in = (nv12_4k[:B4_DENSE],)
        ms, _ = bc.time_call(lambda: resize_batch(
            dense_in, PixelFormat.NV12, W4K, H4K, W, H)[0], device,
            contrast=True)
        result["resize_4k_to_1080p_nv12_fps_dense"] = B4_DENSE / ms * 1e3
        del nv12_4k, dense_in

    if budget.left() > SECTION_MIN_LEFT_S:
        progress("dense contrast")
        ms, _ = bc.time_call(lambda: fused_preprocess(
            (nv12,), PixelFormat.NV12, W, H, DST, DST, **bt709), device,
            contrast=True)
        result["ms_per_64frame_batch_dense"] = ms

    if budget.left() > SECTION_MIN_LEFT_S:
        progress("4K preprocess")
        nv12_4kp = torch.from_numpy(rng.integers(
            0, 256, (B4, H4K * 3 // 2, W4K), dtype=np.uint8)).to(device)
        ms, _ = bc.time_call(lambda: nv12_preprocess(
            nv12_4kp, src_w=W4K, src_h=H4K, dst_w=DST, dst_h=DST, **bt709),
            device)
        result["preprocess_4k_to_224_fps"] = B4 / ms * 1e3
        del nv12_4kp
    del nv12

    progress("H2D")
    h2d = dict.fromkeys(("h2d_gbytes_per_sec", "h2d_spread"))
    if cuda:  # the pipeline's copy: pinned [frames, frame bytes] -> card
        stage = torch.from_numpy(np.ascontiguousarray(
            nv12_host[:H2D_FRAMES].reshape(-1, H * 3 // 2 * W))).pin_memory()
        ms, spread = bc.time_call(
            lambda: stage.to(device, non_blocking=True), device)
        h2d = {"h2d_gbytes_per_sec": stage.nbytes / ms * 1e-6,
               "h2d_spread": spread}
    result.update(h2d)

    progress("remaining configs")
    bc.run_all(device, deadline=t_start + budget_s, sink=configs,
               progress=progress, hard_deadline=t_start + budget_s + 45)
    return result


def exit_status(result: dict) -> int:
    """1 when the line aborted, the headline did not measure or a config
    raised; else 0."""
    if result.get("aborted") or not result.get("value"):
        return 1
    return int(any("error" in rec for rec in result["configs"].values()))


class Line:
    """The bench's one JSON line over ``result``, printed at most once
    (by the watchdog's thread or by the caller's)."""

    def __init__(self, result: dict):
        self.result = result
        self._lock = threading.Lock()
        self._printed = False

    def emit(self, aborted: str | None = None) -> bool:
        """Print the line, marked ``aborted`` when given; False when it
        was printed already."""
        with self._lock:
            if self._printed:
                return False
            self._printed = True
            if aborted:
                self.result["aborted"] = aborted
            # another thread may be adding keys: snapshot, retry on
            # "dict changed size during iteration"
            for _ in range(5):
                try:
                    snap = dict(self.result)
                    snap["configs"] = dict(self.result["configs"])
                    line = json.dumps(snap)
                    break
                except RuntimeError:
                    time.sleep(0.05)
            else:
                line = json.dumps({"metric": METRIC, "value": None,
                                   "aborted": aborted})
            print(line, flush=True)
            return True


def abort(line: Line, reason: str) -> None:
    """The watchdog: print the partial line and end the process with
    status 1 (a blocked section cannot be interrupted otherwise)."""
    if line.emit(reason):
        os._exit(1)


def report(device, budget_s: float | None = None) -> int:
    """:func:`run` under a watchdog; prints the line, returns the exit
    status (:func:`exit_status`)."""
    if budget_s is None:
        budget_s = float(os.environ.get("VALI_BENCH_BUDGET_S", BUDGET_S))
    result = new_result()
    line = Line(result)
    t_start = time.monotonic()
    log = _progress_logger(t_start)
    section = ["startup"]

    def progress(msg):
        section[0] = msg
        log(msg)

    watchdog = threading.Timer(budget_s + 60.0, lambda: abort(
        line, f"watchdog: exceeded {budget_s}+60s wall budget during "
              f"'{section[0]}'"))
    watchdog.daemon = True
    watchdog.start()
    try:
        run(device, budget_s, result, progress)
    except Exception as e:  # the line must still print
        traceback.print_exc()
        result["aborted"] = f"error: {type(e).__name__}: {e}"[:300]
    finally:
        watchdog.cancel()
    line.emit()
    return exit_status(result)


def main(argv=None) -> int:
    """``python -m vali_tpu_torch.bench [--device cpu]``: the CLI's
    ``bench`` command."""
    from .__main__ import main as cli

    return cli(["bench", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    sys.exit(main())
