"""A/B of the product kernel ``nv12_to_rgb`` (``csrc/nv12_to_rgb.cu`` on
the staged block of ``csrc/convert_staged.cuh``: a TMA ring, the CSC as
``wgmma`` products with bf16 coefficients or on the CUDA cores with f32
ones, the packed output stored by TMA) against an earlier
``csrc/nv12_to_rgb.cu`` (the CUDA-core design: one thread per 16 pixels,
16-byte loads, the output staged through shared memory), on the card.

This builds the earlier source into a throwaway library under
``build/to_rgb_ab/`` (its own headers first on the include path), beside
the product's and the labs' libraries, and reads from ``nvcc -Xptxas -v``
the new instances' registers, spills and ptxas's C75xx warnings. It
compiles the lab's ``nv12_convert_staged.cu`` of both checkouts to SASS
(``lab/chains_ab.sass``), which must be equal instance for instance: the
lab's V1 / V2 now include the block from the shared header. At each case
(64 x 1080p BT.709 MPEG; 8 x 1080p BGR BT.601 JPEG; a padded pitch with
extra rows; a batch stride larger than the plane; a width of 144 at a
height of 1080; N = 1; the per-pixel route's width of 40 and odd pitch)
and both compute dtypes it counts the output samples in which the new
kernel differs from the earlier one and from the plain version, and
holds the launcher's route (``nv12_to_rgb_tma_route``) to the wrapper's
rule. At 64 x 1080p and at N = 1 it times the earlier and the new kernel
at both compute dtypes, the lab's V1 and the ``dma`` probe with CUDA
events in ``--pairs`` rounds (the order reversed every other round),
each through one prepared call, and each launch's device time by
``torch.profiler``; and each checkout's wrapper at N = 1 in a process of
its own (host microseconds a call, and its CUDA-event time). Prints one
line a case and a summary line with the card's name and power limit,
and, with ``--out``, writes them as JSON; exits 1 where the new kernel
differs from the earlier one or the plain version, the route rules
disagree, the lab's SASS changed, or ptxas reports a spill or a C75xx
warning. Run it from the repository root with the parent checkout
unpacked into the git-ignored ``_chip/`` directory::

    mkdir -p _chip/parent && git archive <commit> | tar -x -C _chip/parent
    python -m vali_tpu_torch.lab.to_rgb_ab \\
        _chip/parent/vali_tpu_torch/csrc/nv12_to_rgb.cu \\
        [--pairs N] [--out FILE]
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops import _cuda_build
from ..ops.nv12_to_rgb import (coefficients, device_table, nv12_to_rgb,
                               nv12_to_rgb_plain, staged_route)
from . import ab_common, chains_ab
from . import convert_ab
from .ab_common import differ, kernel_ms, padded_view, rounds
from .kernel_variants import make_frames
from .timing import CSC_OPS, bound_ms

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)
#: the earlier launcher's C signature
EARLIER_SIGNATURES = {
    "nv12_to_rgb_launch": [_P, _LL, _LL, _I, _I, _I, _FP, _P, _P]}
#: the compute dtypes: the route's name and the wrapper's argument
DTYPES = {"bf16": None, "f32": torch.float32}
#: the timed calls, and the ratios reported of each round
TIMED = ("earlier_bf16", "bf16", "earlier_f32", "f32", "V1", "dma")
RATIOS = (("bf16", "earlier_bf16"), ("f32", "earlier_f32"),
          ("f32", "bf16"), ("bf16", "V1"), ("bf16", "dma"),
          ("earlier_bf16", "dma"))
_BT709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)
_BGR601 = dict(space=ColorSpace.BT_601, crange=ColorRange.JPEG, swap=True)
#: each checkout's wrapper at N = 1 1080p, timed in a process of its own:
#: host microseconds a call (rounds of 100 calls, the card idle between
#: rounds) and the CUDA-event time of one call
WRAPPER_CODE = r"""
import json, statistics, time
import torch
from vali_tpu_torch.core.enums import ColorRange, ColorSpace
from vali_tpu_torch.lab.timing import time_ms
from vali_tpu_torch.ops.nv12_to_rgb import nv12_to_rgb
x = torch.randint(0, 256, (1, 1620, 1920), dtype=torch.uint8,
                  device="cuda")
out = {}
for name, cdt in (("bf16", None), ("f32", torch.float32)):
    kw = dict(src_w=1920, src_h=1080, space=ColorSpace.BT_709,
              crange=ColorRange.MPEG, compute_dtype=cdt)
    for _ in range(50):
        nv12_to_rgb(x, **kw)
    torch.cuda.synchronize()
    us = []
    for _ in range(21):
        t0 = time.perf_counter()
        for _ in range(100):
            nv12_to_rgb(x, **kw)
        us.append((time.perf_counter() - t0) / 100 * 1e6)
        torch.cuda.synchronize()
    out[f"{name}_host_us"] = statistics.median(us)
    out[f"{name}_host_us_range"] = [min(us), max(us)]
    out[f"{name}_event_ms"] = time_ms(lambda: nv12_to_rgb(x, **kw))
print(json.dumps(out))
"""


def _instance(mangled: str):
    """The route of a new nv12_to_rgb.cu kernel ("bf16", "f32", "scalar"),
    or None."""
    m = re.search(r"convert_staged_kernelILi(\d)E", mangled)
    if m:
        return {"0": "f32", "1": "bf16"}[m.group(1)]
    return "scalar" if "nv12_to_rgb_scalar" in mangled else None


def _lab_instance(mangled: str):
    """"V1" / "V2" of a staged convert kernel of the lab, or None."""
    m = re.search(r"convert_staged_kernelILi(\d)E", mangled)
    return f"V{m.group(1)}" if m else None


def lab_sass(parent_csrc: str) -> dict:
    """The lab's V1 / V2 (``nv12_convert_staged.cu``) of both checkouts:
    equal SASS and registers, instance by instance (nvcc names anonymous
    namespaces per file path, so instances are matched by template
    argument)."""
    csrc = os.path.join(_cuda_build._PKG_DIR, "csrc")
    with ThreadPoolExecutor(2) as pool:
        cur = pool.submit(chains_ab.sass,
                          os.path.join(csrc, "nv12_convert_staged.cu"))
        old = pool.submit(chains_ab.sass,
                          os.path.join(parent_csrc,
                                       "nv12_convert_staged.cu"),
                          parent_csrc)
        cur, old = cur.result(), old.result()

    def by_variant(funcs):
        return {v: f for fn, f in funcs.items()
                for v in [_lab_instance(fn)] if v}

    cur, old = by_variant(cur), by_variant(old)
    return {k: dict(same_sass=k in old and cur[k]["sass"] == old[k]["sass"],
                    registers=cur[k].get("registers"),
                    earlier_registers=old.get(k, {}).get("registers"),
                    instructions=len(cur[k]["sass"]))
            for k in sorted(cur)}


def wrapper_times(root: str) -> dict:
    """:data:`WRAPPER_CODE` run from the checkout at ``root`` (its package
    first on the path; it builds its own product library)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    run = subprocess.run([sys.executable, "-c", WRAPPER_CODE],
                         cwd=os.path.abspath(root), env=env,
                         capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"wrapper timing in {root} failed:\n"
                           f"{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def _parent_root(source: str) -> str:
    """The checkout of ``<root>/vali_tpu_torch/csrc/nv12_to_rgb.cu``."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(source))))


def build_in(root: str) -> None:
    """The product library of the checkout at ``root``, built in a process
    of its own (for :func:`wrapper_times`)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    run = subprocess.run(
        [sys.executable, "-c", "from vali_tpu_torch.ops._cuda_build import "
         "load_kernels; load_kernels()"], cwd=os.path.abspath(root),
        env=env, capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"build in {root} failed:\n{run.stderr[-4000:]}")


def builds(source: str) -> dict:
    """The earlier nv12_to_rgb.cu alone and the earlier checkout's product
    library, the product's and the labs' libraries, the new source's
    ptxas report and the lab's SASS of both checkouts; nvcc runs in
    parallel."""
    parent_csrc = os.path.dirname(os.path.abspath(source))
    todo = {
        "earlier_product": lambda: build_in(_parent_root(source)),
        "earlier": lambda: ab_common.build_earlier(source, "to_rgb_ab",
                                                   EARLIER_SIGNATURES),
        "product": _cuda_build.load_kernels,
        "lab": _cuda_build.load_lab_kernels,
        "ptxas": lambda: ab_common.ptxas_report("nv12_to_rgb.cu",
                                                _instance),
        "lab_sass": lambda: lab_sass(parent_csrc),
    }
    with ThreadPoolExecutor(len(todo)) as pool:
        futures = {k: pool.submit(f) for k, f in todo.items()}
        return {k: f.result() for k, f in futures.items()}


def earlier_launcher(lib, x: torch.Tensor, w: int, h: int, cc: dict,
                     cdt):
    """A prepared call of the earlier kernel on ``x``: ``(call, out)``."""
    k = coefficients(cc.get("space", ColorSpace.BT_709),
                     cc.get("crange", ColorRange.JPEG),
                     cc.get("swap", False),
                     torch.float32 if cdt is not None else torch.bfloat16)
    out = torch.empty((x.shape[0], h, 3 * w), dtype=torch.uint8,
                      device=x.device)
    args = (x.data_ptr(), x.stride(0), x.stride(1), x.shape[0], h, w,
            k.ctypes.data_as(_FP), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = lib.nv12_to_rgb_launch(*args)
        if rc != 0:
            raise RuntimeError(f"earlier nv12_to_rgb launch failed ({rc})")
        return out
    return call, out


def current_launcher(lib, x: torch.Tensor, w: int, h: int, cc: dict,
                     cdt):
    """A prepared call of the new kernel on ``x``, one ctypes call as the
    earlier one's (no device context): ``(call, out)``."""
    space = cc.get("space", ColorSpace.BT_709)
    crange = cc.get("crange", ColorRange.JPEG)
    swap = cc.get("swap", False)
    dtype = torch.float32 if cdt is not None else torch.bfloat16
    k = coefficients(space, crange, swap, dtype)
    tab = device_table(space, crange, swap, dtype, x.device)
    out = torch.empty((x.shape[0], h, 3 * w), dtype=torch.uint8,
                      device=x.device)
    args = (x.data_ptr(), x.stride(0), x.stride(1), x.shape[1], x.shape[0],
            h, w, k.ctypes.data_as(_FP), int(cdt is not None),
            tab.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = lib.nv12_to_rgb_launch(*args)
        if rc != 0:
            raise RuntimeError(f"nv12_to_rgb launch failed ({rc})")
        return out
    call.keep = (k, tab)
    return call, out


def cases(device):
    """(name, frames, width, height, colour space, range and swap,
    timed)."""
    x = make_frames(64, 1620, 1920, device)
    pitched = torch.zeros((8, 1660, 1984), dtype=torch.uint8, device=device)
    pitched[:, :, :1920] = make_frames(8, 1660, 1920, device, seed=5)
    flat = torch.zeros(8 * (1620 * 1920 + 4096), dtype=torch.uint8,
                       device=device)
    strided = torch.as_strided(flat, (8, 1620, 1920),
                               (1620 * 1920 + 4096, 1920, 1))
    strided.copy_(x[8:16])
    bt601 = dict(space=ColorSpace.BT_601, crange=ColorRange.JPEG)
    out = [("64x1080p", x, 1920, 1080, _BT709, True),
           ("8x1080p BGR BT.601 JPEG", x[:8], 1920, 1080, _BGR601, False),
           ("8x1080p pitch 1984, 1660 rows, BT.601 JPEG",
            pitched[:, :, :1920], 1920, 1080, bt601, False),
           ("8x1080p batch stride plane + 4096", strided, 1920, 1080,
            _BT709, False),
           ("8x1080p padded view", padded_view(x[:8], 64, 16), 1920, 1080,
            _BGR601, False),
           ("3x144x1080", make_frames(3, 1620, 144, device, seed=144), 144,
            1080, _BGR601, False),
           ("1x1080p", x[:1], 1920, 1080, _BT709, True),
           ("2x40x32 (per-pixel)", make_frames(2, 48, 40, device, seed=40),
            40, 32, _BGR601, False),
           ("2x1080p odd pitch (per-pixel)",
            padded_view(x[:2], 1, 1), 1920, 1080, _BT709, False)]
    return out


def check_case(b: dict, x: torch.Tensor, w: int, h: int, cc: dict,
               row: dict) -> dict:
    """Both compute dtypes of the new kernel against the earlier one and
    the plain version; the new wrapper against the prepared call; the
    launcher's route against the wrapper's rule. Returns the prepared
    calls."""
    calls, ok = {}, True
    for name, cdt in DTYPES.items():
        launch, out = current_launcher(b["product"], x, w, h, cc, cdt)
        launch()
        calls[name] = launch
        plain = nv12_to_rgb_plain(x, src_w=w, src_h=h, compute_dtype=cdt,
                                  **cc)
        earlier, e_out = earlier_launcher(b["earlier"], x, w, h, cc, cdt)
        earlier()
        calls[f"earlier_{name}"] = earlier
        row[f"{name}_vs_earlier"] = differ(out, e_out)
        row[f"{name}_vs_plain"] = differ(out, plain)
        row[f"earlier_{name}_vs_plain"] = differ(e_out, plain)
        row[f"{name}_wrapper_equal"] = bool(torch.equal(
            nv12_to_rgb(x, src_w=w, src_h=h, compute_dtype=cdt, **cc), out))
        ok = (ok and row[f"{name}_vs_earlier"]["differ"] == 0
              and row[f"{name}_vs_plain"]["differ"] == 0
              and row[f"{name}_wrapper_equal"])
    probe = torch.empty(16, dtype=torch.uint8, device=x.device)
    rule = b["product"].nv12_to_rgb_tma_route(
        x.data_ptr(), x.stride(0), x.stride(1), w, probe.data_ptr())
    row["staged_route"] = staged_route(x, w)
    row["route_rules_agree"] = (rule == 1) == row["staged_route"]
    torch.cuda.synchronize()
    row["ok"] = ok and row["route_rules_agree"]
    return calls


def run(source: str, pairs: int = 10, log=print):
    b = builds(source)
    b.pop("earlier_product")
    reports = {k: b.pop(k) for k in ("ptxas", "lab_sass")}
    log(json.dumps(reports))
    rows = []
    for name, x, w, h, cc, timed in cases(torch.device("cuda", 0)):
        row = dict(name=name, samples=x.shape[0] * 3 * h * w)
        calls = check_case(b, x, w, h, cc, row)
        if timed:
            for lab_name in ("V1", "dma"):
                calls[lab_name] = convert_ab.launcher(b["lab"], x, w, h,
                                                      lab_name, _BT709)
            timed_calls = {k: calls[k] for k in TIMED}
            row.update(ab_common.summary(rounds(timed_calls, pairs),
                                         RATIOS))
            nbytes = x.shape[0] * (h * 3 // 2 * w + 3 * h * w)
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, CSC_OPS * x.shape[0] * h * w)
            # last: the profiler's tracing slows the launches timed after
            row["kernel_ms"] = kernel_ms(timed_calls)
        log(json.dumps(row))
        rows.append(row)
        del calls
    torch.cuda.synchronize()
    reports["wrapper_n1"] = {
        "earlier": wrapper_times(_parent_root(source)),
        "current": wrapper_times(os.path.dirname(_cuda_build._PKG_DIR))}
    log(json.dumps({"wrapper_n1": reports["wrapper_n1"]}))
    return reports, rows


def failures(reports: dict, rows: list) -> list:
    """What breaks the A/B's rules: cases (differing samples, the route
    rules), the lab's SASS, spills and C75xx warnings of the new
    instances."""
    bad = [r["name"] for r in rows if not r["ok"]]
    bad += [f"lab {k} SASS changed" for k, v in reports["lab_sass"].items()
            if not v["same_sass"]
            or v["registers"] != v["earlier_registers"]]
    if set(reports["lab_sass"]) != {"V1", "V2"}:
        bad.append("lab instances not found")
    ptxas = reports["ptxas"]
    bad += [f"{k} spills" for k, v in ptxas.items() if k != "warnings"
            and (v.get("spill_store_bytes") or v.get("spill_load_bytes"))]
    bad += [f"ptxas: {w}" for w in ptxas["warnings"]]
    return bad


def line(rows: list, smi: str) -> str:
    parts = [ab_common.summary_line(f"to_rgb_ab {r['name']} NV12 -> RGB", r,
                                    TIMED, RATIOS, smi)
             for r in rows if "bf16_ms" in r]
    return "\n".join(parts)


def main(argv=None) -> int:
    return ab_common.main(
        "vali_tpu_torch.lab.to_rgb_ab", __doc__,
        "an earlier csrc/nv12_to_rgb.cu with the CUDA-core design, its "
        "headers beside it", run, failures, line, argv)


if __name__ == "__main__":
    sys.exit(main())
