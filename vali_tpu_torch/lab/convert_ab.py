"""A/B of the convert lab's staged kernels V1 and V2
(``csrc/nv12_convert_staged.cu``: a TMA ring, the bf16 operand converted
once, the CSC as ``wgmma`` products, the packed output stored by TMA)
against the CUDA-core design they replace, on the card.

The earlier design is ``nv12_convert_variant_launch`` of an earlier
``csrc/nv12_to_rgb_variants.cu`` (bf16 tiles of 4 output rows in shared
memory, the product's FMA CSC). This builds that source into a throwaway
library under ``build/convert_ab/`` (its own headers first on the include
path), and the current ``nv12_convert_staged.cu`` alone, before the labs'
library. Before any timing it reads, from ``nvcc -Xptxas -v``, each new
instance's registers, spills and ptxas's C75xx warnings, and the probes'
registers in both checkouts' ``nv12_to_rgb_variants.cu``; it runs the
``wgmma`` probe (one m64nNk16 with A and B K-major in shared memory at N =
24 and 48, scale-d 0 over NaN accumulators, then once more with scale-d
1) against the matmul. Then at each case (64 x 1080p BT.709 MPEG; eight
1080p frames with a padded pitch, extra rows and BT.601 JPEG; the card
tests' small shapes) it counts the output samples in which the new V1 and
V2, and the earlier ones, differ from ``nv12_to_rgb`` and from the plain
version, and holds the new wrappers to the prepared calls' bits. At the
timed case it times the earlier and the new V1 and V2, ``nv12_to_rgb`` and
the probes ``dma`` and ``outonly`` with CUDA events in ``--pairs`` rounds
(the order reversed every other round), each through one prepared call,
and reports each one's median and range, each round's ratios, each
launch's device time from ``torch.profiler`` and the bounds. Prints one
line a case and a summary line with the card's name and power limit, and,
with ``--out``, writes them as JSON; exits 1 where a new kernel differs
from ``nv12_to_rgb`` or its plain version, the probe disagrees, a probe
mode's registers left the earlier ones, or ptxas reports a spill or a
C75xx warning. Run it from the repository root with a checkout before the
staged kernels unpacked into the git-ignored ``_chip/`` directory::

    mkdir -p _chip/parent && git archive 8576496 vali_tpu_torch \\
        | tar -x -C _chip/parent
    python -m vali_tpu_torch.lab.convert_ab \\
        _chip/parent/vali_tpu_torch/csrc/nv12_to_rgb_variants.cu \\
        [--pairs N] [--out FILE]
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops import _cuda_build
from ..ops.banded import core_matrix_order
from ..ops.nv12_to_rgb import device_table, nv12_to_rgb, nv12_to_rgb_plain
from . import ab_common
from . import convert_lab as cl
from . import convert_staged as cs
from .ab_common import differ, kernel_ms, padded_view, rounds
from .staged import bf16_bits, operand_image
from .timing import BF16_OPS_PER_S, bound_ms, convert_work

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)
#: the earlier launchers' C signatures
EARLIER_SIGNATURES = {
    "nv12_convert_variant_launch": [_P, _LL, _LL, _I, _I, _I, _FP, _I, _P,
                                    _P],
    "nv12_convert_probe_launch":
        _cuda_build._LAB_SIGNATURES["nv12_convert_probe_launch"],
}
_LAUNCHERS = ("nv12_convert_staged_launch",
              "nv12_convert_staged_probe_launch")
#: the timed calls, and the ratios reported of each round
TIMED = ("earlier_V1", "earlier_V2", "V1", "V2", "nv12_to_rgb", "dma",
         "outonly")
RATIOS = (("V1", "earlier_V1"), ("V2", "earlier_V2"), ("V2", "V1"),
          ("V1", "nv12_to_rgb"), ("V2", "nv12_to_rgb"), ("V1", "dma"),
          ("V2", "dma"), ("nv12_to_rgb", "dma"))
_BT709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)


def _instance(mangled: str):
    """"V1" / "V2" of a staged kernel instance, "probe<N>x<1|2>" of a
    probe one, or None."""
    m = re.search(r"convert_staged_kernelILi(\d)E", mangled)
    if m:
        return f"V{m.group(1)}"
    m = re.search(r"convert_staged_probe_kernelILi(\d+)ELi(\d)E", mangled)
    return f"probe{m.group(1)}x{int(m.group(2)) + 1}" if m else None


def _probe_instance(mangled: str):
    """The probe mode of an nv12_to_rgb_variants.cu kernel, or None."""
    m = re.search(r"probe_(stream|csc)_kernelILi(\d)E", mangled)
    if not m:
        return None
    return {v: k for k, v in cl.PROBES.items()}[int(m.group(2))]


def builds(source: str) -> dict:
    """The earlier V1 / V2 and probes; the current nv12_convert_staged.cu
    alone, then (once it built) the labs' and the product's libraries; the
    ptxas reports of the new source and of both checkouts' probes. nvcc
    runs in parallel."""
    todo = {
        "earlier": lambda: ab_common.build_earlier(source, "convert_ab",
                                                   EARLIER_SIGNATURES),
        "current": lambda: ab_common.build_current(
            "nv12_convert_staged.cu", "convert_ab", _LAUNCHERS),
        "ptxas": lambda: ab_common.ptxas_report("nv12_convert_staged.cu",
                                                _instance),
        "probe_regs": lambda: ab_common.ptxas_report(
            "nv12_to_rgb_variants.cu", _probe_instance),
        "earlier_probe_regs": lambda: ab_common.ptxas_report(
            os.path.abspath(source), _probe_instance),
    }
    with ThreadPoolExecutor(len(todo)) as pool:
        futures = {k: pool.submit(f) for k, f in todo.items()}
        out = {k: f.result() for k, f in futures.items()}
    with ThreadPoolExecutor(2) as pool:
        lab = pool.submit(_cuda_build.load_lab_kernels)
        product = pool.submit(_cuda_build.load_kernels)
        out["lab"], out["product"] = lab.result(), product.result()
    return out


def probe(lib, n: int, twice: bool, seed: int = 0) -> bool:
    """One m64nNk16 wgmma of the probe launcher (A K-major at the staged
    operand's offsets: leading byte offset 128, stride 4112; B K-major,
    128 / 256), scale-d 0 over NaN accumulators and with ``twice`` once
    more with scale-d 1, equals (twice) the matmul of the same small
    integers (exact sums)."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + n)
    a = rng.integers(-8, 9, (64, 16)).astype(np.float32)
    b = rng.integers(-8, 9, (16, n)).astype(np.float32)
    img = torch.from_numpy(operand_image(
        bf16_bits(a), cs.OPERAND_LBO, cs.OPERAND_SBO, False)).to(dev)
    b_img = torch.from_numpy(core_matrix_order(bf16_bits(b.T)).view(
        np.int16).copy()).to(dev)
    d = torch.empty((64, n), dtype=torch.float32, device=dev)
    rc = lib.nv12_convert_staged_probe_launch(
        img.data_ptr(), img.numel() // 16, b_img.data_ptr(),
        b_img.numel() * 2 // 16, n, int(twice), cs.OPERAND_LBO,
        cs.OPERAND_SBO, d.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _cuda_build.check(lib, rc, "convert staged probe")
    torch.cuda.synchronize()
    want = (a @ b) * (2 if twice else 1)
    return bool(torch.equal(d.cpu(), torch.from_numpy(want)))


def launcher(lib, x: torch.Tensor, w: int, h: int, name: str, cc: dict):
    """A prepared call of ``name`` on ``x``: "V1" / "V2" (the staged
    kernels), "earlier_V1" / "earlier_V2" (``lib`` the earlier build),
    "nv12_to_rgb" (the product library) or a probe mode."""
    dev, b = x.device, x.shape[0]
    k = cl._coefficients(cc["space"], cc["crange"])
    kp = k.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    head = (x.data_ptr(), x.stride(0), x.stride(1))
    stream = torch.cuda.current_stream().cuda_stream
    shape = (b, h, 3 * w)
    keep = (k,)
    if name in cl.VARIANTS:
        tab = cs.staged_device(cc["space"], cc["crange"], name, dev)
        fn, args = lib.nv12_convert_staged_launch, (
            *head, x.shape[1], b, h, w, kp, cl.VARIANTS[name],
            tab.data_ptr())
        keep += (tab,)
    elif name.startswith("earlier_"):
        fn, args = lib.nv12_convert_variant_launch, (
            *head, b, h, w, kp, cl.VARIANTS[name.removeprefix("earlier_")])
    elif name == "nv12_to_rgb":
        tab = device_table(cc["space"], cc["crange"], False, torch.bfloat16,
                           dev)
        fn, args = lib.nv12_to_rgb_launch, (
            *head, x.shape[1], b, h, w, kp, 0, tab.data_ptr())
        keep += (tab,)
    else:
        sink = torch.zeros(cl.SINK_WORDS, dtype=torch.int32, device=dev)
        fn, args = lib.nv12_convert_probe_launch, (
            *head, x.shape[1], b, h, w, kp, cl.PROBES[name],
            sink.data_ptr(), sink.numel())
        keep += (sink,)
    out = torch.empty(shape, dtype=torch.uint8, device=dev)

    def call():
        rc = fn(*args, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed ({rc})")
        return out
    call.keep = keep   # what the pointers point into
    return call


def cases(device):
    """(name, frames, width, height, colour space and range, timed)."""
    x = cl.make_frames(64, 1620, 1920, device)
    big = torch.zeros((8, 1660, 1984), dtype=torch.uint8, device=device)
    big[:, :, :1920] = cl.make_frames(8, 1660, 1920, device, seed=5)
    out = [("64x1080p", x, 1920, 1080, _BT709, True),
           ("8x1080p pitch 1984, 1660 rows, BT.601 JPEG",
            big[:, :, :1920], 1920, 1080,
            dict(space=ColorSpace.BT_601, crange=ColorRange.JPEG), False),
           ("8x1080p padded view", padded_view(x[:8], 64, 16), 1920, 1080,
            _BT709, False)]
    for b, w, h in ((3, 256, 144), (2, 336, 150), (2, 16, 2)):
        y = cl.make_frames(b, h * 3 // 2, w, device, seed=w + h)
        out.append((f"{b}x{w}x{h}", y, w, h, _BT709, False))
    return out


def check_case(b: dict, x: torch.Tensor, w: int, h: int, cc: dict,
               row: dict) -> dict:
    """The new and the earlier V1 / V2 against nv12_to_rgb and the plain
    version, the new wrappers against the prepared calls; returns the
    prepared calls."""
    product = nv12_to_rgb(x, src_w=w, src_h=h, **cc)
    plain = nv12_to_rgb_plain(x, src_w=w, src_h=h, **cc)
    calls, ok = {}, True
    for name in cl.VARIANTS:
        calls[name] = launcher(b["current"], x, w, h, name, cc)
        got = calls[name]().clone()
        row[f"{name}_vs_product"] = differ(got, product)
        row[f"{name}_vs_plain"] = differ(got, plain)
        row[f"{name}_wrapper_equal"] = bool(torch.equal(
            cl.convert_variant(x, src_w=w, src_h=h, variant=name, **cc),
            got))
        earlier = f"earlier_{name}"
        calls[earlier] = launcher(b["earlier"], x, w, h, earlier, cc)
        row[f"{earlier}_vs_product"] = differ(calls[earlier](), product)
        ok = (ok and row[f"{name}_vs_product"]["differ"] == 0
              and row[f"{name}_vs_plain"]["differ"] == 0
              and row[f"{name}_wrapper_equal"])
    torch.cuda.synchronize()
    row["ok"] = ok
    return calls


def bounds(batch: int, w: int, h: int) -> dict:
    """V1's and V2's bytes, issued FLOPs (zeros included), both bounds
    and shared memory; the bound of the CSC's own operations."""
    csc_ops = convert_work(batch, w, h, h * 3 // 2)[1]
    out = {"csc_ops_bound_ms": csc_ops / BF16_OPS_PER_S * 1e3}
    for name in cl.VARIANTS:
        work = convert_work(batch, w, h, h * 3 // 2, variant=name)
        out[f"{name}_bytes"], out[f"{name}_issued_flops"] = work
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = bound_ms(*work)
        out[f"{name}_issued_flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
        out[f"{name}_smem_bytes"] = cs.staged_smem_bytes(name)
    return out


def run(source: str, pairs: int = 10, log=print):
    b = builds(source)
    reports = {k: b.pop(k) for k in ("ptxas", "probe_regs",
                                     "earlier_probe_regs")}
    reports["probe"] = {f"n{n}_{'twice' if t else 'once'}": probe(
        b["current"], n, t) for n in (24, 48) for t in (False, True)}
    log(json.dumps(reports))
    rows = []
    for name, x, w, h, cc, timed in cases(torch.device("cuda", 0)):
        row = dict(name=name, samples=x.shape[0] * 3 * h * w)
        calls = check_case(b, x, w, h, cc, row)
        if timed:
            calls["nv12_to_rgb"] = launcher(b["product"], x, w, h,
                                            "nv12_to_rgb", cc)
            for mode in ("dma", "outonly"):
                calls[mode] = launcher(b["lab"], x, w, h, mode, cc)
            timed_calls = {k: calls[k] for k in TIMED}
            row.update(ab_common.summary(rounds(timed_calls, pairs),
                                         RATIOS))
            row.update(bounds(x.shape[0], w, h))
            # last: the profiler's tracing slows the launches timed after
            row["kernel_ms"] = kernel_ms({k: calls[k] for k in TIMED})
        log(json.dumps(row))
        rows.append(row)
        del calls
    return reports, rows


def failures(reports: dict, rows: list) -> list:
    """What breaks the A/B's rules: cases, the probe, a probe mode's
    registers off the earlier ones, spills and C75xx warnings of the new
    instances."""
    bad = [r["name"] for r in rows if not r["ok"]]
    bad += [f"probe {k}" for k, v in reports["probe"].items() if not v]
    now, then = reports["probe_regs"], reports["earlier_probe_regs"]
    bad += [f"{k} registers" for k in now if k != "warnings"
            and now[k].get("registers") != then.get(k, {}).get("registers")]
    ptxas = reports["ptxas"]
    bad += [f"{k} spills" for k, v in ptxas.items() if k != "warnings"
            and (v.get("spill_store_bytes") or v.get("spill_load_bytes"))]
    bad += [f"ptxas: {w}" for w in ptxas["warnings"]]
    return bad


def line(rows: list, smi: str) -> str:
    timed = next(r for r in rows if "V1_ms" in r)
    return ab_common.summary_line("convert_ab 64 x 1080p NV12 -> RGB",
                                  timed, TIMED, RATIOS, smi)


def main(argv=None) -> int:
    return ab_common.main(
        "vali_tpu_torch.lab.convert_ab", __doc__,
        "an earlier csrc/nv12_to_rgb_variants.cu with the CUDA-core V1 / "
        "V2, its headers beside it", run, failures, line, argv)


if __name__ == "__main__":
    sys.exit(main())
