"""A/B of lab kernels ``static_kernel`` (S, Slong) and
``transposed_chroma`` (T) (``csrc/nv12_chains.cu``: S2's tensor-core
block with the TPU's cast chains, or with the chroma H rows kept
interleaved and read MN-major) against the CUDA-core designs they
replace, on the card.

The earlier designs are ``nv12_static_launch`` (S / Slong: 8-row strips,
the H row tables in the 64 KB constant bank, the product's FMA passes)
and ``nv12_transposed_launch`` (T: the chroma H rows kept transposed in
shared memory) of an earlier ``csrc/nv12_variants.cu``. This builds that
source and the earlier ``csrc/nv12_static2.cu`` beside it into throwaway
libraries under ``build/chains_ab/`` (each with its own headers first on
the include path), and the current ``nv12_chains.cu`` and
``nv12_static2.cu`` alone, before the labs' library. Before any timing it
reads, from ``nvcc -Xptxas -v``, each new instance's registers, spills
and ptxas's C75xx warnings; from ``cuobjdump`` of both checkouts'
``nv12_static2.cu``, whether S2's instructions and registers are the
earlier ones (the block's new template parameters at their defaults), and
of S2's other users and ``nv12_aligned.cu`` (``SAME_CODE``) whether their
kernels are; and
from the new instances' SASS, the conversion instructions each chain
compiles to. It runs the descriptor probe (``nv12_chains_probe_launch``:
one wgmma with B K-major and MN-major at N = 32 and 64 against a matmul).
Then at each case — 64 x 1080p -> 224, eight frames with a padded pitch
and a misaligned view (element loads), and the card tests' small shapes —
it counts the output samples in which each new arm (``S``, ``Slong``,
``T`` at 32 rows, ``S16``, ``Slong16``, ``T16``) differs from S2 at the
same strip (``static_kernel2`` at (tile, 8)), from its plain version
(``static_kernel2_plain`` at (tile, 8)) and from ``nv12_preprocess``,
holds each to S2's bits, to the kernels' uint8 envelope (1 LSB on fewer
than 1e-3 of the samples) and its wrapper to the arm's bits, and S2 to
the earlier S2's bits. At the timed case it times the earlier S, Slong and
T, the six new arms, S2 t16a8 and t32a8 and ``nv12_preprocess`` with CUDA
events in ``--pairs`` rounds (the order reversed every other round), each
through one prepared call, and reports each one's median and range, each
round's ratios (new over earlier, each arm over S2 at its strip), each
launch's device time from ``torch.profiler`` and each arm's bounds.
Prints one line a case, then a summary line with the card's name and
power limit, and, with ``--out``, writes them as JSON; exits 1 where a
case breaks those rules, the probe disagrees, S2 left the earlier bits
or registers, or ptxas reports a spill or a C75xx warning. Run it from
the repository root with the earlier checkout (92ab04a, the last whose
``nv12_variants.cu`` holds the CUDA-core S and T) unpacked into the
git-ignored ``_chip/`` directory::

    mkdir -p _chip/parent && git archive 92ab04a | tar -x -C _chip/parent
    python -m vali_tpu_torch.lab.chains_ab \\
        _chip/parent/vali_tpu_torch/csrc/nv12_variants.cu \\
        [--pairs N] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops import _cuda_build
from ..ops.banded import (column_ranges, device_tables, fragment_order,
                          static2_smem_bytes, static2_tables, tail_params)
from ..ops.nv12_preprocess import nv12_preprocess
from ..ops.resize import LANCZOS_AA
from . import ab_common, chains, static2_ab
from . import kernel_variants as kv
from .ab_common import differ, kernel_ms, padded_view, rounds, within_envelope
from .preprocess_ab import launcher as product_launcher
from .timing import BF16_OPS_PER_S, bound_ms

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)
#: the earlier launchers' C signatures
EARLIER_SIGNATURES = {
    "nv12_static_launch": [_P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                           _I, _I, _I, _FP, _I, _I, _I, _P, _I, _I, _I, _P,
                           _P],
    "nv12_transposed_launch": [_P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P,
                               _I, _I, _I, _I, _FP, _I, _P, _P],
}
#: the earlier designs' strips (STRIP_ROWS of the earlier wrappers)
EARLIER_ROWS = 8
#: the new arms
ARMS = ("S", "Slong", "T", "S16", "Slong16", "T16")
#: the earlier arms, timed beside the new ones of the same name
EARLIER_ARMS = ("S", "Slong", "T")
_LAUNCHERS = ("nv12_chains_launch", "nv12_tchroma_launch",
              "nv12_chains_probe_launch")


def _arm(name: str):
    """(chain arm "S" / "Slong" / "T", strip rows) of a new arm's name."""
    m = re.fullmatch(r"(S|Slong|T)(\d*)", name)
    return m.group(1), int(m.group(2) or chains.CHAINS_TILE)


def _cuobjdump() -> str:
    return os.path.join(os.path.dirname(_cuda_build._nvcc()), "cuobjdump")


def sass(source: str, include_dir: str = "") -> dict:
    """Per kernel of ``source`` (compiled alone to a cubin with the
    package's flags): its SASS instructions, addresses dropped, and its
    registers (``cuobjdump -res-usage``)."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        incs = [f"-I{include_dir}"] if include_dir else []
        run = subprocess.run(
            [_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, *incs, "-cubin",
             "-o", cubin, source], capture_output=True, text=True,
            timeout=900)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc -cubin {source} failed:\n"
                               f"{run.stderr[-4000:]}")
        text = subprocess.run([_cuobjdump(), "-sass", cubin],
                              capture_output=True, text=True,
                              check=True).stdout
        res = subprocess.run([_cuobjdump(), "-res-usage", cubin],
                             capture_output=True, text=True,
                             check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"sass": []}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if fn and m:
            out[fn]["sass"].append(m.group(1))
    fn = None
    for line in res.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if fn in out and m:
            out[fn]["registers"] = int(m.group(1))
    return out


def _opcode(instr: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", instr).split()[0]


#: sources on the changed headers whose code the defaults should keep
SAME_CODE = ("nv12_static2.cu", "nv12_prodlike.cu", "nv12_combo.cu",
             "nv12_staged.cu", "nv12_aligned.cu")


def sass_report(parent_csrc: str) -> dict:
    """S2 (``nv12_static2.cu``) of both checkouts, instance by instance:
    equal SASS and registers; whether each of SAME_CODE compiles to the
    same kernels in both checkouts; and, per new instance of
    ``nv12_chains.cu``, its registers and its conversion and wgmma
    instructions by opcode."""
    csrc = os.path.join(_cuda_build._PKG_DIR, "csrc")
    with ThreadPoolExecutor(2 * len(SAME_CODE) + 1) as pool:
        futs = {(f, when): pool.submit(
                    sass, os.path.join(root, f), inc)
                for f in SAME_CODE
                for when, root, inc in (("current", csrc, ""),
                                        ("earlier", parent_csrc,
                                         parent_csrc))}
        new = pool.submit(sass, os.path.join(csrc, "nv12_chains.cu"))
        got = {k: v.result() for k, v in futs.items()}
        new = new.result()

    def bodies(funcs):   # the kernels, whatever their names
        return sorted((tuple(v["sass"]), v.get("registers"))
                      for v in funcs.values())

    same_code = {f: bodies(got[f, "current"]) == bodies(got[f, "earlier"])
                 for f in SAME_CODE}
    cur, old = (got["nv12_static2.cu", w] for w in ("current", "earlier"))
    def by_tile(funcs):   # nvcc names anonymous namespaces per file path
        return {f"S2t{m.group(1)}": v for fn, v in funcs.items()
                for m in [re.search(r"nv12_static2_kernelILi(\d+)E", fn)]
                if m}

    cur, old = by_tile(cur), by_tile(old)
    s2 = {k: dict(same_sass=k in old and cur[k]["sass"] == old[k]["sass"],
                  registers=cur[k].get("registers"),
                  earlier_registers=old.get(k, {}).get("registers"))
          for k in sorted(cur)}
    arms = {}
    for fn, v in new.items():
        name = _instance(fn)
        if name is None:
            continue
        ops = Counter(_opcode(i) for i in v["sass"])
        arms[name] = dict(registers=v.get("registers"), ops={
            k: n for k, n in sorted(ops.items())
            if re.match(r"(I2F|F2F|F2FP|FADD|PRMT|HGMMA|I2FP)", k)})
    return {"s2": s2, "same_code": same_code, "arms": arms}


def _instance(mangled: str):
    """The arm name of an nv12_chains_kernel instance, or None."""
    m = re.search(r"nv12_chains_kernelILi(\d+)ELi(\d)ELi(\d)E", mangled)
    if not m:
        return None
    tile, chain, layout = (int(g) for g in m.groups())
    arm = ("T" if layout == chains.CLAYOUTS["transposed"] else
           {chains.CHAINS["short"]: "S", chains.CHAINS["long"]: "Slong"}.get(
               chain, f"chain{chain}"))
    return arm if tile == chains.CHAINS_TILE else f"{arm}{tile}"


def ptxas_report() -> dict:
    """Registers, spills and C75xx warnings (``nvcc -Xptxas -v``) of each
    instance of nv12_chains.cu."""
    return ab_common.ptxas_report("nv12_chains.cu", _instance)


def builds(source: str) -> dict:
    """The earlier S / T and, from the same directory, the earlier S2; the
    current nv12_chains.cu and nv12_static2.cu alone, then (once those
    built) the labs' and the product's libraries; the ptxas and SASS
    reports. nvcc runs in parallel."""
    parent = os.path.dirname(os.path.abspath(source))
    s2_sig = {"nv12_static2_launch":
              _cuda_build._LAB_SIGNATURES["nv12_static2_launch"]}
    todo = {
        "earlier": lambda: ab_common.build_earlier(source, "chains_ab",
                                                   EARLIER_SIGNATURES),
        "earlier_s2": lambda: ab_common.build_earlier(
            os.path.join(parent, "nv12_static2.cu"), "chains_ab", s2_sig),
        "current": lambda: ab_common.build_current(
            "nv12_chains.cu", "chains_ab", _LAUNCHERS),
        "s2": lambda: ab_common.build_current(
            "nv12_static2.cu", "chains_ab", ["nv12_static2_launch"]),
        "ptxas": ptxas_report,
        "sass": lambda: sass_report(parent),
    }
    with ThreadPoolExecutor(len(todo)) as pool:
        futures = {k: pool.submit(f) for k, f in todo.items()}
        out = {k: f.result() for k, f in futures.items()}
    # the new source built alone first: the wrappers' library after it
    with ThreadPoolExecutor(2) as pool:
        lab = pool.submit(_cuda_build.load_lab_kernels)
        product = pool.submit(_cuda_build.load_kernels)
        out["lab"], out["product"] = lab.result(), product.result()
    return out


def _tail():
    return tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0, torch.uint8,
                       None)


def earlier_launcher(lib, nv12: torch.Tensor, geo: dict, arm: str):
    """A prepared call of the earlier S / Slong (constant-bank row tables,
    8-row strips in the fewest output-column ranges that fit a block) or
    T on ``nv12`` with the product's tables, as their wrappers passed
    them."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev, B = nv12.device, nv12.shape[0]
    tail = _tail()
    tabs = device_tables(sw, sh, dw, dh, LANCZOS_AA, "420", torch.bfloat16,
                         dev)
    out = torch.empty((B, 3, dh, dw), dtype=torch.uint8, device=dev)
    head = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, sh, sw, dh, dw, tabs.index.data_ptr(), tabs.weights.data_ptr(),
            *tabs.taps, tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    stream = torch.cuda.current_stream().cuda_stream
    keep = (tail, tabs)
    if arm == "T":
        fn = lib.nv12_transposed_launch
        args = (*head, EARLIER_ROWS, out.data_ptr(), stream)
    else:
        ranges = column_ranges(sw, sh, dw, dh, LANCZOS_AA, EARLIER_ROWS, dev)
        fn = lib.nv12_static_launch
        args = (*head, 1, int(arm == "S"), EARLIER_ROWS, *ranges.args(),
                out.data_ptr(), stream)
        keep += (ranges,)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"earlier {arm} launch failed ({rc})")
        return out
    call.keep = keep   # what the pointers point into
    return call


def launcher(lib, nv12: torch.Tensor, geo: dict, name: str):
    """A prepared call of the new arm ``name`` on ``nv12`` with S2's
    tables at (tile, 8)."""
    arm, tile = _arm(name)
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev, B = nv12.device, nv12.shape[0]
    tail = _tail()
    s_args, keep = kv._static2_device(sw, sh, dw, dh, tile,
                                      chains.CHAINS_ALIGN, dev)
    out = torch.empty((B, 3, dh, dw), dtype=torch.uint8, device=dev)
    knobs = (tile,) if arm == "T" else (int(arm == "S"), tile)
    fn = lib.nv12_tchroma_launch if arm == "T" else lib.nv12_chains_launch
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, sh, sw, dh, dw,
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *knobs,
            *s_args, out.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed ({rc})")
        return out
    call.keep = (tail, keep)
    return call


def probe(lib, n: int, mn_major: bool, seed: int = 0) -> bool:
    """One m64nNk16 wgmma of the probe launcher (A from registers, B
    through a descriptor at T's offsets: leading byte offset kGroupC of
    strip n / 2, stride 128) equals the matmul of the same small
    integers (exact sums)."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 9, (64, 16)).astype(np.float32)
    b = rng.integers(-8, 9, (16, n)).astype(np.float32)
    lbo = chains.group_bytes(n // 2)
    bits = (b.view(np.uint32) >> 16).astype(np.uint16)
    img = torch.from_numpy(chains.operand_image(bits, lbo, 128,
                                                mn_major)).to(dev)
    frags = torch.from_numpy(np.ascontiguousarray(fragment_order(a))).to(
        dev, torch.bfloat16)
    d = torch.full((64, n), float("nan"), dtype=torch.float32, device=dev)
    rc = lib.nv12_chains_probe_launch(
        frags.data_ptr(), img.data_ptr(), img.numel() // 16, n,
        int(mn_major), lbo, 128, d.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _cuda_build.check(lib, rc, "chains probe")
    torch.cuda.synchronize()
    return bool(torch.equal(d.cpu(), torch.from_numpy(a @ b)))


def cases(device):
    """(name, frames, geometry, timed)."""
    hd = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(64, 1620, 1920, device)
    out = [("64x1080p->224", x, hd, True),
           ("8x1080p->224 padded pitch", padded_view(x[:8], 64, 0), hd,
            False),
           ("8x1080p->224 misaligned view", padded_view(x[8:16], 16, 1), hd,
            False)]
    for b, h, w, dh, dw in ((4, 90, 162, 20, 50), (4, 62, 130, 30, 34),
                            (4, 96, 256, 40, 48), (8, 144, 256, 64, 96),
                            (3, 150, 322, 70, 202)):
        geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
        y = kv.make_frames(b, h * 3 // 2, w, device, seed=h + w)
        out.append((f"{b}x{w}x{h}->{dw}x{dh}", y, geo, False))
    return out


def check_case(b: dict, x: torch.Tensor, geo: dict, row: dict) -> dict:
    """The new arms against S2 at their strip, their plain version and
    nv12_preprocess, their wrappers against them, S2 against the earlier
    S2; returns the prepared calls of the new arms and of S2."""
    n = x.shape[0] * 3 * geo["dst_h"] * geo["dst_w"]
    product = nv12_preprocess(x, **geo)
    calls, ok, s2_out = {}, True, {}
    for t in chains.CHAINS_TILES:
        calls[f"S2t{t}a8"] = static2_ab.launcher(b["s2"], x, geo, t, 8,
                                                 False)
        s2_out[t] = calls[f"S2t{t}a8"]().clone()
        same = differ(s2_out[t], static2_ab.launcher(
            b["earlier_s2"], x, geo, t, 8, False)())
        row[f"S2t{t}a8_vs_earlier"] = same
        ok = ok and same["differ"] == 0
    for name in ARMS:
        arm, tile = _arm(name)
        case = kv.case(name, x.shape[0], x.shape[1], **geo)
        call = launcher(b["current"], x, geo, name)
        calls[name] = call
        out = call().clone()
        row[f"{name}_vs_S2"] = differ(out, s2_out[tile])
        row[f"{name}_vs_plain"] = differ(out, case.plain(x))
        row[f"{name}_vs_product"] = differ(out, product)
        row[f"{name}_wrapper_equal"] = bool(torch.equal(case.call(x), out))
        ok = (ok and row[f"{name}_vs_S2"]["differ"] == 0
              and within_envelope(row[f"{name}_vs_plain"], n)
              and within_envelope(row[f"{name}_vs_product"], n)
              and row[f"{name}_wrapper_equal"])
    torch.cuda.synchronize()
    row["ok"] = ok
    return calls


def summary(times: dict) -> dict:
    """Median and range of each call's times and each round's ratios: new
    over earlier, each arm over S2 at its strip."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    pairs = [(a, f"earlier_{a}") for a in EARLIER_ARMS]
    pairs += [(a, f"S2t{_arm(a)[1]}a8") for a in ARMS]
    for a, b in pairs:
        r = [x / y for x, y in zip(times[a], times[b])]
        out[f"{a}_over_{b}"] = r
        out[f"{a}_over_{b}_median"] = statistics.median(r)
    return out


def bounds(batch: int, geo: dict) -> dict:
    """Each new arm's bytes, FLOPs, both bounds and shared memory."""
    out = {}
    for name in ARMS:
        tile = _arm(name)[1]
        work = kv.static2_work(batch, **geo, tile=tile,
                               align=chains.CHAINS_ALIGN)
        out[f"{name}_bytes"], out[f"{name}_flops"] = work
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = bound_ms(*work)
        out[f"{name}_flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
        t = static2_tables(geo["src_w"], geo["src_h"], geo["dst_w"],
                           geo["dst_h"], LANCZOS_AA, tile,
                           chains.CHAINS_ALIGN)
        out[f"{name}_smem_bytes"] = static2_smem_bytes(tile, t.k_luma,
                                                       t.k_chroma)
    return out


def summary_line(row: dict, smi: str) -> str:
    """The timed case's medians and ratios in one line."""
    parts = []
    for name in ARMS:
        s2 = f"S2t{_arm(name)[1]}a8"
        p = (f"{name} {row[f'{name}_ms']:.4f} "
             f"({row[f'{name}_over_{s2}_median']:.3f} of {s2})")
        if name in EARLIER_ARMS:
            p += (f" earlier {row[f'earlier_{name}_ms']:.4f} "
                  f"({row[f'{name}_over_earlier_{name}_median']:.3f})")
        parts.append(p)
    return (f"chains_ab 64 x 1080p -> 224 (ms): " + "; ".join(parts)
            + f"; S2t16a8 {row['S2t16a8_ms']:.4f}, S2t32a8 "
            f"{row['S2t32a8_ms']:.4f}, nv12_preprocess "
            f"{row['nv12_preprocess_ms']:.4f} ({smi})")


def run(source: str, pairs: int = 10, log=print):
    b = builds(source)
    reports = {"ptxas": b.pop("ptxas"), "sass": b.pop("sass")}
    reports["probe"] = {f"n{n}_{'mn' if mn else 'k'}_major": probe(
        b["current"], n, mn) for n in (32, 64) for mn in (True, False)}
    log(json.dumps(reports))
    rows = []
    for name, x, geo, timed in cases(torch.device("cuda", 0)):
        row = dict(name=name, samples=x.shape[0] * 3 * geo["dst_h"]
                   * geo["dst_w"])
        calls = check_case(b, x, geo, row)
        if timed:
            for arm in EARLIER_ARMS:
                calls[f"earlier_{arm}"] = earlier_launcher(b["earlier"], x,
                                                           geo, arm)
                row[f"earlier_{arm}_vs_product"] = differ(
                    calls[f"earlier_{arm}"](), nv12_preprocess(x, **geo))
            calls["nv12_preprocess"] = product_launcher(
                b["product"], "nv12", [x], geo, {}, False)
            row.update(summary(rounds(calls, pairs)))
            row.update(bounds(x.shape[0], geo))
            # last: the profiler's tracing slows the launches timed after
            row["kernel_ms"] = kernel_ms(calls)
        log(json.dumps(row))
        rows.append(row)
        del calls
    return reports, rows


def failures(reports: dict, rows: list) -> list:
    """What breaks the A/B's rules: cases, the probe, S2 off the earlier
    SASS or registers, spills and C75xx warnings of the new instances."""
    bad = [r["name"] for r in rows if not r["ok"]]
    bad += [f"probe {k}" for k, v in reports["probe"].items() if not v]
    bad += [f"{k} registers" for k, v in reports["sass"]["s2"].items()
            if v["registers"] != v["earlier_registers"]]
    ptxas = reports["ptxas"]
    bad += [f"{k} spills" for k, v in ptxas.items() if k != "warnings"
            and (v.get("spill_store_bytes") or v.get("spill_load_bytes"))]
    bad += [f"ptxas: {w}" for w in ptxas["warnings"]]
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.chains_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_variants.cu with "
                                    "the CUDA-core S and T, its headers "
                                    "and nv12_static2.cu beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chains_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    reports, rows = run(args.earlier, args.pairs,
                        log=lambda s: print(s, flush=True))
    timed = next(r for r in rows if "nv12_preprocess_ms" in r)
    print(summary_line(timed, smi), flush=True)
    bad = failures(reports, rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, **reports, "rows": rows}, f, indent=1)
    print(f"failures (a case off S2's bits or outside the envelope, the "
          f"probe, S2 off its earlier registers, spills, C75xx): "
          f"{bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
