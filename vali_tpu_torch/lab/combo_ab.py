"""A/B of lab kernel ``combo`` (``csrc/nv12_combo.cu``, the notebook's
``combo_kernel``) against its earlier design and against S2, on the card.

The earlier design is COMBO of an earlier ``csrc/nv12_variants.cu``
(``nv12_static_launch`` with the W tables staged in shared memory once a
block: the product's banded FMA loops on the CUDA cores over G frames of
a strip, H row tables in the constant bank, tall strips in output-column
ranges), from a checkout before the combo's redesign. The current
``nv12_variants.cu`` holds the stream floor alone; 92ab04a is the last
checkout whose ``nv12_variants.cu`` holds a CUDA-core S, with a later
``nv12_static_launch`` of another signature (``chains_ab`` builds that
one). This builds that source into a throwaway library under
``build/combo_ab/`` with its own headers first on the include path, then
at each case — 64 x 1080p -> 224, eight frames, a padded pitch, a
misaligned view (element loads) and the card tests' small shapes — counts
the output samples in which each of the new kernel's seven instances
(``combo{G}x{T}``) differs from S2 at the same strip height
(``static_kernel2`` at (T, 8); none at T = 64, which S2 refuses), from
``static_kernel2_plain`` at (T, 8) and from ``nv12_preprocess``, and each
earlier instance from ``nv12_preprocess``; it holds the new ones to the
kernels' uint8 envelope (1 LSB on fewer than 1e-3 of the samples), those
whose warpgroups split the chunks as S2's do to S2's bits, every earlier
one to ``nv12_preprocess``'s bits and the wrapper to the launcher. At the
timed case it times the earlier COMBO at its four instances, the new one
at its seven, S2 t16a8 and t32a8 and ``nv12_preprocess`` with CUDA events
in ``--pairs`` rounds (the order reversed every other round), each through
one prepared call, and reports each one's median and range, each
round's ratios (new against earlier, combo GxT against S2 tT), each
launch's device time from ``torch.profiler``, each instance's W-fragment
bytes a batch, shared memory, bounds and FLOPs, and the stream floor;
and, read from ``nvcc -Xptxas -v`` of ``csrc/nv12_combo.cu``, each
instance's registers, spills and ptxas's C75xx warnings. ``--knockouts``
also times the current source built with ``NV12_COMBO_KNOCKOUT`` 1 (no W
pass), 2 (no H pass) and 3 (the staging alone) at every instance, and S2
built with ``NV12_STATIC2_KNOCKOUT`` 1, 2, 3 at t16a8 and t32a8. Prints
one line a case, then a summary line with the card's name and power
limit, and, with ``--out``, writes them as JSON; exits 1 where a case
breaks those rules or ptxas reports a spill or a C75xx warning. Run it
from the repository root
with the earlier sources saved in the git-ignored ``_chip/`` directory::

    mkdir -p _chip/parent
    for f in nv12_variants.cu banded_preprocess.cuh banded_common.cuh; do
        git show <commit>:vali_tpu_torch/csrc/$f > _chip/parent/$f
    done
    python -m vali_tpu_torch.lab.combo_ab _chip/parent/nv12_variants.cu \\
        [--pairs N] [--knockouts] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops import _cuda_build
from ..ops.banded import (COMBO_ALIGN, COMBO_SPLITS, SMEM_LIMIT,
                          ColumnRanges, _ceil16, _nv12_bands,
                          combo_smem_bytes, device_tables, static2_tables,
                          tail_params)
from ..ops.nv12_preprocess import nv12_preprocess
from ..ops.resize import LANCZOS_AA
from . import ab_common
from . import kernel_variants as kv
from . import static2_ab
from .ab_common import (differ, kernel_ms, padded_view, rounds,
                        within_envelope)
from .preprocess_ab import launcher as product_launcher
from .timing import BF16_OPS_PER_S, bound_ms, time_ms

_EARLIER = "nv12_static_launch"
_CURRENT = "nv12_combo_launch"
#: the new kernel's instances (gframes, tile), and the earlier design's
ARMS = tuple(COMBO_SPLITS)
EARLIER_ARMS = ((2, 32), (4, 32), (2, 64), (1, 64))
#: S2's strip heights timed beside them, at align 8
S2_TILES = (16, 32)
KNOCKOUTS = (1, 2, 3)


def _arm(gframes: int, tile: int) -> str:
    return f"combo{gframes}x{tile}"


def build_earlier(source: str):
    """The earlier source, its own headers first, with its C signature."""
    return ab_common.build_earlier(source, "combo_ab",
                                   {_EARLIER: static2_ab.EARLIER_SIGNATURE})


def build_current(flags):
    """The current ``csrc/nv12_combo.cu`` alone, with -D ``flags``."""
    return ab_common.build_current("nv12_combo.cu", "combo_ab", [_CURRENT],
                                   flags)


def ptxas_report() -> dict:
    """Per instance of ``csrc/nv12_combo.cu`` (its kernel's mangled name
    holds Cfg<T, G, split>), from ``nvcc -Xptxas -v``: registers, spill
    store and load bytes; and every line of ptxas's C75xx warnings."""
    def instance(name):
        m = re.search(r"CfgILi(\d+)ELi(\d+)ELi(\d)E", name)
        if "nv12_combo_kernel" not in name or not m:
            return None
        return _arm(int(m.group(2)), int(m.group(1)))
    return ab_common.ptxas_report("nv12_combo.cu", instance)


def earlier_ranges(src_w: int, src_h: int, dst_w: int, dst_h: int,
                   rows: int, device) -> ColumnRanges:
    """The output-column ranges the earlier COMBO took: the fewest whose
    strip of ``rows`` rows of bf16 luma and interleaved chroma H rows, and
    the W tables staged beside them, fit a block (its wrapper's
    ``column_ranges(..., stage_w=True)``)."""
    _, _, (ys, yc, yw), (cs, cc, cw) = _nv12_bands(src_w, src_h, dst_w,
                                                   dst_h, LANCZOS_AA)
    rows = min(rows, dst_h)
    extra = 16 * dst_w + 4 * dst_w * (yw.shape[1] + cw.shape[1])
    for n in range(1, dst_w + 1):
        ext = np.zeros((n, 4), np.int32)
        for z in range(n):
            p0, p1 = z * dst_w // n, (z + 1) * dst_w // n
            ext[z] = ((0, src_w, 0, src_w) if n == 1 else (
                ys[p0:p1].min() // 16 * 16,
                min(src_w, _ceil16(int((ys + yc)[p0:p1].max()))),
                2 * cs[p0:p1].min() // 16 * 16,
                min(src_w, _ceil16(2 * int((cs + cc)[p0:p1].max())))))
        y_pitch = int((ext[:, 1] - ext[:, 0]).max())
        c_pitch = int((ext[:, 3] - ext[:, 2]).max())
        if _ceil16(2 * rows * (y_pitch + c_pitch)) + extra <= SMEM_LIMIT:
            return ColumnRanges(torch.from_numpy(ext).to(device), y_pitch,
                                c_pitch)
    raise ValueError(f"{rows}-row strips do not fit a block")


def launcher(lib, nv12: torch.Tensor, geo: dict, gframes: int, tile: int,
             earlier: bool):
    """A call of one build's combo launcher on ``nv12``, its arguments
    (tables, output) prepared once, so that the host work of a call is the
    ctypes call alone. The earlier design takes the product's tables, the
    constant bank, the short cast chain, the W tables staged and its
    column ranges, as its wrapper passed them."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev, B = nv12.device, nv12.shape[0]
    tail = tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0, torch.uint8,
                       None)
    out = torch.empty((B, 3, dh, dw), dtype=torch.uint8, device=dev)
    head = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, sh, sw, dh, dw)
    tail_p = tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    stream = torch.cuda.current_stream().cuda_stream
    if earlier:
        tabs = device_tables(sw, sh, dw, dh, LANCZOS_AA, "420",
                             torch.bfloat16, dev)
        ranges = earlier_ranges(sw, sh, dw, dh, tile, dev)
        fn = getattr(lib, _EARLIER)
        args = (*head, tabs.index.data_ptr(), tabs.weights.data_ptr(),
                *tabs.taps, tail_p, 1, 1, 1, gframes, tile, *ranges.args(),
                out.data_ptr(), stream)
        keep = (tabs, ranges)
    else:
        c_args, keep = kv._static2_device(sw, sh, dw, dh, tile, COMBO_ALIGN,
                                          dev)
        fn = getattr(lib, _CURRENT)
        args = (*head, tail_p, gframes, tile, *c_args, out.data_ptr(),
                stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{_arm(gframes, tile)} launch failed ({rc})")
        return out
    call.keep = (tail, keep)   # what the pointers point into
    return call


def cases(device):
    """(name, frames, geometry, timed): every batch a multiple of 8 (M8's
    rounds split)."""
    hd = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(64, 1620, 1920, device)
    out = [("64x1080p->224", x, hd, True),
           ("8x1080p->224", x[:8], hd, False),
           ("8x1080p->224 padded pitch", padded_view(x[:8], 64, 0), hd,
            False),
           ("8x1080p->224 misaligned view", padded_view(x[8:16], 16, 1), hd,
            False)]
    for b, h, w, dh, dw in ((8, 90, 162, 20, 50), (8, 62, 130, 30, 34),
                            (8, 96, 256, 40, 48), (8, 144, 256, 64, 96),
                            (8, 150, 322, 70, 202)):
        geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
        y = kv.make_frames(b, h * 3 // 2, w, device, seed=h + w)
        out.append((f"{b}x{w}x{h}->{dw}x{dh}", y, geo, False))
    return out


def resources(geo: dict) -> dict:
    """Per instance: its split, shared memory a block and K of each
    window."""
    row = {}
    args = (geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"],
            LANCZOS_AA)
    for g, t in ARMS:
        tab = static2_tables(*args, t, COMBO_ALIGN)
        row[f"{_arm(g, t)}_split"] = COMBO_SPLITS[g, t]
        row[f"{_arm(g, t)}_smem"] = combo_smem_bytes(g, t, tab.k_luma,
                                                     tab.k_chroma)
        row[f"{_arm(g, t)}_k"] = [tab.k_luma, tab.k_chroma]
    return row


def summary(times: dict) -> dict:
    """Median and range of each call's times, and each round's ratios of
    the new instances to the earlier ones and to S2 at the same strip
    height, and of nv12_preprocess to each."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    pairs = [(f"current_{_arm(g, t)}", f"earlier_{_arm(g, t)}")
             for g, t in EARLIER_ARMS]
    pairs += [(f"current_{_arm(g, t)}", f"S2_t{t}a8")
              for g, t in ARMS if t in S2_TILES]
    pairs += [("nv12_preprocess", f"current_{_arm(g, t)}") for g, t in ARMS]
    for a, b in pairs:
        r = [x / y for x, y in zip(times[a], times[b])]
        out[f"{a}_over_{b}"] = r
        out[f"{a}_over_{b}_median"] = statistics.median(r)
    return out


def summary_line(row: dict, smi: str) -> str:
    """The timed case's medians and ratios in one line."""
    parts = [f"{_arm(g, t)} {row[f'current_{_arm(g, t)}_ms']:.4f} ms"
             + (f" ({row[f'current_{_arm(g, t)}_over_S2_t{t}a8_median']:.3f}"
                f" x S2 t{t}a8)" if t in S2_TILES else "")
             + (f", earlier {row[f'earlier_{_arm(g, t)}_ms']:.4f}"
                if (g, t) in EARLIER_ARMS else "")
             for g, t in ARMS]
    return ("combo_ab 64 x 1080p -> 224: " + "; ".join(parts)
            + f"; S2 t16a8 {row['S2_t16a8_ms']:.4f}, t32a8 "
            f"{row['S2_t32a8_ms']:.4f}, nv12_preprocess "
            f"{row['nv12_preprocess_ms']:.4f} ms ({smi})")


def run(source: str, pairs: int = 10, knockouts: bool = False, log=print):
    todo = {"earlier": lambda: build_earlier(source), "ptxas": ptxas_report}
    if knockouts:
        for m in KNOCKOUTS:
            todo[f"knockout{m}"] = functools.partial(
                build_current, [f"-DNV12_COMBO_KNOCKOUT={m}"])
            todo[f"s2_knockout{m}"] = functools.partial(
                static2_ab.build_current, [f"-DNV12_STATIC2_KNOCKOUT={m}"])
    with ThreadPoolExecutor(len(todo) + 2) as pool:   # nvcc runs in parallel
        futures = {k: pool.submit(f) for k, f in todo.items()}
        futures["current"] = pool.submit(_cuda_build.load_lab_kernels)
        futures["product"] = pool.submit(_cuda_build.load_kernels)
        builds = {k: f.result() for k, f in futures.items()}
    ptxas = builds.pop("ptxas")
    log(json.dumps({"ptxas": ptxas}))
    lab, product_lib = builds["current"], builds.pop("product")
    rows = []
    for name, x, geo, timed in cases(torch.device("cuda", 0)):
        product = nv12_preprocess(x, **geo)
        n = product.numel()
        s2 = {t: kv.static_kernel2(x, **geo, tile=t, align=COMBO_ALIGN)
              for t in S2_TILES}
        row = dict(name=name, samples=n, ok=True)
        calls = {}
        for g, t in ARMS:
            arm = _arm(g, t)
            plain = kv.static_kernel2_plain(x, **geo, tile=t,
                                            align=COMBO_ALIGN)
            calls[f"current_{arm}"] = launcher(lab, x, geo, g, t, False)
            cur = calls[f"current_{arm}"]().clone()
            wrapper = kv.combo_kernel(x, **geo, gframes=g, tile=t)
            torch.cuda.synchronize()
            row[f"current_{arm}_vs_product"] = differ(cur, product)
            row[f"current_{arm}_vs_plain"] = differ(cur, plain)
            row[f"wrapper_{arm}_equal"] = bool(torch.equal(wrapper, cur))
            ok = (row[f"wrapper_{arm}_equal"]
                  and within_envelope(row[f"current_{arm}_vs_product"], n)
                  and within_envelope(row[f"current_{arm}_vs_plain"], n))
            if t in s2:
                row[f"current_{arm}_vs_S2t{t}a8"] = differ(cur, s2[t])
                if COMBO_SPLITS[g, t] == "chunks":
                    ok = ok and row[f"current_{arm}_vs_S2t{t}a8"][
                        "differ"] == 0
            if (g, t) in EARLIER_ARMS:
                calls[f"earlier_{arm}"] = launcher(builds["earlier"], x, geo,
                                                   g, t, True)
                old = calls[f"earlier_{arm}"]()
                row[f"earlier_{arm}_vs_product"] = differ(old, product)
                ok = ok and row[f"earlier_{arm}_vs_product"]["differ"] == 0
                del old
            row["ok"] = row["ok"] and ok
            del plain, wrapper, cur
        torch.cuda.synchronize()
        if timed:
            for t in S2_TILES:
                calls[f"S2_t{t}a8"] = static2_ab.launcher(
                    lab, x, geo, t, COMBO_ALIGN, False)
            calls["nv12_preprocess"] = product_launcher(
                product_lib, "nv12", [x], geo, {}, False)
            row.update(summary(rounds(calls, pairs)))
            row["floor_ms"] = time_ms(lambda: kv.stream_floor(
                x, rows=x.shape[1], W=geo["src_w"], DH=geo["dst_h"],
                DW=geo["dst_w"]))
            for tag, lib in builds.items():
                if tag.startswith("knockout"):
                    for g, t in ARMS:
                        row[f"{tag}_{_arm(g, t)}_ms"] = time_ms(
                            launcher(lib, x, geo, g, t, False))
                elif tag.startswith("s2_knockout"):
                    for t in S2_TILES:
                        row[f"{tag}_t{t}a8_ms"] = time_ms(static2_ab.launcher(
                            lib, x, geo, t, COMBO_ALIGN, False))
            b = x.shape[0]
            for g, t in ARMS + tuple((1, t) for t in S2_TILES):
                work = kv.combo_work(b, **geo, tile=t)
                key = _arm(g, t) if g > 1 or t == 64 else f"S2t{t}a8"
                row[f"{key}_w_fragment_bytes"] = kv.combo_w_fragment_bytes(
                    b, **geo, gframes=g, tile=t)
                row[f"{key}_bytes"], row[f"{key}_flops"] = work
                row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = \
                    bound_ms(*work)
                row[f"{key}_flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
            row.update(resources(geo))
            # last: the profiler's tracing slows the launches timed after
            row["kernel_ms"] = kernel_ms(
                {k: calls[k] for k in calls
                 if k.startswith(("current", "S2"))})
        log(json.dumps(row))
        rows.append(row)
        del calls, product, s2
    return ptxas, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.combo_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_variants.cu, its "
                                    "headers beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H pass and both knocked out, and S2's "
                         "knock-outs")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("combo_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ptxas, rows = run(args.earlier, args.pairs, args.knockouts,
                      log=lambda s: print(s, flush=True))
    timed = next(r for r in rows if "nv12_preprocess_ms" in r)
    print(summary_line(timed, smi), flush=True)
    bad = [r["name"] for r in rows if not r["ok"]]
    spills = [k for k, v in ptxas.items() if k != "warnings"
              and (v.get("spill_store_bytes") or v.get("spill_load_bytes"))]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "ptxas": ptxas, "rows": rows}, f,
                      indent=1)
    print(f"cases outside the envelope, off S2's bits where the split is "
          f"S2's, or with an earlier instance off nv12_preprocess: "
          f"{bad or 'none'}; ptxas spills {spills or 'none'}, C75xx "
          f"warnings {len(ptxas['warnings'])}")
    return 1 if bad or spills or ptxas["warnings"] else 0


if __name__ == "__main__":
    sys.exit(main())
