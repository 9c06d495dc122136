"""A/B of lab kernels ``prod_like`` (``csrc/nv12_prodlike.cu``; full at
S2's strip heights is ``csrc/nv12_static2.cu``) and ``multiframe``
(``csrc/nv12_combo.cu`` at (G, 32)) against the CUDA-core template they
replace, on the card.

The earlier design is ``nv12_variant_launch`` of an earlier
``csrc/nv12_variants.cu``: the product's FMA H pass into full-width bf16
rows in shared memory, then the product's W pass and tail, one block a
(strip, frame) or, with G frames a block, its tables staged in shared
memory once. This builds that source, and the earlier
``csrc/nv12_static2.cu`` and ``csrc/nv12_combo.cu`` beside it, into
throwaway libraries under ``build/prodlike_ab/`` (each with its own
headers first on the include path), then at each case — 64 x 1080p ->
224, eight frames with a padded pitch and a misaligned view (element
loads), and the card tests' small shapes — counts the output samples in
which each new arm (``full{T}``, ``hpass{T}``, ``wpass{T}``, ``M{G}``)
differs from its plain version and from ``nv12_preprocess``, holds it to
its lab case's tolerance (the kernels' uint8 envelope, 1 LSB; hpass,
which stores round(bf16 + bf16), ``kernel_variants.hpass_tolerance``)
on fewer than 1e-3 of the samples, and its wrapper to the arm's bits,
and holds S2 (full16, full32) and the combo (M2, M4) to their earlier
sources' bits. At the timed case it times the earlier template at full /
hpass / wpass (strip 8), full4, full16, full24, M2, M4 and M8, every new
arm, the earlier S2 t16a8 and t32a8 and combo 2x32 and 4x32, and
``nv12_preprocess``, with CUDA events in ``--pairs`` rounds (the order
reversed every other round), each through one prepared call, and
reports each one's median and range, each round's ratios (new over
earlier, hpass and wpass over full at their strip height, S2 and the
combo over their earlier sources), each launch's device time from
``torch.profiler``, each new instance's bounds, and, read from ``nvcc
-Xptxas -v`` before any timing, the registers, spills and ptxas's C75xx
warnings of ``nv12_prodlike.cu``, ``nv12_combo.cu`` and
``nv12_static2.cu``. Prints one line a case, then a summary line with the
card's name and power limit, and, with ``--out``, writes them as JSON;
exits 1 where a case breaks those rules or ptxas reports a spill or a
C75xx warning. Run it from the repository root with the earlier checkout
unpacked into the git-ignored ``_chip/`` directory::

    mkdir -p _chip/parent && git archive <commit> | tar -x -C _chip/parent
    python -m vali_tpu_torch.lab.prodlike_ab \\
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
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops import _cuda_build
from ..ops.banded import device_tables, tail_params
from ..ops.nv12_preprocess import nv12_preprocess
from ..ops.resize import LANCZOS_AA
from . import ab_common, combo_ab, static2_ab
from . import kernel_variants as kv
from .ab_common import differ, kernel_ms, padded_view, rounds, within_envelope
from .preprocess_ab import launcher as product_launcher
from .prodlike import MODES, PRODLIKE_STRIPS, PRODLIKE_TILES, prodlike_device
from .timing import BF16_OPS_PER_S, bound_ms

_EARLIER = "nv12_variant_launch"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the earlier launcher's C signature
EARLIER_SIGNATURE = [_P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                     _I, _I, ctypes.POINTER(ctypes.c_float), _I, _I, _I, _P,
                     _P]
#: the earlier template's timed arms: name -> (mode, frames a block,
#: strip rows); the earlier lab's full / hpass / wpass ran strip 8
EARLIER_ARMS = {"full8": ("full", 0, 8), "hpass8": ("hpass", 0, 8),
                "wpass8": ("wpass", 0, 8), "full4": ("full", 0, 4),
                "full16": ("full", 0, 16), "full24": ("full", 0, 24),
                "M2": ("full", 2, 8), "M4": ("full", 4, 8),
                "M8": ("full", 8, 8)}
#: the new arms: prod_like's modes at their strip heights (full at 8 and
#: up on S2's kernel), then multiframe's frames a block (the combo's)
NEW_ARMS = tuple(f"{m}{t}" for m, ts in PRODLIKE_STRIPS.items()
                 for t in ts) + ("M2", "M4", "M8")
#: S2's and the combo's instances held to their earlier sources
S2_TILES = (16, 32)
COMBOS = ((2, 32), (4, 32))


def _mode_tile(name: str):
    m = re.fullmatch(r"(full|hpass|wpass)(\d+)", name)
    return m.group(1), int(m.group(2))


def builds(source: str) -> dict:
    """The earlier template and, from the same directory, the earlier S2
    and combo; the current labs' and the product's libraries; and the
    ptxas reports of the new and the shared sources. nvcc runs in
    parallel."""
    parent = os.path.dirname(os.path.abspath(source))
    todo = {
        "earlier": lambda: ab_common.build_earlier(
            source, "prodlike_ab", {_EARLIER: EARLIER_SIGNATURE}),
        "earlier_s2": lambda: ab_common.build_earlier(
            os.path.join(parent, "nv12_static2.cu"), "prodlike_ab",
            {"nv12_static2_launch":
             _cuda_build._LAB_SIGNATURES["nv12_static2_launch"]}),
        "earlier_combo": lambda: ab_common.build_earlier(
            os.path.join(parent, "nv12_combo.cu"), "prodlike_ab",
            {"nv12_combo_launch":
             _cuda_build._LAB_SIGNATURES["nv12_combo_launch"]}),
        "current": _cuda_build.load_lab_kernels,
        "product": _cuda_build.load_kernels,
        "ptxas": ptxas_report,
    }
    with ThreadPoolExecutor(len(todo)) as pool:
        futures = {k: pool.submit(f) for k, f in todo.items()}
        return {k: f.result() for k, f in futures.items()}


def ptxas_report() -> dict:
    """Registers, spills and C75xx warnings (``nvcc -Xptxas -v``) of each
    instance of nv12_prodlike.cu, nv12_combo.cu and nv12_static2.cu."""
    names = {v: k for k, v in MODES.items()}

    def prodlike(name):
        m = re.search(r"nv12_prodlike_kernelILi(\d+)ELi(\d+)ELi(\d)E", name)
        return f"{names[int(m.group(3))]}{m.group(2)}" if m else None

    def s2(name):
        m = re.search(r"nv12_static2_kernelILi(\d+)E", name)
        return f"S2t{m.group(1)}" if m else None

    with ThreadPoolExecutor(3) as pool:
        parts = [pool.submit(ab_common.ptxas_report, src, fn)
                 for src, fn in (("nv12_prodlike.cu", prodlike),
                                 ("nv12_static2.cu", s2))]
        parts.append(pool.submit(combo_ab.ptxas_report))
        reports = [p.result() for p in parts]
    out = {"warnings": []}
    for r in reports:
        out["warnings"] += r.pop("warnings")
        out.update(r)
    return out


def earlier_launcher(lib, nv12: torch.Tensor, geo: dict, mode: str,
                     frames: int, rows: int):
    """A prepared call of the earlier ``nv12_variant_launch`` on ``nv12``
    with the product's tables, as its wrapper passed them."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev, B = nv12.device, nv12.shape[0]
    tail = tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0, torch.uint8,
                       None)
    tabs = device_tables(sw, sh, dw, dh, LANCZOS_AA, "420", torch.bfloat16,
                         dev)
    out = torch.empty((B, 3, dh, dw), dtype=torch.uint8, device=dev)
    fn = getattr(lib, _EARLIER)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, sh, sw, dh, dw, tabs.index.data_ptr(), tabs.weights.data_ptr(),
            *tabs.taps, tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            MODES[mode], frames, rows, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"earlier {mode} launch failed ({rc})")
        return out
    call.keep = (tail, tabs)   # what the pointers point into
    return call


def prodlike_launcher(lib, nv12: torch.Tensor, geo: dict, mode: str,
                      tile: int):
    """A prepared call of ``nv12_prodlike_launch`` on ``nv12``."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev, B = nv12.device, nv12.shape[0]
    tail = tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0, torch.uint8,
                       None)
    p_args, keep = prodlike_device(sw, sh, dw, dh, mode, tile, dev)
    out = torch.empty((B, 3, dh, dw), dtype=torch.uint8, device=dev)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, sh, sw, dh, dw,
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), MODES[mode],
            tile, *p_args, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    fn = lib.nv12_prodlike_launch

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{mode}{tile} launch failed ({rc})")
        return out
    call.keep = (tail, keep)
    return call


def cases(device):
    """(name, frames, geometry, timed): every batch a multiple of 8."""
    hd = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(64, 1620, 1920, device)
    out = [("64x1080p->224", x, hd, True),
           ("8x1080p->224 padded pitch", padded_view(x[:8], 64, 0), hd,
            False),
           ("8x1080p->224 misaligned view", padded_view(x[8:16], 16, 1), hd,
            False)]
    for h, w, dh, dw in ((90, 162, 20, 50), (62, 130, 30, 34),
                         (96, 256, 40, 48), (144, 256, 64, 96),
                         (150, 322, 70, 202)):
        geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
        y = kv.make_frames(8, h * 3 // 2 + 8, w, device, seed=h + w)
        out.append((f"8x{w}x{h}->{dw}x{dh}", y, geo, False))
    return out


def arm_launcher(lib, x: torch.Tensor, geo: dict, name: str):
    """A prepared call of the kernel the lab runs for arm ``name``."""
    if name.startswith("M"):
        return combo_ab.launcher(lib, x, geo, int(name[1:]), 32, False)
    mode, tile = _mode_tile(name)
    if tile in PRODLIKE_TILES[mode]:
        return prodlike_launcher(lib, x, geo, mode, tile)
    return static2_ab.launcher(lib, x, geo, tile, 8, False)   # full at T


def _earlier_of(name: str):
    """The earlier S2 or combo arm whose source ``name`` runs, or None."""
    if name in (f"full{t}" for t in S2_TILES):
        return f"earlier_S2_t{name[4:]}a8"
    if name in (f"M{g}" for g, _ in COMBOS):
        return f"earlier_combo{name[1:]}x32"
    return None


def check_case(b: dict, x: torch.Tensor, geo: dict, row: dict) -> dict:
    """The new arms' outputs against their plain versions and
    nv12_preprocess, S2 and the combo against their earlier sources;
    returns the prepared calls of the new arms."""
    n = x.shape[0] * 3 * geo["dst_h"] * geo["dst_w"]
    product = nv12_preprocess(x, **geo)
    calls, ok = {}, True
    for name in NEW_ARMS:
        case = kv.case(name, x.shape[0], x.shape[1], **geo)
        call = arm_launcher(b["current"], x, geo, name)
        calls[name] = call
        out = call().clone()
        plain = case.plain(x)
        row[f"{name}_vs_plain"] = differ(out, plain)
        d = (out.int() - plain.int()).abs()
        row[f"{name}_above_1"] = int((d > 1).sum().item())
        ok = (ok and bool((d <= case.tolerance(x)).all())
              and row[f"{name}_vs_plain"]["differ"] < 1e-3 * n)
        if case.full_function:
            row[f"{name}_vs_product"] = differ(out, product)
            ok = ok and within_envelope(row[f"{name}_vs_product"], n)
        earlier = _earlier_of(name)
        if earlier:
            lib = b["earlier_s2" if name.startswith("full") else
                    "earlier_combo"]
            same = differ(out, arm_launcher(lib, x, geo, name)())
            row[f"{earlier[len('earlier_'):]}_vs_earlier"] = same
            ok = ok and same["differ"] == 0
        wrapped = case.call(x)
        row[f"{name}_wrapper_equal"] = bool(torch.equal(wrapped, out))
        ok = ok and row[f"{name}_wrapper_equal"]
    torch.cuda.synchronize()
    row["ok"] = ok
    return calls


def summary(times: dict) -> dict:
    """Median and range of each call's times and each round's ratios: new
    over earlier, hpass and wpass over full at their strip height, S2
    (full16, full32) and the combo (M2, M4) over their earlier sources."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    pairs = [(f"new_{a}", f"earlier_{a}") for a in EARLIER_ARMS
             if a in NEW_ARMS]
    pairs += [("new_full8", "earlier_full8"), ("new_hpass16", "earlier_hpass8"),
              ("new_wpass16", "earlier_wpass8")]
    pairs += [(f"new_{m}{t}", f"new_full{t}") for m in ("hpass", "wpass")
              for t in S2_TILES]
    pairs += [(f"new_{a}", _earlier_of(a)) for a in NEW_ARMS
              if _earlier_of(a)]
    for a, b in dict.fromkeys(pairs):
        r = [x / y for x, y in zip(times[a], times[b])]
        out[f"{a}_over_{b}"] = r
        out[f"{a}_over_{b}_median"] = statistics.median(r)
    return out


def bounds(batch: int, geo: dict) -> dict:
    """Each new instance's bytes, FLOPs and both bounds."""
    out = {}
    for name in NEW_ARMS:
        if name.startswith("M"):
            work = kv.combo_work(batch, **geo, tile=32)
        else:
            mode, tile = _mode_tile(name)
            work = kv.prodlike_work(batch, **geo, mode=mode, tile=tile)
        out[f"{name}_bytes"], out[f"{name}_flops"] = work
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = bound_ms(*work)
        out[f"{name}_flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
    return out


def summary_line(row: dict, smi: str) -> str:
    """The timed case's medians and ratios in one line."""
    parts = []
    for name in NEW_ARMS:
        p = f"{name} {row[f'new_{name}_ms']:.4f}"
        if f"earlier_{name}_ms" in row:
            p += f" (earlier {row[f'earlier_{name}_ms']:.4f})"
        parts.append(p)
    parts += [f"earlier {a} {row[f'earlier_{a}_ms']:.4f}"
              for a in ("full8", "hpass8", "wpass8")]
    parts += [f"{a} / {e} {row[f'new_{a}_over_{e}_median']:.3f}"
              for a in NEW_ARMS for e in [_earlier_of(a)] if e]
    return (f"prodlike_ab 64 x 1080p -> 224 (ms): " + "; ".join(parts)
            + f"; nv12_preprocess {row['nv12_preprocess_ms']:.4f} ({smi})")


def run(source: str, pairs: int = 10, log=print):
    b = builds(source)
    ptxas = b.pop("ptxas")
    log(json.dumps({"ptxas": ptxas}))
    rows = []
    for name, x, geo, timed in cases(torch.device("cuda", 0)):
        row = dict(name=name, samples=x.shape[0] * 3 * geo["dst_h"]
                   * geo["dst_w"])
        new = check_case(b, x, geo, row)
        if timed:
            calls = {f"new_{k}": v for k, v in new.items()}
            for arm, (mode, g, rows_) in EARLIER_ARMS.items():
                calls[f"earlier_{arm}"] = earlier_launcher(
                    b["earlier"], x, geo, mode, g, rows_)
                out = calls[f"earlier_{arm}"]()
                want = (nv12_preprocess(x, **geo) if mode == "full" else
                        kv.prod_like_plain(x, **geo, mode=mode))
                row[f"earlier_{arm}_vs_function"] = differ(out, want)
            for t in S2_TILES:
                calls[f"earlier_S2_t{t}a8"] = static2_ab.launcher(
                    b["earlier_s2"], x, geo, t, 8, False)
            for g, t in COMBOS:
                calls[f"earlier_combo{g}x{t}"] = combo_ab.launcher(
                    b["earlier_combo"], x, geo, g, t, False)
            calls["nv12_preprocess"] = product_launcher(
                b["product"], "nv12", [x], geo, {}, False)
            row.update(summary(rounds(calls, pairs)))
            row.update(bounds(x.shape[0], geo))
            # last: the profiler's tracing slows the launches timed after
            row["kernel_ms"] = kernel_ms(calls)
        log(json.dumps(row))
        rows.append(row)
    return ptxas, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.prodlike_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_variants.cu, its "
                                    "headers, nv12_static2.cu and "
                                    "nv12_combo.cu beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prodlike_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ptxas, rows = run(args.earlier, args.pairs,
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
    print(f"cases outside their tolerance, or with S2 or the combo off "
          f"their earlier sources' bits: "
          f"{bad or 'none'}; ptxas spills {spills or 'none'}, C75xx "
          f"warnings {len(ptxas['warnings'])}")
    return 1 if bad or spills or ptxas["warnings"] else 0


if __name__ == "__main__":
    sys.exit(main())
