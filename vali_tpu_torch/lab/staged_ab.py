"""A/B of lab kernel ``staged`` (``csrc/nv12_staged.cu``, the notebook's
``variant_kernel`` B / C / D) against its earlier design, on the card.

The earlier design is B / C / D of an earlier ``csrc/nv12_variants.cu``
(``nv12_variant_launch``, staged 1 / 2 or split chroma: the product's
banded FMA loops on the CUDA cores, one block per (8-row strip, frame),
B and C converting each strip's window to bf16 in 256-column tiles). This
builds that source into a throwaway library under ``build/staged_ab/``
with its own headers first on the include path, then at each case — 64 x
1080p -> 224, one frame, a padded pitch, a misaligned view (element
loads) and the card tests' small shapes — counts the output samples in
which the new B, C, D (and D at 32-row strips) differ from
``nv12_preprocess``, ``nv12_preprocess_plain`` and S2 t16a8, and the
earlier ones from ``nv12_preprocess``; it holds the new ones to the
kernels' uint8 envelope (1 LSB on fewer than 1e-3 of the samples), B equal
to C bit for bit and the wrapper equal to the launcher. At the timed case
it times the earlier B / C / D, the new B / C / D, D at 32 rows, S2 t16a8
and t32a8, lab kernel G and ``nv12_preprocess`` with CUDA events in
``--pairs`` rounds (the order reversed every other round), each through
one prepared call, and reports each one's median and range, each round's
ratios, each launch's device time from ``torch.profiler``, each
instance's shared memory a block, blocks an SM and bounds, and the stream
floor. ``--knockouts`` also times the current source built with
``NV12_STAGED_KNOCKOUT`` 1 (no W pass), 2 (no H pass), 3 (the staging
alone) and 4 (no conversion) at B, C, D and D32, and S2 built with
``NV12_STATIC2_KNOCKOUT`` 1, 2, 3 at t16a8. Prints one line a case and,
with ``--out``, writes them as JSON; exits 1 where a case breaks those
rules. Run it from the repository root with the earlier sources saved in
the git-ignored ``_chip/`` directory::

    mkdir -p _chip/parent
    for f in nv12_variants.cu banded_preprocess.cuh banded_common.cuh; do
        git show <commit>:vali_tpu_torch/csrc/$f > _chip/parent/$f
    done
    python -m vali_tpu_torch.lab.staged_ab _chip/parent/nv12_variants.cu \\
        [--pairs N] [--knockouts] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops import _cuda_build
from ..ops.banded import (band_table, dense_weights, device_tables,
                          static2_tables, tail_params, tile_window)
from ..ops.nv12_preprocess import nv12_preprocess, nv12_preprocess_plain
from ..ops.resize import LANCZOS_AA
from . import ab_common
from . import grouped_ab, static2_ab
from . import kernel_variants as kv
from .ab_common import (differ, kernel_ms, padded_view, rounds,
                        within_envelope)
from .preprocess_ab import launcher as product_launcher
from .staged import (STAGED_ALIGN, STAGED_VARIANTS, blocks_per_sm,
                     staged_device, staged_smem_bytes, tma_ok)
from .timing import BF16_OPS_PER_S, bound_ms, time_ms

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)
_EARLIER = "nv12_variant_launch"
#: the earlier launcher's C signature (its knobs staged, split_chroma,
#: span_y and span_c since removed)
EARLIER_SIGNATURE = [_P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                     _I, _I, _FP, _I, _I, _I, _I, _I, _I, _I, _P, _P]
_CURRENT = "nv12_staged_launch"
#: the earlier design's knobs per variant: (staged cast chain, split)
_EARLIER_KNOBS = {"B": (1, 0), "C": (2, 0), "D": (0, 1)}
#: the earlier design's strip height
_EARLIER_ROWS = 8
#: (variant, tile) of the new kernel's instances, and their names here
ARMS = (("B", 16), ("C", 16), ("D", 16), ("D", 32))
KNOCKOUTS = (1, 2, 3, 4)


def _arm(variant: str, tile: int) -> str:
    return variant if tile == 16 else f"{variant}{tile}"


def build_earlier(source: str):
    """The earlier source, its own headers first, with its C signature."""
    return ab_common.build_earlier(source, "staged_ab",
                                   {_EARLIER: EARLIER_SIGNATURE})


def build_current(flags):
    """The current ``csrc/nv12_staged.cu`` alone, with -D ``flags``."""
    return ab_common.build_current("nv12_staged.cu", "staged_ab", [_CURRENT],
                                   flags)


@functools.lru_cache(maxsize=8)
def earlier_spans(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """(luma, chroma) source rows of the widest window an 8-row strip
    reads: the earlier design's staged window extent."""
    dw = dense_weights(src_w, src_h, dst_w, dst_h, LANCZOS_AA, "420")
    rows = min(_EARLIER_ROWS, dst_h)
    return tuple(tile_window(*band_table(d, torch.float32)[:2], rows)
                 for d in (dw.luma_h, dw.chroma_h))


def launcher(lib, nv12: torch.Tensor, geo: dict, variant: str, tile: int,
             earlier: bool):
    """A call of one build's B / C / D launcher on ``nv12``, its arguments
    (tables, output) prepared once, so that the host work of a call is the
    ctypes call alone (the current design's includes encoding its tensor
    map)."""
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
        keep = device_tables(sw, sh, dw, dh, LANCZOS_AA, "420",
                             torch.bfloat16, dev)
        staged, split = _EARLIER_KNOBS[variant]
        spans = earlier_spans(sw, sh, dw, dh) if staged else (0, 0)
        fn = getattr(lib, _EARLIER)
        args = (*head, keep.index.data_ptr(), keep.weights.data_ptr(),
                *keep.taps, tail_p, 0, staged, split, 0, _EARLIER_ROWS,
                *spans, out.data_ptr(), stream)
    else:
        s_args, keep = staged_device(sw, sh, dw, dh, variant, tile, dev)
        fn = getattr(lib, _CURRENT)
        args = (*head, tail_p, STAGED_VARIANTS[variant], tile,
                int(tma_ok(nv12, sw, sh)), *s_args, out.data_ptr(), stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{variant} launch failed ({rc})")
        return out
    call.keep = (tail, keep)   # what the pointers point into
    return call


def cases(device):
    """(name, frames, geometry, timed)."""
    hd = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(64, 1620, 1920, device)
    out = [("64x1080p->224", x, hd, True),
           ("N=1 1080p->224", x[:1], hd, False),
           ("5x1080p->224 padded pitch", padded_view(x[:5], 64, 0), hd, False),
           ("3x1080p->224 misaligned view", padded_view(x[5:8], 16, 1), hd,
            False)]
    for b, h, w, dh, dw in ((4, 90, 162, 20, 50), (4, 62, 130, 30, 34),
                            (4, 96, 256, 40, 48), (8, 144, 256, 64, 96),
                            (3, 150, 322, 70, 202)):
        geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
        y = kv.make_frames(b, h * 3 // 2, w, device, seed=h + w)
        out.append((f"{b}x{w}x{h}->{dw}x{dh}", y, geo, False))
    return out


def resources(geo: dict) -> dict:
    """Per arm: the shared memory a block and blocks an SM."""
    row = {}
    args = (geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"],
            LANCZOS_AA)
    for v, t in ARMS:
        tab = static2_tables(*args, t, STAGED_ALIGN)
        row[f"{_arm(v, t)}_smem"] = staged_smem_bytes(v, t, tab.k_luma,
                                                      tab.k_chroma)
        row[f"{_arm(v, t)}_blocks_per_sm"] = blocks_per_sm(
            v, t, tab.k_luma, tab.k_chroma)
        row[f"{_arm(v, t)}_k"] = [tab.k_luma, tab.k_chroma]
    return row


def summary(times: dict) -> dict:
    """Median and range of each call's times, and each round's ratios of
    the earlier design to the new one, the new D to S2 t16a8, B and C to
    D, B to C, and nv12_preprocess and G to the new D."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    pairs = [(f"earlier_{v}", f"current_{v}") for v in "BCD"]
    pairs += [("current_D", "S2_t16a8"), ("current_B", "current_D"),
              ("current_C", "current_D"), ("current_B", "current_C"),
              ("current_D32", "current_D"), ("current_D32", "S2_t32a8"),
              ("nv12_preprocess", "current_D"), ("G", "current_D")]
    for a, b in pairs:
        r = [x / y for x, y in zip(times[a], times[b])]
        out[f"{a}_over_{b}"] = r
        out[f"{a}_over_{b}_median"] = statistics.median(r)
    return out


def run(source: str, pairs: int = 10, knockouts: bool = False, log=print):
    todo = {"earlier": lambda: build_earlier(source)}
    if knockouts:
        for m in KNOCKOUTS:
            todo[f"knockout{m}"] = functools.partial(
                build_current, [f"-DNV12_STAGED_KNOCKOUT={m}"])
        for m in (1, 2, 3):
            todo[f"s2_knockout{m}"] = functools.partial(
                static2_ab.build_current, [f"-DNV12_STATIC2_KNOCKOUT={m}"])
    with ThreadPoolExecutor(len(todo) + 1) as pool:   # nvcc runs in parallel
        futures = {k: pool.submit(f) for k, f in todo.items()}
        futures["current"] = pool.submit(_cuda_build.load_lab_kernels)
        builds = {k: f.result() for k, f in futures.items()}
    kernels = builds["current"]
    rows = []
    for name, x, geo, timed in cases(torch.device("cuda", 0)):
        product = nv12_preprocess(x, **geo)
        plain = nv12_preprocess_plain(x, **geo)
        s2 = kv.static_kernel2(x, **geo, tile=16, align=STAGED_ALIGN)
        n = product.numel()
        row = dict(name=name, samples=n, ok=True,
                   staging="tma" if tma_ok(x, geo["src_w"], geo["src_h"])
                   else "element")
        calls, outs = {}, {}
        for v, t in ARMS:
            arm = _arm(v, t)
            calls[f"current_{arm}"] = launcher(kernels, x, geo, v, t, False)
            outs[arm] = calls[f"current_{arm}"]().clone()
            row[f"current_{arm}_vs_product"] = differ(outs[arm], product)
            row[f"current_{arm}_vs_plain"] = differ(outs[arm], plain)
            row[f"current_{arm}_vs_S2t16a8"] = differ(outs[arm], s2)
            ok = (within_envelope(row[f"current_{arm}_vs_product"], n)
                  and within_envelope(row[f"current_{arm}_vs_plain"], n))
            if t == 16:
                wrapper = kv.variant_kernel(x, **geo, variant=v)
                row[f"wrapper_{arm}_equal"] = bool(torch.equal(wrapper,
                                                               outs[arm]))
                ok = ok and row[f"wrapper_{arm}_equal"]
                calls[f"earlier_{v}"] = launcher(builds["earlier"], x, geo, v,
                                                 t, True)
                old = calls[f"earlier_{v}"]()
                row[f"earlier_{v}_vs_product"] = differ(old, product)
                del wrapper, old
            row["ok"] = row["ok"] and ok
        row["B_equal_C"] = bool(torch.equal(outs["B"], outs["C"]))
        row["ok"] = row["ok"] and row["B_equal_C"]
        torch.cuda.synchronize()
        if timed:
            calls["S2_t16a8"] = static2_ab.launcher(kernels, x, geo, 16, 8,
                                                    False)
            calls["S2_t32a8"] = static2_ab.launcher(kernels, x, geo, 32, 8,
                                                    False)
            calls["G"] = grouped_ab.launcher(kernels, x, geo, False)
            calls["nv12_preprocess"] = product_launcher(
                _cuda_build.load_kernels(), "nv12", [x], geo, {}, False)
            row.update(summary(rounds(calls, pairs)))
            row["kernel_ms"] = kernel_ms(
                {k: calls[k] for k in calls
                 if k.startswith(("current", "S2", "earlier"))})
            row["floor_ms"] = time_ms(lambda: kv.stream_floor(
                x, rows=x.shape[1], W=geo["src_w"], DH=geo["dst_h"],
                DW=geo["dst_w"]))
            for tag, lib in builds.items():
                if tag.startswith("knockout"):
                    for v, t in ARMS:
                        row[f"{tag}_{_arm(v, t)}_ms"] = time_ms(
                            launcher(lib, x, geo, v, t, False))
                elif tag.startswith("s2_knockout"):
                    row[f"{tag}_t16a8_ms"] = time_ms(
                        static2_ab.launcher(lib, x, geo, 16, 8, False))
            b = x.shape[0]
            for v, t in ARMS:
                work = kv.staged_work(b, **geo, variant=v, tile=t)
                arm = _arm(v, t)
                row[f"{arm}_bytes"], row[f"{arm}_flops"] = work
                row[f"{arm}_bound_ms"], row[f"{arm}_bound_by"] = \
                    bound_ms(*work)
                row[f"{arm}_flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
            row.update(resources(geo))
        log(json.dumps(row))
        rows.append(row)
        del calls, outs, product, plain, s2
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.staged_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_variants.cu, its "
                                    "headers beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H pass, both and its conversion knocked out, "
                         "and S2's knock-outs")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("staged_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = run(args.earlier, args.pairs, args.knockouts,
               log=lambda s: print(s, flush=True))
    bad = [r["name"] for r in rows if not r["ok"]]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "rows": rows}, f, indent=1)
    print(f"cases outside the envelope of nv12_preprocess or the plain "
          f"version, or with B not equal to C: {bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
