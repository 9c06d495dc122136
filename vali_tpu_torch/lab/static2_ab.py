"""A/B of lab kernel S2 (``csrc/nv12_static2.cu``) against its earlier
design, on the card.

The earlier design is S2 of an earlier ``csrc/nv12_variants.cu``
(``nv12_static_launch`` with the strip-window row tables in device memory:
the banded FMA loops on the CUDA cores over every tap of each window, tall
strips in output-column ranges), from a checkout before S2's redesign.
The current ``nv12_variants.cu`` holds the stream floor alone; 92ab04a is
the last checkout whose ``nv12_variants.cu`` holds a CUDA-core S, with a
later ``nv12_static_launch`` of another signature (``chains_ab`` builds
that one). This builds that source into a throwaway
library under ``build/static2_ab/`` with its own headers first on the
include path, then at each case — 64 x 1080p -> 224, one frame, a padded
pitch, a misaligned view and the card tests' small shapes — and each
sweep point (``S2t{tile}a{align}`` of the notebook's ``main_sweep2``)
counts the output samples in which each design differs from
``nv12_preprocess`` and from ``static_kernel2_plain``, and holds the
current one to the kernels' uint8 envelope (1 LSB on fewer than 1e-3 of
the samples). At the timed case it times both designs at t16a8, t32a8,
t48a8 and t32a32, the current one at t24a8 too, lab kernel G and
``nv12_preprocess`` with CUDA events in ``--pairs`` rounds (the order
reversed every other round), each through one prepared call, reports each
one's median and range and each round's ratios and G's differing samples,
and times the stream floor once. ``--knockouts`` also times the current
source built with ``NV12_STATIC2_KNOCKOUT`` 1 (no W pass), 2 (no H pass)
and 3 (the staging ring alone) at every sweep point. The timed case also
reports each sweep point's FLOPs, both bounds and the ``wgmma``s it
issues. Prints one line a case and, with ``--out``, writes them as JSON;
exits 1 when a case leaves the envelope.
Run it from the repository root with the earlier sources saved in the
git-ignored ``_chip/`` directory::

    mkdir -p _chip/parent
    for f in nv12_variants.cu banded_preprocess.cuh banded_common.cuh; do
        git show <commit>:vali_tpu_torch/csrc/$f > _chip/parent/$f
    done
    python -m vali_tpu_torch.lab.static2_ab _chip/parent/nv12_variants.cu \\
        [--pairs N] [--knockouts] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops import _cuda_build
from ..ops.banded import (_nv12_bands, column_ranges, pack_tables,
                          static2_tables, static2_w_tables,
                          strip_window_bands, tail_params)
from ..ops.nv12_preprocess import nv12_preprocess
from ..ops.resize import LANCZOS_AA
from . import ab_common
from . import grouped_ab
from . import kernel_variants as kv
from .ab_common import differ, padded_view, rounds, within_envelope
from .preprocess_ab import launcher as product_launcher
from .timing import BF16_OPS_PER_S, bound_ms, time_ms

_EARLIER = "nv12_static_launch"
_CURRENT = "nv12_static2_launch"
#: (tile, align) of the notebook's sweep
SWEEP = ((16, 8), (24, 8), (32, 8), (48, 8), (32, 32))
#: the sweep points both designs are timed at
TIMED = ((16, 8), (32, 8), (48, 8), (32, 32))


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the earlier launcher's C signature (its stage_w and frames_per_block
#: knobs since removed with the CUDA-core COMBO)
EARLIER_SIGNATURE = [_P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                     _I, _I, ctypes.POINTER(ctypes.c_float), _I, _I, _I, _I,
                     _I, _P, _I, _I, _I, _P, _P]


def build_earlier(source: str):
    """The earlier source, its own headers first, with its C signature."""
    return ab_common.build_earlier(source, "static2_ab",
                                   {_EARLIER: EARLIER_SIGNATURE})


def build_current(flags):
    """The current ``csrc/nv12_static2.cu`` alone, with -D ``flags``."""
    return ab_common.build_current("nv12_static2.cu", "static2_ab", [_CURRENT],
                                   flags)


def launcher(lib, nv12: torch.Tensor, geo: dict, tile: int, align: int,
             earlier: bool):
    """A call of one build's S2 launcher on ``nv12``, its arguments
    (tables, output) prepared once, so that the host work of a call is the
    ctypes call alone. The earlier design takes the product's table layout
    with the strip-window row bands and the fewest output-column ranges
    whose strips fit a block, as its wrapper passed them."""
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
        wy, wc = _nv12_bands(sw, sh, dw, dh, LANCZOS_AA)[2:]
        tabs = pack_tables([*strip_window_bands(sw, sh, dw, dh, LANCZOS_AA,
                                                tile, align), wy, wc], dev)
        ranges = column_ranges(sw, sh, dw, dh, LANCZOS_AA, tile, dev)
        fn = getattr(lib, _EARLIER)
        args = (*head, tabs.index.data_ptr(), tabs.weights.data_ptr(),
                *tabs.taps, tail_p, 0, 0, 0, 1, tile, *ranges.args(),
                out.data_ptr(), stream)
        keep = (tabs, ranges)
    else:
        s_args, keep = kv._static2_device(sw, sh, dw, dh, tile, align, dev)
        fn = getattr(lib, _CURRENT)
        args = (*head, tail_p, tile, *s_args, out.data_ptr(), stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"S2 launch failed ({rc})")
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
                            (4, 96, 256, 40, 48), (8, 144, 256, 64, 96)):
        geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
        y = kv.make_frames(b, h * 3 // 2, w, device, seed=h + w)
        out.append((f"{b}x{w}x{h}->{dw}x{dh}", y, geo, False))
    return out


def wgmma_counts(batch: int, geo: dict, tile: int, align: int) -> dict:
    """The wgmmas one batch issues: the H chains' (N = tile, K_y / 16 and
    K_c / 16 k-steps) and the W pass's (4
    luma at N = tile, 2 chroma at N = 2 tile) for each chunk of each tile
    of each strip."""
    args = (geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"],
            LANCZOS_AA)
    t = static2_tables(*args, tile, align)
    chunks = int(static2_w_tables(*args).heads[:, 2].sum())
    per = batch * t.luma.shape[0] * chunks
    return dict(h_wgmmas=per * (t.k_luma + t.k_chroma) // 16,
                h_n=tile, w_luma_wgmmas=per * 4, w_luma_n=tile,
                w_chroma_wgmmas=per * 2, w_chroma_n=2 * tile)


def summary(times: dict) -> dict:
    """Median and range of each call's times, and each round's ratios of
    the earlier design, G and nv12_preprocess to the current kernel at
    each timed sweep point."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    for t, a in TIMED:
        cur = times[f"current_t{t}a{a}"]
        for k in (f"earlier_t{t}a{a}", "G", "nv12_preprocess"):
            r = [x / y for x, y in zip(times[k], cur)]
            out[f"{k}_over_current_t{t}a{a}"] = r
            out[f"{k}_over_current_t{t}a{a}_median"] = statistics.median(r)
    return out


def run(source: str, pairs: int = 10, knockouts: bool = False, log=print):
    builds = {"earlier": build_earlier(source),
              "current": _cuda_build.load_lab_kernels()}
    if knockouts:
        builds.update({f"knockout{m}": build_current(
            [f"-DNV12_STATIC2_KNOCKOUT={m}"]) for m in (1, 2, 3)})
    rows = []
    for name, x, geo, timed in cases(torch.device("cuda", 0)):
        product = nv12_preprocess(x, **geo)
        n = product.numel()
        row = dict(name=name, samples=n, ok=True)
        calls = {}
        for t, a in SWEEP:
            tag = f"t{t}a{a}"
            plain = kv.static_kernel2_plain(x, **geo, tile=t, align=a)
            for build in ("earlier", "current"):
                calls[f"{build}_{tag}"] = launcher(
                    builds[build], x, geo, t, a, build == "earlier")
            cur = calls[f"current_{tag}"]().clone()
            old = calls[f"earlier_{tag}"]().clone()
            wrapper = kv.static_kernel2(x, **geo, tile=t, align=a)
            torch.cuda.synchronize()
            row[f"current_{tag}_vs_product"] = differ(cur, product)
            row[f"current_{tag}_vs_plain"] = differ(cur, plain)
            row[f"earlier_{tag}_vs_product"] = differ(old, product)
            row[f"wrapper_{tag}_equal"] = bool(torch.equal(wrapper, cur))
            row["ok"] = (row["ok"] and row[f"wrapper_{tag}_equal"]
                         and within_envelope(row[f"current_{tag}_vs_product"],
                                             n)
                         and within_envelope(row[f"current_{tag}_vs_plain"],
                                             n))
            del plain, wrapper
        if timed:
            lib = builds["current"]
            timed_calls = {k: calls[k] for t, a in TIMED
                           for k in (f"earlier_t{t}a{a}",
                                     f"current_t{t}a{a}")}
            timed_calls["current_t24a8"] = calls["current_t24a8"]
            timed_calls["G"] = grouped_ab.launcher(lib, x, geo, False)
            row["G_vs_product"] = differ(timed_calls["G"]().clone(), product)
            timed_calls["nv12_preprocess"] = product_launcher(
                _cuda_build.load_kernels(), "nv12", [x], geo, {}, False)
            row.update(summary(rounds(timed_calls, pairs)))
            rows_ = x.shape[1]
            row["floor_ms"] = time_ms(lambda: kv.stream_floor(
                x, rows=rows_, W=geo["src_w"], DH=geo["dst_h"],
                DW=geo["dst_w"]))
            for tag in builds:
                if tag.startswith("knockout"):
                    for t, a in SWEEP:
                        row[f"{tag}_t{t}a{a}_ms"] = time_ms(launcher(
                            builds[tag], x, geo, t, a, False))
            b = x.shape[0]
            for t, a in SWEEP:
                key = f"current_t{t}a{a}"
                work = kv.static2_work(b, **geo, tile=t, align=a)
                row[f"{key}_bytes"], row[f"{key}_flops"] = work
                row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = \
                    bound_ms(*work)
                row[f"{key}_flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
                row.update({f"{key}_{k}": v for k, v in
                            wgmma_counts(b, geo, t, a).items()})
        log(json.dumps(row))
        rows.append(row)
        del calls, product
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.static2_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_variants.cu, its "
                                    "headers beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H pass, and both knocked out")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("static2_ab: needs a CUDA device", file=sys.stderr)
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
          f"version: {bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
