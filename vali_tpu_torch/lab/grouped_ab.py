"""A/B of lab kernel G (``csrc/nv12_grouped.cu``) against an earlier source
of the file, on the card.

The earlier source is the ``mma.sync`` design (one block per two 8-row
strips, ``[32, K]`` block-diagonal weights of :func:`earlier_tables`, no
W-pass tables). This builds it into a throwaway library under
``build/preprocess_ab/`` with its own headers first on the include path,
builds the current source with the other W pass
(``-DNV12_GROUPED_WPASS``) beside the package's default build, then at
each case — 64 x 1080p -> 224, ragged geometries, one frame, an odd batch
and padded or misaligned views — counts the output samples in which each
build differs from ``nv12_preprocess`` and from ``grouped_kernel_plain``
and holds the current builds to the kernels' envelope (1 LSB on fewer
than 1e-3 of the samples). At the timed case it times the earlier G, both
current builds and the product kernel with CUDA events in ``--pairs``
rounds (the order reversed every other round), each through one prepared
ctypes call, and reports each one's median and range and each round's
ratios. ``--knockouts`` also times the current source built with
``NV12_GROUPED_KNOCKOUT`` 1 (no W pass), 2 (no H pass) and 3 (the staging
ring alone). Prints one line a case and, with ``--out``, writes them as
JSON. Run it from the repository root with the earlier sources saved in
the git-ignored ``_chip/`` directory::

    mkdir -p _chip/parent
    for f in nv12_grouped.cu banded_preprocess.cuh banded_common.cuh; do
        git show <commit>:vali_tpu_torch/csrc/$f > _chip/parent/$f
    done
    python -m vali_tpu_torch.lab.grouped_ab _chip/parent/nv12_grouped.cu \\
        [--pairs N] [--knockouts] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops import _cuda_build
from ..ops.banded import _ceil16, _nv12_bands, device_tables, tail_params
from ..ops.nv12_preprocess import nv12_preprocess
from ..ops.resize import LANCZOS_AA
from . import kernel_variants as kv
from .ab_common import differ, padded_view, rounds, within_envelope
from .preprocess_ab import _build
from .preprocess_ab import launcher as product_launcher
from .timing import BF16_OPS_PER_S, bound_ms, time_ms

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)
#: the earlier launcher's C signature (no W-pass tables)
EARLIER_SIGNATURE = [_P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                     _I, _I, _FP, _P, _P, _I, _I, _I, _P, _P]
_LAUNCHER = "nv12_grouped_launch"
#: the W pass of the current source's other build
OTHER_WPASS = {"mma": "banded", "banded": "mma"}[kv.GROUPED_WPASS]


def earlier_tables(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """The earlier design's tables: per group of two 8-row strips A = [32,
    K] (rows 0-15 the two luma strips over their windows, rows 16-31 the
    two chroma strips, K padded to 16) and [groups, 4] window starts; with
    the window lengths."""
    hy, hc = _nv12_bands(src_w, src_h, dst_w, dst_h, LANCZOS_AA)[:2]
    s = 8
    wins = []
    for (start, count, w), n_in in ((hy, src_h), (hc, src_h // 2)):
        idx = np.arange(0, dst_h, s)
        lo = np.minimum.reduceat(start, idx)
        hi = np.maximum.reduceat(start + count, idx)
        length = int((hi - lo).max())
        wins.append((np.minimum(lo, n_in - length), length, start, count, w))
    ly, lc = wins[0][1], wins[1][1]
    groups = -(-dst_h // (2 * s))
    a = np.zeros((groups, 32, _ceil16(2 * (ly + lc))), np.float32)
    starts = np.zeros((groups, 4), np.int32)
    for g in range(groups):
        for j in range(2):
            strip = min(2 * g + j, len(wins[0][0]) - 1)
            for p, (ws, length, start, count, w) in enumerate(wins):
                starts[g, 2 * p + j] = ws[strip]
                if 2 * g + j != strip:   # no second strip: zero rows
                    continue
                col0 = 2 * ly * p + length * j
                for r in range(s):
                    o = strip * s + r
                    if o >= dst_h:
                        break
                    off = col0 + int(start[o] - ws[strip])
                    a[g, 16 * p + s * j + r, off:off + count[o]] = \
                        w[o, :count[o]]
    return a, starts, ly, lc


def build_earlier(source: str) -> ctypes.CDLL:
    """The earlier source, its own headers first, with its C signature."""
    return _build(source, "grouped_earlier", {_LAUNCHER: EARLIER_SIGNATURE})


def build_current(flags) -> ctypes.CDLL:
    """The current ``csrc/nv12_grouped.cu`` alone, with -D ``flags``."""
    source = os.path.join(_cuda_build._PKG_DIR, "csrc", "nv12_grouped.cu")
    tag = "grouped" + "".join(f.split("=")[-1] for f in flags)
    return _build(source, tag,
                  {_LAUNCHER: _cuda_build._LAB_SIGNATURES[_LAUNCHER]},
                  tuple(flags))


def launcher(lib, nv12: torch.Tensor, geo: dict, earlier: bool):
    """A call of one build's G launcher on ``nv12``, its arguments (tables,
    output) prepared once, so that the host work of a call is the ctypes
    call alone."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev, B = nv12.device, nv12.shape[0]
    tail = tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0, torch.uint8,
                       None)
    t = device_tables(sw, sh, dw, dh, LANCZOS_AA, "420", torch.bfloat16, dev)
    if earlier:
        a, starts, ly, lc = earlier_tables(sw, sh, dw, dh)
        keep = (torch.from_numpy(a).to(dev, torch.bfloat16),
                torch.from_numpy(starts).to(dev))
        g_args = (keep[0].data_ptr(), keep[1].data_ptr(), ly, lc,
                  a.shape[2])
    else:
        g_args, keep = kv._grouped_device(sw, sh, dw, dh, dev)
    out = torch.empty((B, 3, dh, dw), dtype=torch.uint8, device=dev)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, sh, sw, dh, dw, t.index.data_ptr(), t.weights.data_ptr(),
            *t.taps, tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            *g_args, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, _LAUNCHER)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"G launch failed ({rc})")
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
    for b, h, w, dh, dw in ((3, 150, 322, 70, 202), (4, 90, 162, 20, 50),
                            (4, 62, 130, 30, 34), (5, 144, 256, 64, 96)):
        geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
        y = kv.make_frames(b, h * 3 // 2, w, device, seed=h + w)
        out.append((f"{b}x{w}x{h}->{dw}x{dh}", y, geo, False))
    out.append(("5x62x130->30x34 misaligned padded view",
                padded_view(kv.make_frames(5, 93, 130, device, seed=8), 5, 1),
                dict(src_w=130, src_h=62, dst_w=34, dst_h=30), False))
    return out


def summary(times: dict) -> dict:
    """Median and range of each call's times, and each round's ratios of
    the earlier G, the other W pass and the product to the current G."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    cur = times["current"]
    for k in ("earlier", "other", "product"):
        r = [a / b for a, b in zip(times[k], cur)]
        out[f"{k}_over_current"] = r
        out[f"{k}_over_current_median"] = statistics.median(r)
    return out


def run(source: str, pairs: int = 10, knockouts: bool = False, log=print):
    builds = {"earlier": build_earlier(source),
              "current": _cuda_build.load_lab_kernels(),
              "other": build_current([f"-DNV12_GROUPED_WPASS={OTHER_WPASS}"])}
    if knockouts:
        builds.update({f"knockout{m}": build_current(
            [f"-DNV12_GROUPED_KNOCKOUT={m}"]) for m in (1, 2, 3)})
    rows = []
    for name, x, geo, timed in cases(torch.device("cuda", 0)):
        calls = {tag: launcher(lib, x, geo, tag == "earlier")
                 for tag, lib in builds.items()}
        outs = {tag: calls[tag]().clone()
                for tag in ("earlier", "current", "other")}
        product = nv12_preprocess(x, **geo)
        plain = kv.grouped_kernel_plain(x, **geo)
        wrapper = kv.grouped_kernel(x, **geo)
        torch.cuda.synchronize()
        n = product.numel()
        row = dict(name=name, samples=n,
                   wrapper_equal=bool(torch.equal(wrapper, outs["current"])))
        for tag, o in outs.items():
            row[f"{tag}_vs_product"] = differ(o, product)
            row[f"{tag}_vs_plain"] = differ(o, plain)
        row["other_vs_current"] = differ(outs["other"], outs["current"])
        row["ok"] = row["wrapper_equal"] and all(
            within_envelope(row[f"{tag}_vs_{ref}"], n)
            for tag in ("current", "other") for ref in ("product", "plain"))
        if timed:
            calls["product"] = product_launcher(
                _cuda_build.load_kernels(), "nv12", [x], geo, {}, False)
            row.update(summary(rounds(
                {k: calls[k] for k in ("earlier", "current", "other",
                                       "product")}, pairs)))
            for tag in builds:
                if tag.startswith("knockout"):
                    row[f"{tag}_ms"] = time_ms(calls[tag])
            b = x.shape[0]
            for tag, wp in (("current", kv.GROUPED_WPASS),
                            ("other", OTHER_WPASS)):
                work = kv.grouped_work(b, **geo, wpass=wp)
                row[f"{tag}_wpass"] = wp
                row[f"{tag}_bytes"], row[f"{tag}_flops"] = work
                row[f"{tag}_bound_ms"], row[f"{tag}_bound_by"] = \
                    bound_ms(*work)
                row[f"{tag}_flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
        log(json.dumps(row))
        rows.append(row)
        del calls, outs, product, plain, wrapper
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.grouped_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_grouped.cu, its "
                                    "headers beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H pass, and both knocked out")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grouped_ab: needs a CUDA device", file=sys.stderr)
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
