"""A/B of lab kernel ``streamed`` (``csrc/nv12_streamed.cu``) against its
earlier design, on the card.

The earlier design is ``nv12_resize_streamed_launch`` of an earlier
``csrc/nv12_resize_variants.cu``: the banded FMA loops on the CUDA cores,
one block per (column tile of about STREAM_LANES source lanes, frame,
plane) walking the 8-row strips down the frame through a ``cp.async`` ring
of two bands. This builds that source into a throwaway library under
``build/streamed_ab/`` with its own headers first on the include path,
then at each case — 16 x 4K NV12 -> 1080p, one frame, a padded pitch
(staged by TMA), a misaligned view (element loads) and the card tests'
three small shapes — and at bands 64 and 256 counts the output samples in
which the current design differs from ``aligned8x32``, ``nv12_resize`` and
``nv12_resize_plain`` and the earlier one from ``nv12_resize``, and holds
the current one equal to ``aligned8x32`` and within the uint8 envelope
(1 LSB on fewer than 1e-3 of the samples) of the other two. At the timed
case it times both designs at both bands, ``aligned8x32``, ``nv12_resize``
and the lab's ``dma_only`` with CUDA events in ``--pairs`` rounds (the
order reversed every other round), each through one prepared call, and
reports each one's median and range and each round's ratios, and each
launch's (luma, chroma) device time from ``torch.profiler``; also the
host time of encoding the two tensor maps, the bytes each design stages
into shared memory and both bounds. ``--knockouts`` also times the
current source built with ``NV12_STREAMED_KNOCKOUT`` 1 (no W pass), 2 (no
H pass), 3 (the staging alone), 4 (no copies: the products alone), 5
(the H pass alone) and 6 (the W pass alone) at both bands, and
``aligned`` built with ``NV12_ALIGNED_KNOCKOUT`` 1, 2, 3 at 8x32 in the
same call. Prints
one line a case and, with ``--out``, writes them as JSON; exits 1 when a
case is not equal to ``aligned8x32`` or leaves the envelope. Run it from
the repository root with the earlier sources saved in the git-ignored
``_chip/`` directory::

    mkdir -p _chip/parent
    for f in nv12_resize_variants.cu banded_common.cuh; do
        git show <commit>:vali_tpu_torch/csrc/$f > _chip/parent/$f
    done
    python -m vali_tpu_torch.lab.streamed_ab \\
        _chip/parent/nv12_resize_variants.cu [--pairs N] [--knockouts] \\
        [--out FILE]
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import _cuda_build
from ..ops.banded import band_table, pack_resize_tables, sm_count
from ..ops.nv12_resize import nv12_resize, nv12_resize_plain
from ..ops.resize import LANCZOS_AA, resize_weights
from . import ab_common
from . import aligned_ab
from . import resize_diag as rd
from .ab_common import (differ, kernel_ms, padded_view, rounds,
                        within_envelope)
from .resize_ab import launcher as product_launcher
from .timing import BF16_OPS_PER_S, bound_ms, time_ms

_LAUNCHER = "nv12_resize_streamed_launch"
#: the earlier launcher's C signature: the resize lab's frames, geometry
#: and luma and chroma band tables, then its band
EARLIER_SIGNATURE = _cuda_build._RESIZE_LAB + [_cuda_build._I,
                                               _cuda_build._P,
                                               _cuda_build._P]
_ENCODE = "nv12_streamed_encode"
#: the build flag that exports it (the product library does not)
_ENCODE_FLAG = "-DNV12_STREAMED_ENCODE"
_ENCODE_SIGNATURE = [_cuda_build._P, _cuda_build._LL, _cuda_build._LL,
                     _cuda_build._I, _cuda_build._I, _cuda_build._I,
                     _cuda_build._I, _cuda_build._I]
#: source lanes the earlier design's column tiles aimed at
STREAM_LANES = 320
BANDS = (64, 256)


def build_earlier(source: str):
    """The earlier source, its own headers first, with its C signature."""
    return ab_common.build_earlier(source, "streamed_ab",
                                   {_LAUNCHER: EARLIER_SIGNATURE})


def build_current(flags):
    """The current ``csrc/nv12_streamed.cu`` alone, with -D ``flags`` (with
    ``-DNV12_STREAMED_ENCODE`` it also exports the tensor-map encoding that
    :func:`encode_us` times)."""
    return ab_common.build_current(
        "nv12_streamed.cu", "streamed_ab", [_LAUNCHER], flags,
        {_ENCODE: _ENCODE_SIGNATURE} if _ENCODE_FLAG in flags else None)


@functools.lru_cache(maxsize=16)
def earlier_tables(src_h, dst_h, src_w, dst_w, channels, device):
    """The earlier design's tables: the product's bands in column tiles of
    about STREAM_LANES source lanes."""
    return pack_resize_tables(
        band_table(resize_weights(src_h, dst_h, LANCZOS_AA), torch.bfloat16),
        band_table(resize_weights(src_w, dst_w, LANCZOS_AA), torch.bfloat16),
        torch.bfloat16, channels, device, target_lanes=STREAM_LANES)


def launcher(lib, nv12: torch.Tensor, geo: dict, band: int, earlier: bool):
    """A call of one build's streamed launcher on ``nv12``, its arguments
    (tables, output) prepared once, so that the host work of a call is the
    ctypes call alone (the current design's includes encoding its two
    tensor maps)."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev = nv12.device
    if earlier:
        keep = [earlier_tables(h, oh, w, ow, c, dev)
                for h, oh, w, ow, c in ((sh, dh, sw, dw, 1),
                                        (sh // 2, dh // 2, sw // 2, dw // 2,
                                         2))]
        t_args = (*keep[0].args(), *keep[1].args(), band)
    else:
        t_args, keep = rd._streamed_device(sw, sh, dw, dh, band,
                                           nv12.shape[0], sm_count(dev), dev)
        t_args = (*t_args, band, int(rd.tma_stageable(nv12)))
    out = torch.empty((nv12.shape[0], dh * 3 // 2, dw), dtype=torch.uint8,
                      device=dev)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[0],
            sh, sw, dh, dw, *t_args, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, _LAUNCHER)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"streamed launch failed ({rc})")
        return out
    call.keep = keep   # what the pointers point into
    return call


def cases(device):
    """(name, frames, geometry, timed)."""
    k4 = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(16, 3240, 3840, device)
    out = [("16x4K->1080p", x, k4, True),
           ("N=1 4K->1080p", x[:1], k4, False),
           ("3x4K->1080p padded pitch", padded_view(x[:3], 64, 0), k4, False),
           ("2x4K->1080p misaligned view", padded_view(x[3:5], 16, 1), k4,
            False)]
    for b, h, w, dh, dw in ((3, 288, 512, 144, 256), (2, 150, 322, 70, 202),
                            (3, 96, 256, 40, 120)):
        out.append((f"{b}x{w}x{h}->{dw}x{dh}",
                    rd.make_frames(b, h * 3 // 2, w, device, seed=h + w),
                    dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh), False))
    return out


def aligned_staged_bytes(batch: int, geo: dict) -> int:
    """Bytes ``aligned`` at 8x32 copies into shared memory a batch: per
    strip, range and frame its window's rows of its ring stages."""
    total = 0
    for t, ch in zip(rd._aligned_planes(geo["src_w"], geo["src_h"],
                                        geo["dst_w"], geo["dst_h"], 8, 32),
                     (1, 2)):
        stages = -(-t.ranges[:, 3] * ch // rd.ALIGNED_STAGE_COLS)
        total += (t.weights.shape[0] * t.k_pad * rd.ALIGNED_STAGE_COLS
                  * int(stages.sum()))
    return batch * total


def plan_row(batch: int, geo: dict, sms: int) -> dict:
    """The host plan at both bands: per plane the ranges, chunks, slots,
    runs and blocks, and the bytes staged (with the restarts' share:
    against each walk staged in one run)."""
    row = {"frame_bytes": batch * geo["src_h"] * 3 // 2 * geo["src_w"],
           "aligned8x32_staged_bytes": aligned_staged_bytes(batch, geo)}
    for band in BANDS:
        staged = whole = 0
        for name, p in zip(("luma", "chroma"),
                           rd.streamed_plan(**geo, band=band, batch=batch,
                                            sms=sms)):
            strips = p.tables.weights.shape[0]
            one = p._replace(runs=np.array(
                [[r, f, 0, strips] for f in range(batch)
                 for r in range(len(p.ranges))], np.int32))
            staged += rd.streamed_staged_bytes(p)
            whole += rd.streamed_staged_bytes(one)
            row[f"band{band}_{name}"] = dict(
                ranges=len(p.ranges), chunks=p.chunks, slots=p.slots,
                hcols=p.hcols, runs=len(p.runs), blocks=len(p.blocks) - 1,
                smem=int(rd.streamed_smem_bytes(p.channels, p.hcols,
                                                p.tables.k_pad, p.slots,
                                                band, p.chunks)))
        row[f"band{band}_staged_bytes"] = staged
        row[f"band{band}_restart_bytes"] = staged - whole
    return row


def encode_us(lib, nv12: torch.Tensor, geo: dict, band: int,
              reps: int = 2000) -> float:
    """Host µs of encoding both planes' tensor maps once (``lib`` built by
    :func:`build_current` with the encoding exported)."""
    fn = getattr(lib, _ENCODE)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[0],
            geo["src_h"], geo["src_w"], band)
    if fn(*args, 10) != 0:
        raise RuntimeError("tensor map encoding failed")
    t0 = time.perf_counter()
    fn(*args, reps)
    return (time.perf_counter() - t0) / reps * 1e6


def summary(times: dict) -> dict:
    """Median and range of each call's times, each round's ratios of the
    earlier design, aligned8x32 and nv12_resize to the current kernel at
    each band, and the rounds in which the current kernel beat
    aligned8x32."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    for band in BANDS:
        cur = times[f"current{band}"]
        for k in (f"earlier{band}", "aligned8x32", "nv12_resize"):
            r = [a / b for a, b in zip(times[k], cur)]
            out[f"{k}_over_current{band}"] = r
            out[f"{k}_over_current{band}_median"] = statistics.median(r)
        out[f"current{band}_under_aligned8x32_rounds"] = sum(
            a > b for a, b in zip(times["aligned8x32"], cur))
    return out


def run(source: str, pairs: int = 10, knockouts: bool = False, log=print):
    kernels = _cuda_build.load_lab_kernels()
    builds = {"earlier": build_earlier(source), "current": kernels}
    encoder = build_current([_ENCODE_FLAG])
    if knockouts:
        builds.update({f"knockout{m}": build_current(
            [f"-DNV12_STREAMED_KNOCKOUT={m}"]) for m in range(1, 7)})
        builds.update({f"aligned_knockout{m}": aligned_ab.build_current(
            [f"-DNV12_ALIGNED_KNOCKOUT={m}"]) for m in (1, 2, 3)})
    rows = []
    for name, x, geo, timed in cases(torch.device("cuda", 0)):
        product = nv12_resize(x, **geo)
        plain = nv12_resize_plain(x, **geo)
        aligned = rd.aligned_resize(x, **geo, h_align=8, w_align=32)
        n = product.numel()
        row = dict(name=name, samples=n, ok=True,
                   staging="tma" if rd.tma_stageable(x) else "element",
                   aligned8x32_vs_product=differ(aligned, product))
        calls = {}
        for band in BANDS:
            for build in ("earlier", "current"):
                calls[f"{build}{band}"] = launcher(
                    builds[build], x, geo, band, build == "earlier")
            cur = calls[f"current{band}"]().clone()
            old = calls[f"earlier{band}"]().clone()
            before = rd.streamed_resize.tma_launches
            wrapper = rd.streamed_resize(x, **geo, band=band)
            torch.cuda.synchronize()
            row[f"wrapper{band}_tma"] = (rd.streamed_resize.tma_launches
                                         - before)
            row[f"current{band}_vs_aligned8x32"] = differ(cur, aligned)
            row[f"current{band}_vs_product"] = differ(cur, product)
            row[f"current{band}_vs_plain"] = differ(cur, plain)
            row[f"earlier{band}_vs_product"] = differ(old, product)
            row[f"wrapper{band}_equal"] = bool(torch.equal(wrapper, cur))
            row["ok"] = (row["ok"] and row[f"wrapper{band}_equal"]
                         and row[f"current{band}_vs_aligned8x32"]["differ"]
                         == 0
                         and within_envelope(row[f"current{band}_vs_product"],
                                             n)
                         and within_envelope(row[f"current{band}_vs_plain"],
                                             n))
        if timed:
            timed_calls = dict(calls)
            timed_calls["aligned8x32"] = aligned_ab.launcher(
                kernels, x, geo, 8, 32, False)
            timed_calls["nv12_resize"] = product_launcher(
                _cuda_build.load_kernels(), "nv12", x, geo, LANCZOS_AA, None,
                False)
            timed_calls["dma_only"] = (
                lambda: rd.resize_phases(x, **geo, mode="dma_only"))
            row.update(summary(rounds(timed_calls, pairs)))
            row["kernel_ms"] = kernel_ms(
                {k: timed_calls[k] for k in ("current64", "current256",
                                             "aligned8x32")})
            for tag, lib in builds.items():
                if tag.startswith("knockout"):
                    for band in BANDS:
                        row[f"{tag}_{band}_ms"] = time_ms(launcher(
                            lib, x, geo, band, False))
                elif tag.startswith("aligned_knockout"):
                    row[f"{tag}_8x32_ms"] = time_ms(aligned_ab.launcher(
                        lib, x, geo, 8, 32, False))
            row["encode_us"] = {band: encode_us(encoder, x, geo, band)
                                for band in BANDS}
            work = rd.aligned_work(x.shape[0], **geo, h_align=8, w_align=32)
            row["bytes"], row["flops"] = work
            row["bound_ms"], row["bound_by"] = bound_ms(*work)
            row["flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
            row.update(plan_row(x.shape[0], geo, sm_count(x.device)))
        log(json.dumps(row))
        rows.append(row)
        del calls, product, plain, aligned
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.streamed_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_resize_variants.cu,"
                                    " its headers beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H pass, and both knocked out, and aligned's")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("streamed_ab: needs a CUDA device", file=sys.stderr)
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
    print(f"cases not equal to aligned8x32 or outside the envelope of "
          f"nv12_resize or the plain version: {bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
