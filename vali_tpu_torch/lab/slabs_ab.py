"""A/B of lab kernel ``slabs`` (``csrc/nv12_slabs.cu``) against its
earlier design, on the card.

The earlier design is ``nv12_resize_slabs_launch`` of an earlier
``csrc/nv12_resize_variants.cu``: the banded FMA loops on the CUDA cores
over the windows of :func:`~vali_tpu_torch.lab.resize_diag.aligned_tables`
at 8x32, one block per (column tile, 8-row strip, frame), one ``cp.async``
group a slab piece. This builds that source into a throwaway library
under ``build/slabs_ab/`` with its own headers first on the include path,
then at each case — 16 x 4K NV12 -> 1080p, one frame, a padded pitch
(staged by TMA), a misaligned view (element loads) and the card tests'
three small shapes — and at ``nslabs`` 2, 4, 6 (and 16 at the small
shapes) counts the output samples in which the current design differs from
``aligned8x32`` (all of them, and those of the rows whose band lies in one
slab), ``slabs_resize_plain`` and ``nv12_resize``, and the earlier one from
the plain version; it holds the current one equal to ``aligned8x32`` off
the straddling rows and within the uint8 envelope (1 LSB on fewer than
1e-3 of the samples) of the other two. At the timed case it times both
designs at the three ``nslabs``, ``aligned8x32``, ``nv12_resize`` and the
lab's ``dma_only`` with CUDA events in ``--pairs`` rounds (the order
reversed every other round), each through one prepared call, and reports
each one's median and range and each round's ratios, each launch's (luma,
chroma) device time from ``torch.profiler``, the pieces and both bounds.
``--knockouts`` also times the current source built with
``NV12_SLABS_KNOCKOUT`` 1 (no W pass), 2 (no H pass) and 3 (the staging
alone) at the three ``nslabs`` and ``aligned`` built with
``NV12_ALIGNED_KNOCKOUT`` 1, 2, 3, and adds the build with
``NV12_SLABS_CPASYNC`` (each piece staged by cp.async, not TMA) to the
rounds and the bit counts. Prints one line a case and, with ``--out``,
writes them as JSON; exits 1 where a case breaks those rules. Run it from
the repository root with the earlier sources saved in the git-ignored
``_chip/`` directory::

    mkdir -p _chip/parent
    for f in nv12_resize_variants.cu banded_common.cuh; do
        git show <commit>:vali_tpu_torch/csrc/$f > _chip/parent/$f
    done
    python -m vali_tpu_torch.lab.slabs_ab \\
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _cuda_build
from ..ops.nv12_resize import nv12_resize
from ..ops.resize import LANCZOS_AA
from . import ab_common
from . import aligned_ab
from . import resize_diag as rd
from .ab_common import (differ, kernel_ms, padded_view, rounds,
                        within_envelope)
from .resize_ab import launcher as product_launcher
from .timing import BF16_OPS_PER_S, bound_ms, time_ms

_LAUNCHER = "nv12_resize_slabs_launch"
#: the earlier launcher's C signature: the resize lab's frames, geometry
#: and luma and chroma band tables, then its slab height
EARLIER_SIGNATURE = _cuda_build._RESIZE_LAB + [_cuda_build._I,
                                               _cuda_build._P,
                                               _cuda_build._P]
NSLABS = (2, 4, 6)
_CPASYNC_FLAG = "-DNV12_SLABS_CPASYNC=1"


def build_earlier(source: str):
    """The earlier source, its own headers first, with its C signature."""
    return ab_common.build_earlier(source, "slabs_ab",
                                   {_LAUNCHER: EARLIER_SIGNATURE})


def build_current(flags):
    """The current ``csrc/nv12_slabs.cu`` alone, with -D ``flags``."""
    return ab_common.build_current("nv12_slabs.cu", "slabs_ab", [_LAUNCHER],
                                   flags)


def launcher(lib, nv12: torch.Tensor, geo: dict, nslabs: int,
             earlier: bool):
    """A call of one build's slabs launcher on ``nv12``, its arguments
    (tables, output) prepared once, so that the host work of a call is the
    ctypes call alone (the current design's includes encoding its two
    tensor maps)."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev = nv12.device
    if earlier:
        keep = [rd.aligned_tables(h, oh, w, ow, channels=c, device=dev,
                                  h_align=8, w_align=32)
                for h, oh, w, ow, c in ((sh, dh, sw, dw, 1),
                                        (sh // 2, dh // 2, sw // 2, dw // 2,
                                         2))]
        t_args = (*keep[0].args(), *keep[1].args(), rd.slab_rows(sh, nslabs))
    else:
        t_args, keep = rd._slabs_device(sw, sh, dw, dh, nslabs, 8, 32, dev)
        t_args = (*t_args, int(rd.tma_stageable(nv12)))
    out = torch.empty((nv12.shape[0], dh * 3 // 2, dw), dtype=torch.uint8,
                      device=dev)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[0],
            sh, sw, dh, dw, *t_args, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, _LAUNCHER)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"slabs launch failed ({rc})")
        return out
    call.keep = keep   # what the pointers point into
    return call


def cases(device):
    """(name, frames, geometry, nslabs, timed)."""
    k4 = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(16, 3240, 3840, device)
    out = [("16x4K->1080p", x, k4, NSLABS, True),
           ("N=1 4K->1080p", x[:1], k4, NSLABS, False),
           ("3x4K->1080p padded pitch", padded_view(x[:3], 64, 0), k4, NSLABS,
            False),
           ("2x4K->1080p misaligned view", padded_view(x[3:5], 16, 1), k4,
            NSLABS, False)]
    for b, h, w, dh, dw in ((3, 288, 512, 144, 256), (2, 150, 322, 70, 202),
                            (3, 96, 256, 40, 120)):
        out.append((f"{b}x{w}x{h}->{dw}x{dh}",
                    rd.make_frames(b, h * 3 // 2, w, device, seed=h + w),
                    dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh),
                    NSLABS + (16,), False))
    return out


def pieces_row(geo: dict) -> dict:
    """Per nslabs and plane: the strips, the strips that issue more than
    one piece, the issued pieces, the most a window issues, B's blocks a
    strip and a block's shared memory."""
    row = {}
    for n in NSLABS:
        for name, ch, p in zip(("luma", "chroma"), (1, 2),
                               rd._slabs_planes(**geo, nslabs=n, h_align=8,
                                                w_align=32)):
            row[f"slabs{n}_{name}"] = dict(
                strips=len(p.pfirst) - 1,
                straddling=int((np.diff(p.pfirst) > 1).sum()),
                pieces=len(p.pieces), most=p.most_pieces, blocks=p.blocks,
                ranges=len(p.ranges),
                smem=rd.slabs_smem_bytes(ch, p.hcols, p.tables.k_pad,
                                         p.blocks))
    return row


def summary(times: dict) -> dict:
    """Median and range of each call's times, and each round's ratios of
    the earlier design, aligned8x32, nv12_resize (and the cp.async build)
    to the current kernel at each nslabs."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    for n in NSLABS:
        cur = times[f"current{n}"]
        for k in (f"earlier{n}", "aligned8x32", "nv12_resize",
                  f"cpasync{n}"):
            if k not in times:
                continue
            r = [a / b for a, b in zip(times[k], cur)]
            out[f"{k}_over_current{n}"] = r
            out[f"{k}_over_current{n}_median"] = statistics.median(r)
    return out


def run(source: str, pairs: int = 10, knockouts: bool = False, log=print):
    todo = {"earlier": lambda: build_earlier(source)}
    if knockouts:
        todo["cpasync"] = lambda: build_current([_CPASYNC_FLAG])
        for m in (1, 2, 3):
            todo[f"knockout{m}"] = functools.partial(
                build_current, [f"-DNV12_SLABS_KNOCKOUT={m}"])
            todo[f"aligned_knockout{m}"] = functools.partial(
                aligned_ab.build_current, [f"-DNV12_ALIGNED_KNOCKOUT={m}"])
    with ThreadPoolExecutor(len(todo) + 1) as pool:   # nvcc runs in parallel
        futures = {k: pool.submit(f) for k, f in todo.items()}
        futures["current"] = pool.submit(_cuda_build.load_lab_kernels)
        builds = {k: f.result() for k, f in futures.items()}
    kernels = builds["current"]
    rows = []
    for name, x, geo, nslabs, timed in cases(torch.device("cuda", 0)):
        product = nv12_resize(x, **geo)
        aligned = rd.aligned_resize(x, **geo, h_align=8, w_align=32)
        n = product.numel()
        row = dict(name=name, samples=n, ok=True,
                   staging="tma" if rd.tma_stageable(x) else "element")
        calls = {}
        for ns in nslabs:
            plain = rd.slabs_resize_plain(x, **geo, nslabs=ns)
            edge = torch.from_numpy(rd.straddling_rows(
                geo["src_h"], geo["dst_h"], rd.slab_rows(geo["src_h"], ns))
            ).to(x.device)
            for build in ("earlier", "current", "cpasync"):
                if build in builds:
                    calls[f"{build}{ns}"] = launcher(
                        builds[build], x, geo, ns, build == "earlier")
            cur = calls[f"current{ns}"]().clone()
            old = calls[f"earlier{ns}"]().clone()
            before = rd.slabs_resize.tma_launches
            wrapper = rd.slabs_resize(x, **geo, nslabs=ns)
            torch.cuda.synchronize()
            row[f"wrapper{ns}_tma"] = rd.slabs_resize.tma_launches - before
            row[f"wrapper{ns}_equal"] = bool(torch.equal(wrapper, cur))
            row[f"straddling_rows{ns}"] = int(edge.sum())
            off = differ(cur[:, ~edge], aligned[:, ~edge])
            row[f"current{ns}_vs_aligned8x32_off_edges"] = off
            row[f"current{ns}_vs_aligned8x32"] = differ(cur, aligned)
            row[f"current{ns}_vs_plain"] = differ(cur, plain)
            row[f"current{ns}_vs_product"] = differ(cur, product)
            row[f"earlier{ns}_vs_plain"] = differ(old, plain)
            row[f"earlier{ns}_vs_product"] = differ(old, product)
            ok = (row[f"wrapper{ns}_equal"] and off["differ"] == 0
                  and within_envelope(row[f"current{ns}_vs_plain"], n)
                  and within_envelope(row[f"current{ns}_vs_product"], n))
            if "cpasync" in builds:
                cp = calls[f"cpasync{ns}"]().clone()
                row[f"cpasync{ns}_equal"] = bool(torch.equal(cp, cur))
                ok = ok and row[f"cpasync{ns}_equal"]
            row["ok"] = row["ok"] and ok
            del plain
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
                {k: timed_calls[k] for k in timed_calls
                 if k.startswith(("current", "cpasync", "aligned"))})
            for tag, lib in builds.items():
                if tag.startswith("knockout"):
                    for ns in NSLABS:
                        row[f"{tag}_{ns}_ms"] = time_ms(launcher(
                            lib, x, geo, ns, False))
                elif tag.startswith("aligned_knockout"):
                    row[f"{tag}_8x32_ms"] = time_ms(aligned_ab.launcher(
                        lib, x, geo, 8, 32, False))
            for ns in NSLABS:
                work = rd.slabs_work(x.shape[0], **geo, nslabs=ns)
                row[f"slabs{ns}_flops"] = work[1]
                row[f"slabs{ns}_bound_ms"], row[f"slabs{ns}_bound_by"] = \
                    bound_ms(*work)
                row[f"slabs{ns}_flop_bound_ms"] = (work[1] / BF16_OPS_PER_S
                                                   * 1e3)
            work = rd.aligned_work(x.shape[0], **geo, h_align=8, w_align=32)
            row["bytes"], row["aligned8x32_flops"] = work
            row.update(pieces_row(geo))
        log(json.dumps(row))
        rows.append(row)
        del calls, product, aligned
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.slabs_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_resize_variants.cu,"
                                    " its headers beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H pass, and both knocked out, aligned's, and "
                         "the cp.async staging")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slabs_ab: needs a CUDA device", file=sys.stderr)
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
    print(f"cases not equal to aligned8x32 off the straddling rows or "
          f"outside the envelope of nv12_resize or the plain version: "
          f"{bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
