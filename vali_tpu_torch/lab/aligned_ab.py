"""A/B of lab kernel ``aligned`` (``csrc/nv12_aligned.cu``) against its
earlier design, on the card.

The earlier design is ``nv12_resize_aligned_launch`` of an earlier
``csrc/nv12_resize_variants.cu``: the banded FMA loops on the CUDA cores
over the windows of :func:`~vali_tpu_torch.lab.resize_diag.aligned_tables`
(one block per column tile and 8-row strip, 16-byte loads where ``w_align``
is a multiple of 16). This builds that source into a throwaway library
under ``build/aligned_ab/`` with its own headers first on the include path,
then at each case — 16 x 4K NV12 -> 1080p, one frame, a padded pitch, a
misaligned view and the card tests' two small shapes — and each alignment
(``aligned8x32``, ``aligned32x128``, ``aligned4x16``, ``aligned4x8``)
counts the output samples in which each design differs from
``nv12_resize`` and from ``nv12_resize_plain``, and holds the current one
to the uint8 envelope (1 LSB on fewer than 1e-3 of the samples). At the
timed case it times both designs at 8x32 and 32x128, ``nv12_resize`` and
the lab's ``dma_only`` with CUDA events in ``--pairs`` rounds (the order
reversed every other round), each through one prepared call, and reports
each one's median and range and each round's ratios. ``--knockouts`` also
times the current source built with ``NV12_ALIGNED_KNOCKOUT`` 1 (no W
pass), 2 (no H pass) and 3 (the staging ring alone) at both alignments.
Prints one line a case and, with ``--out``, writes them as JSON; exits 1
when a case leaves the envelope. Run it from the repository root with the
earlier sources saved in the git-ignored ``_chip/`` directory::

    mkdir -p _chip/parent
    for f in nv12_resize_variants.cu banded_common.cuh; do
        git show <commit>:vali_tpu_torch/csrc/$f > _chip/parent/$f
    done
    python -m vali_tpu_torch.lab.aligned_ab \\
        _chip/parent/nv12_resize_variants.cu [--pairs N] [--knockouts] \\
        [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from ..ops import _cuda_build
from ..ops.nv12_resize import nv12_resize, nv12_resize_plain
from ..ops.resize import LANCZOS_AA
from . import ab_common
from . import resize_diag as rd
from .ab_common import differ, padded_view, rounds, within_envelope
from .resize_ab import launcher as product_launcher
from .timing import BF16_OPS_PER_S, bound_ms, time_ms

_LAUNCHER = "nv12_resize_aligned_launch"
#: the earlier launcher's C signature: the resize lab's frames, geometry
#: and luma and chroma band tables, then its 16-byte-load knob
EARLIER_SIGNATURE = _cuda_build._RESIZE_LAB + [_cuda_build._I,
                                               _cuda_build._P,
                                               _cuda_build._P]
ALIGNS = ((8, 32), (32, 128), (4, 16), (4, 8))
TIMED_ALIGNS = ((8, 32), (32, 128))


def build_earlier(source: str):
    """The earlier source, its own headers first, with its C signature."""
    return ab_common.build_earlier(source, "aligned_ab",
                                   {_LAUNCHER: EARLIER_SIGNATURE})


def build_current(flags):
    """The current ``csrc/nv12_aligned.cu`` alone, with -D ``flags``."""
    return ab_common.build_current("nv12_aligned.cu", "aligned_ab",
                                   [_LAUNCHER], flags)


def launcher(lib, nv12: torch.Tensor, geo: dict, h_align: int,
             w_align: int, earlier: bool):
    """A call of one build's aligned launcher on ``nv12``, its arguments
    (tables, output) prepared once, so that the host work of a call is the
    ctypes call alone."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev = nv12.device
    if earlier:
        tabs = [rd.aligned_tables(h, oh, w, ow, channels=c, device=dev,
                                  h_align=h_align, w_align=w_align)
                for h, oh, w, ow, c in ((sh, dh, sw, dw, 1),
                                        (sh // 2, dh // 2, sw // 2, dw // 2,
                                         2))]
        t_args = (*tabs[0].args(), *tabs[1].args(), int(w_align % 16 == 0))
        keep = tabs
    else:
        t_args, keep = rd._aligned_device(sw, sh, dw, dh, h_align, w_align,
                                          dev)
    out = torch.empty((nv12.shape[0], dh * 3 // 2, dw), dtype=torch.uint8,
                      device=dev)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[0],
            sh, sw, dh, dw, *t_args, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, _LAUNCHER)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"aligned launch failed ({rc})")
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
    for b, h, w, dh, dw in ((3, 288, 512, 144, 256), (2, 150, 322, 70, 202)):
        out.append((f"{b}x{w}x{h}->{dw}x{dh}",
                    rd.make_frames(b, h * 3 // 2, w, device, seed=h + w),
                    dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh), False))
    return out


def summary(times: dict) -> dict:
    """Median and range of each call's times, and each round's ratios of
    the earlier design and nv12_resize to the current kernel."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    for ha, wa in TIMED_ALIGNS:
        cur = times[f"current{ha}x{wa}"]
        for k in (f"earlier{ha}x{wa}", "nv12_resize"):
            r = [a / b for a, b in zip(times[k], cur)]
            out[f"{k}_over_current{ha}x{wa}"] = r
            out[f"{k}_over_current{ha}x{wa}_median"] = statistics.median(r)
    return out


def run(source: str, pairs: int = 10, knockouts: bool = False, log=print):
    builds = {"earlier": build_earlier(source),
              "current": _cuda_build.load_lab_kernels()}
    if knockouts:
        builds.update({f"knockout{m}": build_current(
            [f"-DNV12_ALIGNED_KNOCKOUT={m}"]) for m in (1, 2, 3)})
    rows = []
    for name, x, geo, timed in cases(torch.device("cuda", 0)):
        product = nv12_resize(x, **geo)
        plain = nv12_resize_plain(x, **geo)
        n = product.numel()
        row = dict(name=name, samples=n, ok=True)
        calls = {}
        for ha, wa in ALIGNS:
            tag = f"{ha}x{wa}"
            for build in ("earlier", "current"):
                calls[f"{build}{tag}"] = launcher(
                    builds[build], x, geo, ha, wa, build == "earlier")
            cur = calls[f"current{tag}"]().clone()
            old = calls[f"earlier{tag}"]().clone()
            wrapper = rd.aligned_resize(x, **geo, h_align=ha, w_align=wa)
            torch.cuda.synchronize()
            row[f"current{tag}_vs_product"] = differ(cur, product)
            row[f"current{tag}_vs_plain"] = differ(cur, plain)
            row[f"earlier{tag}_vs_product"] = differ(old, product)
            row[f"wrapper{tag}_equal"] = bool(torch.equal(wrapper, cur))
            row["ok"] = (row["ok"] and row[f"wrapper{tag}_equal"]
                         and within_envelope(row[f"current{tag}_vs_product"],
                                             n)
                         and within_envelope(row[f"current{tag}_vs_plain"],
                                             n))
        if timed:
            timed_calls = {k: calls[k] for ha, wa in TIMED_ALIGNS
                           for k in (f"earlier{ha}x{wa}",
                                     f"current{ha}x{wa}")}
            timed_calls["nv12_resize"] = product_launcher(
                _cuda_build.load_kernels(), "nv12", x, geo, LANCZOS_AA, None,
                False)
            timed_calls["dma_only"] = (
                lambda: rd.resize_phases(x, **geo, mode="dma_only"))
            row.update(summary(rounds(timed_calls, pairs)))
            for tag in builds:
                if tag.startswith("knockout"):
                    for ha, wa in TIMED_ALIGNS:
                        row[f"{tag}_{ha}x{wa}_ms"] = time_ms(launcher(
                            builds[tag], x, geo, ha, wa, False))
            for ha, wa in TIMED_ALIGNS:
                work = rd.aligned_work(x.shape[0], **geo, h_align=ha,
                                       w_align=wa)
                key = f"current{ha}x{wa}"
                row[f"{key}_bytes"], row[f"{key}_flops"] = work
                row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = \
                    bound_ms(*work)
                row[f"{key}_flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
        log(json.dumps(row))
        rows.append(row)
        del calls, product, plain
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.aligned_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_resize_variants.cu,"
                                    " its headers beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H pass, and both knocked out")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("aligned_ab: needs a CUDA device", file=sys.stderr)
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
    print(f"cases outside the envelope of nv12_resize or the plain version: "
          f"{bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
