"""A/B of lab kernels ``variant`` (``resize_phases``,
``csrc/nv12_phases.cu``) and ``skewed`` (``skewed_resize``,
``csrc/nv12_skewed.cu``) on ``aligned``'s tensor-core block against the
CUDA-core designs they replace, on the card.

The earlier designs are ``nv12_resize_phases_launch`` and
``nv12_resize_skewed_launch`` of an earlier
``csrc/nv12_resize_variants.cu``: the product's 8-row-strip FMA H pass
into bf16 rows in shared memory, then its W pass, with a phase knocked out
(one block a column tile, strip and frame), or one 512-thread block a
column tile, strip and plane walking the frames, half its threads running
frame b's H pass while the other half run frame b - 1's W pass. This
builds that source, and the earlier ``csrc/nv12_aligned.cu`` beside it,
into throwaway libraries under ``build/phases_ab/`` (each with its own
headers first on the include path) beside the current labs' library,
then at each case —
16 x 4K NV12 -> 1080p, three frames at a padded pitch and two at a
misaligned view (element loads), and the card tests' small shapes —
counts the output samples in which each new arm differs from its plain
version and from ``aligned8x32``: ``dma_only`` must equal its plain
version, ``h_only`` lie within ``resize_diag.h_only_tolerance`` (its low
bytes mod 256), ``w_only`` within the kernels' uint8 envelope, ``both``
equal ``aligned8x32``'s luma rows, every ``skewed{G}`` (G = 2, 4, 8, the
batch) equal ``aligned8x32``, and ``aligned8x32`` from the moved block
equal the earlier source's; at the timed case the ``dma_only`` and
``w_only`` sinks must equal the XOR of the frames. At the timed case it
times the earlier ``dma_only``, ``h_only``, ``w_only``, ``both`` and
``skewed``, every new arm, ``aligned8x32`` from the earlier source and
from the moved block, and ``nv12_resize`` with CUDA events in ``--pairs``
rounds (the order reversed every other round), each through one prepared
call, and reports each one's median and range, each round's ratios (new
over earlier, each skewed G over ``aligned8x32``, the moved
``aligned8x32`` over the earlier source's), each launch's device time from
``torch.profiler``, each arm's bounds, shared memory and resident blocks
an SM, and, read from ``nvcc -Xptxas -v`` before any timing, the
registers, spills and ptxas's C75xx warnings of the three current sources
and the earlier ``nv12_aligned.cu``. Prints one line a case, then a
summary line with the card's name and power limit, and, with ``--out``,
writes them as JSON; exits 1 where a case breaks those rules or ptxas
reports a C75xx warning or a spill. Run it from the repository root
with the earlier checkout unpacked into the git-ignored ``_chip/``
directory::

    mkdir -p _chip/parent && git archive <commit> | tar -x -C _chip/parent
    python -m vali_tpu_torch.lab.phases_ab \\
        _chip/parent/vali_tpu_torch/csrc/nv12_resize_variants.cu \\
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

import numpy as np
import torch

from ..ops import _cuda_build
from ..ops.nv12_resize import nv12_resize_plain
from ..ops.resize import LANCZOS_AA
from . import ab_common, aligned_ab
from . import resize_diag as rd
from .ab_common import differ, kernel_ms, padded_view, rounds
from .resize_ab import launcher as product_launcher
from .timing import BF16_OPS_PER_S, bound_ms

_P, _I = _cuda_build._P, _cuda_build._I
#: the earlier launchers' C signatures: the resize lab's frames, geometry
#: and luma and chroma band tables, then (phases) the mode and the sink
EARLIER_SIGNATURES = {
    "nv12_resize_phases_launch": _cuda_build._RESIZE_LAB
    + [_I, _P, _I, _P, _P],
    "nv12_resize_skewed_launch": _cuda_build._RESIZE_LAB + [_P, _P]}
_ALIGNED = "nv12_resize_aligned_launch"
#: the skewed arms' frames a block (None: the batch)
SKEWED_G = {"skewed2": 2, "skewed4": 4, "skewed8": 8, "skewed": None}
NEW_ARMS = tuple(rd.MODES) + tuple(SKEWED_G)
EARLIER_ARMS = tuple(rd.MODES) + ("skewed",)


def builds(source: str) -> dict:
    """The earlier resize variants and, from the same directory, the
    earlier aligned; the current labs' and the product's libraries; and
    the ptxas reports. nvcc runs in parallel."""
    parent = os.path.dirname(os.path.abspath(source))
    todo = {
        "earlier": lambda: ab_common.build_earlier(source, "phases_ab",
                                                   EARLIER_SIGNATURES),
        "earlier_aligned": lambda: ab_common.build_earlier(
            os.path.join(parent, "nv12_aligned.cu"), "phases_ab",
            {_ALIGNED: _cuda_build._LAB_SIGNATURES[_ALIGNED]}),
        "current": _cuda_build.load_lab_kernels,
        "product": _cuda_build.load_kernels,
        "ptxas": lambda: ptxas_report(parent),
    }
    with ThreadPoolExecutor(len(todo)) as pool:
        futures = {k: pool.submit(f) for k, f in todo.items()}
        return {k: f.result() for k, f in futures.items()}


_BLOCK_MODE = {0: "full", 1: "h_only", 2: "w_only", 3: "dma"}


def ptxas_report(parent: str) -> dict:
    """Registers, spills and C75xx warnings (``nvcc -Xptxas -v``) of each
    instance of the current nv12_phases.cu, nv12_skewed.cu and
    nv12_aligned.cu, and of the earlier nv12_aligned.cu in ``parent``."""
    def phases(name):
        m = re.search(r"phases_kernelILi(\d+)ELi(\d)ELi(\d)E", name)
        return (f"phases_{_BLOCK_MODE[int(m.group(3))]}_ch{m.group(2)}"
                f"_nk{m.group(1)}" if m else None)

    def kernel(prefix, tag):
        def f(name):
            m = re.search(prefix + r"ILi(\d+)ELi(\d)E", name)
            return f"{tag}_ch{m.group(2)}_nk{m.group(1)}" if m else None
        return f

    jobs = (("nv12_phases.cu", phases),
            ("nv12_skewed.cu", kernel("skewed_kernel", "skewed")),
            ("nv12_aligned.cu", kernel("aligned_kernel", "aligned")),
            (os.path.join(parent, "nv12_aligned.cu"),
             kernel("aligned_kernel", "earlier_aligned")))
    with ThreadPoolExecutor(len(jobs)) as pool:
        reports = list(pool.map(lambda j: ab_common.ptxas_report(*j), jobs))
    out = {"warnings": []}
    for r in reports:
        out["warnings"] += r.pop("warnings")
        out.update(r)
    return out


def earlier_launcher(lib, nv12: torch.Tensor, geo: dict, arm: str):
    """A prepared call of an earlier CUDA-core launcher on ``nv12`` with
    the product's band tables, as its wrapper passed them."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev, B = nv12.device, nv12.shape[0]
    tabs = rd._tables(sw, sh, dw, dh, dev, rd._product_tables)
    sink = torch.zeros(rd.SINK_WORDS, dtype=torch.int32, device=dev)
    if arm == "skewed":
        out = torch.empty((B, dh * 3 // 2, dw), dtype=torch.uint8,
                          device=dev)
        fn, knobs = lib.nv12_resize_skewed_launch, ()
    else:
        out = torch.empty((B, dh, dw), dtype=torch.uint8, device=dev)
        fn = lib.nv12_resize_phases_launch
        knobs = (rd.MODES[arm], sink.data_ptr(), sink.numel())
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), B, sh, sw, dh,
            dw, *tabs[0].args(), *tabs[1].args(), *knobs, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"earlier {arm} launch failed ({rc})")
        return out
    call.keep = (tabs, sink)   # what the pointers point into
    return call


def phases_launcher(lib, nv12: torch.Tensor, geo: dict, mode: str,
                    sink: torch.Tensor):
    """A prepared call of ``nv12_resize_phases_launch`` on ``nv12``."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    t_args, keep = rd._phases_device(sw, sh, dw, dh, nv12.device)
    out = torch.empty((nv12.shape[0], dh, dw), dtype=torch.uint8,
                      device=nv12.device)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[0],
            sh, sw, dh, dw, *t_args, rd.MODES[mode], sink.data_ptr(),
            sink.numel(), None, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    fn = lib.nv12_resize_phases_launch

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{mode} launch failed ({rc})")
        return out
    call.keep = (keep, sink)
    return call


def skewed_launcher(lib, nv12: torch.Tensor, geo: dict, g):
    """A prepared call of ``nv12_resize_skewed_launch`` on ``nv12`` with
    ``g`` frames a block (None: the batch)."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    t_args, keep = rd._skewed_device(sw, sh, dw, dh, nv12.device)
    out = torch.empty((nv12.shape[0], dh * 3 // 2, dw), dtype=torch.uint8,
                      device=nv12.device)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[0],
            sh, sw, dh, dw, *t_args, g or nv12.shape[0], None,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    fn = lib.nv12_resize_skewed_launch

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"skewed G={g} launch failed ({rc})")
        return out
    call.keep = keep
    return call


def cases(device):
    """(name, frames, geometry, timed)."""
    k4 = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(16, 3240, 3840, device)
    out = [("16x4K->1080p", x, k4, True),
           ("3x4K->1080p padded pitch", padded_view(x[:3], 64, 0), k4, False),
           ("2x4K->1080p misaligned view", padded_view(x[3:5], 16, 1), k4,
            False)]
    for b, h, w, dh, dw in ((3, 288, 512, 144, 256), (2, 150, 322, 70, 202),
                            (3, 96, 256, 40, 120), (2, 144, 256, 72, 128)):
        out.append((f"{b}x{w}x{h}->{dw}x{dh}",
                    rd.make_frames(b, h * 3 // 2, w, device, seed=h + w),
                    dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh), False))
    return out


def check_case(b: dict, x: torch.Tensor, geo: dict, row: dict) -> dict:
    """The new arms against their plain versions and aligned8x32, the
    moved aligned against the earlier source; returns the prepared calls
    of the new arms and of both aligned builds."""
    B, dh = x.shape[0], geo["dst_h"]
    calls = {"aligned8x32": aligned_ab.launcher(b["current"], x, geo, 8, 32,
                                                False),
             "earlier_aligned8x32": aligned_ab.launcher(
                 b["earlier_aligned"], x, geo, 8, 32, False)}
    aligned = calls["aligned8x32"]().clone()
    row["aligned8x32_vs_earlier"] = differ(
        aligned, calls["earlier_aligned8x32"]())
    plain = nv12_resize_plain(x, **geo)
    row["aligned8x32_vs_plain"] = differ(aligned, plain)
    ok = row["aligned8x32_vs_earlier"]["differ"] == 0
    for mode in rd.MODES:
        c = rd.case(mode, B, **geo)
        sink = torch.zeros(rd.SINK_WORDS, dtype=torch.int32, device=x.device)
        calls[mode] = phases_launcher(b["current"], x, geo, mode, sink)
        out = calls[mode]().clone()
        ref = c.plain(x)
        d = c.distance(out, ref)
        row[f"{mode}_vs_plain"] = dict(differ=int((d > 0).sum().item()),
                                       maxdiff=int(d.max().item()))
        if mode == "both":
            row["both_vs_aligned8x32"] = differ(out, aligned[:, :dh])
            ok = ok and row["both_vs_aligned8x32"]["differ"] == 0
        else:
            ok = ok and c.within(out, x)
        if mode == "dma_only":
            ok = ok and row["dma_only_vs_plain"]["differ"] == 0
    for arm, g in SKEWED_G.items():
        calls[arm] = skewed_launcher(b["current"], x, geo, g)
        out = calls[arm]()
        row[f"{arm}_vs_aligned8x32"] = differ(out, aligned)
        row[f"{arm}_vs_plain"] = differ(out, plain)
        ok = ok and row[f"{arm}_vs_aligned8x32"]["differ"] == 0
    torch.cuda.synchronize()
    row["ok"] = ok
    return calls


def sinks_ok(calls: dict, x: torch.Tensor, row: dict) -> bool:
    """The new dma_only's and w_only's sinks, zeroed before one call,
    against the XOR of every 32-bit word of the frames."""
    want = int(np.bitwise_xor.reduce(x.cpu().numpy().view(np.uint32),
                                     axis=None))
    ok = True
    for mode in ("dma_only", "w_only"):
        sink = calls[mode].keep[1]
        sink.zero_()
        calls[mode]()
        got = int(np.bitwise_xor.reduce(sink.cpu().numpy().view(np.uint32)))
        row[f"{mode}_sink_equal"] = got == want
        ok = ok and got == want
    return ok


def summary(times: dict) -> dict:
    """Median and range of each call's times and each round's ratios: new
    over earlier (each mode; each skewed G over the earlier skewed), each
    skewed G and the moved aligned8x32 over aligned8x32 and its earlier
    source."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    pairs = [(f"new_{m}", f"earlier_{m}") for m in rd.MODES]
    pairs += [(f"new_{a}", "earlier_skewed") for a in SKEWED_G]
    pairs += [(f"new_{a}", "aligned8x32") for a in SKEWED_G]
    pairs += [("aligned8x32", "earlier_aligned8x32")]
    for a, b in pairs:
        r = [x / y for x, y in zip(times[a], times[b])]
        out[f"{a}_over_{b}"] = r
        out[f"{a}_over_{b}_median"] = statistics.median(r)
    return out


def over_aligned(times: dict) -> dict:
    """Each call's median and each skewed arm's median ratio to
    ``aligned8x32`` in the same rounds (``chip_smoke.py``'s skewed
    rounds)."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    for k, v in times.items():
        if k != "aligned8x32":
            out[f"{k}_over_aligned8x32_median"] = statistics.median(
                [a / b for a, b in zip(v, times["aligned8x32"])])
    return out


def resident(lib, x: torch.Tensor, geo: dict):
    """(luma, chroma) blocks an SM of a build's skewed launches, asked of
    its launcher without a launch."""
    res = (ctypes.c_int * 2)()
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    t_args, _ = rd._skewed_device(sw, sh, dw, dh, x.device)
    rc = lib.nv12_resize_skewed_launch(
        x.data_ptr(), x.stride(0), x.stride(1), 0, sh, sw, dh, dw, *t_args,
        1, ctypes.addressof(res), None,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"skewed residency query failed ({rc})")
    return res[0], res[1]


def arm_facts(libs: dict, x: torch.Tensor, geo: dict) -> dict:
    """Each new arm's bytes, FLOPs, both bounds, shared memory per block
    (luma, chroma) and resident blocks an SM (luma, chroma)."""
    B = x.shape[0]
    geo4 = (geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"])
    aligned = rd._aligned_planes(*geo4, *rd.PHASES_ALIGN)
    skewed = rd._skewed_planes(*geo4)
    out = {}
    for arm in NEW_ARMS + ("aligned8x32",):
        if arm in rd.MODES:
            work = rd.phases_work(B, **geo, mode=arm)
            smem = [rd.aligned_smem_bytes(c, t.hcols, t.k_pad)
                    for c, t in zip((1, 2), aligned)]
            held = rd.resident_blocks(x, **geo, mode=arm)
        elif arm in SKEWED_G:
            work = rd.skewed_work(B, **geo)
            smem = [rd.skewed_smem_bytes(c, t.hcols, t.k_pad)
                    for c, t in zip((1, 2), skewed)]
            held = resident(libs["current"], x, geo)
        else:
            work = rd.aligned_work(B, **geo, h_align=8, w_align=32)
            smem = [rd.aligned_smem_bytes(c, t.hcols, t.k_pad)
                    for c, t in zip((1, 2), aligned)]
            held = None
        out[f"{arm}_bytes"], out[f"{arm}_flops"] = work
        out[f"{arm}_bound_ms"], out[f"{arm}_bound_by"] = bound_ms(*work)
        out[f"{arm}_flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
        out[f"{arm}_smem_bytes"] = smem
        out[f"{arm}_resident_blocks"] = held
    out["skewed_ranges"] = [len(t.ranges) for t in skewed]
    out["aligned_ranges"] = [len(t.ranges) for t in aligned]
    return out


def summary_line(row: dict, smi: str) -> str:
    """The timed case's medians and ratios in one line."""
    parts = [f"{a} {row[f'new_{a}_ms']:.4f}"
             + (f" (earlier {row[f'earlier_{a}_ms']:.4f})"
                if f"earlier_{a}_ms" in row else "")
             for a in NEW_ARMS]
    parts += [f"{a} / aligned8x32 {row[f'new_{a}_over_aligned8x32_median']:.3f}"
              for a in SKEWED_G]
    parts += [f"aligned8x32 {row['aligned8x32_ms']:.4f} (earlier "
              f"{row['earlier_aligned8x32_ms']:.4f}, ratio "
              f"{row['aligned8x32_over_earlier_aligned8x32_median']:.3f})",
              f"nv12_resize {row['nv12_resize_ms']:.4f}"]
    return (f"phases_ab 16 x 4K -> 1080p (ms): " + "; ".join(parts)
            + f" ({smi})")


def run(source: str, pairs: int = 10, log=print):
    b = builds(source)
    ptxas = b.pop("ptxas")
    log(json.dumps({"ptxas": ptxas}))
    rows = []
    for name, x, geo, timed in cases(torch.device("cuda", 0)):
        row = dict(name=name, samples=x.shape[0] * geo["dst_h"] * 3 // 2
                   * geo["dst_w"])
        new = check_case(b, x, geo, row)
        if timed:
            row["ok"] = sinks_ok(new, x, row) and row["ok"]
            calls = {f"new_{a}": new[a] for a in NEW_ARMS}
            calls["aligned8x32"] = new["aligned8x32"]
            calls["earlier_aligned8x32"] = new["earlier_aligned8x32"]
            for arm in EARLIER_ARMS:
                calls[f"earlier_{arm}"] = earlier_launcher(b["earlier"], x,
                                                           geo, arm)
                out = calls[f"earlier_{arm}"]()
                c = rd.case(arm, x.shape[0], **geo)
                d = c.distance(out, c.plain(x))
                row[f"earlier_{arm}_vs_plain"] = dict(
                    differ=int((d > 0).sum().item()),
                    maxdiff=int(d.max().item()))
            calls["nv12_resize"] = product_launcher(
                b["product"], "nv12", x, geo, LANCZOS_AA, None, False)
            row.update(summary(rounds(calls, pairs)))
            row.update(arm_facts(b, x, geo))
            # last: the profiler's tracing slows the launches timed after
            row["kernel_ms"] = kernel_ms(calls)
        log(json.dumps(row))
        rows.append(row)
    return ptxas, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.phases_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_resize_variants.cu,"
                                    " its headers and nv12_aligned.cu "
                                    "beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phases_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ptxas, rows = run(args.earlier, args.pairs,
                      log=lambda s: print(s, flush=True))
    timed = next(r for r in rows if "nv12_resize_ms" in r)
    print(summary_line(timed, smi), flush=True)
    bad = [r["name"] for r in rows if not r["ok"]]
    spills = [k for k, v in ptxas.items() if k != "warnings"
              and (v.get("spill_store_bytes") or v.get("spill_load_bytes"))]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "ptxas": ptxas, "rows": rows}, f,
                      indent=1)
    print(f"cases outside their tolerance, off aligned8x32's bits or the "
          f"earlier aligned's, or with a sink short of the frames: "
          f"{bad or 'none'}; ptxas spills {spills or 'none'}, C75xx "
          f"warnings {len(ptxas['warnings'])}")
    return 1 if bad or spills or ptxas["warnings"] else 0


if __name__ == "__main__":
    sys.exit(main())
