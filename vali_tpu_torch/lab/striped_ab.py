"""A/B of lab kernel ``striped`` (``csrc/nv12_striped.cu``) against its
earlier design and ``aligned8x32``, on the card.

The earlier design is ``nv12_resize_striped_launch`` of an earlier
``csrc/nv12_resize_variants.cu``: the H pass on the CUDA cores per
(stripe, 8-row strip, frame) into a bf16 scratch of the whole frame in
device memory, then the W pass in a second kernel (relay: a relayout
kernel between). This builds that source into a throwaway library under
``build/striped_ab/`` with its own headers first on the include path.
At each case (16 x 4K NV12 -> 1080p, one frame, a padded pitch, a
misaligned view and the card tests' three small shapes, the small ones
also at nw 1, 7 and 8) it counts the output samples in which each current
instance differs from ``aligned8x32``, ``striped_resize_plain`` and
``nv12_resize``, and at 4K the earlier design's from ``nv12_resize``; it
holds the current kernel equal to ``aligned8x32`` and within the uint8
envelope (1 LSB on fewer than 1e-3 of the samples) of the other two. At
the timed case it times the earlier design at 3dyn, 5dyn, 3relay and
3unroll, the current one at 2dyn, 3dyn, 5dyn, 6dyn, 3relay and 3unroll,
``aligned8x32``, ``nv12_resize`` and the lab's ``dma_only`` with CUDA
events in ``--pairs`` rounds (the order reversed every other round), each
through one prepared call, and reports each one's median and range, each
round's ratios (current over earlier, current over ``aligned8x32``), each
launch's device time from ``torch.profiler``, and per current instance the
H columns it issues, the halo bytes its clusters trade a batch, its
resident clusters (``cudaOccupancyMaxActiveClusters``), its shared memory
and, from ``nvcc -Xptxas -v``, each kernel instance's registers and spills
and ptxas's C75xx warnings. ``--knockouts`` also times the current source
built with ``NV12_STRIPED_KNOCKOUT`` 1 (no W pass), 2 (no H products), 3
(the staging alone) and 4 (no halo exchange and no cluster barriers) at
each instance, and ``aligned`` built with ``NV12_ALIGNED_KNOCKOUT`` 1, 2,
3. Prints one line a case and a summary line and, with ``--out``, writes
them as JSON; exits 1 where a case breaks those rules. Run it from the
repository root with the earlier sources saved in the git-ignored
``_chip/`` directory::

    mkdir -p _chip/parent
    for f in nv12_resize_variants.cu banded_common.cuh; do
        git show <commit>:vali_tpu_torch/csrc/$f > _chip/parent/$f
    done
    python -m vali_tpu_torch.lab.striped_ab \\
        _chip/parent/nv12_resize_variants.cu [--pairs N] [--knockouts] \\
        [--out FILE]
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

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

_LAUNCHER = "nv12_resize_striped_launch"
#: the earlier launcher's C signature: the resize lab's frames, geometry
#: and luma and chroma band tables, then nw, the stripe width, the store,
#: the scratch and its pitch, the relay scratch and its pitch
EARLIER_SIGNATURE = _cuda_build._RESIZE_LAB + [
    _cuda_build._I, _cuda_build._I, _cuda_build._I, _cuda_build._P,
    _cuda_build._I, _cuda_build._P, _cuda_build._I, _cuda_build._P,
    _cuda_build._P]
#: the earlier design's timed names and the current instances
EARLIER = ((3, "dyn"), (5, "dyn"), (3, "relay"), (3, "unroll"))
CURRENT = ((2, "dyn"), (3, "dyn"), (5, "dyn"), (6, "dyn"), (3, "relay"),
           (3, "unroll"))
#: more instances at the small shapes: one stripe, and halos from several
#: peers with stripes that own no tile
SMALL_ONLY = ((1, "dyn"), (7, "relay"), (8, "dyn"), (8, "unroll"))
KNOCKOUTS = (1, 2, 3, 4)
_STORE_CODE = {"0": "dyn", "1": "relay", "2": "unroll"}


def _name(nw: int, store: str) -> str:
    return f"striped{nw}{store}"


def build_earlier(source: str):
    """The earlier source, its own headers first, with its C signature."""
    return ab_common.build_earlier(source, "striped_ab",
                                   {_LAUNCHER: EARLIER_SIGNATURE})


def build_current(flags):
    """The current ``csrc/nv12_striped.cu`` alone, with -D ``flags``."""
    return ab_common.build_current("nv12_striped.cu", "striped_ab",
                                   [_LAUNCHER], flags)


def _instance(mangled: str):
    """A kernel of ``csrc/nv12_striped.cu`` by its mangled name:
    ``striped_kernel<NK, CH, STORE>`` as store_nkN_chC, ``relay_w_kernel
    <CH>`` as relay_w_chC."""
    m = re.search(r"striped_kernelILi(\d+)ELi(\d)ELi(\d)E", mangled)
    if m:
        return (f"{_STORE_CODE[m.group(3)]}_nk{m.group(1)}"
                f"_ch{m.group(2)}")
    m = re.search(r"relay_w_kernelILi(\d)E", mangled)
    return f"relay_w_ch{m.group(1)}" if m else None


def ptxas_report() -> dict:
    """Registers and spills of every kernel instance of
    ``csrc/nv12_striped.cu`` and ptxas's C75xx warnings."""
    return ab_common.ptxas_report("nv12_striped.cu", _instance)


def launcher(lib, nv12: torch.Tensor, geo: dict, nw: int, store: str,
             earlier: bool):
    """A call of one build's striped launcher on ``nv12``, its arguments
    (tables, scratch, output) prepared once, so that the host work of a
    call is the ctypes call alone."""
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    dev, batch = nv12.device, nv12.shape[0]
    if earlier:
        tabs = rd._tables(sw, sh, dw, dh, dev, rd._product_tables)
        edges = rd.stripe_edges(sw, nw)
        ldh, ldr = -(-sw // 4) * 4, -(-(sw - edges[-2]) // 4) * 4
        rows = dh * 3 // 2
        hres = torch.empty((batch, rows, ldh), dtype=torch.bfloat16,
                           device=dev)
        relay = (torch.empty((batch, nw, rows, ldr), dtype=torch.bfloat16,
                             device=dev) if store == "relay" else None)
        t_args = (*tabs[0].args(), *tabs[1].args(), nw,
                  rd.stripe_width(sw, nw), rd.STORES.index(store),
                  hres.data_ptr(), ldh,
                  None if relay is None else relay.data_ptr(), ldr)
        keep = [tabs, hres, relay]
    else:
        t_args, keep = rd._striped_device(sw, sh, dw, dh, nw, store, dev)
        scratch = (torch.empty(rd.striped_scratch_elems(batch, **geo),
                               dtype=torch.bfloat16, device=dev)
                   if store == "relay" else None)
        t_args = (*t_args, nw, rd.striped_stripe_bytes(sw, nw),
                  rd.STORES.index(store),
                  None if scratch is None else scratch.data_ptr(), None)
        keep = [keep, scratch]
    out = torch.empty((batch, dh * 3 // 2, dw), dtype=torch.uint8,
                      device=dev)
    args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1), batch, sh, sw,
            dh, dw, *t_args, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, _LAUNCHER)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"striped launch failed ({rc})")
        return out
    call.keep = keep   # what the pointers point into
    return call


def cases(device):
    """(name, frames, geometry, instances, timed)."""
    k4 = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(16, 3240, 3840, device)
    out = [("16x4K->1080p", x, k4, CURRENT, True),
           ("N=1 4K->1080p", x[:1], k4, CURRENT, False),
           ("3x4K->1080p padded pitch", padded_view(x[:3], 64, 0), k4,
            CURRENT, False),
           ("2x4K->1080p misaligned view", padded_view(x[3:5], 16, 1), k4,
            CURRENT, False)]
    for b, h, w, dh, dw in ((3, 288, 512, 144, 256), (2, 150, 322, 70, 202),
                            (3, 96, 256, 40, 120)):
        out.append((f"{b}x{w}x{h}->{dw}x{dh}",
                    rd.make_frames(b, h * 3 // 2, w, device, seed=h + w),
                    dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh),
                    CURRENT + SMALL_ONLY, False))
    return out


def instance_row(x, geo: dict) -> dict:
    """Per current instance: the H columns (bytes of a row) it issues a
    batch against aligned8x32's, the halo bytes its clusters trade a
    batch, its resident clusters, each plane's stripes' pixels held and a
    block's shared memory (the relay store's W block's beside it)."""
    batch = x.shape[0]
    aligned = sum(t.weights.shape[0] * ch * int(t.ranges[:, 3].sum())
                  for ch, t in zip((1, 2), rd._aligned_planes(
                      geo["src_w"], geo["src_h"], geo["dst_w"],
                      geo["dst_h"], 8, 32)))
    row = {"aligned8x32_h_columns": batch * aligned}
    for nw, store in CURRENT:
        planes = rd._striped_planes(geo["src_w"], geo["src_h"],
                                    geo["dst_w"], geo["dst_h"], nw, store)
        cols = sum(p.tables.weights.shape[0] * ch * int(p.stripes[:, 2].sum())
                   for ch, p in zip((1, 2), planes))
        row[_name(nw, store)] = dict(
            h_columns=batch * cols,
            halo_bytes=(0 if store == "relay" else rd.striped_halo_bytes(
                batch, **geo, nw=nw)),
            clusters=rd.striped_clusters(x, **geo, nw=nw, store=store),
            held=[p.stripes[:, 3].tolist() for p in planes],
            smem=[rd.striped_smem_bytes(ch, p.hcols, p.tables.k_pad)
                  for ch, p in zip((1, 2), planes)],
            w_smem=([rd.striped_w_smem_bytes(ch, p.wcols)
                     for ch, p in zip((1, 2), planes)]
                    if store == "relay" else None))
    return row


def summary(times: dict) -> dict:
    """Median and range of each call's times, and each round's ratios of
    each current instance over the earlier design at its name and over
    aligned8x32."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    for nw, store in CURRENT:
        cur = times.get(f"current_{_name(nw, store)}")
        if cur is None:
            continue
        for ref in (f"earlier_{_name(nw, store)}", "aligned8x32"):
            if ref not in times:
                continue
            r = [a / b for a, b in zip(cur, times[ref])]
            key = f"{_name(nw, store)}_over_{ref.removeprefix('earlier_')}"
            if ref.startswith("earlier"):
                key = f"{_name(nw, store)}_over_earlier"
            out[key] = r
            out[f"{key}_median"] = statistics.median(r)
    return out


def run(source: str, pairs: int = 10, knockouts: bool = False, log=print):
    todo = {"earlier": lambda: build_earlier(source)}
    if knockouts:
        for m in KNOCKOUTS:
            todo[f"knockout{m}"] = functools.partial(
                build_current, [f"-DNV12_STRIPED_KNOCKOUT={m}"])
        for m in (1, 2, 3):
            todo[f"aligned_knockout{m}"] = functools.partial(
                aligned_ab.build_current, [f"-DNV12_ALIGNED_KNOCKOUT={m}"])
    with ThreadPoolExecutor(len(todo) + 3) as pool:   # nvcc in parallel
        futures = {k: pool.submit(f) for k, f in todo.items()}
        futures["current"] = pool.submit(_cuda_build.load_lab_kernels)
        futures["product"] = pool.submit(_cuda_build.load_kernels)
        futures["ptxas"] = pool.submit(ptxas_report)
        builds = {k: f.result() for k, f in futures.items()}
    ptxas = builds.pop("ptxas")
    log(json.dumps({"ptxas": ptxas}))
    kernels = builds["current"]
    rows = []
    for name, x, geo, instances, timed in cases(torch.device("cuda", 0)):
        product = nv12_resize(x, **geo)
        aligned = rd.aligned_resize(x, **geo, h_align=8, w_align=32)
        n = product.numel()
        row = dict(name=name, samples=n, ok=True)
        calls, plains = {}, {}
        for nw, store in instances:
            k = _name(nw, store)
            calls[f"current_{k}"] = launcher(kernels, x, geo, nw, store,
                                             False)
            cur = calls[f"current_{k}"]().clone()
            wrapper = rd.striped_resize(x, **geo, nw=nw, store=store)
            if nw not in plains:
                plains[nw] = rd.striped_resize_plain(x, **geo, nw=nw)
            row[f"{k}_wrapper_equal"] = bool(torch.equal(wrapper, cur))
            row[f"{k}_vs_aligned8x32"] = differ(cur, aligned)
            row[f"{k}_vs_plain"] = differ(cur, plains[nw])
            row[f"{k}_vs_product"] = differ(cur, product)
            row["ok"] = (row["ok"] and row[f"{k}_wrapper_equal"]
                         and row[f"{k}_vs_aligned8x32"]["differ"] == 0
                         and within_envelope(row[f"{k}_vs_plain"], n)
                         and within_envelope(row[f"{k}_vs_product"], n))
        if timed:
            for nw, store in EARLIER:
                k = _name(nw, store)
                calls[f"earlier_{k}"] = launcher(builds["earlier"], x, geo,
                                                 nw, store, True)
                row[f"earlier_{k}_vs_product"] = differ(
                    calls[f"earlier_{k}"]().clone(), product)
            calls["aligned8x32"] = aligned_ab.launcher(kernels, x, geo, 8,
                                                       32, False)
            calls["nv12_resize"] = product_launcher(
                builds["product"], "nv12", x, geo, LANCZOS_AA, None, False)
            calls["dma_only"] = (
                lambda: rd.resize_phases(x, **geo, mode="dma_only"))
            row.update(summary(rounds(calls, pairs)))
            row["kernel_ms"] = kernel_ms(
                {k: calls[k] for k in calls
                 if k.startswith(("current", "earlier", "aligned"))})
            for tag, lib in builds.items():
                if tag.startswith("knockout"):
                    for nw, store in CURRENT:
                        if tag == "knockout4" and store == "relay":
                            continue   # no exchange to knock out
                        row[f"{tag}_{_name(nw, store)}_ms"] = time_ms(
                            launcher(lib, x, geo, nw, store, False))
                elif tag.startswith("aligned_knockout"):
                    row[f"{tag}_8x32_ms"] = time_ms(aligned_ab.launcher(
                        lib, x, geo, 8, 32, False))
            work = rd.striped_work(x.shape[0], **geo)
            row["bytes"], row["flops"] = work
            row["bound_ms"], row["bound_by"] = bound_ms(*work)
            row["flop_bound_ms"] = work[1] / BF16_OPS_PER_S * 1e3
            row["aligned8x32_flops"] = rd.aligned_work(
                x.shape[0], **geo, h_align=8, w_align=32)[1]
            row["instances"] = instance_row(x, geo)
        log(json.dumps(row))
        rows.append(row)
        del calls, product, aligned, plains
    return rows, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.striped_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/nv12_resize_variants.cu,"
                                    " its headers beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H products, both, and its halo exchange "
                         "knocked out, and aligned's")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("striped_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows, ptxas = run(args.earlier, args.pairs, args.knockouts,
                      log=lambda s: print(s, flush=True))
    bad = [r["name"] for r in rows if not r["ok"]]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "ptxas": ptxas, "rows": rows}, f,
                      indent=1)
    timed = rows[0]
    print("striped A/B summary (" + smi + "): " + json.dumps(
        {k: v for k, v in timed.items()
         if k.endswith(("_ms", "_median")) and not k.startswith("knockout")
         and not k.startswith("aligned_knockout")}))
    print(f"cases not equal to aligned8x32 or outside the envelope of "
          f"nv12_resize or the plain version: {bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
