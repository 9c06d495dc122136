"""A/B of the banded resize kernel against an earlier source of
``csrc/banded_resize.cu``, on the card.

The earlier source is the 8-row-strip design (C launchers that take the
tables of :func:`vali_tpu_torch.ops.banded.resize_tables`: tile, window and
span). This builds it into a throwaway library under
``build/resize_ab/``, then at each case — the six shapes ``chip_smoke.py``
times, the sample and compute types it runs, the Surface path's N = 1
shapes, a ragged geometry and a misaligned view — counts the output
samples that differ between the two kernels (bit patterns), checks the
current kernel's output against the product wrapper's, and times both
kernels with CUDA events, earlier, current, current, earlier, each side
keeping its better median. Both are timed through the same prepared
ctypes call (tables and output made once), so that at the N = 1 shapes,
where a wrapper's host work outlasts the kernel, the kernels and not two
host paths are compared. Prints one line a case and, with ``--out``,
writes them as JSON. With ``--knockouts`` it also builds the current
source with each phase knocked out (``BANDED_RESIZE_KNOCKOUT``: 1 no W
pass, 2 no H pass, 3 the ring fill alone) and times those at the timed
cases, with the product's tables. With ``--sweep`` it also times, at each
timed case, the block geometries the packer weighs
(:func:`vali_tpu_torch.ops.banded.stream_candidates`; eleven tile widths,
every stage and strip height; for NV12 the luma and the chroma launch each
with the other at the packer's pick), each once quickly, then the fastest
eight and the packer's pick as above, and reports the pick against the
best (every swept geometry's output is checked equal to the product's).
Run it from the repository root with the earlier source saved in the
git-ignored ``_chip/`` directory, outside the package::

    mkdir -p _chip/parent
    git show <commit>:vali_tpu_torch/csrc/banded_resize.cu \
        > _chip/parent/banded_resize.cu
    python -m vali_tpu_torch.lab.resize_ab _chip/parent/banded_resize.cu \
        [--knockouts] [--sweep] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from ..ops import _cuda_build
from ..ops.banded import (IN_KINDS, SAMPLE_BYTES, resize_compute_dtype,
                          resize_tables, sm_count, stream_bands,
                          stream_candidates, stream_resize_tables,
                          stream_tables)
from ..ops.nv12_resize import nv12_resize
from ..ops.packed_resize import packed_resize
from ..ops.plane_resize import plane_resize
from ..ops.resize import LANCZOS, LANCZOS_AA
from .timing import bound_ms, resize_work, time_ms

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the earlier launchers' C signatures
_EARLIER = {
    "plane_resize_launch": [_P, _I, _LL, _LL, _I, _I, _I, _I, _I, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P, _LL, _LL, _P],
    "packed_resize_launch": [_P, _I, _LL, _LL, _I, _I, _I, _I, _I, _P, _P,
                             _I, _I, _I, _I, _I, _I, _P, _LL, _LL, _P],
    "nv12_resize_launch": [_P, _I, _LL, _LL, _I, _I, _I, _I, _I, _P, _P,
                           _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P, _P],
}


def _build(source: str, tag: str, signatures: dict, flags=()):
    """``source`` built with the package's headers into build/resize_ab/,
    with the launchers' ``signatures``."""
    return _cuda_build.build_source(
        source, "resize_ab", tag, signatures, flags,
        [os.path.join(_cuda_build._PKG_DIR, "csrc")])


def build_earlier(source: str) -> ctypes.CDLL:
    """The earlier source with its C signatures."""
    return _build(source, "earlier", _EARLIER)


def build_knockout(mode: int) -> ctypes.CDLL:
    """The current source with phases knocked out (``mode`` as
    BANDED_RESIZE_KNOCKOUT)."""
    source = os.path.join(_cuda_build._PKG_DIR, "csrc", "banded_resize.cu")
    return _build(source, f"knockout{mode}",
                  {n: _cuda_build._SIGNATURES[n] for n in _EARLIER},
                  (f"-DBANDED_RESIZE_KNOCKOUT={mode}",))


def parts(kind: str, geo: dict, x: torch.Tensor):
    """(src_h, dst_h, src_w, dst_w, channels) of each table set of a call:
    one, or luma and chroma for NV12."""
    sh, dh, dw = geo["src_h"], geo["dst_h"], geo["dst_w"]
    if kind == "nv12":
        sw = geo["src_w"]
        return [(sh, dh, sw, dw, 1), (sh // 2, dh // 2, sw // 2, dw // 2, 2)]
    c = 3 if kind == "packed" else 1
    return [(sh, dh, x.shape[2] // c, dw, c)]


def launcher(lib, kind: str, x: torch.Tensor, geo: dict, method: str,
             compute_dtype, earlier: bool, blocks=None):
    """A call of one build's launcher for ``kind`` on ``x``, its arguments
    (tables, output) prepared once, so that the host work of a call is the
    ctypes call alone, the same for every build. ``earlier`` takes the
    earlier design's tables (:func:`resize_tables`), else the product
    wrapper's (:func:`stream_resize_tables`), whose block geometry an item
    of ``blocks`` that is not None replaces (one item per table set of
    :func:`parts`)."""
    cdt = resize_compute_dtype(x.dtype, compute_dtype)
    B, dev = x.shape[0], x.device
    part_of = {p: i for i, p in enumerate(parts(kind, geo, x))}

    def tables(h, dh, w, dw, c):
        if earlier:
            return resize_tables(h, dh, w, dw, method, cdt, c, dev).args()
        block = (blocks or {}).get(part_of[(h, dh, w, dw, c)])
        if block is not None:
            return stream_tables(stream_bands(h, dh, w, dw, method, cdt, dev),
                                 block).args()
        return stream_resize_tables(h, dh, w, dw, method, cdt, c, x.dtype, B,
                                    sm_count(dev), dev).args()

    sh, dh, dw = geo["src_h"], geo["dst_h"], geo["dst_w"]
    head = (x.data_ptr(), IN_KINDS[x.dtype], x.stride(0), x.stride(1), B)
    f32 = int(cdt == torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "nv12":
        sw = geo["src_w"]
        out = torch.empty((B, dh * 3 // 2, dw), dtype=x.dtype, device=dev)
        fn = lib.nv12_resize_launch
        args = (*head, sh, sw, dh, dw, *tables(sh, dh, sw, dw, 1),
                *tables(sh // 2, dh // 2, sw // 2, dw // 2, 2), f32,
                out.data_ptr(), stream)
    else:
        c = 3 if kind == "packed" else 1
        sw = x.shape[2] // c
        out = torch.empty((B, dh, dw * c), dtype=x.dtype, device=dev)
        fn = getattr(lib, f"{kind}_resize_launch")
        args = (*head, sh, sw, dh, dw, *tables(sh, dh, sw, dw, c), f32,
                out.data_ptr(), out.stride(0), out.stride(1), stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{kind}_resize launch failed ({rc})")
        return out
    return call


def current_call(kind: str, x: torch.Tensor, geo: dict, method: str,
                 compute_dtype=None) -> torch.Tensor:
    """The product wrapper's call."""
    fn = {"plane": plane_resize, "packed": packed_resize,
          "nv12": nv12_resize}[kind]
    kw = dict(geo)
    if kind == "plane":
        kw.pop("src_w")
    return fn(x, **kw, method=method, compute_dtype=compute_dtype)


def frames(shape, dtype, device, seed: int) -> torch.Tensor:
    """Even frames uniform random samples, odd frames smooth gradients:
    uint8 full range, uint16 10-bit MSB-aligned, float32 in [0, 1]."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, shape, generator=g, device=device,
                      dtype=torch.int32).float()
    rows = torch.arange(shape[1], device=device, dtype=torch.float32)
    lanes = torch.arange(shape[2], device=device, dtype=torch.float32)
    grad = (rows[:, None] / shape[1] * 150 + lanes[None, :] / shape[2] * 100)
    x[1::2] = grad.floor()
    if dtype == torch.float32:
        return (x / 255.0).contiguous()
    if dtype == torch.uint16:
        return (x.int() << 8).to(torch.uint16)
    return x.to(torch.uint8)


def cases(device):
    """(name, kind, frames, geometry, method, compute dtype, timed)."""
    hd = dict(src_w=1920, src_h=1080)
    k4 = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    rgb = frames((64, 1080, 5760), torch.uint8, device, 1)
    nv4k = frames((16, 3240, 3840), torch.uint8, device, 2)
    y4k = nv4k[:, :2160]
    uv = frames((32, 1080, 1920), torch.uint8, device, 3)
    f32 = torch.float32
    out = [
        ("packed 64x1080p->224 u8/bf16", "packed", rgb,
         dict(hd, dst_w=224, dst_h=224), LANCZOS_AA, None, True),
        ("packed 64x1080p->640x360 u8/bf16", "packed", rgb,
         dict(hd, dst_w=640, dst_h=360), LANCZOS_AA, None, True),
        ("plane 16x4K Y->1080p u8/bf16", "plane", y4k, k4, LANCZOS_AA, None,
         True),
        ("plane 32x1080p U/V->540p u8/bf16", "plane", uv,
         dict(hd, dst_w=960, dst_h=540), LANCZOS_AA, None, True),
        ("nv12 16x4K->1080p u8/bf16", "nv12", nv4k, k4, LANCZOS_AA, None,
         True),
        ("nv12 16x4K->1080p u8/f32", "nv12", nv4k, k4, LANCZOS_AA, f32,
         True),
        ("packed 64x1080p->224 u8/f32", "packed", rgb,
         dict(hd, dst_w=224, dst_h=224), LANCZOS_AA, f32, False),
        ("packed 64x1080p->224 f32", "packed",
         frames((64, 1080, 5760), f32, device, 4),
         dict(hd, dst_w=224, dst_h=224), LANCZOS_AA, None, False),
        ("plane 16x4K Y->1080p u8/f32", "plane", y4k, k4, LANCZOS_AA, f32,
         False),
        ("plane 16x4K->1080p u16", "plane",
         frames((16, 2160, 3840), torch.uint16, device, 5), k4, LANCZOS_AA,
         None, False),
        ("plane 192x1080p->224 f32", "plane",
         frames((192, 1080, 1920), f32, device, 6),
         dict(hd, dst_w=224, dst_h=224), LANCZOS_AA, None, False),
        ("nv12 16x4K->1080p p10", "nv12",
         frames((16, 3240, 3840), torch.uint16, device, 7), k4, LANCZOS_AA,
         None, False),
        ("packed N=1 1080p->640x360 lanczos", "packed", rgb[:1],
         dict(hd, dst_w=640, dst_h=360), LANCZOS, None, True),
        ("nv12 N=1 4K->1080p lanczos", "nv12", nv4k[:1], k4, LANCZOS, None,
         True),
        ("plane N=1 Y 1080p->540p lanczos", "plane", uv[:1],
         dict(hd, dst_w=960, dst_h=540), LANCZOS, None, True),
        ("plane B=2 U/V 540p->270p lanczos", "plane", uv[:2, :540, :960],
         dict(src_w=960, src_h=540, dst_w=480, dst_h=270), LANCZOS, None,
         True),
        ("packed 3x150x322->70x202 u8/bf16", "packed",
         frames((3, 150, 966), torch.uint8, device, 8),
         dict(src_w=322, src_h=150, dst_w=202, dst_h=70), LANCZOS_AA, None,
         False),
        ("plane misaligned view 3x96x256->40x120", "plane",
         frames((3, 100, 260), torch.uint8, device, 9)[:, :96, 1:257],
         dict(src_w=256, src_h=96, dst_w=120, dst_h=40), LANCZOS_AA, None,
         False),
    ]
    return out


def work(kind, x, geo, method):
    """(bytes, operations) of one call."""
    sb = x.element_size()
    if kind == "nv12":
        sh, sw, dh, dw = geo["src_h"], geo["src_w"], geo["dst_h"], geo["dst_w"]
        y = resize_work(x.shape[0], sh, sw, dh, dw, 1, method, sb)
        c = resize_work(x.shape[0], sh // 2, sw // 2, dh // 2, dw // 2, 2,
                        method, sb)
        return y[0] + c[0], y[1] + c[1]
    c = 3 if kind == "packed" else 1
    return resize_work(x.shape[0], geo["src_h"], x.shape[2] // c,
                       geo["dst_h"], geo["dst_w"], c, method, sb)


#: the sweep's column tiles: the widths that split a row into this many
SWEEP_TILES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64)


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s samples as integers of their width (compare bit patterns)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype in (torch.uint16, torch.bfloat16):
        return t.view(torch.int16)
    return t


def quick_ms(fn, calls: int = 3) -> float:
    """ms of one call of ``fn()``: CUDA events around ``calls`` calls, after
    one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def sweep(lib, kind: str, x: torch.Tensor, geo: dict, method: str,
          compute_dtype, want: torch.Tensor, keep: int = 8) -> dict:
    """The packer's block geometry against the swept ones at one case: per
    table set, each geometry of :func:`stream_candidates` at a SWEEP_TILES
    width (and the pick's) timed once with :func:`quick_ms` and checked
    equal to ``want``, then the ``keep`` fastest and the pick with
    :func:`time_ms`; the others at the pick. NV12 also times its two best
    together."""
    cdt = resize_compute_dtype(x.dtype, compute_dtype)
    mid = 4 if cdt == torch.float32 else 2
    B, dev = x.shape[0], x.device

    def call(blocks):
        return launcher(lib, kind, x, geo, method, compute_dtype, False,
                        blocks)

    out, best = {"parts": []}, {}
    for i, (h, dh, w, dw, c) in enumerate(parts(kind, geo, x)):
        bands = stream_bands(h, dh, w, dw, method, cdt, dev)
        cands = sorted(stream_candidates(bands.rows, bands.cols, c,
                                         SAMPLE_BYTES[x.dtype], mid, B,
                                         sm_count(dev)))
        pick = cands[0][1]
        tiles = {-(-dw // n) for n in SWEEP_TILES} | {pick[0]}
        quick = []
        for _, g in cands:
            if g[0] not in tiles:
                continue
            fn = call({i: g})
            if not torch.equal(bits(fn()), bits(want)):
                raise AssertionError(f"block geometry {g} changed the "
                                     f"output of {kind}_resize")
            quick.append((quick_ms(fn), g))
        quick.sort()
        t_pick = next(t for t, g in quick if g == pick)
        timed = {g: time_ms(call({i: g}))
                 for g in [pick] + [g for _, g in quick[:keep]]}
        best[i] = min(timed, key=timed.get)
        out["parts"].append(dict(
            candidates=len(cands), swept=len(quick), pick=list(pick),
            pick_ms=timed[pick], best=list(best[i]), best_ms=timed[best[i]],
            faster_than_pick_quick=sum(t < t_pick for t, _ in quick)))
    if len(best) > 1:
        out["best_together_ms"] = time_ms(call(best))
    return out


def run(source: str, knockouts: bool = False, swept: bool = False,
        log=print):
    dev = torch.device("cuda", 0)
    builds = {"earlier": build_earlier(source),
              "current": _cuda_build.load_kernels()}
    if knockouts:
        builds.update({f"knockout{m}": build_knockout(m) for m in (1, 2, 3)})
    rows = []
    for name, kind, x, geo, method, cdt, timed in cases(dev):
        calls = {tag: launcher(lib, kind, x, geo, method, cdt,
                               tag == "earlier")
                 for tag, lib in builds.items()}
        a = calls["earlier"]().clone()
        b = calls["current"]().clone()
        product = current_call(kind, x, geo, method, cdt)
        torch.cuda.synchronize()
        a, b, product = (bits(t) for t in (a, b, product))
        row = dict(name=name, samples=b.numel(),
                   differ=int((a != b).sum().item()),
                   wrapper_equal=bool(torch.equal(b, product)))
        if timed:
            t_old = time_ms(calls["earlier"])
            t_new = time_ms(calls["current"])
            t_new = min(t_new, time_ms(calls["current"]))
            t_old = min(t_old, time_ms(calls["earlier"]))
            bound, by = bound_ms(*work(kind, x, geo, method))
            row.update(earlier_ms=t_old, current_ms=t_new, bound_ms=bound,
                       bound_by=by, speedup=t_old / t_new)
            for tag in builds:
                if tag.startswith("knockout"):
                    row[f"{tag}_ms"] = time_ms(calls[tag])
            if swept:
                row["sweep"] = sweep(builds["current"], kind, x, geo, method,
                                     cdt, product)
        log(json.dumps(row))
        rows.append(row)
        del a, b, product, calls
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/banded_resize.cu")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H pass, and both knocked out")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the block geometries the packer "
                         "weighs at each timed case")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("resize_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = run(args.earlier, args.knockouts, args.sweep,
               log=lambda s: print(s, flush=True))
    bad = [r["name"] for r in rows
           if r["differ"] or not r["wrapper_equal"]]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "rows": rows}, f, indent=1)
    print(f"cases that differ from the earlier kernel or the product "
          f"wrapper: {bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
