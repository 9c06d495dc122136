"""A/B of the banded preprocess kernel against an earlier source of
``csrc/banded_preprocess.cu``, and of ``nv12_preprocess``'s tensor-core
route against both, on the card.

The earlier source is the 8-row-strip design (C launchers that take the
tables of :func:`vali_tpu_torch.ops.banded.device_tables` and no block
geometry) or the streaming design, whose launchers take the current
source's tables and block geometry (:func:`takes_geometry`). This builds
it into a throwaway library under
``build/preprocess_ab/`` with the earlier ``banded_preprocess.cuh`` and
``banded_common.cuh`` first on the include path, then at each case — the
four layouts at 64 x 1080p -> 224, NV12 with float32 compute, P010, the
pipeline's letterbox launch (I420 -> 640x360 bfloat16, normalised), ragged
geometries, one frame, an odd batch and a misaligned, padded view —
counts the output samples that differ between the two kernels (bit
patterns), checks the current kernel's output against the FMA kernel's
own entry (:func:`fma_call`), and times both kernels with CUDA events in
``--pairs`` alternating pairs (earlier, current, then current, earlier,
...). Each side reports the median and range of its times, and each pair
the earlier time over the current one: a case counts as resolved faster
(slower) only where every pair's ratio is above (below) 1. Both are timed
through the same prepared ctypes call (tables and output made once), so
that the kernels and not two host paths are compared.

Where ``nv12_route`` sends a case to the tensor-core kernel
(``csrc/nv12_wgmma_preprocess.cu``), the row also holds that route's
output against the wrapper's (equal), the earlier kernel's and the plain
version's (the kernels' uint8 envelope, differing samples counted), and
against the lab's T16 and S2 t16a8 (``csrc/nv12_chains.cu``,
``csrc/nv12_static2.cu`` at 16 rows: equal); at a timed case the earlier
kernel, the route and the two lab arms are timed in ``--pairs`` rounds of
all four (:func:`~vali_tpu_torch.lab.ab_common.rounds`), and the route's
device time read by ``torch.profiler`` by kernel name. The run also
reports the route's kernel's ptxas registers and spills and its shared
memory at 64 x 1080p -> 224. Prints one line a case and, with ``--out``,
writes them as JSON.

``--knockouts`` builds the current source with each phase knocked out
(``BANDED_PREPROCESS_KNOCKOUT``: 1 no W pass, 2 no H pass, 3 the ring fill
alone) and times those; ``--variant`` builds it with other -D knobs
(``BANDED_PREPROCESS_H_ROWS``, ``..._W_ROWS``) and times those with the
packer's geometry. ``--sweep`` times, at each timed case, the block
geometries the packer weighs
(:func:`vali_tpu_torch.ops.banded.preprocess_candidates` at SWEEP_TILES
widths), each once quickly, then the fastest eight and the packer's pick
as above, and reports the pick against the best (every swept geometry's
output is checked equal to the product's). Run it from the repository
root with the earlier sources saved in the git-ignored ``_chip/``
directory, outside the package::

    mkdir -p _chip/parent
    for f in banded_preprocess.cu banded_preprocess.cuh banded_common.cuh; do
        git show <commit>:vali_tpu_torch/csrc/$f > _chip/parent/$f
    done
    python -m vali_tpu_torch.lab.preprocess_ab _chip/parent/banded_preprocess.cu \\
        [--pairs N] [--knockouts] [--sweep] [--variant K=V[,K=V]]... \\
        [--out FILE]
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
from ..ops import _cuda_build, banded
from ..ops import nv12_preprocess as nv12_mod
from ..ops import yuv420_preprocess as i420_mod
from ..ops import yuv422_preprocess as i422_mod
from ..ops import yuv444_preprocess as i444_mod
from ..ops.banded import (OUT_KINDS, PreprocessTables, SAMPLE_BYTES,
                          device_tables, preprocess_candidates, sm_count,
                          stream_preprocess_tables)
from ..ops.resize import LANCZOS_AA
from . import kernel_variants as kv
from .ab_common import (differ, kernel_ms, ptxas_report, rounds, summary,
                        within_envelope)
from .resize_ab import bits, quick_ms
from .timing import bound_ms, preprocess_work, time_ms

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)
_TAIL = [_I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _FP, _I, _P, _I, _P]
#: the earlier launchers' C signatures (no block geometry)
_EARLIER = {
    "nv12_preprocess_launch": [_P, _I, _LL, _LL] + _TAIL,
    "yuv420_preprocess_launch": [_P, _P, _P, _I] + [_LL] * 6 + _TAIL,
    "yuv422_preprocess_launch": [_P, _P, _P] + [_LL] * 6 + _TAIL,
    "yuv444_preprocess_launch": [_P, _P, _P] + [_LL] * 6 + _TAIL,
}
_CURRENT = {n: _cuda_build._SIGNATURES[n] for n in _EARLIER}
#: layout -> (launcher, the wrapper's module, the packer's layout)
KINDS = {"nv12": ("nv12_preprocess_launch", nv12_mod, "nv12"),
         "i420": ("yuv420_preprocess_launch", i420_mod, "420"),
         "422": ("yuv422_preprocess_launch", i422_mod, "422"),
         "444": ("yuv444_preprocess_launch", i444_mod, "444")}
#: the sweep's column tiles: the widths that split a row into this many
SWEEP_TILES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def _build(source: str, tag: str, signatures: dict, flags=(),
           include=None):
    """``source`` built into build/preprocess_ab/ with ``include`` (else
    the source's own directory) on the include path."""
    return _cuda_build.build_source(
        source, "preprocess_ab", tag, signatures, flags,
        [include or os.path.dirname(os.path.abspath(source))])


def _current_source() -> str:
    return os.path.join(_cuda_build._PKG_DIR, "csrc", "banded_preprocess.cu")


def takes_geometry(source: str) -> bool:
    """Whether an earlier source's launchers take the packer's block
    geometry (the streaming design's C signatures, as the current source)
    rather than the 8-row-strip design's."""
    with open(source) as f:
        return "const int* geometry" in f.read()


def build_earlier(source: str) -> ctypes.CDLL:
    """The earlier source, its own headers first, with its C
    signatures."""
    return _build(source, "earlier",
                  _CURRENT if takes_geometry(source) else _EARLIER)


def build_current(flags) -> ctypes.CDLL:
    """The current source with extra ``flags`` (-D knobs)."""
    tag = "current" + "".join(f.split("=")[-1] for f in flags)
    return _build(_current_source(), tag, _CURRENT, tuple(flags))


def checked(kind: str, planes, geo: dict, kw: dict):
    """(compute dtype, packed tail) as the product wrapper checks them."""
    mod = KINDS[kind][1]
    w, h = geo["src_w"], geo["src_h"]
    base = (kw.get("space", ColorSpace.BT_709),
            kw.get("crange", ColorRange.MPEG),
            kw.get("out_dtype", torch.uint8), kw.get("normalize"))
    if kind == "nv12":
        return mod._checked(planes[0], w, h, *base, kw.get("compute_dtype"))
    if kind == "i420":
        return mod._checked(*planes, w, h, *base, kw.get("bit_depth"),
                            kw.get("compute_dtype"))
    return mod._checked(*planes, w, h, *base, kw.get("compute_dtype"))


def tables_for(kind: str, planes, geo: dict, cdt, block=None):
    """The current kernel's tables: the packer's pick, or ``block``, a
    geometry of :func:`preprocess_candidates`."""
    x = planes[0]
    layout = KINDS[kind][2]
    args = (geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"],
            LANCZOS_AA, layout, cdt, x.dtype, x.shape[0], sm_count(x.device),
            x.device)
    t = stream_preprocess_tables(*args)
    if block is None:
        return t
    return PreprocessTables(t.index, t.weights, t.taps, *block,
                            np.array(block[:7], np.int32))


def launcher(lib, kind: str, planes, geo: dict, kw: dict, earlier: bool,
             tables=None):
    """A call of one build's launcher for ``kind`` on ``planes``, its
    arguments (tables, output) prepared once, so that the host work of a
    call is the ctypes call alone. ``earlier`` takes the earlier design's
    tables (:func:`device_tables`), else ``tables`` (the product's pick by
    default)."""
    cdt, tail = checked(kind, planes, geo, kw)
    x = planes[0]
    B, dev = x.shape[0], x.device
    sw, sh, dw, dh = geo["src_w"], geo["src_h"], geo["dst_w"], geo["dst_h"]
    if earlier:
        dense = "420" if kind in ("nv12", "i420") else kind
        t = device_tables(sw, sh, dw, dh, LANCZOS_AA, dense, cdt, dev)
        targs = (t.index.data_ptr(), t.weights.data_ptr(), *t.taps)
    else:
        targs = (tables or tables_for(kind, planes, geo, cdt)).args()
    out_dtype = kw.get("out_dtype", torch.uint8)
    out = torch.empty((B, 3, dh, dw), dtype=out_dtype, device=dev)
    if kind == "nv12":
        head = (x.data_ptr(), x.element_size(), x.stride(0), x.stride(1))
    else:
        strides = [s for p in planes for s in (p.stride(0), p.stride(1))]
        head = (*(p.data_ptr() for p in planes),
                *((x.element_size(),) if kind == "i420" else ()), *strides)
    args = (*head, B, sh, sw, dh, dw, *targs,
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(cdt == torch.float32), out.data_ptr(), OUT_KINDS[out_dtype],
            torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, KINDS[kind][0])

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{kind} preprocess launch failed ({rc})")
        return out
    call.keep = (tail, targs)   # the host arrays the pointers point into
    return call


def product_call(kind: str, planes, geo: dict, kw: dict) -> torch.Tensor:
    """The product wrapper's call."""
    mod = KINDS[kind][1]
    fn = getattr(mod, mod.__name__.rsplit(".", 1)[-1])
    return fn(*planes, **geo, **kw)


def fma_call(kind: str, planes, geo: dict, kw: dict) -> torch.Tensor:
    """The FMA kernel's own entry: the product wrapper, but for NV12, whose
    wrapper may take the tensor-core route, ``_nv12_preprocess_banded``."""
    if kind == "nv12":
        return nv12_mod._nv12_preprocess_banded(*planes, **geo, **kw)
    return product_call(kind, planes, geo, kw)


#: the lab's arms at the route's strip: T16 (the route's instance in the
#: labs' library) and S2 t16a8, each launcher's name
LAB_ARMS = {"T16": "nv12_tchroma_launch", "S2t16a8": "nv12_static2_launch"}


def _s2_call(lib, launcher: str, planes, geo: dict, kw: dict, targs,
             knobs=()):
    """A prepared call of a launcher on S2's tables (``targs``: frames,
    geometry, tail, ``knobs``, tables, out, stream), as :func:`launcher`
    prepares the FMA kernel's."""
    _, tail = checked("nv12", planes, geo, kw)
    x = planes[0]
    out = torch.empty((x.shape[0], 3, geo["dst_h"], geo["dst_w"]),
                      dtype=torch.uint8, device=x.device)
    args = (x.data_ptr(), x.stride(0), x.stride(1), x.shape[1], x.shape[0],
            geo["src_h"], geo["src_w"], geo["dst_h"], geo["dst_w"],
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *knobs,
            *targs, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, launcher)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{launcher} failed ({rc})")
        return out
    call.keep = tail
    return call


def routed_launcher(planes, geo: dict, kw: dict):
    """A prepared call of the product's tensor-core launcher on NV12
    planes that ``nv12_route`` sends there, with the wrapper's cached
    tables."""
    x = planes[0]
    _, targs = nv12_mod._wgmma_tables(geo["src_w"], geo["src_h"],
                                      geo["dst_w"], geo["dst_h"], LANCZOS_AA,
                                      x.device)
    return _s2_call(_cuda_build.load_kernels(),
                    "nv12_wgmma_preprocess_launch", planes, geo, kw, targs)


def lab_launcher(arm: str, planes, geo: dict, kw: dict):
    """A prepared call of the lab's ``arm`` (:data:`LAB_ARMS`) at 16-row
    strips over windows aligned to 8 rows."""
    tile = nv12_mod.WGMMA_TILE
    targs, _ = kv._static2_device(geo["src_w"], geo["src_h"], geo["dst_w"],
                                  geo["dst_h"], tile, nv12_mod.WGMMA_ALIGN,
                                  planes[0].device)
    return _s2_call(_cuda_build.load_lab_kernels(), LAB_ARMS[arm], planes,
                    geo, kw, targs, (tile,))


def make_planes(kind: str, b: int, w: int, h: int, device, seed: int,
                dtype=torch.uint8, bits_used: int = 8, pad=(0, 0, 0)):
    """Planes of ``kind`` for ``b`` frames: even frames uniform random in
    ``bits_used`` bits (MSB-aligned for a uint16 NV12), odd frames smooth
    gradients. ``pad`` (rows, columns, offset) makes each plane a view of a
    larger buffer starting ``offset`` samples into its rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    ch, cw = {"nv12": (h // 2, w), "i420": (h // 2, w // 2),
              "422": (h, w // 2), "444": (h, w)}[kind]
    shapes = ([(h * 3 // 2, w)] if kind == "nv12"
              else [(h, w), (ch, cw), (ch, cw)])
    top = (1 << bits_used) - 1
    shift = 16 - bits_used if kind == "nv12" and dtype == torch.uint16 else 0
    out = []
    for rows, cols in shapes:
        x = torch.randint(0, top + 1, (b, rows, cols), generator=g,
                          device=device, dtype=torch.int32)
        r = torch.arange(rows, device=device)[:, None] / max(rows - 1, 1)
        c = torch.arange(cols, device=device)[None, :] / max(cols - 1, 1)
        x[1::2] = ((r * 0.6 + c * 0.4) * top).int()
        x = (x << shift).to(dtype)
        pr, pc, off = pad
        big = torch.zeros((b, rows + pr, cols + pc + off), dtype=dtype,
                          device=device)
        big[:, :rows, off:off + cols] = x
        out.append(big[:, :rows, off:off + cols])
    return out


def cases(device):
    """(name, kind, planes, geometry, keywords, timed)."""
    hd = dict(src_w=1920, src_h=1080)
    to224 = dict(hd, dst_w=224, dst_h=224)
    jpeg = dict(space=ColorSpace.BT_601, crange=ColorRange.JPEG)
    norm = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    nv = make_planes("nv12", 64, 1920, 1080, device, 1)
    i420 = make_planes("i420", 64, 1920, 1080, device, 2)
    rag = dict(src_w=322, src_h=150, dst_w=202, dst_h=70)
    out = [
        ("nv12 64x1080p->224 u8/bf16", "nv12", nv, to224, {}, True),
        ("i420 64x1080p->224 u8/bf16", "i420", i420, to224, {}, True),
        ("422 64x1080p->224 u8/bf16 bt601/jpeg", "422",
         make_planes("422", 64, 1920, 1080, device, 3), to224, jpeg, True),
        ("444 64x1080p->224 u8/bf16", "444",
         make_planes("444", 64, 1920, 1080, device, 4), to224, {}, True),
        ("nv12 64x1080p->224 u8/f32", "nv12", nv, to224,
         dict(compute_dtype=torch.float32), True),
        ("p010 64x1080p->224 f32+norm", "nv12",
         make_planes("nv12", 64, 1920, 1080, device, 5, torch.uint16, 10),
         to224, dict(out_dtype=torch.float32, normalize=norm), True),
        ("i420 letterbox 64x1080p->640x360 bf16+norm", "i420", i420,
         dict(hd, dst_w=640, dst_h=360),
         dict(out_dtype=torch.bfloat16, normalize=norm), True),
        ("i420 10bit 3x150x322->70x202 f32", "i420",
         make_planes("i420", 3, 322, 150, device, 6, torch.uint16, 10), rag,
         dict(out_dtype=torch.float32), False),
        ("nv12 N=1 1080p->224", "nv12", [nv[0][:1]], to224, {}, False),
    ]
    for kind in KINDS:
        out.append((f"{kind} ragged 3x150x322->70x202", kind,
                    make_planes(kind, 3, 322, 150, device, 7), rag, {},
                    False))
        out.append((f"{kind} misaligned padded view 5x62x130->30x34", kind,
                    make_planes(kind, 5, 130, 62, device, 8,
                                pad=(3, 5, 1)),
                    dict(src_w=130, src_h=62, dst_w=34, dst_h=30), {},
                    False))
    return out


def work(kind: str, planes, geo: dict, kw: dict):
    """(bytes, operations) of one call: the planes read once, the output
    written once, the FMAs of the bands and the tail."""
    out = torch.empty((), dtype=kw.get("out_dtype", torch.uint8))
    return preprocess_work(planes[0].shape[0], geo["src_w"], geo["src_h"],
                           geo["dst_w"], geo["dst_h"],
                           {"nv12": "420", "i420": "420"}.get(kind, kind),
                           sample_bytes=planes[0].element_size(),
                           out_bytes=out.element_size())


def sweep(lib, kind, planes, geo, kw, want, keep: int = 8) -> dict:
    """The packer's block geometry against the swept ones at one case:
    each geometry of :func:`preprocess_candidates` at a SWEEP_TILES width (and
    the pick's) timed once with :func:`quick_ms` and checked equal to
    ``want``, then the ``keep`` fastest and the pick with :func:`time_ms`.
    """
    cdt, _ = checked(kind, planes, geo, kw)
    x = planes[0]
    layout = KINDS[kind][2]
    dense = "420" if layout == "nv12" else layout
    bands = banded._layout_bands(geo["src_w"], geo["src_h"], geo["dst_w"],
                                 geo["dst_h"], LANCZOS_AA, dense, cdt)
    cands = sorted(preprocess_candidates(
        bands, layout, SAMPLE_BYTES[x.dtype],
        4 if cdt == torch.float32 else 2, x.shape[0], sm_count(x.device)))
    pick = tuple(tables_for(kind, planes, geo, cdt)[3:-1])
    tiles = {-(-geo["dst_w"] // n) for n in SWEEP_TILES} | {pick[0]}
    quick = []
    for _, g in cands:
        if g[0] not in tiles:
            continue
        fn = launcher(lib, kind, planes, geo, kw, False,
                      tables_for(kind, planes, geo, cdt, block=g))
        if not torch.equal(bits(fn()), bits(want)):
            raise AssertionError(f"block geometry {g} changed the output of "
                                 f"{kind} preprocess")
        quick.append((quick_ms(fn), g))
    quick.sort()
    timed = {}
    for g in [pick] + [g for _, g in quick[:keep] if g != pick]:
        timed[g] = time_ms(launcher(lib, kind, planes, geo, kw, False,
                                    tables_for(kind, planes, geo, cdt,
                                               block=g)))
    best = min(timed, key=timed.get)
    t_pick = next((t for t, g in quick if g == pick), None)
    return dict(candidates=len(cands), swept=len(quick), pick=list(pick),
                pick_ms=timed[pick], best=list(best), best_ms=timed[best],
                faster_than_pick_quick=sum(t < t_pick for t, _ in quick)
                if t_pick is not None else None,
                top=[(t, list(g)) for t, g in quick[:keep]])


def pairs_of(earlier, current, pairs: int) -> dict:
    """``pairs`` alternating pairs of :func:`time_ms` of two calls
    (earlier first in even pairs, current first in odd ones): each side's
    median and range, each pair's earlier / current ratio, and whether
    every ratio lies on one side of 1."""
    old, new = [], []
    for i in range(pairs):
        for tag in (("old", "new") if i % 2 == 0 else ("new", "old")):
            if tag == "old":
                old.append(time_ms(earlier))
            else:
                new.append(time_ms(current))
    ratio = [a / b for a, b in zip(old, new)]
    verdict = ("faster" if min(ratio) > 1 else
               "slower" if max(ratio) < 1 else "not resolved")
    return dict(earlier_ms=statistics.median(old), earlier_range=[
        min(old), max(old)], current_ms=statistics.median(new),
        current_range=[min(new), max(new)], pairs=pairs,
        speedup=statistics.median(ratio), speedup_range=[min(ratio),
                                                         max(ratio)],
        resolved=verdict)


def routed_row(planes, geo: dict, kw: dict, earlier: torch.Tensor,
               earlier_call, pairs: int, timed: bool) -> dict:
    """The tensor-core route's part of a row: its output against the
    wrapper's, the earlier kernel's (``earlier``) and the plain version's,
    each lab arm's equality with it, and at a timed case ``pairs`` rounds
    of the earlier kernel (``earlier_call``), the route and the lab arms,
    and the route's device time by kernel name."""
    rcall = routed_launcher(planes, geo, kw)
    labs = {arm: lab_launcher(arm, planes, geo, kw) for arm in LAB_ARMS}
    r = bits(rcall().clone())
    wrapper = bits(product_call("nv12", planes, geo, kw))
    plain = bits(nv12_mod.nv12_preprocess_plain(*planes, **geo, **kw))
    torch.cuda.synchronize()
    row = dict(routed_wrapper_equal=bool(torch.equal(r, wrapper)),
               routed_vs_earlier=differ(r, earlier),
               routed_vs_plain=differ(r, plain))
    row.update({f"{arm}_equal": bool(torch.equal(bits(fn()), r))
                for arm, fn in labs.items()})
    if timed:
        times = rounds({"earlier": earlier_call, "routed": rcall, **labs},
                       pairs)
        row.update(summary(times, [("earlier", "routed")] + [
            ("routed", arm) for arm in labs]))
        row["routed_device_ms"] = kernel_ms({"routed": rcall})["routed"]
    return row


def run(source: str, pairs: int = 10, knockouts: bool = False,
        swept: bool = False, variants=(), log=print):
    builds = {"earlier": build_earlier(source),
              "current": _cuda_build.load_kernels()}
    extra = {" ".join(v): build_current(v) for v in variants}
    if knockouts:
        builds.update({f"knockout{m}": build_current(
            [f"-DBANDED_PREPROCESS_KNOCKOUT={m}"]) for m in (1, 2, 3)})
    strips8 = not takes_geometry(source)   # the earlier 8-row design
    rows = []
    for name, kind, planes, geo, kw, timed in cases(torch.device("cuda", 0)):
        cdt, _ = checked(kind, planes, geo, kw)
        calls = {tag: launcher(lib, kind, planes, geo, kw,
                               tag == "earlier" and strips8)
                 for tag, lib in builds.items()}
        a = bits(calls["earlier"]().clone())
        b = bits(calls["current"]().clone())
        product = bits(fma_call(kind, planes, geo, kw))
        torch.cuda.synchronize()
        t = tables_for(kind, planes, geo, cdt)
        route = (nv12_mod.nv12_route(*planes, **geo, **kw)
                 if kind == "nv12" else "banded")
        row = dict(name=name, samples=b.numel(), route=route,
                   differ=int((a != b).sum().item()),
                   wrapper_equal=bool(torch.equal(b, product)),
                   geometry=[int(v) for v in t[3:-1]])
        if route == "wgmma":
            row.update(routed_row(planes, geo, kw, a, calls["earlier"],
                                  pairs, timed))
        if timed:
            bound, by = bound_ms(*work(kind, planes, geo, kw))
            row.update(bound_ms=bound, bound_by=by)
        if timed and route == "banded":   # the FMA kernel is the product's
            row.update(pairs_of(calls["earlier"], calls["current"], pairs))
            for tag in builds:
                if tag.startswith("knockout"):
                    row[f"{tag}_ms"] = time_ms(calls[tag])
            for tag, lib in extra.items():
                fn = launcher(lib, kind, planes, geo, kw, False, t)
                if not torch.equal(bits(fn()), product):
                    raise AssertionError(f"{tag} changed {name}")
                row[f"{tag} ms"] = time_ms(fn)
            if swept:
                row["sweep"] = sweep(builds["current"], kind, planes, geo,
                                     kw, product)
        log(json.dumps(row))
        rows.append(row)
        del a, b, product, calls
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/banded_preprocess.cu, "
                                    "its headers beside it")
    ap.add_argument("--pairs", type=int, default=10,
                    help="alternating earlier / current timing pairs a "
                         "timed case (default 10)")
    ap.add_argument("--knockouts", action="store_true",
                    help="also time the current source with its W pass, "
                         "its H pass, and both knocked out")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the block geometries the packer "
                         "weighs at each timed case")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=V[,NAME=V]",
                    help="also time the current source built with these "
                         "-D knobs (e.g. BANDED_PREPROCESS_H_ROWS=4)")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("preprocess_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    variants = [[f"-D{kv}" for kv in v.split(",")] for v in args.variant]
    rows = run(args.earlier, args.pairs, args.knockouts, args.sweep,
               variants, log=lambda s: print(s, flush=True))
    report = routed_report()
    print(json.dumps(report), flush=True)
    bad = [r["name"] for r in rows if failed(r)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "routed_kernel": report, "rows": rows},
                      f, indent=1)
    print(f"cases that differ from the earlier kernel or the FMA kernel's "
          f"entry, or whose route leaves the envelope or the lab's bits: "
          f"{bad or 'none'}")
    return 1 if bad else 0


def failed(row: dict) -> bool:
    """A row's FMA kernel differs from the earlier one or from its entry,
    or its tensor-core route differs from the wrapper or the lab's T16 and
    S2 t16a8, or leaves the kernels' uint8 envelope of the earlier kernel
    or of the plain version."""
    if row["differ"] or not row["wrapper_equal"]:
        return True
    if row["route"] != "wgmma":
        return False
    n = row["samples"]
    return not (row["routed_wrapper_equal"]
                and all(row[f"{arm}_equal"] for arm in LAB_ARMS)
                and within_envelope(row["routed_vs_earlier"], n)
                and within_envelope(row["routed_vs_plain"], n))


def routed_report() -> dict:
    """The route's kernel from ``nvcc -Xptxas -v`` (registers, spills, the
    C75xx warnings) and its dynamic shared memory at 64 x 1080p -> 224."""
    ptxas = ptxas_report("nv12_wgmma_preprocess.cu",
                         lambda n: "routed" if "preprocess_kernel" in n
                         else None)
    t = banded.static2_tables(1920, 1080, 224, 224, LANCZOS_AA,
                              nv12_mod.WGMMA_TILE, nv12_mod.WGMMA_ALIGN)
    return dict(ptxas, smem_bytes_1080p_224=banded.static2_smem_bytes(
        nv12_mod.WGMMA_TILE, t.k_luma, t.k_chroma))


if __name__ == "__main__":
    sys.exit(main())
