"""Kernel times on the card with CUDA events, and the least time the card
could take for the same work.

:func:`time_cuda` is the port's counterpart of the TPU notebook's
two-point slope (``bench_kernel_variants.time_fn``): on the card a kernel
is timed directly with CUDA events around back-to-back calls, so the host
launch latency overlaps device work and needs no slope to cancel it.

:func:`bound_ms` is the roofline bound: the larger of the bytes a function
must move (each input read once, each output written once) over the
card's memory rate and its operations over the card's peak rate, with the
H100 SXM data-sheet figures below. The ``*_work`` helpers count those
bytes and operations for the banded kernels from their band tables.
"""

from __future__ import annotations

import statistics
from typing import Callable, List, Optional, Tuple

import torch

from ..ops.banded import band_table, dense_weights
from ..ops.resize import LANCZOS_AA, resize_weights

#: H100 SXM data sheet (dense rates): device memory 3.35 TB/s, bf16
#: tensor cores 989 TFLOP/s — the least time takes the fastest type that
#: computes the bf16 cast points
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
#: operations of the CSC and quantise tail per output pixel: 3 offsets,
#: 9 products, 6 sums, 3 round/clip
CSC_OPS = 21

TIMED_RUNS = 21
CALLS_PER_SAMPLE = 5


def _samples(fn: Callable[[], object], samples: int,
             calls: int) -> List[float]:
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def time_ms(fn: Callable[[], object], samples: int = TIMED_RUNS,
            calls: int = CALLS_PER_SAMPLE) -> float:
    """Median ms of one call of ``fn()``: ``samples`` samples, each CUDA
    events around ``calls`` back-to-back calls, after warm-up."""
    return statistics.median(_samples(fn, samples, calls))


def time_spread(fn: Callable[[], object], samples: int = TIMED_RUNS,
                calls: int = CALLS_PER_SAMPLE) -> Tuple[float, float]:
    """(median ms of one call of ``fn()``, relative spread
    (max - min) / median of the samples), timed as :func:`time_ms`."""
    times = _samples(fn, samples, calls)
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med


def time_cuda(fn: Callable[[torch.Tensor], object],
              x: torch.Tensor) -> Tuple[float, float]:
    """:func:`time_spread` of ``fn(x)``."""
    return time_spread(lambda: fn(x))


def bound_ms(nbytes: float, ops: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations": which of the two bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _taps(dense) -> int:
    """Source samples all outputs of a dense resampling matrix read."""
    return int(band_table(dense, torch.float32)[1].sum())


def preprocess_work(batch: int, src_w: int, src_h: int, dst_w: int,
                    dst_h: int, layout: str = "420", h_pass: bool = True,
                    w_pass: bool = True,
                    h_fmas: Optional[int] = None,
                    w_fmas: Optional[int] = None, sample_bytes: int = 1,
                    out_bytes: int = 1) -> Tuple[int, int]:
    """(bytes, operations) of a lanczos_aa banded preprocess batch of
    chroma ``layout``, ``sample_bytes`` a source sample and ``out_bytes``
    an output sample (uint8 -> uint8 by default): the H pass over every
    luma and chroma column, the W pass and the CSC tail (one FMA is two
    operations). ``h_pass=False`` counts the work of the lab's wpass
    knock-out (two dst_h-row slabs in, no H pass), ``w_pass=False`` that
    of its hpass knock-out. ``h_fmas`` replaces the H pass's FMAs per
    frame by the count a lab variant runs, zero weights included (S2's
    strip windows, G's dense block-diagonal product), and ``w_fmas`` the W
    pass's (G's products over each output tile's band)."""
    dw = dense_weights(src_w, src_h, dst_w, dst_h, LANCZOS_AA, layout)
    cw = src_w if layout == "444" else src_w // 2   # one chroma plane row
    c_rows = src_h // 2 if layout == "420" else src_h
    out = batch * 3 * dst_h * dst_w * out_bytes
    ops = 0
    if h_pass:
        ops += 2 * (h_fmas if h_fmas is not None else
                    _taps(dw.luma_h) * src_w + 2 * _taps(dw.chroma_h) * cw)
        nbytes = batch * (src_h * src_w + 2 * c_rows * cw) * sample_bytes
    else:
        nbytes = batch * 2 * dst_h * src_w
    if w_pass:
        ops += 2 * (w_fmas if w_fmas is not None else
                    dst_h * (_taps(dw.luma_w) + 2 * _taps(dw.chroma_w)))
        ops += CSC_OPS * dst_h * dst_w
    else:
        ops += 2 * dst_h * dst_w
    return nbytes + out, batch * ops


def nv12_resize_work(batch: int, src_h: int, src_w: int, dst_h: int,
                     dst_w: int, h_pass: bool = True, w_pass: bool = True,
                     chroma: bool = True, h_fmas: Optional[int] = None,
                     w_fmas: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, operations) of a uint8 lanczos_aa banded NV12 resize batch:
    the NV12 frames read once, the output written once, and the FMAs of
    the bands (one FMA is two operations). Luma and the interleaved UV
    rows resample as their own images (chroma on the half grid, both
    channels of a pair). ``chroma=False`` counts the lab's knock-outs,
    which write the luma rows only: no chroma W pass or output, while
    their chroma H pass still counts with ``h_pass``. Alignment slack is
    not work the function needs, so the full-function variants on the
    CUDA cores have the product's count; ``h_fmas`` and ``w_fmas`` replace
    the H and W passes' FMAs per frame by the count a lab variant issues,
    zero weights included (the aligned kernel's tensor-core products)."""
    luma_h = _taps(resize_weights(src_h, dst_h, LANCZOS_AA))
    chroma_h = _taps(resize_weights(src_h // 2, dst_h // 2, LANCZOS_AA))
    luma_w = _taps(resize_weights(src_w, dst_w, LANCZOS_AA))
    chroma_w = _taps(resize_weights(src_w // 2, dst_w // 2, LANCZOS_AA))
    out_rows = dst_h + (dst_h // 2 if chroma else 0)
    fmas = 0
    if h_pass:   # a chroma row has src_w lanes: src_w / 2 pairs
        fmas += (h_fmas if h_fmas is not None else
                 (luma_h + chroma_h) * src_w)
    if w_pass:
        fmas += (w_fmas if w_fmas is not None else dst_h * luma_w
                 + (dst_h // 2 * 2 * chroma_w if chroma else 0))
    nbytes = batch * (src_h * 3 // 2 * src_w + out_rows * dst_w)
    return nbytes, 2 * batch * fmas


#: the staged convert's tile (csrc/nv12_convert_staged.cu): output rows
#: by pixels; and the FLOPs its products issue a pixel, zeros included: V1
#: two m64n48k16 a 16-pixel span, V2 two m64n24k16
STAGED_TILE = (64, 128)
STAGED_FLOPS = {"V1": 2 * 2 * 48 * 16 // 16, "V2": 2 * 2 * 24 * 16 // 16}


def convert_work(batch: int, src_w: int, src_h: int, rows: int,
                 probe: str = "", variant: str = "") -> Tuple[int, int]:
    """(bytes, operations) of a uint8 NV12 -> packed RGB batch on frames of
    ``rows`` buffer rows: the NV12 frame read once, [H, 3W] written once,
    CSC_OPS per pixel. ``variant`` (V1 or V2) counts the FLOPs the staged
    convert's products issue instead, zeros included, over its whole tiles
    (STAGED_TILE: the ragged band and column tile too). ``probe`` counts
    the convert lab's probes instead:
    ``dma`` reads every row of the buffer and ``inonly`` too (one XOR per
    32-bit word, into the sink); ``inonly`` writes [8, 128] (its sums),
    ``outonly`` and ``outband`` read 8 rows; none of those three does the
    CSC. ``noquant`` and ``noh`` are the full function's work."""
    out = 3 * src_h * src_w
    frame = src_h * 3 // 2 * src_w
    if variant:
        th, tw = STAGED_TILE
        pixels = -(-src_h // th) * th * -(-src_w // tw) * tw
        return batch * (frame + out), batch * STAGED_FLOPS[variant] * pixels
    if probe in ("", "noquant", "noh"):
        return batch * (frame + out), batch * CSC_OPS * src_h * src_w
    read = 8 * src_w if probe in ("outonly", "outband") else rows * src_w
    if probe == "inonly":
        out = 8 * 128
        sums = 8 * 128 * -(-rows // 512)
    else:
        sums = 0
    return batch * (read + out), batch * (read // 4 + sums)


def fcn_work(batch: int, h: int, w: int, widths: Tuple[int, ...],
             num_classes: int, in_bytes: int = 4, act_bytes: int = 2
             ) -> Tuple[int, int, int]:
    """(bytes, layer bytes, operations) of one FCN forward
    (``models/fcn.py``) on a [batch, h, w, 3] input of ``in_bytes``
    samples: the input read once and the logits written once; the same
    plus every layer's ``act_bytes`` activations written and read back
    once (what a layer-by-layer run must move); and two operations per
    multiply-add of the convolutions at their SAME output sizes."""
    ops, acts, cin, oh, ow = 0, 0, 3, h, w
    layers = [(3, 2 if 0 < i < 4 else 1, c) for i, c in enumerate(widths)]
    for k, s, cout in layers + [(1, 1, num_classes)]:
        oh, ow = -(-oh // s), -(-ow // s)
        ops += 2 * oh * ow * cout * cin * k * k
        acts += oh * ow * cout
        cin = cout
    io = h * w * 3 * in_bytes + oh * ow * num_classes * act_bytes
    inner = (acts - oh * ow * num_classes) * 2 * act_bytes
    return batch * io, batch * (io + inner), batch * ops


def resize_work(batch: int, src_h: int, src_w: int, dst_h: int, dst_w: int,
                channels: int = 1, method: str = LANCZOS_AA,
                sample_bytes: int = 1) -> Tuple[int, int]:
    """(bytes, operations) of a banded resize of ``batch`` images of
    ``channels`` interleaved channels of ``sample_bytes``-byte samples:
    H pass over every source column, then W pass."""
    taps_h = _taps(resize_weights(src_h, dst_h, method))
    taps_w = _taps(resize_weights(src_w, dst_w, method))
    nbytes = sample_bytes * batch * channels * (src_h * src_w
                                                + dst_h * dst_w)
    ops = 2 * batch * channels * (taps_h * src_w + dst_h * taps_w)
    return nbytes, ops
