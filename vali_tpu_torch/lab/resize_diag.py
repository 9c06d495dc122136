"""4K NV12 resize lab: where the banded NV12 resize kernel's time goes,
run on the card.

Counterpart of the TPU notebook ``resize_diag.py`` (its ``main``,
``main_aligned``, ``main_skewed``, ``main_streamed``, ``main_slabs`` and
``main_striped``). Six wrappers
over the kernels of ``csrc/nv12_phases.cu``, ``csrc/nv12_aligned.cu``,
``csrc/nv12_skewed.cu``, ``csrc/nv12_streamed.cu``,
``csrc/nv12_slabs.cu`` and ``csrc/nv12_striped.cu``, each beside its
plain PyTorch version, with the same dispatch as the product wrappers: a CUDA
tensor launches the kernel, a CPU tensor runs the plain version, any other
device raises. uint8 NV12 in, bf16 compute, lanczos_aa.

- :func:`resize_phases` (``variant``): the luma resize with a phase
  knocked out, as the notebook computes it where unwritten scratch reads
  as zero, on ``aligned``'s tensor-core block at 8x32. ``both`` is the
  luma rows of :func:`aligned_resize` (so within the uint8 envelope of
  :func:`nv12_resize`'s); ``h_only`` the H pass of luma and chroma, with
  output lanes < LANE_TILE the luma H-pass rows truncated to int and cut
  to their low byte (within :func:`h_only_tolerance` of its plain
  version); ``w_only`` the luma W pass of H-pass rows that are the frame's
  first TILE rows, then zeros; ``dma_only`` the frame's first TILE rows x
  LANE_TILE lanes. On the card what a mode must not drop goes into a sink,
  so ``h_only - dma_only`` and ``w_only - dma_only`` are the H and W costs
  over a stream of the same bytes.
- :func:`aligned_resize` (``aligned``): the full resize with both passes
  as products on the tensor cores (wgmma fed by a cp.async ring) over
  aligned windows: each strip's source-row window aligned to ``h_align``
  rows and each output column's tap range to ``w_align`` lanes (zero taps
  added). Within 1 LSB on fewer than 1e-3 of the samples of
  :func:`nv12_resize`.
- :func:`skewed_resize` (``skewed``): the full resize with frame b's H pass
  beside frame b - 1's W pass inside one block, ``aligned``'s tensor-core
  passes at 8x32 split between a producer and a consumer warpgroup over
  ``frames_per_block`` frames; equal to ``aligned8x32``.
- :func:`streamed_resize` (``streamed``): the full resize with each block
  walking down the frame, source rows copied in bands of ``band`` rows by
  TMA into an ``mbarrier`` ring under ``aligned``'s tensor-core passes at
  8x32; equal to ``aligned8x32``.
- :func:`slabs_resize` (``slabs``): the full resize with the NV12 buffer's
  rows cut into ``nslabs`` slabs; each H-pass sum is one fp32 partial per
  slab piece of its window (on the card ``aligned``'s tensor-core passes
  at 8x32, each piece staged by TMA boxes against its own mbarrier), added
  in slab order. Equal to ``aligned8x32`` where no row band straddles a
  slab edge, within 1 LSB on fewer than 1e-3 of the samples of
  :func:`nv12_resize` everywhere.
- :func:`striped_resize` (``striped``): the full resize with each strip's
  H pass cut into ``nw`` column stripes on ``aligned``'s tensor-core
  passes at 8x32; ``store`` dyn or unroll (the stripes of a strip one
  thread-block cluster that trades the W tiles' halo through distributed
  shared memory) or relay (the H rows through device memory). Equal to
  ``aligned8x32``.

On the card every full-function variant runs the tensor cores, so it
lies within the uint8 envelope of :func:`nv12_resize` (``skewed``,
``streamed`` and ``striped`` equal ``aligned8x32`` bit for bit, ``both``
its luma rows); on the CPU its plain version is the product's, split as
the variant splits it.

Run the lab (16 x 4K -> 1080p on ``cuda:0``; ``--device cpu`` runs the
plain versions at 3 x 512x288 -> 256x144 and times nothing)::

    python -m vali_tpu_torch.lab.resize_diag [NAME ...] [--device cpu]

Names: ``prod`` (:func:`nv12_resize` itself), ``dma_only``, ``h_only``,
``w_only``, ``both``, ``aligned{h}x{w}`` (``aligned8x32``),
``skewed{G}`` (``skewed2``, ``skewed4``, ``skewed8``; ``skewed``: G the
batch), ``streamed{band}`` (``streamed64``), ``slabs{n}`` (``slabs4``),
``striped{nw}{dyn|relay|unroll}`` (``striped3dyn``). Each prints one line: ms
per batch, spread, maxdiff against its reference (``h_only``: the low
bytes' distance mod 256), GB/s and the bound; on the card also the H/W
split as shares of ``prod``.
"""

from __future__ import annotations

import argparse
import functools
import re
import subprocess
import sys
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..ops.banded import (BLOCK_RESERVED_SMEM, SM_SMEM, SMEM_LIMIT,
                          ResizeTables, STRIP_ROWS, band_table,
                          core_matrix_order, fragment_order,
                          pack_resize_tables, resize_tables, sm_count,
                          tile_window)
from ..ops.fused import exact_f32_matmul, to_f32
from ..ops.nv12_resize import nv12_resize, nv12_resize_plain
from ..ops.resize import (LANCZOS_AA, from_f32, resize_plane, resize_weights,
                          round_to)
from .kernel_variants import SINK_WORDS, _on_cpu, make_frames
from .timing import bound_ms, nv12_resize_work, time_cuda

#: the TPU notebook's constants that define the knock-outs' outputs:
#: H-pass rows per matrix-unit step, output lanes per W-pass step
TILE = 32
LANE_TILE = 128
MODES = {"both": 0, "h_only": 1, "w_only": 2, "dma_only": 3}

DEFAULT_NAMES = ("prod", "dma_only", "h_only", "w_only", "both",
                 "aligned8x32", "aligned32x128", "aligned4x16", "skewed2",
                 "skewed4", "skewed8", "skewed",
                 "streamed64", "streamed256", "slabs2", "slabs4", "slabs6",
                 "striped3dyn", "striped5dyn", "striped3relay",
                 "striped3unroll")
CARD_SIZE = (16, 3840, 2160, 1920, 1080)   # batch, W, H, DW, DH
CPU_SIZE = (3, 512, 288, 256, 144)

_BF16 = torch.bfloat16


def _checked(nv12, src_w, src_h, dst_w, dst_h) -> None:
    """Validate a uint8 NV12 buffer [B, >= H*3/2, W] and the geometry."""
    if (nv12.dim() != 3 or nv12.shape[1] < src_h * 3 // 2
            or nv12.shape[2] != src_w):
        raise ValueError(f"NV12 buffer shape {tuple(nv12.shape)} does not "
                         f"match {src_w}x{src_h}")
    if nv12.dtype != torch.uint8:
        raise ValueError(f"the resize lab takes uint8 samples, got "
                         f"{nv12.dtype}")
    if (src_w % 2 or src_h % 2 or dst_w % 2 or dst_h % 2 or dst_w <= 0
            or dst_h <= 0):
        raise ValueError("NV12 resize needs even, positive dims")


def _tables(src_w, src_h, dst_w, dst_h, device, build, **knobs):
    """(luma, chroma) tables of ``build`` (a table builder of one plane,
    keyed by channels and device)."""
    return (build(src_h, dst_h, src_w, dst_w, channels=1, device=device,
                  **knobs),
            build(src_h // 2, dst_h // 2, src_w // 2, dst_w // 2,
                  channels=2, device=device, **knobs))


def _product_tables(src_h, dst_h, src_w, dst_w, *, channels, device):
    return resize_tables(src_h, dst_h, src_w, dst_w, LANCZOS_AA, _BF16,
                         channels, device)


def _full_out(nv12, dst_w, dst_h) -> torch.Tensor:
    return torch.empty((nv12.shape[0], dst_h * 3 // 2, dst_w),
                       dtype=torch.uint8, device=nv12.device)


# --- the knock-outs (notebook ``variant``) ---------------------------------

def resize_phases_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                        dst_w: int, dst_h: int, mode: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`resize_phases` (any device)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    _checked(nv12, src_w, src_h, dst_w, dst_h)
    luma = nv12[:, :src_h]
    if mode == "both":
        return resize_plane(luma, dst_h, dst_w, LANCZOS_AA,
                            compute_dtype=_BF16)
    dev = nv12.device
    out = torch.zeros((nv12.shape[0], dst_h, dst_w), dtype=torch.uint8,
                      device=dev)
    rows = min(TILE, dst_h, src_h * 3 // 2)
    lanes = min(LANE_TILE, dst_w, src_w)
    if mode == "dma_only":
        out[:, :rows, :lanes] = nv12[:, :rows, :lanes]
    elif mode == "h_only":
        wh = round_to(resize_weights(src_h, dst_h, LANCZOS_AA), _BF16).to(dev)
        with exact_f32_matmul():
            yh = round_to(torch.matmul(wh, to_f32(luma[..., :lanes])), _BF16)
        # the notebook's astype(int32).astype(uint8): truncate, low byte
        out[..., :lanes] = (yh.to(torch.int32) & 255).to(torch.uint8)
    else:   # w_only
        ww = round_to(resize_weights(src_w, dst_w, LANCZOS_AA), _BF16).to(dev)
        yh = torch.zeros((nv12.shape[0], dst_h, src_w), device=dev)
        yh[:, :rows] = to_f32(nv12[:, :rows])
        with exact_f32_matmul():
            out = torch.clamp(torch.round(torch.matmul(yh, ww.T)), 0.0,
                              255.0).to(torch.uint8)
    return out


def resize_phases(nv12: torch.Tensor, *, src_w: int, src_h: int, dst_w: int,
                  dst_h: int, mode: str,
                  sink: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The luma NV12 resize with phases knocked out -> [B, dst_h, dst_w]
    uint8 (``mode``: both, h_only, w_only, dma_only; see the module), on
    ``aligned``'s tensor-core block at 8x32 (:func:`phases_tables`).

    On the card each block XORs into one of the int32 words of ``sink`` (a
    fresh zeroed one of SINK_WORDS when None) what its mode would otherwise
    drop: the H-pass values (h_only: luma and chroma; both: chroma), or its
    share of the frame's bytes (w_only, dma_only: each byte by one block,
    so the XOR of the sink after a call on a zeroed sink is the XOR of
    every 32-bit word of the frames' H*3/2 rows). Raises ValueError for a
    geometry the block cannot take (:func:`phases_refusal`), on either
    device."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    _checked(nv12, src_w, src_h, dst_w, dst_h)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = phases_refusal(**geo)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("resize_phases", nv12):
        return resize_phases_plain(nv12, **geo, mode=mode)
    if sink is None:
        sink = torch.zeros(SINK_WORDS, dtype=torch.int32, device=nv12.device)
    if (sink.dtype != torch.int32 or sink.device != nv12.device
            or not sink.is_contiguous() or sink.numel() < 1):
        raise ValueError("sink must be a contiguous int32 tensor on the "
                         "frames' device")
    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    out = torch.empty((nv12.shape[0], dst_h, dst_w), dtype=torch.uint8,
                      device=nv12.device)
    _phases_call(nv12, geo, mode, nv12.shape[0], sink, out.data_ptr(), None)
    resize_phases.launches += 1
    return out


def _phases_call(nv12, geo, mode, batch, sink, out, resident):
    """One call of the phases launcher (``batch`` 0: the residency query
    alone)."""
    from ..ops._cuda_build import check, load_lab_kernels

    args, _ = _phases_device(geo["src_w"], geo["src_h"], geo["dst_w"],
                             geo["dst_h"], nv12.device)
    lib = load_lab_kernels()
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_resize_phases_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), batch,
            geo["src_h"], geo["src_w"], geo["dst_h"], geo["dst_w"], *args,
            MODES[mode], sink.data_ptr(), sink.numel(), resident, out,
            torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "resize_phases")


# --- aligned windows (notebook ``aligned``) --------------------------------

def _rebase(start, count, weights, new_start, new_count):
    """Bands moved to start at ``new_start`` with ``new_count`` taps:
    weight k of a band goes to tap k + start - new_start, the added taps
    weigh 0."""
    taps = np.zeros((len(start), max(1, int(new_count.max(initial=0)))),
                    np.float32)
    off = start - new_start
    for o in range(len(start)):
        taps[o, off[o]:off[o] + count[o]] = weights[o, :count[o]]
    return new_start.astype(np.int32), new_count.astype(np.int32), taps


def align_rows(bands, rows: int, align: int, n_in: int):
    """Row bands widened to their strip's window of source rows (strips of
    ``rows`` output rows), which starts at a multiple of ``align`` and
    ends at one, clamped to the ``n_in`` rows of the plane."""
    start, count, weights = bands
    lo = np.empty_like(start)
    hi = np.empty_like(start)
    for s in range(0, len(start), rows):
        a = int(start[s:s + rows].min()) // align * align
        b = -(-int((start + count)[s:s + rows].max()) // align) * align
        lo[s:s + rows], hi[s:s + rows] = a, min(b, n_in)
    return _rebase(start, count, weights, lo, hi - lo)


def align_cols(bands, align: int, n_in: int):
    """Column bands that start at a multiple of ``align`` source pixels,
    their length rounded up to one, clamped to the ``n_in`` pixels of the
    row."""
    start, count, weights = bands
    lo = start // align * align
    hi = np.minimum(-(-(start + count) // align) * align, n_in)
    return _rebase(start, count, weights, lo, hi - lo)


@functools.lru_cache(maxsize=32)
def aligned_tables(src_h: int, dst_h: int, src_w: int, dst_w: int, *,
                   channels: int, device: torch.device, h_align: int,
                   w_align: int) -> ResizeTables:
    """The product's band tables with each strip's row window aligned to
    ``h_align`` rows and each column's tap range to ``w_align`` lanes
    (``w_align // channels`` pixels, at least 1)."""
    rows = align_rows(band_table(resize_weights(src_h, dst_h, LANCZOS_AA),
                                 _BF16), STRIP_ROWS, h_align, src_h)
    cols = align_cols(band_table(resize_weights(src_w, dst_w, LANCZOS_AA),
                                 _BF16), max(1, w_align // channels), src_w)
    return pack_resize_tables(rows, cols, _BF16, channels, device)


class AlignedPlane(NamedTuple):
    """One plane's tables of :func:`aligned_resize` (csrc/nv12_aligned.cu).

    H pass: per strip of ALIGNED_ROWS output rows, ``starts`` [strips]
    int32, the first plane row of its window of ``k_pad`` rows, and
    ``weights`` [strips, ALIGNED_ROWS, k_pad] float32 of bf16 values, each
    output row's band at its rows of the window (rows past the plane read
    its last row and weigh 0). W pass: per tile of ALIGNED_W_TILE output
    pixels, ``heads`` [tiles, 3] int32 (its first k-step in ``frags``, its
    first source pixel, a multiple of 8, and its k-steps of 16 pixels) and
    ``frags`` [k-steps, 128, 8] float32 of bf16 values, the tile's [64,
    16 k] weights in wgmma's register fragments (``fragment_order``).
    Blocks: ``ranges`` [n, 4] int32, per run of tiles its first tile, its
    tiles, its first H pixel (a multiple of 16 bytes of a row) and its H
    pixels (a multiple of 16) covering its tiles' bands; ``hcols`` the
    widest."""
    starts: np.ndarray
    weights: np.ndarray
    heads: np.ndarray
    frags: np.ndarray
    ranges: np.ndarray

    @property
    def k_pad(self) -> int:
        return self.weights.shape[2]

    @property
    def hcols(self) -> int:
        return int(self.ranges[:, 3].max())


#: output rows of a strip of the aligned kernel (its kRows: N of the H
#: product), output pixels of a W tile (wgmma's M), bytes of a ring stage,
#: ring stages, the most window rows (K) it is compiled for
ALIGNED_ROWS = 32
ALIGNED_W_TILE = 64
ALIGNED_STAGE_COLS = 128
ALIGNED_STAGES = 3
ALIGNED_MAX_K = 256
#: shared memory of a block when two share an SM
ALIGNED_TWO_BLOCKS = SM_SMEM // 2 - BLOCK_RESERVED_SMEM


def aligned_smem_bytes(channels: int, hcols: int, k_pad: int) -> int:
    """Shared memory of one block of the aligned kernel: its tiled H rows
    (ALIGNED_ROWS rows, chroma's U and V rows each, of ``hcols`` pixels;
    column groups of 8 padded by 16 bytes), B and the ring."""
    group = 16 * ALIGNED_ROWS * channels + 16
    return (hcols // 8 * group + 2 * k_pad * ALIGNED_ROWS
            + ALIGNED_STAGES * k_pad * ALIGNED_STAGE_COLS)


def _split(n: int, parts: int) -> List[Tuple[int, int]]:
    """``n`` items in ``parts`` runs as even as can be: (first, count)."""
    edges = [n * i // parts for i in range(parts + 1)]
    return [(a, b - a) for a, b in zip(edges, edges[1:])]


@functools.lru_cache(maxsize=32)
def aligned_plane_tables(n_in: int, n_out: int, px: int, ow: int,
                         channels: int, h_align: int,
                         w_align: int) -> AlignedPlane:
    """The tables of one plane of ``n_in`` rows of ``px`` pixels
    (``channels`` interleaved) resized to ``n_out`` rows of ``ow``.

    Row windows: each strip's rows' bf16 bands (:func:`align_rows`)
    widened to ``h_align`` rows, then with zeros to k_pad, the widest
    rounded up to 16, pulled back to stay inside the plane. Tile bands: the
    union of its columns' tap ranges widened to ``w_align // channels``
    pixels (:func:`align_cols`), started on a multiple of 8 and run in
    whole k-steps of 16, kept inside the plane's width rounded up to 16.
    Ranges: the fewest runs of tiles (split evenly) whose H columns leave a
    block two to an SM; one tile a run where none do."""
    bf = _BF16
    start, count, w = band_table(resize_weights(n_in, n_out, LANCZOS_AA), bf)
    lo, span, _ = align_rows((start, count, w), ALIGNED_ROWS, h_align, n_in)
    k_pad = max(16, -(-int(span.max()) // 16) * 16)
    strips = -(-n_out // ALIGNED_ROWS)
    first = lo[::ALIGNED_ROWS]
    starts = np.maximum(0, np.minimum(first, n_in - k_pad)).astype(np.int32)
    weights = np.zeros((strips, ALIGNED_ROWS, k_pad), np.float32)
    for o in range(n_out):
        s = o // ALIGNED_ROWS
        off = int(start[o] - starts[s])
        weights[s, o % ALIGNED_ROWS, off:off + count[o]] = w[o, :count[o]]

    cs, cc, cw = band_table(resize_weights(px, ow, LANCZOS_AA), bf)
    clo, cn, _ = align_cols((cs, cc, cw), max(1, w_align // channels), px)
    wp = -(-px // 16) * 16
    tiles = -(-ow // ALIGNED_W_TILE)
    heads = np.zeros((tiles, 3), np.int32)
    frags, step = [], 0
    for t in range(tiles):
        oc = np.arange(ALIGNED_W_TILE * t, min(ALIGNED_W_TILE * (t + 1), ow))
        c0 = int(clo[oc].min()) // 8 * 8
        nk = -(-(int((clo + cn)[oc].max()) - c0) // 16)
        c0 = min(c0, wp - 16 * nk)
        a = np.zeros((ALIGNED_W_TILE, 16 * nk), np.float32)
        for m, o in enumerate(oc):
            a[m, cs[o] - c0:cs[o] - c0 + cc[o]] = cw[o, :cc[o]]
        frags.append(fragment_order(a))
        heads[t] = (step, c0, nk)
        step += nk

    ranges = _fewest_ranges(
        heads, channels, lambda r: aligned_smem_bytes(
            channels, int(r[:, 3].max()), k_pad) <= ALIGNED_TWO_BLOCKS)
    if ranges is None:
        ranges = _column_ranges(heads, channels, tiles)
    return AlignedPlane(starts, weights, heads, np.concatenate(frags),
                        ranges)


def _column_ranges(heads: np.ndarray, channels: int,
                   parts: int) -> np.ndarray:
    """The W tiles of ``heads`` in ``parts`` runs (split evenly), each with
    the H columns that cover its tiles' bands: [parts, 4] int32 of its
    first tile, its tiles, its first H pixel (a multiple of 16 bytes of a
    row) and its H pixels (a multiple of 16)."""
    out = np.zeros((parts, 4), np.int32)
    for i, (t0, n) in enumerate(_split(len(heads), parts)):
        c0s = heads[t0:t0 + n, 1]
        x0 = int(c0s.min()) // (16 // channels) * (16 // channels)
        hi = int((c0s + 16 * heads[t0:t0 + n, 2]).max())
        out[i] = (t0, n, x0, -(-(hi - x0) // 16) * 16)
    return out


def _fewest_ranges(heads: np.ndarray, channels: int,
                   fits: Callable[[np.ndarray], bool]
                   ) -> Optional[np.ndarray]:
    """The :func:`_column_ranges` of the fewest runs that ``fits``, or None
    where not even one tile a run does."""
    for parts in range(1, len(heads) + 1):
        ranges = _column_ranges(heads, channels, parts)
        if fits(ranges):
            return ranges
    return None


def _aligned_planes(src_w, src_h, dst_w, dst_h, h_align, w_align):
    """(luma, chroma) :class:`AlignedPlane` tables."""
    return (aligned_plane_tables(src_h, dst_h, src_w, dst_w, 1, h_align,
                                 w_align),
            aligned_plane_tables(src_h // 2, dst_h // 2, src_w // 2,
                                 dst_w // 2, 2, h_align, w_align))


def aligned_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                    h_align: int, w_align: int) -> str:
    """Why the aligned kernel cannot take this geometry, or "" when it
    can: a window of more than ALIGNED_MAX_K rows, or a block's shared
    memory over a block's."""
    for name, ch, t in zip(("luma", "chroma"), (1, 2),
                           _aligned_planes(src_w, src_h, dst_w, dst_h,
                                           h_align, w_align)):
        if t.k_pad > ALIGNED_MAX_K:
            return (f"its {name} windows of {t.k_pad} rows exceed the "
                    f"kernel's {ALIGNED_MAX_K}")
        smem = aligned_smem_bytes(ch, t.hcols, t.k_pad)
        if smem > SMEM_LIMIT:
            return (f"its {name} H rows, weights and ring need {smem} B of "
                    f"shared memory, over a block's {SMEM_LIMIT} B")
    return ""


def aligned_work(batch: int, src_w: int, src_h: int, dst_w: int,
                 dst_h: int, h_align: int, w_align: int) -> Tuple[int, int]:
    """(bytes, operations) of one aligned batch: the product's bytes, and
    the FLOPs its tables issue, zeros included: per strip [ALIGNED_ROWS,
    k_pad] weights times the H columns of each of its ranges (bytes of a
    row), and per strip each tile's [64, 16] A times its ALIGNED_ROWS H
    rows (chroma: U and V) each k-step."""
    (yh, yw), (ch, cw) = (_plane_fmas(t, c) for c, t in zip(
        (1, 2), _aligned_planes(src_w, src_h, dst_w, dst_h, h_align,
                                w_align)))
    return nv12_resize_work(batch, src_h, src_w, dst_h, dst_w,
                            h_fmas=yh + ch, w_fmas=yw + cw)


def _plane_fmas(t: AlignedPlane, channels: int) -> Tuple[int, int]:
    """(H, W) FMAs a frame's plane issues on the tensor cores from tables
    ``t``, zeros included: per strip [ALIGNED_ROWS, k_pad] weights times
    the H columns of each of its ranges (bytes of a row), and per strip
    each tile's [64, 16] A times its ALIGNED_ROWS H rows (chroma: U and V)
    each k-step."""
    strips = t.weights.shape[0]
    return (strips * ALIGNED_ROWS * t.k_pad * channels
            * int(t.ranges[:, 3].sum()),
            strips * ALIGNED_W_TILE * 16 * ALIGNED_ROWS * channels
            * int(t.heads[:, 2].sum()))


def _planes_device(planes, device):
    """A launcher's table arguments on ``device`` for (luma, chroma)
    :class:`AlignedPlane` tables: per plane B in bf16 core-matrix order,
    the window starts, k_pad, the ranges, their count, the H columns, the
    heads and the bf16 A fragments; with the tensors they point into."""
    args, keep = [], []
    for t in planes:
        b, starts, ranges, heads, frags = (
            torch.from_numpy(core_matrix_order(t.weights)).to(device, _BF16),
            torch.from_numpy(t.starts).to(device),
            torch.from_numpy(t.ranges.reshape(-1)).to(device),
            torch.from_numpy(t.heads.reshape(-1)).to(device),
            torch.from_numpy(t.frags).to(device, _BF16))
        keep += [b, starts, ranges, heads, frags]
        args += [b.data_ptr(), starts.data_ptr(), t.k_pad, ranges.data_ptr(),
                 len(t.ranges), t.hcols, heads.data_ptr(), frags.data_ptr()]
    return tuple(args), keep


@functools.lru_cache(maxsize=8)
def _aligned_device(src_w, src_h, dst_w, dst_h, h_align, w_align, device):
    """aligned's launcher arguments (:func:`_planes_device`), uploaded once
    per geometry."""
    return _planes_device(
        _aligned_planes(src_w, src_h, dst_w, dst_h, h_align, w_align),
        device)


def aligned_resize(nv12: torch.Tensor, *, src_w: int, src_h: int,
                   dst_w: int, dst_h: int, h_align: int = 8,
                   w_align: int = 32) -> torch.Tensor:
    """The NV12 resize -> [B, dst_h*3/2, dst_w] uint8 with both passes as
    products over aligned windows on the tensor cores
    (:func:`aligned_plane_tables`): each strip's source-row window starts
    and ends on a multiple of ``h_align`` rows, each output column's tap
    range on ``w_align // channels`` pixels, the added taps weighing 0;
    where wgmma's k-step needs more (K a multiple of 16, a tile's band
    starting on 8 pixels), the windows widen further with zeros. bf16
    weights and samples, fp32 sums, the H rows rounded to bf16: within the
    uint8 envelope of :func:`nv12_resize` (the tensor cores sum in their
    own order); on the CPU :func:`nv12_resize_plain` itself. Raises
    ValueError for a geometry whose windows or shared memory do not fit
    the kernel (:func:`aligned_refusal`), on either device."""
    if h_align < 1 or w_align < 1:
        raise ValueError(f"h_align and w_align must be >= 1, got "
                         f"{h_align}, {w_align}")
    _checked(nv12, src_w, src_h, dst_w, dst_h)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = aligned_refusal(**geo, h_align=h_align, w_align=w_align)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("aligned_resize", nv12):
        return nv12_resize_plain(nv12, **geo)
    from ..ops._cuda_build import check, load_lab_kernels

    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    args, _ = _aligned_device(src_w, src_h, dst_w, dst_h, h_align, w_align,
                              nv12.device)
    out = _full_out(nv12, dst_w, dst_h)
    lib = load_lab_kernels()
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_resize_aligned_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[0],
            src_h, src_w, dst_h, dst_w, *args, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "aligned_resize")
    aligned_resize.launches += 1
    return out


# --- the knock-outs' tables (``resize_phases`` on aligned's block) ---------

#: the windows the knock-outs run at: the notebook's production defaults
PHASES_ALIGN = (8, 32)


def sink_partition(t: AlignedPlane, n_in: int, row_bytes: int,
                   channels: int) -> Tuple[np.ndarray, np.ndarray]:
    """The knock-outs' sink partition of a plane of ``n_in`` rows of
    ``row_bytes`` bytes: ([strips, 2], [ranges, 2]) int32, the plane rows
    [lo, hi) each strip's blocks fold and the row bytes [lo, hi) each
    range's blocks fold, so that every byte of the plane lies in exactly
    one (range, strip) share. A strip owns the rows from its window's
    first to the next window's first (the first strip from row 0, the last
    to the plane's end), a range the bytes from its first H byte to the
    next range's: each share lies in its block's window and ring where the
    windows overlap, and the kernel folds what does not by element
    loads."""
    rows = np.concatenate([[0], t.starts[1:].astype(np.int64), [n_in]])
    rows = np.clip(np.maximum.accumulate(rows), 0, n_in)
    xb = t.ranges[:, 2].astype(np.int64) * channels
    cols = np.concatenate([[0], xb[1:], [row_bytes]])
    cols = np.clip(np.maximum.accumulate(cols), 0, row_bytes)
    return (np.stack([rows[:-1], rows[1:]], 1).astype(np.int32),
            np.stack([cols[:-1], cols[1:]], 1).astype(np.int32))


def h_only_owners(t: AlignedPlane, lanes: int) -> np.ndarray:
    """[ranges, 2] int32: per column range of the luma tables ``t`` the
    pixels [lo, hi) below ``lanes`` whose H rows h_only's blocks of that
    range store, each pixel by the lowest range whose H columns hold it.
    Raises ValueError where a pixel lies in no range's H columns, or a
    range's pixels do not form one run."""
    x0 = t.ranges[:, 2].astype(np.int64)
    holds = ((x0[:, None] <= np.arange(lanes))
             & (np.arange(lanes) < (x0 + t.ranges[:, 3])[:, None]))
    if lanes and not holds.any(axis=0).all():
        raise ValueError(f"h_only keeps the H rows of pixels 0 .. "
                         f"{lanes - 1}, but no column range holds pixel "
                         f"{int(np.argmin(holds.any(axis=0)))}")
    owner = holds.argmax(axis=0)
    own = np.zeros((len(t.ranges), 2), np.int32)
    for r in range(len(t.ranges)):
        px = np.flatnonzero(owner == r) if lanes else np.zeros(0, int)
        if len(px):
            if px[-1] - px[0] + 1 != len(px):
                raise ValueError(f"h_only: range {r}'s pixels are not one "
                                 f"run")
            own[r] = (px[0], px[-1] + 1)
    return own


@functools.lru_cache(maxsize=8)
def phases_tables(src_w: int, src_h: int, dst_w: int,
                  dst_h: int) -> Tuple[np.ndarray, ...]:
    """The knock-outs' tables beside aligned's at 8x32: luma and chroma
    :func:`sink_partition` (rows, bytes each), then luma's
    :func:`h_only_owners` of the LANE_TILE corner."""
    y, c = _aligned_planes(src_w, src_h, dst_w, dst_h, *PHASES_ALIGN)
    return (*sink_partition(y, src_h, src_w, 1),
            *sink_partition(c, src_h // 2, src_w, 2),
            h_only_owners(y, min(LANE_TILE, dst_w, src_w)))


@functools.lru_cache(maxsize=32)
def phases_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int) -> str:
    """Why the knock-outs' block cannot take this geometry, or "" when it
    can: aligned's refusal at 8x32, or a pixel of h_only's corner that no
    column range holds."""
    why = aligned_refusal(src_w, src_h, dst_w, dst_h, *PHASES_ALIGN)
    if why:
        return why
    try:
        phases_tables(src_w, src_h, dst_w, dst_h)
    except ValueError as e:
        return str(e)
    return ""


def phases_work(batch: int, src_w: int, src_h: int, dst_w: int, dst_h: int,
                mode: str) -> Tuple[int, int]:
    """(bytes, operations) of one knock-out batch: the NV12 frames read
    once and the luma rows written once, and the FLOPs the mode's products
    issue from aligned's tables at 8x32, zeros included: the H products of
    both planes (h_only, both) and the luma W products (w_only, both)."""
    (yh, yw), (ch, _) = (_plane_fmas(t, c) for c, t in zip(
        (1, 2), _aligned_planes(src_w, src_h, dst_w, dst_h,
                                *PHASES_ALIGN)))
    h, w = mode in ("h_only", "both"), mode in ("w_only", "both")
    return nv12_resize_work(batch, src_h, src_w, dst_h, dst_w, h_pass=h,
                            w_pass=w, chroma=False, h_fmas=yh + ch,
                            w_fmas=yw)


@functools.lru_cache(maxsize=8)
def _phases_device(src_w, src_h, dst_w, dst_h, device):
    """The phases launcher's table arguments on ``device``: aligned's at
    8x32 (:func:`_aligned_device`), then :func:`phases_tables`; with the
    tensors they point into."""
    args, keep = _aligned_device(src_w, src_h, dst_w, dst_h, *PHASES_ALIGN,
                                 device)
    parts = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             for a in phases_tables(src_w, src_h, dst_w, dst_h)]
    return args + tuple(a.data_ptr() for a in parts), (keep, parts)


def resident_blocks(nv12: torch.Tensor, *, src_w: int, src_h: int,
                    dst_w: int, dst_h: int,
                    mode: str = "both") -> Tuple[int, int]:
    """(luma, chroma) blocks an SM holds of the knock-out ``mode``'s
    launches, or with ``mode`` "skewed" of :func:`skewed_resize`'s
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), asked of the
    launcher without a launch."""
    import ctypes

    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    res = (ctypes.c_int * 2)()
    if mode == "skewed":
        _skewed_call(nv12, geo, 1, 0, None, ctypes.addressof(res))
    else:
        sink = torch.zeros(1, dtype=torch.int32, device=nv12.device)
        _phases_call(nv12, geo, mode, 0, sink, None, ctypes.addressof(res))
    return res[0], res[1]


def wrap_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| mod 256 the nearer way round: how far apart two low bytes
    of truncated H values lie."""
    d = (a.int() - b.int()) % 256
    return torch.minimum(d, 256 - d)


def _abs_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.int() - b.int()).abs()


def h_sum_tolerance(sums: torch.Tensor) -> torch.Tensor:
    """How far (mod 256) the low byte of trunc(v) may move when an H sum v
    rounds one bf16 ulp apart: one ulp of |v| (8 significant bits: 1 at
    128-255, 2 at 256-511), and at least 1 (truncation moves an integer
    across by one below 128). int32, the shape of ``sums``."""
    ulp = torch.ldexp(torch.ones_like(sums),
                      torch.frexp(sums.abs()).exponent - 8)
    return torch.clamp(ulp, min=1.0).to(torch.int32)


def h_only_tolerance(nv12: torch.Tensor, *, src_w: int, src_h: int,
                     dst_w: int, dst_h: int) -> torch.Tensor:
    """[B, dst_h, dst_w] int32: how far, taken mod 256 (the nearer way
    round), h_only's kernel may lie from :func:`resize_phases_plain` at
    each sample. The tensor cores' fp32 sum may round to the bf16 value one
    ulp from the plain version's, which truncation and the low byte turn
    into :func:`h_sum_tolerance` of the plain sum (255.x against 256 reads
    255 against 0: 1 the nearer way round); the lanes past LANE_TILE are 0
    exactly. The lab also holds h_only to fewer than 1e-3 of its samples
    differing."""
    luma = nv12[:, :src_h]
    lanes = min(LANE_TILE, dst_w, src_w)
    wh = round_to(resize_weights(src_h, dst_h, LANCZOS_AA), _BF16).to(
        nv12.device)
    with exact_f32_matmul():
        yh = round_to(torch.matmul(wh, to_f32(luma[..., :lanes])), _BF16)
    tol = torch.zeros((nv12.shape[0], dst_h, dst_w), dtype=torch.int32,
                      device=nv12.device)
    tol[..., :lanes] = h_sum_tolerance(yh)
    return tol


# --- the skewed pipeline (notebook ``skewed``) -----------------------------

#: the windows the skewed kernel runs at: the notebook's defaults
SKEWED_ALIGN = (8, 32)


def skewed_smem_bytes(channels: int, hcols: int, k_pad: int) -> int:
    """Shared memory of one block of the skewed kernel: aligned's
    (:func:`aligned_smem_bytes`) and a second buffer of the tiled H
    rows."""
    return (aligned_smem_bytes(channels, hcols, k_pad)
            + hcols // 8 * (16 * ALIGNED_ROWS * channels + 16))


@functools.lru_cache(maxsize=16)
def skewed_plane_tables(n_in: int, n_out: int, px: int, ow: int,
                        channels: int) -> AlignedPlane:
    """aligned's tables at 8x32 (:func:`aligned_plane_tables`) with the
    column ranges cut anew: the fewest runs of tiles whose two H buffers,
    B and ring leave a block two to an SM (:func:`skewed_smem_bytes`); one
    tile a run where none do."""
    t = aligned_plane_tables(n_in, n_out, px, ow, channels, *SKEWED_ALIGN)
    ranges = _fewest_ranges(
        t.heads, channels, lambda r: skewed_smem_bytes(
            channels, int(r[:, 3].max()), t.k_pad) <= ALIGNED_TWO_BLOCKS)
    if ranges is None:
        ranges = _column_ranges(t.heads, channels, len(t.heads))
    return t._replace(ranges=ranges)


def _skewed_planes(src_w, src_h, dst_w, dst_h):
    """(luma, chroma) :func:`skewed_plane_tables`."""
    return (skewed_plane_tables(src_h, dst_h, src_w, dst_w, 1),
            skewed_plane_tables(src_h // 2, dst_h // 2, src_w // 2,
                                dst_w // 2, 2))


@functools.lru_cache(maxsize=32)
def skewed_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                   h_align: int, w_align: int) -> str:
    """Why the skewed kernel cannot take this geometry and alignment, or
    "" when it can: an alignment but SKEWED_ALIGN, a window of more than
    ALIGNED_MAX_K rows, or a block's shared memory over a block's."""
    if (h_align, w_align) != SKEWED_ALIGN:
        return (f"skewed runs aligned's windows at h_align, w_align = "
                f"{SKEWED_ALIGN[0]}, {SKEWED_ALIGN[1]} only, got {h_align}, "
                f"{w_align}")
    for name, ch, t in zip(("luma", "chroma"), (1, 2),
                           _skewed_planes(src_w, src_h, dst_w, dst_h)):
        if t.k_pad > ALIGNED_MAX_K:
            return (f"its {name} windows of {t.k_pad} rows exceed the "
                    f"kernel's {ALIGNED_MAX_K}")
        smem = skewed_smem_bytes(ch, t.hcols, t.k_pad)
        if smem > SMEM_LIMIT:
            return (f"its {name} H buffers, weights and ring need {smem} B "
                    f"of shared memory, over a block's {SMEM_LIMIT} B")
    return ""


def skewed_work(batch: int, src_w: int, src_h: int, dst_w: int,
                dst_h: int) -> Tuple[int, int]:
    """(bytes, operations) of one skewed batch: the product's bytes, and
    the FLOPs its tables issue, zeros included (:func:`aligned_work`'s
    count on :func:`skewed_plane_tables`' column ranges)."""
    (yh, yw), (ch, cw) = (_plane_fmas(t, c) for c, t in zip(
        (1, 2), _skewed_planes(src_w, src_h, dst_w, dst_h)))
    return nv12_resize_work(batch, src_h, src_w, dst_h, dst_w,
                            h_fmas=yh + ch, w_fmas=yw + cw)


def skewed_groups(batch: int, frames_per_block: int) -> List[Tuple[int, int]]:
    """Per grid z of a skewed launch the frames its blocks walk: (first
    frame, frames), G = ``frames_per_block`` each, the last fewer; block z
    runs frame f0 + s's H pass and frame f0 + s - 1's W pass at step s = 0
    .. frames."""
    return [(f0, min(frames_per_block, batch - f0))
            for f0 in range(0, batch, frames_per_block)]


@functools.lru_cache(maxsize=8)
def _skewed_device(src_w, src_h, dst_w, dst_h, device):
    """The skewed launcher's table arguments (:func:`_planes_device`),
    uploaded once per geometry."""
    return _planes_device(_skewed_planes(src_w, src_h, dst_w, dst_h), device)


def _skewed_call(nv12, geo, group, batch, out, resident):
    """One call of the skewed launcher (``batch`` 0: the residency query
    alone)."""
    from ..ops._cuda_build import check, load_lab_kernels

    args, _ = _skewed_device(geo["src_w"], geo["src_h"], geo["dst_w"],
                             geo["dst_h"], nv12.device)
    lib = load_lab_kernels()
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_resize_skewed_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), batch,
            geo["src_h"], geo["src_w"], geo["dst_h"], geo["dst_w"], *args,
            group, resident, out, torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "skewed_resize")


def skewed_resize(nv12: torch.Tensor, *, src_w: int, src_h: int, dst_w: int,
                  dst_h: int, h_align: int = 8, w_align: int = 32,
                  frames_per_block: Optional[int] = None) -> torch.Tensor:
    """The NV12 resize -> [B, dst_h*3/2, dst_w] uint8 with frame b's H pass
    beside frame b - 1's W pass in each block: ``aligned``'s tensor-core
    passes at (``h_align``, ``w_align``) = (8, 32), each block of (column
    range, strip, plane) walking ``frames_per_block`` frames (None: the
    batch), one warpgroup running the H products of a frame while the other
    runs the W tiles of the one before. Equal to
    ``aligned_resize(h_align=8, w_align=32)``, so within the uint8
    envelope of :func:`nv12_resize`; on the CPU :func:`nv12_resize_plain`.
    Raises ValueError for another alignment or a geometry the kernel cannot
    take (:func:`skewed_refusal`), on either device."""
    _checked(nv12, src_w, src_h, dst_w, dst_h)
    group = nv12.shape[0] if frames_per_block is None else frames_per_block
    if not isinstance(group, int) or (frames_per_block is not None
                                      and group < 1):
        raise ValueError(f"frames_per_block must be an int >= 1, got "
                         f"{frames_per_block!r}")
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = skewed_refusal(**geo, h_align=h_align, w_align=w_align)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("skewed_resize", nv12):
        return nv12_resize_plain(nv12, **geo)
    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    out = _full_out(nv12, dst_w, dst_h)
    if nv12.shape[0] == 0:
        return out
    _skewed_call(nv12, geo, group, nv12.shape[0], out.data_ptr(), None)
    skewed_resize.launches += 1
    return out


# --- streamed row bands (notebook ``streamed``) ----------------------------

#: rows of the tallest band: one TMA box (cuTensorMapEncodeTiled's limit)
STREAMED_MAX_BAND = 256
#: bands start on multiples of this many rows: each [band, 128 bytes] box
#: is then a whole number of the 128-byte swizzle's 1024-byte atoms
STREAMED_BAND_ALIGN = 8
#: bytes of one [band, 128] box row: a ring chunk's width
STREAMED_CHUNK = 128


class StreamedPlane(NamedTuple):
    """One plane's plan of :func:`streamed_resize`
    (csrc/nv12_streamed.cu): ``aligned``'s tables at 8x32 (``tables``: the
    window starts, B, the W heads and fragments) under its own column
    ``ranges`` ([n, 4] int32 as :class:`AlignedPlane`'s), a ring of
    ``slots`` bands of ``band`` rows, and per block its runs of strips:
    ``runs`` [nruns, 4] int32 (range, frame, first strip, strips) and
    ``blocks`` [nblocks + 1] int32, block b walking runs blocks[b] to
    blocks[b + 1] - 1 in order."""
    tables: AlignedPlane
    channels: int
    n_in: int
    band: int
    ranges: np.ndarray
    slots: int
    runs: np.ndarray
    blocks: np.ndarray

    @property
    def hcols(self) -> int:
        return int(self.ranges[:, 3].max())

    @property
    def chunks(self) -> int:
        """128-byte chunks of the widest range: a ring slot's boxes."""
        return int(_chunks(self.ranges, self.channels).max())

    def strip_bands(self) -> Tuple[np.ndarray, np.ndarray]:
        """(first, last) band of each strip's window rows (rows past the
        plane read its last row)."""
        return strip_bands(self.tables.starts, self.tables.k_pad, self.n_in,
                           self.band)


def _chunks(ranges: np.ndarray, channels: int) -> np.ndarray:
    """128-byte chunks of each range's H columns."""
    return -(-ranges[:, 3] * channels // STREAMED_CHUNK)


def strip_bands(starts: np.ndarray, k_pad: int, n_in: int,
                band: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first, last) band of each window of ``k_pad`` rows from
    ``starts``, rows past the ``n_in`` rows of the plane clamped to its
    last (they weigh 0)."""
    last = np.minimum(starts.astype(np.int64) + k_pad, n_in) - 1
    return starts // band, last // band


def streamed_smem_bytes(channels: int, hcols: int, k_pad: int, slots: int,
                        band: int, chunks: int) -> int:
    """Shared memory of one streamed block: the ring of ``slots`` bands of
    ``chunks`` [band, 128] boxes, the tiled H rows (as ``aligned``'s), one
    strip's B, two tables of window rows' ring offsets (int32: this
    strip's and the next's) and the ring's and B's full barriers."""
    group = 16 * ALIGNED_ROWS * channels + 16
    return (slots * band * STREAMED_CHUNK * chunks + hcols // 8 * group
            + 2 * k_pad * ALIGNED_ROWS + 8 * k_pad + 8 * (slots + 1))


def _notebook_span(src_w: int, src_h: int, dst_w: int, dst_h: int) -> int:
    """Source rows the widest strip of STRIP_ROWS output rows reads, luma
    or chroma: the least band of the notebook's ``streamed``."""
    return max(tile_window(*band_table(resize_weights(n, oh, LANCZOS_AA),
                                       _BF16)[:2], STRIP_ROWS)
               for n, oh in ((src_h, dst_h), (src_h // 2, dst_h // 2)))


@functools.lru_cache(maxsize=32)
def _streamed_ring(n_in: int, n_out: int, px: int, ow: int, channels: int,
                   band: int):
    """(tables, ranges, slots) of one plane, or (tables, None, needed
    bytes) where no ring fits: the slots one window spans plus one band in
    flight (else none in flight), and the fewest column ranges whose ring,
    H rows and B fit a block."""
    t = aligned_plane_tables(n_in, n_out, px, ow, channels, 8, 32)
    lo, hi = strip_bands(t.starts, t.k_pad, n_in, band)
    span = int((hi - lo).max()) + 1
    for slots in (span + 1, span):
        def need(r, slots=slots):
            return streamed_smem_bytes(channels, int(r[:, 3].max()),
                                       t.k_pad, slots, band,
                                       int(_chunks(r, channels).max()))
        ranges = _fewest_ranges(t.heads, channels,
                                lambda r: need(r) <= SMEM_LIMIT)
        if ranges is not None:
            return t, ranges, slots
    return t, None, need(_column_ranges(t.heads, channels, len(t.heads)))


def _streamed_rings(src_w, src_h, dst_w, dst_h, band):
    return (_streamed_ring(src_h, dst_h, src_w, dst_w, 1, band),
            _streamed_ring(src_h // 2, dst_h // 2, src_w // 2, dst_w // 2, 2,
                           band))


@functools.lru_cache(maxsize=64)
def streamed_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                     band: int) -> str:
    """Why the streamed kernel cannot take this band at this geometry, or
    "" when it can: a band shorter than the notebook's least (the source
    rows of a strip of STRIP_ROWS output rows), not a multiple of
    STREAMED_BAND_ALIGN rows, a window past ``aligned``'s K, a ring that
    does not fit a block's shared memory beside one W tile's H columns, or
    a band taller than one TMA box."""
    span = _notebook_span(src_w, src_h, dst_w, dst_h)
    if band < span:
        return (f"band={band} rows is less than the {span} source rows of "
                f"a strip")
    if band % STREAMED_BAND_ALIGN:
        return (f"band={band} rows is not a multiple of "
                f"{STREAMED_BAND_ALIGN} (the ring's 128-byte swizzle atom)")
    why = aligned_refusal(src_w, src_h, dst_w, dst_h, 8, 32)
    if why:
        return why
    for name, (_, ranges, slots) in zip(
            ("luma", "chroma"),
            _streamed_rings(src_w, src_h, dst_w, dst_h, band)):
        if ranges is None:
            return (f"its {name} ring of {band}-row bands beside one W "
                    f"tile's H rows and B needs {slots} B of shared "
                    f"memory, over a block's {SMEM_LIMIT} B")
    if band > STREAMED_MAX_BAND:
        return (f"band={band} rows is over the {STREAMED_MAX_BAND} rows of "
                f"one TMA box")
    return ""


def _walk_runs(cost: np.ndarray, strips: int,
               blocks: int) -> Tuple[np.ndarray, np.ndarray]:
    """Runs of consecutive strips of the walks (``cost`` [walks] the work
    of one strip of each walk), the sequence of all strips cut where its
    running work first reaches each of ``blocks`` equal shares (empty
    pieces dropped): (runs [nruns, 3] of walk, first strip, strips; each
    piece's first run [pieces + 1])."""
    edges = np.cumsum(np.repeat(cost.astype(np.int64), strips))
    total = int(edges[-1])
    cuts = [0] + [int(np.searchsorted(edges, -(-total * b // blocks))) + 1
                  for b in range(1, blocks)] + [len(edges)]
    runs, firsts = [], []
    for a, e in zip(cuts, cuts[1:]):
        if e <= a:
            continue
        firsts.append(len(runs))
        while a < e:
            w, s = divmod(a, strips)
            n = min(e - a, strips - s)
            runs.append((w, s, n))
            a += n
    firsts.append(len(runs))
    return (np.asarray(runs, np.int32).reshape(-1, 3),
            np.asarray(firsts, np.int32))


@functools.lru_cache(maxsize=16)
def streamed_plan(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  band: int, batch: int, sms: int
                  ) -> Tuple[StreamedPlane, StreamedPlane]:
    """The (luma, chroma) plans of a geometry the kernel takes
    (:func:`streamed_refusal`) for ``batch`` frames on ``sms`` SMs: each
    plane's walks (frame, range) cut into runs of strips over at most
    ``sms`` persistent blocks, the work of a strip counted as the
    tensor-core steps it issues (m64n32k16 units: two per chunk and window
    k-step for the H product, the W k-steps of its tiles times the
    plane's channels), so each SM gets the same within one strip's."""
    out = []
    for (t, ranges, slots), ch, n_in in zip(
            _streamed_rings(src_w, src_h, dst_w, dst_h, band), (1, 2),
            (src_h, src_h // 2)):
        strips = t.weights.shape[0]
        ksteps = np.array([int(t.heads[r[0]:r[0] + r[1], 2].sum())
                           for r in ranges])
        cost = np.tile(2 * _chunks(ranges, ch) * (t.k_pad // 16)
                       + ch * ksteps, batch)
        nblocks = max(1, min(sms, batch * len(ranges) * strips))
        walk, firsts = _walk_runs(cost, strips, nblocks)
        frame, rng = np.divmod(walk[:, 0], len(ranges))
        runs = np.stack([rng, frame, walk[:, 1], walk[:, 2]],
                        axis=1).astype(np.int32)
        out.append(StreamedPlane(t, ch, n_in, band, ranges, slots, runs,
                                 firsts))
    return out[0], out[1]


def streamed_staged_bytes(plan: StreamedPlane) -> int:
    """Bytes one launch of a plane copies into shared memory: per run, its
    bands (the first strip's first to the last strip's last) of its
    range's chunks."""
    lo, hi = plan.strip_bands()
    r, s0, n = plan.runs[:, 0], plan.runs[:, 2], plan.runs[:, 3]
    bands = hi[s0 + n - 1] - lo[s0] + 1
    return int((bands * plan.band * STREAMED_CHUNK
                * _chunks(plan.ranges, plan.channels)[r]).sum())


@functools.lru_cache(maxsize=8)
def _streamed_device(src_w, src_h, dst_w, dst_h, band, batch, sms, device):
    """The launcher's table arguments on ``device``, uploaded once per
    geometry, batch and SM count: per plane B, the window starts, k_pad,
    the ranges and their count, the H columns, the heads, the fragments,
    the ring's slots, the runs and the blocks' first runs and their count;
    with the tensors they point into."""
    args, keep = [], []
    for p in streamed_plan(src_w, src_h, dst_w, dst_h, band, batch, sms):
        t = p.tables
        b, starts, ranges, heads, frags, runs, blocks = (
            torch.from_numpy(core_matrix_order(t.weights)).to(device, _BF16),
            torch.from_numpy(t.starts).to(device),
            torch.from_numpy(p.ranges.reshape(-1)).to(device),
            torch.from_numpy(t.heads.reshape(-1)).to(device),
            torch.from_numpy(t.frags).to(device, _BF16),
            torch.from_numpy(p.runs.reshape(-1)).to(device),
            torch.from_numpy(p.blocks).to(device))
        keep += [b, starts, ranges, heads, frags, runs, blocks]
        args += [b.data_ptr(), starts.data_ptr(), t.k_pad, ranges.data_ptr(),
                 len(p.ranges), p.hcols, heads.data_ptr(), frags.data_ptr(),
                 p.slots, runs.data_ptr(), blocks.data_ptr(),
                 len(p.blocks) - 1]
    return tuple(args), keep


def tma_stageable(nv12: torch.Tensor) -> bool:
    """Whether the streamed kernel stages ``nv12`` by TMA: a 16-byte
    aligned start and row and batch strides that are multiples of 16
    bytes (else its element loads fill the same ring)."""
    return (nv12.data_ptr() % 16 == 0 and nv12.stride(1) % 16 == 0
            and nv12.stride(0) % 16 == 0)


def streamed_resize(nv12: torch.Tensor, *, src_w: int, src_h: int,
                    dst_w: int, dst_h: int, band: int = 64
                    ) -> torch.Tensor:
    """The NV12 resize -> [B, dst_h*3/2, dst_w] uint8 with each block
    walking down the frame, its source rows staged in bands of ``band``
    rows (one TMA box a 128-byte chunk) into a ring, under ``aligned``'s
    products at 8x32 (:func:`streamed_plan`): equal to
    ``aligned_resize(h_align=8, w_align=32)``, so within the uint8
    envelope of :func:`nv12_resize`; on the CPU :func:`nv12_resize_plain`
    itself. A view that TMA cannot take (:func:`tma_stageable`) fills the
    same ring with element loads; ``streamed_resize.tma_launches`` counts
    the launches staged by TMA. Raises ValueError for a band the kernel
    cannot take (:func:`streamed_refusal`), on either device."""
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    _checked(nv12, src_w, src_h, dst_w, dst_h)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = streamed_refusal(**geo, band=band)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("streamed_resize", nv12):
        return nv12_resize_plain(nv12, **geo)
    from ..ops._cuda_build import check, load_lab_kernels

    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    tma = tma_stageable(nv12)
    args, _ = _streamed_device(src_w, src_h, dst_w, dst_h, band,
                               nv12.shape[0], sm_count(nv12.device),
                               nv12.device)
    out = _full_out(nv12, dst_w, dst_h)
    lib = load_lab_kernels()
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_resize_streamed_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[0],
            src_h, src_w, dst_h, dst_w, *args, band, int(tma),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "streamed_resize")
    streamed_resize.launches += 1
    streamed_resize.tma_launches += int(tma)
    return out


# --- the plain versions' passes, split as the variants split them --------

def _planes_plain(nv12, src_w, src_h, dst_w, dst_h, h_pass) -> torch.Tensor:
    """The NV12 resize with ``h_pass(plane, row0, weights)`` (row0: the
    plane's first buffer row) as each plane's fp32 H pass, then
    resize_plane's bf16 cast point, W pass and quantise."""
    out = []
    for row0, n, oh, ow, ch in ((0, src_h, dst_h, dst_w, 1),
                                (src_h, src_h // 2, dst_h // 2, dst_w // 2,
                                 2)):
        dev = nv12.device
        wh = round_to(resize_weights(n, oh, LANCZOS_AA), _BF16).to(dev)
        w = src_w // ch
        ww = round_to(resize_weights(w, ow, LANCZOS_AA), _BF16).to(dev)
        with exact_f32_matmul():
            t = round_to(h_pass(to_f32(nv12[:, row0:row0 + n]), row0, wh),
                         _BF16)
            t = t.unflatten(2, (w, ch)).movedim(-1, -2)
            t = torch.matmul(t, ww.T).movedim(-2, -1)
        out.append(from_f32(t.reshape(nv12.shape[0], oh, ow * ch),
                            torch.uint8))
    return torch.cat(out, dim=1)


# --- row slabs (notebook ``slabs``) ----------------------------------------

def slab_rows(src_h: int, nslabs: int) -> int:
    """Rows of one slab: the NV12 buffer's src_h*3/2 rows cut into
    ``nslabs``, rounded up to 32 (notebook ``slabs``, whose row count may
    also include the padding of its TPU block tables)."""
    if nslabs < 1:
        raise ValueError(f"nslabs must be >= 1, got {nslabs}")
    per = -(-(src_h * 3 // 2) // nslabs)
    return -(-per // 32) * 32


@functools.lru_cache(maxsize=64)
def straddling_rows(src_h: int, dst_h: int, slab: int) -> np.ndarray:
    """[dst_h * 3 / 2] bool: the output rows of the NV12 resize (luma, then
    chroma) whose bf16 row band crosses a slab edge of the buffer's rows
    (a multiple of ``slab``; chroma's rows start at buffer row src_h)."""
    out = []
    for row0, n, dn in ((0, src_h, dst_h), (src_h, src_h // 2, dst_h // 2)):
        start, count, _ = band_table(resize_weights(n, dn, LANCZOS_AA),
                                     _BF16)
        out.append((row0 + start) // slab != (row0 + start + count - 1)
                   // slab)
    return np.concatenate(out)


def slabs_resize_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                       dst_w: int, dst_h: int, nslabs: int = 4
                       ) -> torch.Tensor:
    """Plain PyTorch version of :func:`slabs_resize` (any device): each
    plane's H pass summed as one fp32 product per slab, added in slab
    order."""
    _checked(nv12, src_w, src_h, dst_w, dst_h)
    slab = slab_rows(src_h, nslabs)

    def h_pass(plane, row0, wh):
        acc, a, n = None, 0, plane.shape[1]
        while a < n:
            e = min(n, ((row0 + a) // slab + 1) * slab - row0)
            part = torch.matmul(wh[:, a:e], plane[:, a:e])
            acc = part if acc is None else acc + part
            a = e
        return acc

    return _planes_plain(nv12, src_w, src_h, dst_w, dst_h, h_pass)


#: the most issued pieces (slab pieces with a nonzero weight) one window
#: may have: the kernel's mbarriers a ring stage
SLABS_MAX_PIECES = 8
#: bytes of one k-step of B ([16, ALIGNED_ROWS] bf16) and of one TMA box
#: of a ring stage ([16 rows, ALIGNED_STAGE_COLS bytes])
SLABS_BLOCK_BYTES = 16 * ALIGNED_ROWS * 2
SLABS_BOX_BYTES = 16 * ALIGNED_STAGE_COLS


def slab_cuts(start: int, k_pad: int, row0: int,
              slab: int) -> List[Tuple[int, int]]:
    """(first, end) window rows of the pieces of a window of ``k_pad`` rows
    whose row 0 is buffer row ``row0 + start``: cut at every buffer row
    that is a multiple of ``slab``."""
    edges = [k for k in range(1, k_pad) if (row0 + start + k) % slab == 0]
    bounds = [0] + edges + [k_pad]
    return list(zip(bounds, bounds[1:]))


class SlabsPlane(NamedTuple):
    """One plane's tables of :func:`slabs_resize` (csrc/nv12_slabs.cu):
    ``aligned``'s tables (``tables``: the window starts, B, the W heads and
    fragments) under its own column ``ranges`` ([n, 4] int32 as
    :class:`AlignedPlane`'s), each strip's window cut at the buffer's slab
    edges. ``cuts`` [n, 3] int32: per piece (strip, first window row, end
    row), in strip and row order, covering each window once. ``pfirst``
    [strips + 1] int32: strip s issues ``pieces[pfirst[s]:pfirst[s + 1]]``,
    the pieces with a nonzero weight, in slab order: [m, 4] int32 of its
    first k-step, its k-steps (those of its nonzero rows), its first block
    of ``bp``, and its boxes: its last ``boxes`` k-steps, whose [16, 128]
    boxes count against its barrier (a k-step shared with the piece before
    is that piece's). ``bp`` [blocks, ALIGNED_ROWS, 16] float32 of bf16
    values: per issued k-step of a piece, aligned's B at those window rows
    with the rows outside the piece set to zero."""
    tables: AlignedPlane
    ranges: np.ndarray
    cuts: np.ndarray
    pfirst: np.ndarray
    pieces: np.ndarray
    bp: np.ndarray

    @property
    def hcols(self) -> int:
        return int(self.ranges[:, 3].max())

    @property
    def blocks(self) -> int:
        """B's blocks in a block's shared memory, the most a strip has: its
        first piece's B_p at its window k-steps (k_pad / 16 blocks, zero
        ones around it), then its later pieces' k-steps."""
        p, f = self.pieces, self.pfirst
        return self.tables.k_pad // 16 + max(
            int(p[f[s] + 1:f[s + 1], 1].sum()) for s in range(len(f) - 1))

    @property
    def most_pieces(self) -> int:
        return int(np.diff(self.pfirst).max())


def slabs_smem_bytes(channels: int, hcols: int, k_pad: int,
                     blocks: int) -> int:
    """Shared memory of one slabs block: the ring of ALIGNED_STAGES stages
    of [k_pad, 128] bytes, the tiled H rows (as ``aligned``'s), ``blocks``
    blocks of B (:attr:`SlabsPlane.blocks`) and a zero one, a barrier a
    (stage, piece) and the strip's pieces (int32 x 4 each)."""
    group = 16 * ALIGNED_ROWS * channels + 16
    return (ALIGNED_STAGES * k_pad * ALIGNED_STAGE_COLS + hcols // 8 * group
            + (blocks + 1) * SLABS_BLOCK_BYTES
            + (8 * ALIGNED_STAGES + 16) * SLABS_MAX_PIECES)


@functools.lru_cache(maxsize=32)
def slabs_plane_tables(n_in: int, n_out: int, px: int, ow: int,
                       channels: int, h_align: int, w_align: int, row0: int,
                       slab: int) -> SlabsPlane:
    """The tables of one plane (``row0``: its first buffer row) with the
    buffer's rows cut into slabs of ``slab`` rows: ``aligned``'s at
    ``h_align`` x ``w_align`` (:func:`aligned_plane_tables`), each strip's
    window cut at the slab edges (:func:`slab_cuts`), and the fewest
    column ranges whose block fits two to an SM (None where not even one
    tile a range does)."""
    t = aligned_plane_tables(n_in, n_out, px, ow, channels, h_align,
                             w_align)
    cuts, pfirst, pieces, bp = [], [0], [], []
    for s in range(t.weights.shape[0]):
        last = -1   # the last k-step the strip's previous piece issued
        for a, e in slab_cuts(int(t.starts[s]), t.k_pad, row0, slab):
            cuts.append((s, a, e))
            b = np.zeros_like(t.weights[s])
            b[:, a:e] = t.weights[s][:, a:e]
            live = np.flatnonzero(b.reshape(ALIGNED_ROWS, -1, 16).any(
                axis=(0, 2)))
            if not len(live):
                continue
            ks0, nks = int(live[0]), int(live[-1]) + 1 - int(live[0])
            pieces.append((ks0, nks, len(bp), nks - int(ks0 == last)))
            bp += [b[:, 16 * k:16 * k + 16] for k in range(ks0, ks0 + nks)]
            last = ks0 + nks - 1
        pfirst.append(len(pieces))
    blocks = t.k_pad // 16 + max(sum(q[1] for q in pieces[f0 + 1:f1])
                                 for f0, f1 in zip(pfirst, pfirst[1:]))
    ranges = _fewest_ranges(
        t.heads, channels, lambda r: slabs_smem_bytes(
            channels, int(r[:, 3].max()), t.k_pad, blocks)
        <= ALIGNED_TWO_BLOCKS)
    return SlabsPlane(t, ranges, np.asarray(cuts, np.int32),
                      np.asarray(pfirst, np.int32),
                      np.asarray(pieces, np.int32).reshape(-1, 4),
                      np.stack(bp).astype(np.float32))


def _slabs_planes(src_w, src_h, dst_w, dst_h, nslabs, h_align, w_align):
    """(luma, chroma) :class:`SlabsPlane` tables."""
    slab = slab_rows(src_h, nslabs)
    return (slabs_plane_tables(src_h, dst_h, src_w, dst_w, 1, h_align,
                               w_align, 0, slab),
            slabs_plane_tables(src_h // 2, dst_h // 2, src_w // 2,
                               dst_w // 2, 2, h_align, w_align, src_h, slab))


@functools.lru_cache(maxsize=64)
def slabs_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  nslabs: int, h_align: int, w_align: int) -> str:
    """Why the slabs kernel cannot take this geometry, or "" when it can:
    ``aligned``'s refusal (:func:`aligned_refusal`), a window cut into more
    than SLABS_MAX_PIECES issued pieces, or a block (ring, H rows of one W
    tile's band, the pieces' B and barriers) over half an SM's shared
    memory: the kernel runs two blocks an SM. Its boxes start at each
    window's first row, so any ``h_align`` is staged."""
    why = aligned_refusal(src_w, src_h, dst_w, dst_h, h_align, w_align)
    if why:
        return why
    for name, ch, p in zip(("luma", "chroma"), (1, 2),
                           _slabs_planes(src_w, src_h, dst_w, dst_h, nslabs,
                                         h_align, w_align)):
        if p.most_pieces > SLABS_MAX_PIECES:
            return (f"nslabs={nslabs} cuts a {name} window into "
                    f"{p.most_pieces} pieces, over the kernel's "
                    f"{SLABS_MAX_PIECES}")
        if p.ranges is None:
            smem = slabs_smem_bytes(ch, 16 * int(p.tables.heads[:, 2].max()),
                                    p.tables.k_pad, p.blocks)
            return (f"its {name} ring, H rows, pieces' B and barriers need "
                    f"{smem} B of shared memory, over the "
                    f"{ALIGNED_TWO_BLOCKS} B of a block two to an SM")
    return ""


def slabs_work(batch: int, src_w: int, src_h: int, dst_w: int, dst_h: int,
               nslabs: int, h_align: int = 8,
               w_align: int = 32) -> Tuple[int, int]:
    """(bytes, operations) of one slabs batch: the product's bytes, and the
    FLOPs the kernel issues, zeros included: per strip and issued piece a
    chain of k_pad / 16 k-steps (those outside the piece's own against a
    zero block) of [ALIGNED_ROWS, 16] weights times the H columns of each
    range, and ``aligned``'s W products."""
    h_fmas = w_fmas = 0
    for ch, p in zip((1, 2), _slabs_planes(src_w, src_h, dst_w, dst_h,
                                           nslabs, h_align, w_align)):
        t = p.tables
        h_fmas += (len(p.pieces) * ALIGNED_ROWS * t.k_pad * ch
                   * int(p.ranges[:, 3].sum()))
        w_fmas += (t.weights.shape[0] * ALIGNED_W_TILE * 16 * ALIGNED_ROWS
                   * ch * int(t.heads[:, 2].sum()))
    return nv12_resize_work(batch, src_h, src_w, dst_h, dst_w,
                            h_fmas=h_fmas, w_fmas=w_fmas)


@functools.lru_cache(maxsize=8)
def _slabs_device(src_w, src_h, dst_w, dst_h, nslabs, h_align, w_align,
                  device):
    """The launcher's table arguments on ``device``, uploaded once per
    geometry: per plane aligned's (B's place taken by the pieces' B_p in
    bf16 core-matrix order, a k-step a block; the ranges the plane's own),
    then the strips' first pieces, the pieces and B's blocks a strip; with
    the tensors they point into."""
    args, keep = [], []
    for p in _slabs_planes(src_w, src_h, dst_w, dst_h, nslabs, h_align,
                           w_align):
        t = p.tables
        b, starts, ranges, heads, frags, pfirst, pieces = (
            torch.from_numpy(core_matrix_order(p.bp)).to(device, _BF16),
            torch.from_numpy(t.starts).to(device),
            torch.from_numpy(p.ranges.reshape(-1)).to(device),
            torch.from_numpy(t.heads.reshape(-1)).to(device),
            torch.from_numpy(t.frags).to(device, _BF16),
            torch.from_numpy(p.pfirst).to(device),
            torch.from_numpy(p.pieces.reshape(-1)).to(device))
        keep += [b, starts, ranges, heads, frags, pfirst, pieces]
        args += [b.data_ptr(), starts.data_ptr(), t.k_pad, ranges.data_ptr(),
                 len(p.ranges), p.hcols, heads.data_ptr(), frags.data_ptr(),
                 pfirst.data_ptr(), pieces.data_ptr(), p.blocks]
    return tuple(args), keep


def slabs_resize(nv12: torch.Tensor, *, src_w: int, src_h: int, dst_w: int,
                 dst_h: int, nslabs: int = 4, h_align: int = 8,
                 w_align: int = 32) -> torch.Tensor:
    """The NV12 resize -> [B, dst_h*3/2, dst_w] uint8 with the buffer's
    rows cut into ``nslabs`` slabs of :func:`slab_rows` rows, on
    ``aligned``'s tensor-core passes at ``h_align`` x ``w_align``
    (:func:`slabs_plane_tables`): each H-pass sum is one fp32 partial per
    slab piece of its strip's window (that piece's B_p: aligned's B with
    the rows outside the piece zero), the partials added in slab order,
    then rounded to bf16. Each piece's rows are staged by TMA boxes against
    its own mbarrier, a view TMA cannot take (:func:`tma_stageable`) by
    element loads into the same ring (``slabs_resize.tma_launches`` counts
    the launches staged by TMA). Equal to ``aligned_resize`` at the same
    alignment on every output row whose band lies inside one slab, within
    the uint8 envelope of :func:`slabs_resize_plain` and of
    :func:`nv12_resize`; on the CPU :func:`slabs_resize_plain` itself.
    Raises ValueError for a geometry the kernel cannot take
    (:func:`slabs_refusal`), on either device."""
    if h_align < 1 or w_align < 1:
        raise ValueError(f"h_align and w_align must be >= 1, got "
                         f"{h_align}, {w_align}")
    _checked(nv12, src_w, src_h, dst_w, dst_h)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = slabs_refusal(**geo, nslabs=nslabs, h_align=h_align,
                        w_align=w_align)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("slabs_resize", nv12):
        return slabs_resize_plain(nv12, **geo, nslabs=nslabs)
    from ..ops._cuda_build import check, load_lab_kernels

    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    tma = tma_stageable(nv12)
    args, _ = _slabs_device(src_w, src_h, dst_w, dst_h, nslabs, h_align,
                            w_align, nv12.device)
    out = _full_out(nv12, dst_w, dst_h)
    lib = load_lab_kernels()
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_resize_slabs_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[0],
            src_h, src_w, dst_h, dst_w, *args, int(tma), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "slabs_resize")
    slabs_resize.launches += 1
    slabs_resize.tma_launches += int(tma)
    return out


# --- column stripes (notebook ``striped``) ---------------------------------

STORES = ("dyn", "relay", "unroll")
#: stripes a cluster store (dyn, unroll) runs as one thread-block cluster:
#: the portable cluster size, and the unroll store's switch (kMaxStripes)
MAX_CLUSTER_STRIPES = 8
#: the kernel's stripes are whole runs of this many bytes of a row, so no
#: UV pair is split and every stripe edge is a column group of 8 pixels
STRIPE_ALIGN = 16


def stripe_width(src_w: int, nw: int) -> int:
    """Lanes of each of ``nw`` stripes of the NV12 rows but the last, which
    takes the rest: ``src_w // nw`` rounded down to a multiple of 4 (even,
    so no UV pair is split). The plain version's cut."""
    if nw < 1:
        raise ValueError(f"nw must be >= 1, got {nw}")
    sw = src_w // nw // 4 * 4
    if sw < 4:
        raise ValueError(f"{nw} stripes of a {src_w}-lane row are narrower "
                         f"than 4 lanes")
    return sw


def stripe_edges(src_w: int, nw: int) -> List[int]:
    """Lane edges of the ``nw`` stripes of :func:`stripe_width`."""
    sw = stripe_width(src_w, nw)
    return [s * sw for s in range(nw)] + [src_w]


def striped_stripe_bytes(src_w: int, nw: int) -> int:
    """Bytes of a row in each of the kernel's ``nw`` stripes but the last,
    which takes the rest: the notebook's ``src_w // nw`` rounded down to a
    multiple of STRIPE_ALIGN (the same bytes in both planes: chroma's
    stripes hold half as many pixel pairs)."""
    if nw < 1:
        raise ValueError(f"nw must be >= 1, got {nw}")
    sw = src_w // nw // STRIPE_ALIGN * STRIPE_ALIGN
    if sw < STRIPE_ALIGN:
        raise ValueError(f"{nw} stripes of a {src_w}-byte row are narrower "
                         f"than {STRIPE_ALIGN} bytes")
    return sw


class StripedPlane(NamedTuple):
    """One plane's tables of :func:`striped_resize` (csrc/nv12_striped.cu):
    ``aligned``'s tables at 8x32 (``tables``: the window starts, B, the W
    heads and fragments) cut into stripes of ``spx`` pixels (the last
    taking the rest of the row's pixels rounded up to 16). Each W tile
    belongs to the stripe that holds its band's first column (``owner``
    [tiles]); ``order`` [tiles] int32 lists the tiles stripe by stripe;
    ``stripes`` [nw, 4] int32: per stripe its first entry of ``order``,
    its tiles, its own pixels and the pixels it holds (its own, then the
    halo its tiles' bands reach past them; own alone for the relay
    store)."""
    tables: AlignedPlane
    channels: int
    spx: int
    owner: np.ndarray
    order: np.ndarray
    stripes: np.ndarray

    @property
    def hcols(self) -> int:
        """The most pixels a stripe holds: a block's H rows."""
        return int(self.stripes[:, 3].max())

    @property
    def wcols(self) -> int:
        """Pixels of the widest tile band: the relay store's W block."""
        return 16 * int(self.tables.heads[:, 2].max())


@functools.lru_cache(maxsize=64)
def striped_plane_tables(n_in: int, n_out: int, px: int, ow: int,
                         channels: int, nw: int, sw: int,
                         relay: bool) -> StripedPlane:
    """The tables of one plane of ``n_in`` rows of ``px`` pixels
    (``channels`` interleaved) resized to ``n_out`` rows of ``ow``:
    :func:`aligned_plane_tables` at 8x32, cut into ``nw`` stripes of
    ``sw`` bytes of a row (:func:`striped_stripe_bytes`)."""
    t = aligned_plane_tables(n_in, n_out, px, ow, channels, 8, 32)
    spx = sw // channels
    wp = -(-px // 16) * 16
    c0, nk = t.heads[:, 1], t.heads[:, 2]
    owner = np.minimum(c0 // spx, nw - 1).astype(np.int32)
    order = np.argsort(owner, kind="stable").astype(np.int32)
    count = np.bincount(owner, minlength=nw)
    first = np.concatenate([[0], np.cumsum(count)[:-1]])
    x0 = np.arange(nw) * spx
    own = np.where(np.arange(nw) < nw - 1, spx, wp - x0)
    held = own.copy()
    if not relay:
        np.maximum.at(held, owner, c0 + 16 * nk - x0[owner])
    stripes = np.stack([first, count, own, held], axis=1).astype(np.int32)
    return StripedPlane(t, channels, spx, owner, order, stripes)


def _striped_planes(src_w, src_h, dst_w, dst_h, nw, store):
    """(luma, chroma) :class:`StripedPlane` tables."""
    sw = striped_stripe_bytes(src_w, nw)
    relay = store == "relay"
    return (striped_plane_tables(src_h, dst_h, src_w, dst_w, 1, nw, sw,
                                 relay),
            striped_plane_tables(src_h // 2, dst_h // 2, src_w // 2,
                                 dst_w // 2, 2, nw, sw, relay))


def striped_smem_bytes(channels: int, hcols: int, k_pad: int) -> int:
    """Shared memory of one stripe's block: its tiled H rows (``hcols``
    pixels: own and halo), B and the ring, as ``aligned``'s block
    (:func:`aligned_smem_bytes`)."""
    return aligned_smem_bytes(channels, hcols, k_pad)


def striped_w_smem_bytes(channels: int, wcols: int) -> int:
    """Shared memory of one block of the relay store's W launch: the tiled
    H rows of the widest tile band."""
    return wcols // 8 * (16 * ALIGNED_ROWS * channels + 16)


@functools.lru_cache(maxsize=64)
def striped_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                    nw: int, store: str) -> str:
    """Why the striped kernel cannot take ``nw`` stripes under ``store`` at
    this geometry, or "" when it can: ``nw`` < 1, a stripe under
    STRIPE_ALIGN bytes, more than MAX_CLUSTER_STRIPES stripes under a
    cluster store, a window past ALIGNED_MAX_K rows, or a block's shared
    memory over a block's."""
    if store not in STORES:
        return f"store must be one of {STORES}, got {store!r}"
    if nw < 1:
        return f"nw must be >= 1, got {nw}"
    if src_w // nw < STRIPE_ALIGN:
        return (f"{nw} stripes of a {src_w}-byte row are narrower than "
                f"{STRIPE_ALIGN} bytes")
    if store != "relay" and nw > MAX_CLUSTER_STRIPES:
        return (f"the {store} store runs the {nw} stripes of a strip as one "
                f"thread-block cluster of at most {MAX_CLUSTER_STRIPES} "
                f"blocks, got nw={nw}")
    for name, ch, p in zip(("luma", "chroma"), (1, 2),
                           _striped_planes(src_w, src_h, dst_w, dst_h, nw,
                                           store)):
        k_pad = p.tables.k_pad
        if k_pad > ALIGNED_MAX_K:
            return (f"its {name} windows of {k_pad} rows exceed the "
                    f"kernel's {ALIGNED_MAX_K}")
        smem = max(striped_smem_bytes(ch, p.hcols, k_pad),
                   striped_w_smem_bytes(ch, p.wcols)
                   if store == "relay" else 0)
        if smem > SMEM_LIMIT:
            return (f"its {name} stripes' H rows, weights and ring need "
                    f"{smem} B of shared memory, over a block's "
                    f"{SMEM_LIMIT} B")
    return ""


def striped_work(batch: int, src_w: int, src_h: int, dst_w: int,
                 dst_h: int) -> Tuple[int, int]:
    """(bytes, operations) of one striped batch, at any ``nw`` and store:
    the product's bytes, and the FLOPs the kernel issues, zeros included:
    per strip [ALIGNED_ROWS, k_pad] weights times each row's pixels
    (rounded up to 16) once, no column twice, and ``aligned``'s W
    products."""
    h_fmas = w_fmas = 0
    for ch, t in zip((1, 2), _aligned_planes(src_w, src_h, dst_w, dst_h, 8,
                                             32)):
        strips = t.weights.shape[0]
        px = src_w // ch
        h_fmas += strips * ALIGNED_ROWS * t.k_pad * ch * (-(-px // 16) * 16)
        w_fmas += (strips * ALIGNED_W_TILE * 16 * ALIGNED_ROWS * ch
                   * int(t.heads[:, 2].sum()))
    return nv12_resize_work(batch, src_h, src_w, dst_h, dst_w,
                            h_fmas=h_fmas, w_fmas=w_fmas)


def striped_halo_bytes(batch: int, src_w: int, src_h: int, dst_w: int,
                       dst_h: int, nw: int) -> int:
    """Bytes of bf16 H rows a cluster store's blocks copy from their peers
    in one batch: each stripe's halo pixels, ALIGNED_ROWS rows (chroma: U
    and V) of 2 bytes, per strip and frame."""
    total = 0
    for ch, p in zip((1, 2), _striped_planes(src_w, src_h, dst_w, dst_h, nw,
                                             "dyn")):
        halo = int((p.stripes[:, 3] - p.stripes[:, 2]).sum())
        total += p.tables.weights.shape[0] * halo * ALIGNED_ROWS * ch * 2
    return batch * total


def striped_scratch_elems(batch: int, src_w: int, src_h: int, dst_w: int,
                          dst_h: int) -> int:
    """bf16 elements of the relay store's scratch: per frame, plane and
    strip, every pixel of a row (rounded up to 16) x ALIGNED_ROWS rows
    (chroma: U and V)."""
    n = 0
    for px, oh, ch in ((src_w, dst_h, 1), (src_w // 2, dst_h // 2, 2)):
        n += -(-oh // ALIGNED_ROWS) * (-(-px // 16) * 16) * ALIGNED_ROWS * ch
    return batch * n


@functools.lru_cache(maxsize=16)
def _striped_device(src_w, src_h, dst_w, dst_h, nw, store, device):
    """The launcher's table arguments on ``device``, uploaded once per
    geometry, ``nw`` and store: per plane B in bf16 core-matrix order, the
    window starts, k_pad, the stripes, the most pixels a stripe holds, the
    widest tile band, the tiles' order, the heads and the bf16 A
    fragments; with the tensors they point into."""
    args, keep = [], []
    for p in _striped_planes(src_w, src_h, dst_w, dst_h, nw, store):
        t = p.tables
        b, starts, stripes, order, heads, frags = (
            torch.from_numpy(core_matrix_order(t.weights)).to(device, _BF16),
            torch.from_numpy(t.starts).to(device),
            torch.from_numpy(p.stripes.reshape(-1)).to(device),
            torch.from_numpy(p.order).to(device),
            torch.from_numpy(t.heads.reshape(-1)).to(device),
            torch.from_numpy(t.frags).to(device, _BF16))
        keep += [b, starts, stripes, order, heads, frags]
        args += [b.data_ptr(), starts.data_ptr(), t.k_pad,
                 stripes.data_ptr(), p.hcols, p.wcols, order.data_ptr(),
                 heads.data_ptr(), frags.data_ptr()]
    return tuple(args), keep


def striped_resize_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                         dst_w: int, dst_h: int, nw: int = 3
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`striped_resize` (any device): each
    stripe's columns H-passed on their own, then the W pass of the
    frame-wide rows."""
    _checked(nv12, src_w, src_h, dst_w, dst_h)
    edges = stripe_edges(src_w, nw)

    def h_pass(plane, row0, wh):
        return torch.cat([torch.matmul(wh, plane[..., a:b])
                          for a, b in zip(edges, edges[1:])], dim=-1)

    return _planes_plain(nv12, src_w, src_h, dst_w, dst_h, h_pass)


def _striped_call(nv12, geo, nw, store, batch, out, scratch, resident):
    """One call of the striped launcher (``batch`` 0: the residency query
    alone)."""
    from ..ops._cuda_build import check, load_lab_kernels

    args, _ = _striped_device(geo["src_w"], geo["src_h"], geo["dst_w"],
                              geo["dst_h"], nw, store, nv12.device)
    lib = load_lab_kernels()
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_resize_striped_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), batch,
            geo["src_h"], geo["src_w"], geo["dst_h"], geo["dst_w"], *args,
            nw, striped_stripe_bytes(geo["src_w"], nw), STORES.index(store),
            scratch, resident, out,
            torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "striped_resize")


def striped_clusters(nv12: torch.Tensor, *, src_w: int, src_h: int,
                     dst_w: int, dst_h: int, nw: int = 3,
                     store: str = "dyn") -> Tuple[int, int]:
    """(luma, chroma) clusters of ``nw`` blocks the card can hold at once
    for the cluster stores (``cudaOccupancyMaxActiveClusters``; 0 for
    relay, which runs no cluster), asked of the launcher without a
    launch."""
    import ctypes

    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = striped_refusal(**geo, nw=nw, store=store)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if store == "relay":
        return 0, 0
    res = (ctypes.c_int * 2)()
    _striped_call(nv12, geo, nw, store, 0, None, None,
                  ctypes.addressof(res))
    return res[0], res[1]


def striped_resize(nv12: torch.Tensor, *, src_w: int, src_h: int,
                   dst_w: int, dst_h: int, nw: int = 3,
                   store: str = "dyn") -> torch.Tensor:
    """The NV12 resize -> [B, dst_h*3/2, dst_w] uint8 with each strip's H
    pass cut into ``nw`` column stripes (:func:`striped_stripe_bytes`) on
    ``aligned``'s tensor-core passes at 8x32 (:func:`striped_plane_tables`).
    ``store`` dyn or unroll: the stripes of a strip are one thread-block
    cluster, each block holding its stripe's H rows and copying its W
    tiles' halo from its neighbours' shared memory (unroll: the H pass
    compiled once a stripe); relay: the H rows through a bf16 scratch in
    device memory, then a W launch. Equal to
    ``aligned_resize(h_align=8, w_align=32)``, so within the uint8
    envelope of :func:`nv12_resize`; on the CPU
    :func:`striped_resize_plain`. Raises ValueError for a store, ``nw`` or
    geometry the kernel cannot take (:func:`striped_refusal`), on either
    device, and RuntimeError where no cluster of ``nw`` blocks fits the
    card."""
    if store not in STORES:
        raise ValueError(f"store must be one of {STORES}, got {store!r}")
    _checked(nv12, src_w, src_h, dst_w, dst_h)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = striped_refusal(**geo, nw=nw, store=store)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("striped_resize", nv12):
        return striped_resize_plain(nv12, **geo, nw=nw)
    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    out = _full_out(nv12, dst_w, dst_h)
    if nv12.shape[0] == 0:
        return out
    scratch = (torch.empty(striped_scratch_elems(nv12.shape[0], **geo),
                           dtype=_BF16, device=nv12.device)
               if store == "relay" else None)
    _striped_call(nv12, geo, nw, store, nv12.shape[0], out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), None)
    striped_resize.launches += 1
    return out


#: kernel launches made by each wrapper (CPU calls are not counted)
resize_phases.launches = 0
aligned_resize.launches = 0
skewed_resize.launches = 0
streamed_resize.launches = 0
streamed_resize.tma_launches = 0
slabs_resize.launches = 0
slabs_resize.tma_launches = 0
striped_resize.launches = 0
WRAPPERS = (resize_phases, aligned_resize, skewed_resize, streamed_resize,
            slabs_resize, striped_resize)


# --- the lab ----------------------------------------------------------------

class Case(NamedTuple):
    """One lab name: the wrapper it launches, the call, the plain version
    of its function, the reference its maxdiff is taken against, whether
    it must equal that reference bit for bit, and its work."""
    wrapper: Callable
    call: Callable[[torch.Tensor], torch.Tensor]
    plain: Callable[[torch.Tensor], torch.Tensor]
    reference: Callable[[torch.Tensor], torch.Tensor]
    exact: bool
    work: tuple      # (bytes, operations) of one batch of B frames
    # per-sample bound against the reference where the envelope's 1 LSB
    # does not hold (h_only: h_only_tolerance), on the given frames
    tol: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    # how far two outputs lie apart (h_only: its low bytes mod 256)
    distance: Callable[[torch.Tensor, torch.Tensor],
                       torch.Tensor] = _abs_distance

    def tolerance(self, frames: torch.Tensor):
        """How far the kernel may lie from its reference on ``frames``:
        ``tol``, 0 where it is exact, or the envelope's 1 LSB."""
        return self.tol(frames) if self.tol else 0 if self.exact else 1

    def within(self, out: torch.Tensor, frames: torch.Tensor) -> bool:
        """Whether ``out`` of ``frames`` lies within :meth:`tolerance` of
        the reference, fewer than 1e-3 of its samples differing."""
        d = self.distance(out, self.reference(frames))
        return (bool((d <= self.tolerance(frames)).all())
                and int((d > 0).sum()) < 1e-3 * d.numel())


def case(name: str, batch: int, src_w: int, src_h: int, dst_w: int,
         dst_h: int) -> Case:
    """The :class:`Case` of a lab name on [batch, >= src_h*3/2, src_w]
    frames. ``both`` is held to ``aligned8x32``'s luma rows bit for bit,
    the full-function variants to :func:`nv12_resize` (bit for bit on the
    CUDA cores, within its envelope on the tensor cores), the other
    knock-outs to their plain versions (h_only within
    :func:`h_only_tolerance`)."""
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    full = nv12_resize_work(batch, src_h, src_w, dst_h, dst_w)
    product = (lambda x: nv12_resize(x, **geo))
    plain = (lambda x: nv12_resize_plain(x, **geo))
    if name == "prod":
        return Case(nv12_resize, product, plain, product, True, full)
    if name in MODES:
        call = (lambda x: resize_phases(x, **geo, mode=name))
        knock_plain = (lambda x: resize_phases_plain(x, **geo, mode=name))
        work = phases_work(batch, **geo, mode=name)
        if name == "both":
            return Case(resize_phases, call, knock_plain,
                        lambda x: aligned_resize(x, **geo)[:, :dst_h], True,
                        work)
        if name == "h_only":
            return Case(resize_phases, call, knock_plain, knock_plain, False,
                        work, lambda x: h_only_tolerance(x, **geo),
                        wrap_distance)
        return Case(resize_phases, call, knock_plain, knock_plain, False,
                    work)
    m = re.fullmatch(r"aligned(\d+)x(\d+)", name)
    if m:
        ha, wa = int(m.group(1)), int(m.group(2))
        return Case(aligned_resize,
                    lambda x: aligned_resize(x, **geo, h_align=ha,
                                             w_align=wa),
                    plain, product, False,
                    aligned_work(batch, **geo, h_align=ha, w_align=wa))
    m = re.fullmatch(r"skewed(\d*)", name)
    if m:
        g = int(m.group(1)) if m.group(1) else None
        return Case(skewed_resize,
                    lambda x: skewed_resize(x, **geo, frames_per_block=g),
                    plain, product, False, skewed_work(batch, **geo))
    m = re.fullmatch(r"streamed(\d+)", name)
    if m:
        band = int(m.group(1))
        return Case(streamed_resize,
                    lambda x: streamed_resize(x, **geo, band=band), plain,
                    product, False,
                    aligned_work(batch, **geo, h_align=8, w_align=32))
    m = re.fullmatch(r"slabs(\d+)", name)
    if m:
        n = int(m.group(1))
        split = (lambda x: slabs_resize_plain(x, **geo, nslabs=n))
        return Case(slabs_resize, lambda x: slabs_resize(x, **geo, nslabs=n),
                    split, split, False,
                    slabs_work(batch, **geo, nslabs=n))
    m = re.fullmatch(r"striped(\d+)(dyn|relay|unroll)", name)
    if m:
        nw, store = int(m.group(1)), m.group(2)
        return Case(striped_resize,
                    lambda x: striped_resize(x, **geo, nw=nw, store=store),
                    lambda x: striped_resize_plain(x, **geo, nw=nw),
                    product, False, striped_work(batch, **geo))
    raise ValueError(f"unknown lab name {name!r}: one of {DEFAULT_NAMES}, "
                     f"aligned{{h}}x{{w}}, skewed{{G}}, streamed{{band}}, "
                     f"slabs{{n}} or striped{{nw}}{{dyn|relay|unroll}}")


def run(names: Sequence[str], frames: torch.Tensor, *, src_w: int,
        src_h: int, dst_w: int, dst_h: int,
        log: Callable[[str], None] = print) -> List[Dict[str, object]]:
    """Run each lab name on ``frames`` [B, >= src_h*3/2, src_w]: its maxdiff
    on the first three frames against its reference and whether that lies
    within the name's tolerance (:meth:`Case.within`), and on the card its
    time per batch. Logs one line per name, and on the card the H/W split
    as shares of ``prod``; returns one dict per name."""
    batch = frames.shape[0]
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    on_card = frames.device.type == "cuda"
    head = frames[:3]
    results = []
    for name in names:
        c = case(name, batch, **geo)
        out = c.call(head)
        maxdiff = int(c.distance(out, c.reference(head)).max().item())
        bound, bound_by = bound_ms(*c.work)
        row = dict(name=name, maxdiff=maxdiff, within=c.within(out, head),
                   bound_ms=bound, bound_by=bound_by, ms=None, spread=None)
        if on_card:
            ms, spread = time_cuda(c.call, frames)
            row.update(ms=ms, spread=spread,
                       gbps=c.work[0] / (ms * 1e-3) / 1e9)
            log(f"{name}: {ms:.4f} ms/batch  spread={spread:.1%}  "
                f"maxdiff={maxdiff}  GB/s={row['gbps']:.1f}  "
                f"bound={bound:.4f} ms ({bound_by})")
        else:
            log(f"{name}: maxdiff={maxdiff} (plain version on the CPU; "
                f"not timed)")
        results.append(row)
    times = {r["name"]: r["ms"] for r in results}
    if on_card and all(times.get(k) for k in ("prod",) + tuple(MODES)):
        log("H/W split: " + ", ".join(
            f"{k} {times[k]:.4f} ms = {times[k] / times['prod']:.1%}"
            for k in ("dma_only", "h_only", "w_only", "both"))
            + f" of prod {times['prod']:.4f} ms")
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.resize_diag",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(DEFAULT_NAMES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("resize_diag: no CUDA device (use --device cpu for the "
                  "plain versions)", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        batch, W, H, DW, DH = CARD_SIZE
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"{torch.cuda.get_device_name(0)} ({smi}) torch="
              f"{torch.__version__} cuda={torch.version.cuda}", flush=True)
    else:
        device = torch.device("cpu")
        batch, W, H, DW, DH = CPU_SIZE
    rows = H * 3 // 2
    print(f"{batch} x {W}x{H} NV12 (rows={rows}) -> {DW}x{DH} uint8, bf16 "
          f"compute, lanczos_aa", flush=True)
    frames = make_frames(batch, rows, W, device)
    run(args.names, frames, src_w=W, src_h=H, dst_w=DW, dst_h=DH,
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
