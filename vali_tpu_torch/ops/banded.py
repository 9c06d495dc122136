"""Host half of the banded kernels: compute-dtype policy, band tables, the
shared plain versions and the preprocess format dispatch.

Counterpart of the host code in ``vali_tpu/ops/pallas_fused.py``. The TPU
kernels slice the dense resampling matrices into aligned TILE x WIN blocks
for the matrix unit; the Hopper kernel instead reads one compact band per
output row or column: the first source index, the tap count, and the
weights padded to the largest tap count (:func:`band_table`). A band is the
nonzero extent of a dense row inside the plane, so the kernel never reads
outside a plane and the staging buffers need no pad rows.

The four preprocess kernels (``ops/nv12_preprocess.py``,
``ops/yuv420_preprocess.py``, ``ops/yuv422_preprocess.py``,
``ops/yuv444_preprocess.py``) use the same four tables: luma rows, chroma
rows, luma columns, chroma columns, built from the same dense matrices the
dense route uses. The chroma layout decides the chroma pair
(:func:`dense_weights`): 4:2:0 resamples both chroma axes with the
half-resolution matrices, 4:2:2 reuses the luma row matrix, and 4:4:4
reuses both luma matrices, so one kernel serves every layout with the same
table arguments.

The three resize kernels (``ops/plane_resize.py``, ``ops/packed_resize.py``,
``ops/nv12_resize.py``) use two tables per resampled image, rows and
columns, built straight from ``resize_weights`` (:func:`stream_bands`;
:func:`resize_tables` packs them for the earlier 8-row design, which the
resize lab keeps):
NV12 chroma is resized as its own half-size image, so its tables are
``resize_weights(H/2, DH/2)`` and ``resize_weights(W/2, DW/2)``, never the
chroma-to-luma-grid matrices of the preprocess kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..utils.tracing import count, span, traced_build
from . import colors
from .fused import _chroma_weights, exact_f32_matmul, to_f32
from .resize import resize_weights, round_to

#: output dtype -> the kernels' out_kind code
OUT_KINDS = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}


def resolve_compute_dtype(compute_dtype, hbd: bool = False) -> torch.dtype:
    """Compute-dtype policy shared by both kernels: uint8 input defaults to
    bfloat16 compute, uint16 ("hbd") input always computes in float32.

    ``compute_dtype=torch.float32`` is the per-call exactness knob for
    uint8 input."""
    if compute_dtype is None:
        return torch.float32 if hbd else torch.bfloat16
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if hbd and compute_dtype != torch.float32:
        raise ValueError(
            "high-bit-depth input (uint16 / float32) requires float32 "
            "compute — bfloat16 cannot hold its significant bits")
    return compute_dtype


def band_table(dense: np.ndarray, compute_dtype: torch.dtype
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact per-row bands of a dense [n_out, n_in] resampling matrix.

    Returns ``(start [n_out] int32, count [n_out] int32,
    weights [n_out, K] float32)``: row ``o`` reads source indices
    ``start[o] .. start[o] + count[o] - 1``, all inside ``[0, n_in)``, with
    ``weights[o, :count[o]]`` (the rest is zero). K is the largest count.
    Weights are rounded to ``compute_dtype`` (the TPU kernels' cast point
    for their weight blocks) and stored as float32."""
    dense = np.asarray(dense, dtype=np.float32)
    n_out, n_in = dense.shape
    nz = dense != 0.0
    has = nz.any(axis=1)
    first = np.where(has, nz.argmax(axis=1), 0)
    last = np.where(has, n_in - 1 - nz[:, ::-1].argmax(axis=1), -1)
    count = (last - first + 1).astype(np.int32)
    k = max(1, int(count.max(initial=0)))
    cols = first[:, None] + np.arange(k)[None, :]
    inside = np.arange(k)[None, :] < count[:, None]
    weights = np.where(inside, dense[np.arange(n_out)[:, None],
                                    np.minimum(cols, n_in - 1)], 0.0)
    weights = round_to(weights.astype(np.float32), compute_dtype).numpy()
    return first.astype(np.int32), count, weights


#: chroma layouts of the preprocess kernels: 4:2:0 (NV12, P10, P12,
#: YUV420, YUV420_10bit), 4:2:2 (YUV422) and 4:4:4 (YUV444)
LAYOUTS = ("420", "422", "444")


class DenseWeights(NamedTuple):
    """The four dense resampling matrices of one geometry."""
    luma_h: np.ndarray    # [DH, H]
    chroma_h: np.ndarray  # [DH, H/2] (4:2:0) or the luma matrix
    luma_w: np.ndarray    # [DW, W]
    chroma_w: np.ndarray  # [DW, W/2] (4:2:0, 4:2:2) or the luma matrix


def dense_weights(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  method: str, layout: str) -> DenseWeights:
    """The matrices of ``layout``: 4:2:2 chroma rows are full height, so
    they take the luma row matrix; 4:4:4 chroma takes both luma
    matrices."""
    if layout not in LAYOUTS:
        raise ValueError(f"chroma layout must be one of {LAYOUTS}, got "
                         f"{layout!r}")
    luma_h = resize_weights(src_h, dst_h, method)
    luma_w = resize_weights(src_w, dst_w, method)
    chroma_h = (_chroma_weights(src_h // 2, dst_h, src_h, method)
                if layout == "420" else luma_h)
    chroma_w = (luma_w if layout == "444"
                else _chroma_weights(src_w // 2, dst_w, src_w, method))
    return DenseWeights(luma_h, chroma_h, luma_w, chroma_w)


class DeviceTables(NamedTuple):
    """Band tables of one geometry, uploaded to one device.

    ``index`` int32 holds, back to back: luma-row start and count [DH]
    each, chroma-row start and count [DH] each, luma-column start and
    count [DW] each, chroma-column start and count [DW] each.
    ``weights`` float32 holds luma-row weights [DH, taps[0]], chroma-row
    weights [DH, taps[1]], then the column weights TRANSPOSED — luma
    [taps[2], DW] and chroma [taps[3], DW] — so neighbouring output
    columns read neighbouring addresses."""
    index: torch.Tensor
    weights: torch.Tensor
    taps: Tuple[int, int, int, int]


@functools.lru_cache(maxsize=32)
@traced_build
def device_tables(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  method: str, layout: str, compute_dtype: torch.dtype,
                  device: torch.device) -> DeviceTables:
    """Build and upload the band tables once per geometry, chroma layout
    and device. The layout is part of the cache key: two layouts of one
    geometry have different chroma tables."""
    dw = dense_weights(src_w, src_h, dst_w, dst_h, method, layout)
    return pack_tables([band_table(m, compute_dtype) for m in dw], device)


def pack_tables(tabs, device: torch.device) -> DeviceTables:
    """Upload the four bands ``(start, count, weights)`` of
    :func:`band_table` — luma rows, chroma rows, luma columns, chroma
    columns — as a :class:`DeviceTables`."""
    index = np.concatenate([np.concatenate([s, c]) for s, c, _ in tabs])
    weights = np.concatenate([
        tabs[0][2].reshape(-1), tabs[1][2].reshape(-1),
        tabs[2][2].T.reshape(-1), tabs[3][2].T.reshape(-1)])
    return DeviceTables(
        torch.from_numpy(index).to(device),
        torch.from_numpy(np.ascontiguousarray(weights)).to(device),
        tuple(int(t[2].shape[1]) for t in tabs))


def tail_params(space: ColorSpace, crange: ColorRange, scale: float,
                out_dtype: torch.dtype, normalize) -> np.ndarray:
    """Validate the CSC/quantise tail and pack it as the kernels take it:
    18 float32 — the 3x3 matrix (row-major), luma offset, chroma offset,
    output divisor (``scale`` for uint8 out, ``255 * scale`` for float),
    mean[3], std[3]. Without ``normalize`` mean is 0 and std 1, which
    leaves every value unchanged."""
    mo = colors.yuv2rgb_matrix(space, crange)
    if mo is None:
        raise ValueError(f"Unsupported cc combo {space}/{crange}")
    if out_dtype not in OUT_KINDS:
        raise ValueError(
            f"out_dtype must be uint8, float32 or bfloat16, got {out_dtype}")
    is_u8 = out_dtype == torch.uint8
    if normalize is not None and is_u8:
        raise ValueError("normalize requires a float out_dtype")
    m, y_off = mo
    mean, std = normalize if normalize is not None else ((0.0,) * 3,
                                                         (1.0,) * 3)
    return np.array(
        list(m.astype(np.float32).reshape(-1))
        + [y_off * scale, 128.0 * scale,
           scale if is_u8 else 255.0 * scale]
        + [float(x) for x in mean] + [float(x) for x in std],
        dtype=np.float32)


def banded_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                 src_w: int, src_h: int, dst_w: int, dst_h: int,
                 method: str, layout: str, compute_dtype: torch.dtype,
                 tail: np.ndarray, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the banded preprocess kernels on planar
    y/u/v views of chroma ``layout``.

    Same dense matrices and cast points as the kernels: weights rounded to
    the compute dtype, an fp32 product with TF32 off, the H-pass result
    rounded to the compute dtype, the W-pass product, the CSC and the
    quantise/normalise tail in fp32. Returns [B, 3, dst_h, dst_w]."""
    dw = dense_weights(src_w, src_h, dst_w, dst_h, method, layout)
    dev = y.device
    wyh, wch, wyw, wcw = (round_to(m, compute_dtype).to(dev) for m in dw)
    ch = dw.chroma_h.shape[1]  # chroma rows the row matrix reads
    with exact_f32_matmul():
        yh = round_to(torch.matmul(wyh, to_f32(y[:, :src_h])), compute_dtype)
        uh = round_to(torch.matmul(wch, to_f32(u[:, :ch])), compute_dtype)
        vh = round_to(torch.matmul(wch, to_f32(v[:, :ch])), compute_dtype)
    return w_pass_tail_plain(yh, uh, vh, wyw, wcw, tail, out_dtype)


def w_pass_tail_plain(yh: torch.Tensor, uh: torch.Tensor, vh: torch.Tensor,
                      wyw: torch.Tensor, wcw: torch.Tensor, tail: np.ndarray,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """The second half of :func:`banded_plain`: the W pass of the H-pass
    rows ``yh``, ``uh``, ``vh`` [B, rows, cols] with the dense column
    matrices ``wyw``, ``wcw`` [DW, cols], then the CSC and the
    quantise/normalise tail in fp32. Returns [B, 3, rows, DW]."""
    with exact_f32_matmul():
        yv = torch.matmul(yh, wyw.T) - float(tail[9])
        uv = torch.matmul(uh, wcw.T) - float(tail[10])
        vv = torch.matmul(vh, wcw.T) - float(tail[10])
    m = [float(x) for x in tail[:9]]
    div = float(tail[11])
    chans = []
    for c in range(3):
        x = m[3 * c] * yv + m[3 * c + 1] * uv + m[3 * c + 2] * vv
        if out_dtype == torch.uint8:
            x = torch.clamp(torch.round(x / div), 0.0, 255.0).to(torch.uint8)
        else:
            x = ((x / div - float(tail[12 + c])) / float(tail[15 + c])).to(
                out_dtype)
        chans.append(x)
    return torch.stack(chans, dim=1)


# --- host tables of the strip-window block and the lab's grouped variants --
# (csrc/static2_passes.cuh: S2's block, which the product's tensor-core
# route of nv12_preprocess runs at 16-row strips, csrc/nv12_wgmma_
# preprocess.cu, and the lab's kernels on it; csrc/nv12_grouped.cu; the
# output-column ranges of the earlier CUDA-core designs, which their A/Bs
# build)

#: dynamic shared memory one block may use on sm_90 (kSmemLimit)
SMEM_LIMIT = 232448


@functools.lru_cache(maxsize=16)
def _nv12_bands(src_w: int, src_h: int, dst_w: int, dst_h: int,
                method: str):
    """The four bf16 bands of a 4:2:0 geometry (:func:`band_table`)."""
    dw = dense_weights(src_w, src_h, dst_w, dst_h, method, "420")
    return tuple(band_table(m, torch.bfloat16) for m in dw)


def _strip_windows(start, count, weights, n_in: int, tile: int,
                   align: int):
    """Bands of ``tile``-row strips over shared windows: each strip's
    window starts at a multiple of ``align`` source rows (pulled back to
    stay inside the ``n_in`` rows) and all have the length the TPU's
    ``_banded_blocks_from_dense`` gives, the widest strip band rounded up
    past one more ``align``. Returns per output row (window start, window
    length, weights over the window: the row's band at its place, zeros
    elsewhere)."""
    n_out = len(start)
    idx = np.arange(0, n_out, tile)
    lo = np.minimum.reduceat(start, idx)
    hi = np.maximum.reduceat(start + count, idx)
    span = int((hi - lo).max())
    length = min(-(-(span + align) // align) * align, n_in)
    ws = np.minimum(lo // align * align, n_in - length).astype(np.int32)
    row_ws = np.repeat(ws, tile)[:n_out]
    w = np.zeros((n_out, length), np.float32)
    for o in range(n_out):
        off = int(start[o] - row_ws[o])
        if off < 0 or off + count[o] > length:
            raise ValueError(f"row {o}'s band leaves its strip window")
        w[o, off:off + count[o]] = weights[o, :count[o]]
    return row_ws, np.full(n_out, length, np.int32), w


@functools.lru_cache(maxsize=16)
def strip_window_bands(src_w: int, src_h: int, dst_w: int, dst_h: int,
                       method: str, tile: int, align: int):
    """S2's luma and chroma row bands over strip windows
    (:func:`_strip_windows`, strips of ``tile`` rows aligned to
    ``align``)."""
    if tile < 1 or align < 1:
        raise ValueError(f"tile and align must be >= 1, got tile={tile}, "
                         f"align={align}")
    hy, hc = _nv12_bands(src_w, src_h, dst_w, dst_h, method)[:2]
    return (_strip_windows(*hy, src_h, tile, align),
            _strip_windows(*hc, src_h // 2, tile, align))


def _ceil16(x: int) -> int:
    return -(-x // 16) * 16


class ColumnRanges(NamedTuple):
    """Output-column ranges of a strip kernel's blocks: ``ext`` [n, 4]
    int32 — per range the luma source columns [lo, hi) and the
    interleaved chroma columns [lo, hi) its W bands read, widened to
    multiples of 16 — and the widest of each (the shared-memory row
    pitches)."""
    ext: torch.Tensor
    y_pitch: int
    c_pitch: int

    @property
    def n(self) -> int:
        return self.ext.shape[0]

    def args(self):
        """The ranges as the earlier nv12_static_launch took them."""
        return (self.ext.data_ptr(), self.n, self.y_pitch, self.c_pitch)


@functools.lru_cache(maxsize=32)
def column_ranges(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  method: str, rows: int,
                  device: torch.device) -> ColumnRanges:
    """The fewest output-column ranges whose H rows fit one block: a strip
    of ``rows`` output rows keeps its luma and interleaved chroma H rows
    in bf16 for the source columns its range's W bands read. One range is
    the full row."""
    _, _, (ys, yc, _), (cs, cc, _) = _nv12_bands(src_w, src_h, dst_w, dst_h,
                                                 method)
    rows = min(rows, dst_h)
    for n in range(1, dst_w + 1):
        if n == 1:
            ext = np.array([[0, src_w, 0, src_w]], np.int32)
        else:
            ext = np.zeros((n, 4), np.int32)
            for z in range(n):
                p0, p1 = z * dst_w // n, (z + 1) * dst_w // n
                ext[z] = (ys[p0:p1].min() // 16 * 16,
                          min(src_w, _ceil16(int((ys + yc)[p0:p1].max()))),
                          2 * cs[p0:p1].min() // 16 * 16,
                          min(src_w, _ceil16(2 * int((cs + cc)[p0:p1].max()))))
        y_pitch = int((ext[:, 1] - ext[:, 0]).max())
        c_pitch = int((ext[:, 3] - ext[:, 2]).max())
        if 2 * rows * (y_pitch + c_pitch) <= SMEM_LIMIT:
            return ColumnRanges(torch.from_numpy(ext).to(device), y_pitch,
                                c_pitch)
    raise ValueError(f"{rows}-row strips of {src_w}-wide rows do not fit a "
                     f"block in any column ranges")


class GroupedTables(NamedTuple):
    """G's H-pass tables (csrc/nv12_grouped.cu): ``weights`` [strips, 16,
    k_pad] — per strip of GROUP_STRIP output rows, rows 0-7 the luma rows'
    weights over the strip's window of ``luma_rows`` luma rows (columns 0
    on), rows 8-15 the chroma rows' over its window of ``chroma_rows``
    interleaved chroma rows (columns ``luma_rows`` on), zeros elsewhere, K
    padded with zeros to a multiple of 16 — and ``starts`` [strips, 2]
    int32, the first plane row of each window."""
    weights: np.ndarray
    starts: np.ndarray
    luma_rows: int
    chroma_rows: int

    @property
    def k_pad(self) -> int:
        return self.weights.shape[2]


#: output rows of one of G's strips (in each plane): one block a strip
GROUP_STRIP = 8
#: G's window rows at most (its kernel keeps K / 16 A fragments a thread)
GROUPED_MAX_K = 256
#: G's ring: stages of GROUPED_STAGE_COLS frame columns
GROUPED_STAGES = 3
GROUPED_STAGE_COLS = 128
#: bytes of one 8-column group of G's 8 tiled H rows (128 and 16 of pad)
GROUPED_GROUP_BYTES = 144
#: output columns of one of G's W-pass products (wgmma's M)
GROUPED_W_TILE = 64


@functools.lru_cache(maxsize=16)
def grouped_tables(src_w: int, src_h: int, dst_w: int, dst_h: int,
                   method: str) -> GroupedTables:
    """Build G's block-diagonal tables from the bf16 row bands: each
    strip's window is the union of its rows' bands, all windows of a plane
    one length (the widest), pulled back to stay inside the plane."""
    hy, hc = _nv12_bands(src_w, src_h, dst_w, dst_h, method)[:2]
    s = GROUP_STRIP
    idx = np.arange(0, dst_h, s)
    wins = []
    for (start, count, w), n_in in ((hy, src_h), (hc, src_h // 2)):
        lo = np.minimum.reduceat(start, idx)
        hi = np.maximum.reduceat(start + count, idx)
        length = int((hi - lo).max())
        wins.append((np.minimum(lo, n_in - length), length, start, count, w))
    ly, lc = wins[0][1], wins[1][1]
    weights = np.zeros((len(idx), 2 * s, _ceil16(ly + lc)), np.float32)
    starts = np.zeros((len(idx), 2), np.int32)
    for p, (ws, _, start, count, w) in enumerate(wins):
        starts[:, p] = ws
        for o in range(dst_h):
            off = ly * p + int(start[o] - ws[o // s])
            weights[o // s, s * p + o % s, off:off + count[o]] = \
                w[o, :count[o]]
    return GroupedTables(weights, starts, ly, lc)


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits of float32 values exact in bf16."""
    return (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(
        np.uint16)


def core_matrix_order(m: np.ndarray) -> np.ndarray:
    """[..., N, K] (N a multiple of 8, K of 16) in wgmma's K-major core
    matrices without swizzle, as G's kernel reads its B: per k-step of 16,
    the N / 8 row groups, each two 8 x 8 matrices (K halves) of 8 rows of
    8 contiguous elements. Returns [..., N * K]."""
    *lead, n, k = m.shape
    x = m.reshape(*lead, n // 8, 8, k // 16, 2, 8)
    nl = len(lead)
    x = np.transpose(x, (*range(nl), nl + 2, nl, nl + 3, nl + 1, nl + 4))
    return np.ascontiguousarray(x).reshape(*lead, n * k)


def grouped_smem_bytes(src_w: int, k_pad: int) -> int:
    """Shared memory of one of G's blocks: its tiled 8 luma, 8 U and 8 V
    H rows (columns padded to 16), its [k_pad, 16] bf16 B and the ring of
    GROUPED_STAGES [k_pad, GROUPED_STAGE_COLS] byte stages."""
    groups = (_ceil16(src_w) + 2 * _ceil16(src_w // 2)) // 8
    return (groups * GROUPED_GROUP_BYTES + 2 * 16 * k_pad
            + GROUPED_STAGES * GROUPED_STAGE_COLS * k_pad)


def grouped_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                    method: str) -> str:
    """Why G's kernel cannot take this geometry, or "" when it can."""
    k_pad = grouped_tables(src_w, src_h, dst_w, dst_h, method).k_pad
    if k_pad > GROUPED_MAX_K:
        return (f"G's stacked windows of {k_pad} rows exceed its "
                f"{GROUPED_MAX_K}")
    smem = grouped_smem_bytes(src_w, k_pad)
    if smem > SMEM_LIMIT:
        return (f"G's H rows, weights and ring need {smem} B of shared "
                f"memory, over a block's {SMEM_LIMIT} B")
    return ""


def fragment_order(a: np.ndarray) -> np.ndarray:
    """[64, K] (K a multiple of 16) in the register fragments of wgmma's A
    from registers: [K / 16, 128, 8], thread t of the warpgroup holding
    rows 16 (t / 32) + (t mod 32) / 4 (+ 8) at k pairs 2 (t mod 4) (+ 8) of
    each k-step, as four packed pairs, low k first."""
    t = np.arange(128)
    m0 = 16 * (t // 32) + (t % 32) // 4
    k = 2 * (t % 4)
    rows = np.stack([m0, m0, m0 + 8, m0 + 8] * 2, axis=1)
    cols = np.stack([k, k + 1, k, k + 1, k + 8, k + 9, k + 8, k + 9], axis=1)
    steps = 16 * np.arange(a.shape[1] // 16)[:, None, None]
    return a[rows[None], steps + cols[None]]


class GroupedWTables(NamedTuple):
    """G's mma W pass (csrc/nv12_grouped.cu): ``heads`` [tiles, 2, 3] int32,
    per tile of GROUPED_W_TILE output columns and per product (luma over
    the luma H rows; chroma over the U and V rows at once) its first k-step
    in ``frags``, its first source column (luma or chroma samples, a
    multiple of 8) and its k-steps; ``frags`` [k-steps, 128, 8] float32 of
    bf16 values, the A fragments (:func:`fragment_order`) of each product's
    band of columns."""
    heads: np.ndarray
    frags: np.ndarray

    @property
    def k_steps(self) -> int:
        return self.frags.shape[0]


@functools.lru_cache(maxsize=16)
def grouped_w_tables(src_w: int, src_h: int, dst_w: int, dst_h: int,
                     method: str) -> GroupedWTables:
    """Build G's W-pass tables from the dense bf16 column matrices: row m
    of a tile's products is its output column m; each product's k-steps
    cover the columns its rows weigh, kept inside the 16-column padded
    width of its H rows."""
    dw = dense_weights(src_w, src_h, dst_w, dst_h, method, "420")
    tiles = -(-dst_w // GROUPED_W_TILE)
    heads = np.zeros((tiles, 2, 3), np.int32)
    frags, step = [], 0
    for prod, m in enumerate((dw.luma_w, dw.chroma_w)):
        w = round_to(m, torch.bfloat16).numpy()
        wp = _ceil16(w.shape[1])
        for t in range(tiles):
            a = np.zeros((GROUPED_W_TILE, wp), np.float32)
            oc = GROUPED_W_TILE * t + np.arange(GROUPED_W_TILE)
            a[oc < dst_w, :w.shape[1]] = w[oc[oc < dst_w]]
            nz = np.flatnonzero(a.any(axis=0))
            c0 = int(nz[0]) // 8 * 8
            nk = -(-(int(nz[-1]) + 1 - c0) // 16)
            c0 = min(c0, wp - 16 * nk)
            frags.append(fragment_order(a[:, c0:c0 + 16 * nk]))
            heads[t, prod] = (step, c0, nk)
            step += nk
    return GroupedWTables(heads, np.concatenate(frags, axis=0))


class Static2Tables(NamedTuple):
    """S2's H-pass tables (csrc/static2_passes.cuh): per strip of ``tile``
    output rows, ``luma`` [strips, tile, k_luma] and ``chroma`` [strips,
    tile, k_chroma] float32 of bf16 values — each output row's band at its
    rows of the strip's window (:func:`strip_window_bands`), widened with
    zero rows to a multiple of 16; rows past dst_h weigh 0 — and
    ``starts`` [strips, 2] int32, the first plane row of the luma and the
    chroma window (rows past a plane read its last row)."""
    luma: np.ndarray
    chroma: np.ndarray
    starts: np.ndarray

    @property
    def k_luma(self) -> int:
        return self.luma.shape[2]

    @property
    def k_chroma(self) -> int:
        return self.chroma.shape[2]


#: S2's strip heights: multiples of 8 (wgmma's N) up to 48, one kernel
#: instance each
STATIC2_TILES = (8, 16, 24, 32, 40, 48)
#: S2's ring: stages of STATIC2_STAGE_COLS frame bytes, a chunk of
#: STATIC2_CHUNK bytes a warpgroup
STATIC2_STAGES = 3
STATIC2_STAGE_COLS = 128
STATIC2_CHUNK = 64
#: W k-steps of a chunk: its 64 luma columns, its 32 chroma pixels
STATIC2_W_STEPS = (4, 2)


@functools.lru_cache(maxsize=32)
def static2_tables(src_w: int, src_h: int, dst_w: int, dst_h: int,
                   method: str, tile: int, align: int) -> Static2Tables:
    """Build S2's H-pass tables from its strip-window bands."""
    strips = -(-dst_h // tile)
    mats, starts = [], np.zeros((strips, 2), np.int32)
    for p, (ws, length, w) in enumerate(strip_window_bands(
            src_w, src_h, dst_w, dst_h, method, tile, align)):
        m = np.zeros((strips * tile, _ceil16(int(length[0]))), np.float32)
        m[:dst_h, :w.shape[1]] = w
        mats.append(m.reshape(strips, tile, -1))
        starts[:, p] = ws[::tile]
    return Static2Tables(mats[0], mats[1], starts)


class Static2WTables(NamedTuple):
    """S2's W pass (csrc/static2_passes.cuh): ``heads`` [tiles, 4] int32, per
    tile of GROUPED_W_TILE output columns its first chunk in ``frags``,
    its first byte column x0 (a multiple of 32) and its chunks (even), 0;
    ``frags`` [chunks, 6, 128, 8] float32 of bf16 values, per chunk of
    STATIC2_CHUNK frame bytes from x0 the A fragments
    (:func:`fragment_order`) of its 4 luma k-steps (luma columns) and 2
    chroma k-steps (chroma pixels from x0 / 2), zeros outside the tile's
    bands and past the row."""
    heads: np.ndarray
    frags: np.ndarray


@functools.lru_cache(maxsize=16)
def static2_w_tables(src_w: int, src_h: int, dst_w: int, dst_h: int,
                     method: str) -> Static2WTables:
    """Build S2's W-pass tables from the dense bf16 column matrices: each
    tile's chunks run from the first byte its luma or chroma columns weigh
    to the last, in an even count (one chunk a warpgroup a stage)."""
    dw = dense_weights(src_w, src_h, dst_w, dst_h, method, "420")
    wy, wc = (round_to(m, torch.bfloat16).numpy()
              for m in (dw.luma_w, dw.chroma_w))
    tiles = -(-dst_w // GROUPED_W_TILE)
    heads = np.zeros((tiles, 4), np.int32)
    frags, first = [], 0
    for t in range(tiles):
        oc = np.arange(GROUPED_W_TILE * t, min(GROUPED_W_TILE * (t + 1),
                                                dst_w))
        ny = np.flatnonzero(wy[oc].any(axis=0))
        nc = np.flatnonzero(wc[oc].any(axis=0))
        x0 = min(int(ny[0]), 2 * int(nc[0])) // 32 * 32
        x1 = max(int(ny[-1]) + 1, 2 * int(nc[-1]) + 2)
        chunks = -(-(x1 - x0) // (2 * STATIC2_CHUNK)) * 2
        cols = chunks * STATIC2_CHUNK
        ay = np.zeros((GROUPED_W_TILE, cols), np.float32)
        ac = np.zeros((GROUPED_W_TILE, cols // 2), np.float32)
        n = min(cols, src_w - x0)
        ay[:len(oc), :n] = wy[oc, x0:x0 + n]
        ac[:len(oc), :(n + 1) // 2] = wc[oc, x0 // 2:x0 // 2 + (n + 1) // 2]
        fy = fragment_order(ay).reshape(chunks, 4, 128, 8)
        fc = fragment_order(ac).reshape(chunks, 2, 128, 8)
        frags.append(np.concatenate([fy, fc], axis=1))
        heads[t] = (first, x0, chunks, 0)
        first += chunks
    return Static2WTables(heads, np.concatenate(frags, axis=0))


def static2_smem_bytes(tile: int, k_luma: int, k_chroma: int) -> int:
    """Shared memory of one of S2's blocks: the ring of STATIC2_STAGES
    [k_luma + k_chroma, STATIC2_STAGE_COLS] byte stages, or the partial W
    sums its two warpgroups trade at the end, the larger; B_y and B_c in
    bf16; and each warpgroup's H rows of a chunk (tile luma rows of 64
    columns, tile U and tile V rows of 32 pixels; 8-column groups padded
    by 16 bytes)."""
    kst = k_luma + k_chroma
    ring = max(STATIC2_STAGES * kst * STATIC2_STAGE_COLS,
               4 * (tile // 2 + tile) * 128)
    chunk = 8 * (16 * tile + 16) + 4 * (32 * tile + 16)
    return ring + 2 * kst * tile + 2 * chunk


def static2_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                    method: str, tile: int, align: int) -> str:
    """Why S2's kernel cannot take this geometry and strip, or "" when it
    can: a strip height that is not one of STATIC2_TILES (a multiple of 8
    up to 48), an odd width, or a block's shared memory over a block's."""
    if tile not in STATIC2_TILES:
        return (f"S2's tensor-core kernel takes strips of a multiple of 8 "
                f"rows up to {STATIC2_TILES[-1]}, got tile={tile}")
    if src_w % 2 or src_h < 2:
        return (f"S2's tensor-core kernel takes an even width and two rows "
                f"or more, got {src_w}x{src_h}")
    t = static2_tables(src_w, src_h, dst_w, dst_h, method, tile, align)
    smem = static2_smem_bytes(tile, t.k_luma, t.k_chroma)
    if smem > SMEM_LIMIT:
        return (f"S2's ring, weights and H rows need {smem} B of shared "
                f"memory, over a block's {SMEM_LIMIT} B")
    return ""


class Static2Device(NamedTuple):
    """S2's tables at one (tile, align) on one device, as its launchers
    take them after the tail: ``b`` [strips, (k_luma + k_chroma) tile]
    bf16, per strip B_y then B_c in core-matrix order; ``starts`` [strips,
    2] int32; ``heads`` [tiles, 4] int32; ``frags`` [chunks, 6, 128, 8]
    bf16 (:func:`static2_tables`, :func:`static2_w_tables`)."""
    b: torch.Tensor
    starts: torch.Tensor
    k_luma: int
    k_chroma: int
    heads: torch.Tensor
    frags: torch.Tensor

    def args(self):
        """The tables as the launchers take them (the pointers point into
        this tuple's tensors: keep it while a launch may read them)."""
        return (self.b.data_ptr(), self.starts.data_ptr(), self.k_luma,
                self.k_chroma, self.heads.data_ptr(), self.frags.data_ptr())


@functools.lru_cache(maxsize=32)
@traced_build
def static2_device_tables(src_w: int, src_h: int, dst_w: int, dst_h: int,
                          method: str, tile: int, align: int,
                          device: torch.device) -> Static2Device:
    """Build S2's tables at (tile, align) and upload them to ``device``,
    once per geometry, method, strip and device."""
    geo = (src_w, src_h, dst_w, dst_h, method)
    t = static2_tables(*geo, tile, align)
    wt = static2_w_tables(*geo)
    b = np.concatenate([core_matrix_order(t.luma),
                        core_matrix_order(t.chroma)], axis=1)
    return Static2Device(
        torch.from_numpy(b).to(device, torch.bfloat16),
        torch.from_numpy(t.starts).to(device), t.k_luma, t.k_chroma,
        torch.from_numpy(wt.heads).to(device),
        torch.from_numpy(wt.frags).to(device, torch.bfloat16))


#: the combo's instances (csrc/nv12_combo.cu): (frames a block, strip
#: height) -> how its two warpgroups split the block, so that a thread
#: holds at most 96 fp32 W accumulators (1.5 x the strip rows a frame):
#: "chunks" (S2's: each warpgroup one chunk of a 128-column stage, every
#: frame, partial sums traded at the end), "frames" (each warpgroup half
#: the frames, every chunk), "rounds" (the frames split on 4 frames at a
#: time, gframes / 4 rounds: the lab's M8) or "rows" (64-column stages,
#: each warpgroup half the strip's rows of every frame)
COMBO_SPLITS = {(2, 16): "chunks", (4, 16): "chunks", (2, 32): "chunks",
                (4, 32): "frames", (1, 64): "rows", (2, 64): "rows",
                (8, 32): "rounds"}
#: the combo's strips start on multiples of this many rows (the notebook's
#: ALIGN)
COMBO_ALIGN = 8


def combo_smem_bytes(gframes: int, tile: int, k_luma: int,
                     k_chroma: int) -> int:
    """Shared memory of one of the combo's blocks: the ring of
    STATIC2_STAGES stages of the stacked windows (128 columns, or 64 where
    the warpgroups split the rows), or the partial W sums its warpgroups
    trade at the end (the chunks split: gframes frames of 4 (N / 2 + N)
    128 bytes), the larger; B_y and B_c in bf16; and each warpgroup's H
    rows of a chunk at its N (tile, or tile / 2 in the rows split)."""
    split = COMBO_SPLITS[gframes, tile]
    cols, n = (64, tile // 2) if split == "rows" else (128, tile)
    kst = k_luma + k_chroma
    trade = gframes * 4 * (n // 2 + n) * 128 if split == "chunks" else 0
    ring = max(STATIC2_STAGES * kst * cols, trade)
    chunk = 8 * (16 * n + 16) + 4 * (32 * n + 16)
    return ring + 2 * kst * tile + 2 * chunk


def combo_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  method: str, gframes: int, tile: int) -> str:
    """Why the combo's kernel cannot take these frames a block, strip
    height and geometry, or "" when it can: a (gframes, tile) that is not
    one of COMBO_SPLITS, or a block's shared memory over a block's."""
    if (gframes, tile) not in COMBO_SPLITS:
        return (f"the combo's tensor-core kernel runs (gframes, tile) "
                f"{', '.join(map(str, COMBO_SPLITS))}, got "
                f"{(gframes, tile)}")
    t = static2_tables(src_w, src_h, dst_w, dst_h, method, tile, COMBO_ALIGN)
    smem = combo_smem_bytes(gframes, tile, t.k_luma, t.k_chroma)
    if smem > SMEM_LIMIT:
        return (f"the combo's ring, weights and H rows need {smem} B of "
                f"shared memory, over a block's {SMEM_LIMIT} B")
    return ""


def planar_u8_checked(fmt: str, y, u, v, *, src_w: int, src_h: int,
                      chroma_w: int, space: ColorSpace, crange: ColorRange,
                      out_dtype: torch.dtype, normalize, compute_dtype):
    """Validate the arguments of a full-height planar 8-bit kernel (4:2:2,
    4:4:4): y [B, >= H, W], u and v [B, >= H, chroma_w], all uint8 on one
    device. Returns (compute dtype, packed tail)."""
    if (y.dim() != 3 or u.dim() != 3 or v.dim() != 3
            or y.shape[1] < src_h or y.shape[2] != src_w
            or u.shape[1] < src_h or u.shape[2] != chroma_w
            or u.shape != v.shape or y.shape[0] != u.shape[0]):
        raise ValueError(
            f"Plane shapes {tuple(y.shape)}/{tuple(u.shape)}/"
            f"{tuple(v.shape)} do not match {fmt} {src_w}x{src_h}")
    if not (y.dtype == u.dtype == v.dtype == torch.uint8):
        raise ValueError(f"{fmt} planes must all be uint8, got "
                         f"{y.dtype}/{u.dtype}/{v.dtype}")
    if not (y.device == u.device == v.device):
        raise ValueError(f"{fmt} planes must be on one device")
    return (resolve_compute_dtype(compute_dtype),
            tail_params(space, crange, 1.0, out_dtype, normalize))


def launch_planar_u8(wrapper: str, y, u, v, *, src_w: int, src_h: int,
                     dst_w: int, dst_h: int, method: str, layout: str,
                     compute_dtype: torch.dtype, tail: np.ndarray,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``<wrapper>_launch`` (``yuv422_preprocess`` or
    ``yuv444_preprocess``) on checked CUDA planes; rows must be
    contiguous, rows past H and a batch stride larger than the plane are
    accepted; the block geometry is the packer's for this batch
    (:func:`stream_preprocess_tables`). Returns [B, 3, dst_h, dst_w] and
    counts ``launches.<wrapper>``."""
    with span(wrapper + ".checks"):
        if y.stride(2) != 1 or u.stride(2) != 1 or v.stride(2) != 1:
            raise ValueError("plane rows must be contiguous (stride 1)")
    B = y.shape[0]
    with span(wrapper + ".tables"):
        tabs = stream_preprocess_tables(src_w, src_h, dst_w, dst_h, method,
                                        layout, compute_dtype, y.dtype, B,
                                        sm_count(y.device), y.device)
    with span(wrapper + ".alloc"):
        out = torch.empty((B, 3, dst_h, dst_w), dtype=out_dtype,
                          device=y.device)
    with span(wrapper + ".launch"):
        from ._cuda_build import check, load_kernels

        lib = load_kernels()
        with torch.cuda.device(y.device):
            rc = getattr(lib, wrapper + "_launch")(
                y.data_ptr(), u.data_ptr(), v.data_ptr(), y.stride(0),
                y.stride(1), u.stride(0), u.stride(1), v.stride(0),
                v.stride(1), B, src_h, src_w, dst_h, dst_w, *tabs.args(),
                tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                int(compute_dtype == torch.float32), out.data_ptr(),
                OUT_KINDS[out_dtype], torch.cuda.current_stream().cuda_stream)
        check(lib, rc, wrapper)
        count("launches." + wrapper)
    return out


def kernel_preprocess_formats():
    """The formats a banded preprocess kernel covers — one source of truth
    for the pipeline's routing and the :func:`kernel_preprocess`
    dispatch."""
    return frozenset({
        PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12,
        PixelFormat.YUV420, PixelFormat.YUV420_10bit,
        PixelFormat.YUV422, PixelFormat.YUV444,
    })


def kernel_preprocess(planes, fmt, *, src_w: int, src_h: int, dst_w: int,
                      dst_h: int, space: ColorSpace, crange: ColorRange,
                      out_dtype: torch.dtype, method: str, normalize
                      ) -> torch.Tensor:
    """Dispatch the banded fused CSC+resize kernel for ``fmt``.

    Every format in :func:`kernel_preprocess_formats` has a branch here;
    an uncovered format raises. Output is planar [B, 3, dst_h, dst_w]."""
    from .nv12_preprocess import nv12_preprocess
    from .yuv420_preprocess import yuv420_preprocess
    from .yuv422_preprocess import yuv422_preprocess
    from .yuv444_preprocess import yuv444_preprocess

    fmt = PixelFormat(fmt)
    if fmt in (PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12):
        return nv12_preprocess(
            planes[0], src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h,
            space=space, crange=crange, out_dtype=out_dtype, method=method,
            normalize=normalize)
    if fmt in (PixelFormat.YUV420, PixelFormat.YUV420_10bit):
        bd = 10 if fmt == PixelFormat.YUV420_10bit else 8
        return yuv420_preprocess(
            planes[0], planes[1], planes[2], src_w=src_w, src_h=src_h,
            dst_w=dst_w, dst_h=dst_h, space=space, crange=crange,
            out_dtype=out_dtype, method=method, normalize=normalize,
            bit_depth=bd)
    planar = {PixelFormat.YUV422: yuv422_preprocess,
              PixelFormat.YUV444: yuv444_preprocess}.get(fmt)
    if planar is not None:
        return planar(
            planes[0], planes[1], planes[2], src_w=src_w, src_h=src_h,
            dst_w=dst_w, dst_h=dst_h, space=space, crange=crange,
            out_dtype=out_dtype, method=method, normalize=normalize)
    raise ValueError(
        f"no preprocess kernel for {fmt!r} — "
        f"kernel_preprocess_formats() is out of sync with this dispatch")


# --- banded resize (csrc/banded_resize.cu) ---------------------------------

#: sample dtype -> the resize kernels' in_kind code
IN_KINDS = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
#: output rows per block: kRows of csrc/banded_resize.cu
STRIP_ROWS = 8
#: source lanes one block's H pass aims to cover: four per thread of its
#: 256, two rounds at most
TARGET_LANES = 2048
SMEM_BUDGET = 200 * 1024


def resize_compute_dtype(dtype: torch.dtype, compute_dtype) -> torch.dtype:
    """Compute dtype of a banded resize: uint8 defaults to bfloat16;
    uint16 and float32 samples always compute in float32."""
    if dtype not in IN_KINDS:
        raise ValueError(
            f"resize samples must be uint8, uint16 or float32, got {dtype}")
    return resolve_compute_dtype(compute_dtype, hbd=dtype != torch.uint8)


def tile_window(start: np.ndarray, count: np.ndarray, tile: int) -> int:
    """Source indices the widest group of ``tile`` consecutive outputs
    reads (columns of a block's tile, or rows of its strip)."""
    idx = np.arange(0, len(start), tile)
    lo = np.minimum.reduceat(start, idx)
    hi = np.maximum.reduceat(start + count - 1, idx)
    return int((hi - lo + 1).max())


class ResizeTables(NamedTuple):
    """Band tables of one resampled image, uploaded to one device.

    ``index`` int32 holds, back to back: row start and count [DH] each,
    column start and count [DW] each. ``weights`` float32 holds the row
    weights [DH, taps[0]], then the column weights TRANSPOSED
    [taps[1], DW]. A block covers ``tile_w`` output columns, whose H pass
    reads at most ``window`` source pixels of each row, and STRIP_ROWS
    output rows, which read at most ``span`` source rows."""
    index: torch.Tensor
    weights: torch.Tensor
    taps: Tuple[int, int]
    tile_w: int
    window: int
    span: int

    def args(self):
        """The tables as a launcher takes them."""
        return (self.index.data_ptr(), self.weights.data_ptr(), *self.taps,
                self.tile_w, self.window, self.span)


@functools.lru_cache(maxsize=64)
def resize_tables(src_h: int, dst_h: int, src_w: int, dst_w: int,
                  method: str, compute_dtype: torch.dtype, channels: int,
                  device: torch.device) -> ResizeTables:
    """Build and upload one image's band tables once per geometry
    (:func:`pack_resize_tables`)."""
    return pack_resize_tables(
        band_table(resize_weights(src_h, dst_h, method), compute_dtype),
        band_table(resize_weights(src_w, dst_w, method), compute_dtype),
        compute_dtype, channels, device)


def pack_resize_tables(row_bands, col_bands, compute_dtype: torch.dtype,
                       channels: int, device: torch.device,
                       target_lanes: int = TARGET_LANES) -> ResizeTables:
    """Upload row and column bands ``(start, count, weights)`` of
    :func:`band_table` as a :class:`ResizeTables`.

    The tile is the widest power of two of output columns whose source
    window stays within ``target_lanes`` lanes (one with at least 8
    columns otherwise), narrowed while the block's shared memory would
    pass SMEM_BUDGET."""
    hs, hc, hw = row_bands
    ws, wc, ww = col_bands
    span = tile_window(hs, hc, STRIP_ROWS)
    elem = 4 if compute_dtype == torch.float32 else 2

    def smem(window):
        return STRIP_ROWS * (4 * span + elem * (window * channels + 6))

    tile = 512
    while tile > 8 and tile_window(ws, wc, tile) * channels > target_lanes:
        tile //= 2
    while tile > 1 and smem(tile_window(ws, wc, tile)) > SMEM_BUDGET:
        tile //= 2
    index = np.concatenate([hs, hc, ws, wc])
    weights = np.concatenate([hw.reshape(-1), ww.T.reshape(-1)])
    return ResizeTables(
        torch.from_numpy(index).to(device),
        torch.from_numpy(np.ascontiguousarray(weights)).to(device),
        (int(hw.shape[1]), int(ww.shape[1])), tile,
        tile_window(ws, wc, tile), span)


# --- the streaming block geometry of csrc/banded_resize.cu ------------------
# A block is (frame, column tile, strip of output rows). It walks its strip
# top to bottom in stages of `stage_rows` output rows; the source rows of the
# tile's window pass through a ring of `ring_rows` rows in shared memory,
# each fetched once per block, one stage ahead of the stage being summed.

#: threads of one block (kThreads)
STREAM_THREADS = 256
#: bytes each thread fetches and sums per H-pass item: 16-byte copies
STREAM_VEC_BYTES = 16
#: shared memory of one SM, and what the card reserves per block
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
#: blocks per SM the kernel's registers allow (about 64 a thread)
MAX_BLOCKS_PER_SM = 4
#: sample dtype -> bytes
SAMPLE_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.float32: 4}
#: output rows per stage the packer considers
STAGE_ROWS = (1, 2, 3, 4, 6, 8)
#: output rows one thread resamples together in the W pass (kRowBlock)
W_ROW_BLOCK = 4
#: stages whose rows are in flight while one is summed (kLookahead)
LOOKAHEAD = 2
#: the estimate's cost of a block's first fetch, in stage-cost units
#: (issue slots of one thread times blocks per SM): about 4 us of device
#: memory latency under load (about 2,000 units at ~2 us a stage)
FETCH_LATENCY = 2000


def ring_rows(start: np.ndarray, count: np.ndarray, stage_rows: int) -> int:
    """Source rows the ring must hold so that the rows fetched for stage
    t + LOOKAHEAD never overwrite a row that stage t still reads: the
    most, over stages of ``stage_rows`` output rows, of the highest row
    fetched so far through stage t + LOOKAHEAD less the first row of stage
    t, plus one (rows with an empty band read none). Raises where a stage
    starts above the next one: the ring only slides down the image."""
    idx = np.arange(0, len(start), stage_rows)
    has = count > 0
    lo = np.minimum.reduceat(np.where(has, start, np.iinfo(np.int32).max),
                             idx)
    hi = np.maximum.reduceat(np.where(has, start + count - 1, -1), idx)
    live = lo <= hi
    lo, hi = lo[live], hi[live]
    if np.any(np.diff(lo) < 0):
        raise ValueError("row bands start out of order: a sliding ring of "
                         "source rows cannot serve them")
    top = np.maximum.accumulate(hi)
    ahead = top[np.minimum(np.arange(len(top)) + LOOKAHEAD, len(top) - 1)]
    return int((ahead - lo + 1).max(initial=1))


def tile_lanes(start: np.ndarray, count: np.ndarray, tile: int,
               channels: int, vec: int) -> np.ndarray:
    """Per column tile of ``tile`` output pixels, the lanes of its source
    window, from its first lane rounded down to ``vec`` lanes, for samples
    of ``channels`` interleaved lanes."""
    idx = np.arange(0, len(start), tile)
    lo = np.minimum.reduceat(start, idx) * channels // vec * vec
    return np.maximum.reduceat(start + count, idx) * channels - lo


class StreamTables(NamedTuple):
    """Band tables and block geometry of the streaming resize kernel
    (``csrc/banded_resize.cu``) for one batch size, uploaded to one
    device.

    ``index`` and ``weights`` are packed as :class:`ResizeTables`'s. A
    block covers ``tile_w`` output pixels, whose source window spans at
    most ``pitch`` lanes (a multiple of 16 bytes of samples), and a strip
    of ``strip_rows`` output rows, which it sums ``stage_rows`` rows per
    stage from a ring of ``ring_rows`` source rows; it takes ``smem`` bytes
    of shared memory, so that ``blocks_per_sm`` blocks fit on one SM."""
    index: torch.Tensor
    weights: torch.Tensor
    taps: Tuple[int, int]
    tile_w: int
    pitch: int
    stage_rows: int
    ring_rows: int
    strip_rows: int
    smem: int
    blocks_per_sm: int

    def args(self):
        """The tables as a launcher takes them."""
        return (self.index.data_ptr(), self.weights.data_ptr(), *self.taps,
                self.tile_w, self.pitch, self.stage_rows, self.ring_rows,
                self.strip_rows)


def stream_smem(pitch: int, stage_rows: int, ring: int, tile: int,
                w_taps: int, sample_bytes: int, mid_bytes: int) -> int:
    """Shared memory of one block (the kernel's ``smem_bytes``): the ring
    of source rows, two stages of H rows in the compute type, and the
    tile's column weights (per pixel, padded to an odd count), starts and
    counts."""
    return (ring * pitch * sample_bytes + 2 * stage_rows * pitch * mid_bytes
            + tile * (4 * (w_taps | 1) + 8))


def stream_candidates(row_bands, col_bands, channels: int,
                      sample_bytes: int, mid_bytes: int, batch: int,
                      sms: int):
    """Every block geometry that fits in shared memory, as (estimated
    cost, (tile_w, pitch, stage_rows, ring_rows, strip_rows, smem,
    blocks_per_sm)), for ``batch`` images on ``sms`` SMs.

    A stage costs the issue slots of its slowest thread — H items of 16
    bytes of window lanes by output row, each the row taps long, and W
    items of one output lane by W_ROW_BLOCK rows, each the column taps
    long, in rounds of STREAM_THREADS — times the blocks that share the
    SM (a third more where one block is alone: nothing hides its barriers
    and fetches). A block costs its stages plus FETCH_LATENCY, the first
    fetch that nothing hides; the grid costs its waves of blocks. Ties go
    to the taller stage, the narrower tile, the taller strip."""
    hs, hc, _ = row_bands
    ws, wc, ww = col_bands
    dst_h, dst_w = len(hs), len(ws)
    vec = STREAM_VEC_BYTES // sample_bytes
    w_taps = int(ww.shape[1])
    cvt = 0 if sample_bytes == 4 else 2     # u8 / u16 -> f32 per use
    h_item = float(np.mean(hc)) * (vec * (cvt + 1) + 4)
    w_item = w_taps * (3 * W_ROW_BLOCK + 1)
    t = STREAM_THREADS
    rings = {g: ring_rows(hs, hc, g) for g in STAGE_ROWS}
    for tile in sorted({-(-dst_w // n) for n in range(1, min(dst_w, 64) + 1)}):
        lanes = tile_lanes(ws, wc, tile, channels, vec)
        pitch = -(-int(lanes.max()) // vec) * vec
        chunks = pitch // vec
        tiles = -(-dst_w // tile)
        for g, ring in rings.items():
            smem = stream_smem(pitch, g, ring, tile, w_taps, sample_bytes,
                               mid_bytes)
            if smem > SMEM_LIMIT:
                continue
            bps = min(SM_SMEM // (smem + BLOCK_RESERVED_SMEM),
                      MAX_BLOCKS_PER_SM)
            rounds_h = -(-g * chunks // t)
            rounds_w = -(-(-(-g // W_ROW_BLOCK)) * tile * channels // t)
            stage = (bps * (rounds_h * h_item + rounds_w * w_item)
                     * (4 / 3 if bps < 2 else 1))
            stages = -(-dst_h // g)
            for per in sorted({min(1 << k, stages) for k in range(12)}):
                strips = -(-stages // per)
                waves = -(-batch * tiles * strips // (sms * bps))
                cost = waves * (per * stage + FETCH_LATENCY)
                yield ((cost, -g, tile, -per),
                       (tile, pitch, g, ring, per * g, smem, bps))


def stream_geometry(row_bands, col_bands, channels: int, sample_bytes: int,
                    mid_bytes: int, batch: int, sms: int):
    """(tile_w, pitch, stage_rows, ring_rows, strip_rows, smem,
    blocks_per_sm) of the block that fits in shared memory and is
    estimated fastest for ``batch`` images on ``sms`` SMs
    (:func:`stream_candidates`). Raises when no tile and stage fit."""
    best = min(stream_candidates(row_bands, col_bands, channels,
                                 sample_bytes, mid_bytes, batch, sms),
               default=None)
    if best is None:
        raise ValueError(
            f"no column tile of a {len(col_bands[0])}-pixel row fits a "
            f"block's shared memory ({SMEM_LIMIT} bytes) with its ring of "
            f"source rows")
    return best[1]


class StreamBands(NamedTuple):
    """One image's row and column bands (host arrays of
    :func:`band_table`) and their upload: ``index`` and ``weights`` as
    :class:`ResizeTables`'s."""
    rows: tuple
    cols: tuple
    index: torch.Tensor
    weights: torch.Tensor


@functools.lru_cache(maxsize=64)
def stream_bands(src_h: int, dst_h: int, src_w: int, dst_w: int,
                 method: str, compute_dtype: torch.dtype,
                 device: torch.device) -> StreamBands:
    """Build and upload one image's band tables once per geometry, method,
    compute type and device: every sample type, channel count and batch
    size shares them."""
    rows = band_table(resize_weights(src_h, dst_h, method), compute_dtype)
    cols = band_table(resize_weights(src_w, dst_w, method), compute_dtype)
    index = np.concatenate([rows[0], rows[1], cols[0], cols[1]])
    weights = np.concatenate([rows[2].reshape(-1), cols[2].T.reshape(-1)])
    return StreamBands(
        rows, cols, torch.from_numpy(index).to(device),
        torch.from_numpy(np.ascontiguousarray(weights)).to(device))


def stream_tables(bands: StreamBands, geometry) -> StreamTables:
    """``bands`` with a block ``geometry`` of :func:`stream_candidates`."""
    return StreamTables(bands.index, bands.weights,
                        (int(bands.rows[2].shape[1]),
                         int(bands.cols[2].shape[1])), *geometry)


@functools.lru_cache(maxsize=256)
@traced_build
def stream_resize_tables(src_h: int, dst_h: int, src_w: int, dst_w: int,
                         method: str, compute_dtype: torch.dtype,
                         channels: int, sample_dtype: torch.dtype,
                         batch: int, sms: int,
                         device: torch.device) -> StreamTables:
    """One image's band tables (:func:`stream_bands`, uploaded once per
    geometry) with the streaming kernel's block geometry for ``batch``
    images of ``channels`` interleaved ``sample_dtype`` lanes on ``sms``
    SMs, chosen once per such call."""
    bands = stream_bands(src_h, dst_h, src_w, dst_w, method, compute_dtype,
                         device)
    return stream_tables(bands, stream_geometry(
        bands.rows, bands.cols, channels, SAMPLE_BYTES[sample_dtype],
        4 if compute_dtype == torch.float32 else 2, batch, sms))


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# --- the streaming block geometry of csrc/banded_preprocess.cu --------------
# A block is (frame, column tile, strip of output rows), walked top to bottom
# in stages of `stage_rows` output rows, as the resize's. Luma and chroma
# each pass through their own ring of source rows (4:2:0 chroma rows slide
# at half the luma rate, so each plane's depth comes from its own bands),
# fetched once per block by 16-byte cp.async copies two stages ahead of the
# stage that reads them; the H pass converts the samples it loads.

#: output rows an H item sums, each source sample converted once for both
#: (BANDED_PREPROCESS_H_ROWS)
PREPROCESS_H_ROWS = 2
#: blocks per SM the kernel is compiled for (__launch_bounds__(256, 2)):
#: its registers allow no more
PREPROCESS_BLOCKS_PER_SM = 2


#: the estimate's cost of a block's first fetch and column tables, in
#: stage-cost units (twice the resize's FETCH_LATENCY: its tables are two
#: sets of column weights, and a sweep of block geometries on the card
#: favoured fewer, taller strips)
PREPROCESS_BLOCK_COST = 4000


def preprocess_w_rows(layout: str, sample_bytes: int) -> int:
    """Output rows a W item resamples (the kernel's w_rows): 2 for 4:4:4,
    whose chroma column taps are twice as many, and for uint16 samples,
    else 4 (the faster of the two on the card, PERF.md section 6)."""
    return 2 if layout == "444" or sample_bytes == 2 else 4


#: chroma planes a ring holds, and lanes per chroma sample in one of them
_CHROMA_RINGS = {"nv12": (1, 2), "420": (2, 1), "422": (2, 1), "444": (2, 1)}


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


def preprocess_smem(y_pitch: int, c_pitch: int, stage_rows: int,
                    strip_rows: int, y_ring: int, c_ring: int, tile: int,
                    wy_taps: int, wc_taps: int, layout: str,
                    sample_bytes: int, mid_bytes: int) -> int:
    """Shared memory of one block (the kernel's ``carve``): the rings of
    luma and chroma (one interleaved UV plane for NV12, U and V planes
    otherwise), two stages of H rows in the compute type, the tile's column weights (per pixel, padded to an odd count),
    offsets and counts, and the luma and chroma source rows of each stage
    of the strip (four int32); each part starts on 16 bytes."""
    nc = _CHROMA_RINGS[layout][0]
    parts = (y_ring * y_pitch * sample_bytes,
             nc * c_ring * c_pitch * sample_bytes,
             2 * stage_rows * (y_pitch + nc * c_pitch) * mid_bytes,
             tile * (4 * (wy_taps | 1) + 4 * (wc_taps | 1) + 16),
             16 * (strip_rows // stage_rows))
    return sum(_ceil(p, 16) for p in parts)


class PreprocessTables(NamedTuple):
    """Band tables (:func:`device_tables`) and block geometry of the
    streaming preprocess kernel for one batch size, uploaded to one device.

    A block covers ``tile_w`` output pixels, whose luma and chroma source
    windows span at most ``y_pitch`` and ``c_pitch`` lanes (multiples of 16
    bytes of samples; a chroma lane is one U or V sample), and a strip of
    ``strip_rows`` output rows, summed ``stage_rows`` rows a stage. Source
    rows pass through rings of ``y_ring`` and ``c_ring`` rows. The block
    takes ``smem`` bytes of shared memory, so
    that ``blocks_per_sm`` blocks fit on one SM."""
    index: torch.Tensor
    weights: torch.Tensor
    taps: Tuple[int, int, int, int]
    tile_w: int
    y_pitch: int
    c_pitch: int
    stage_rows: int
    strip_rows: int
    y_ring: int
    c_ring: int
    smem: int
    blocks_per_sm: int
    geometry: np.ndarray   # int32 [7], tile_w .. c_ring, as the kernel reads

    def args(self):
        """The tables and geometry as a launcher takes them: table
        pointers, the four tap counts, the host geometry array."""
        return (self.index.data_ptr(), self.weights.data_ptr(), *self.taps,
                self.geometry.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))


def preprocess_candidates(bands, layout: str, sample_bytes: int,
                          mid_bytes: int, batch: int, sms: int):
    """Every block geometry that fits in shared memory, as (estimated cost,
    (tile_w, y_pitch, c_pitch, stage_rows, strip_rows, y_ring, c_ring,
    smem, blocks_per_sm)), for ``batch`` frames of the four ``bands``
    (:func:`band_table` of luma rows, chroma rows, luma columns, chroma
    columns) on ``sms`` SMs; ``layout`` is "nv12" for interleaved chroma
    rows, else the planar layout.

    The estimate is :func:`stream_candidates`'s: a stage costs the
    instruction slots of its slowest thread (H items of 16 bytes of window lanes by
    PREPROCESS_H_ROWS output rows over their bands, W items of one output
    pixel by :func:`preprocess_w_rows` rows over the luma and both chroma
    column taps), times the blocks that share an SM; a block costs its stages plus
    PREPROCESS_BLOCK_COST; the grid its waves."""
    (hys, hyc, _), (hcs, hcc, _), (wys, wyc, wyw), (wcs, wcc, wcw) = bands
    dst_h, dst_w = len(hys), len(wys)
    nc, cc = _CHROMA_RINGS[layout]
    vr = STREAM_VEC_BYTES // sample_bytes   # lanes an H item sums
    wy_t, wc_t = int(wyw.shape[1]), int(wcw.shape[1])
    # source rows a stage brings, per plane: the rows advance per output row
    y_adv = (hys[-1] + hyc[-1] - hys[0]) / max(dst_h, 1)
    c_adv = (hcs[-1] + hcc[-1] - hcs[0]) / max(dst_h, 1)
    hr = PREPROCESS_H_ROWS

    def h_item(taps, adv):
        """Instruction slots of an H item: each source row of its rows' bands
        loaded once (one slot), converted once (two a lane) and tested per
        row, each tap an FMA a lane and a weight load."""
        walk = taps + (hr - 1) * adv
        return walk * (2 * vr + 1 + 3 * hr) + hr * taps * (vr + 1)
    y_item = h_item(float(np.mean(hyc)), y_adv)
    c_item = h_item(float(np.mean(hcc)), c_adv)
    wr = preprocess_w_rows(layout, sample_bytes)
    w_item = (wy_t + 2 * wc_t) * (3 * wr + 1) + 30 * wr
    t = STREAM_THREADS
    depth = {g: (ring_rows(hys, hyc, g), ring_rows(hcs, hcc, g))
             for g in STAGE_ROWS}
    for tile in sorted({-(-dst_w // n) for n in range(1, min(dst_w, 64) + 1)}):
        y_pitch = _ceil(int(tile_lanes(wys, wyc, tile, 1, vr).max()), vr)
        c_pitch = _ceil(int(tile_lanes(wcs, wcc, tile, cc, vr).max()), vr)
        tiles = -(-dst_w // tile)
        for g, (yr, cr) in depth.items():
            blocks = -(-g // hr)
            rounds_h = (-(-blocks * y_pitch // vr // t) * y_item
                        + -(-blocks * nc * c_pitch // vr // t) * c_item)
            rounds_w = -(-(-(-g // wr)) * tile // t) * w_item
            stages = -(-dst_h // g)
            for per in sorted({min(1 << k, stages) for k in range(12)}):
                smem = preprocess_smem(y_pitch, c_pitch, g, per * g, yr, cr,
                                       tile, wy_t, wc_t, layout,
                                       sample_bytes, mid_bytes)
                if smem > SMEM_LIMIT:
                    continue
                bps = min(SM_SMEM // (smem + BLOCK_RESERVED_SMEM),
                          PREPROCESS_BLOCKS_PER_SM)
                stage = (bps * (rounds_h + rounds_w)
                         * (4 / 3 if bps < 2 else 1))
                strips = -(-stages // per)
                waves = -(-batch * tiles * strips // (sms * bps))
                cost = waves * (per * stage + PREPROCESS_BLOCK_COST)
                yield ((cost, -g, tile, -per),
                       (tile, y_pitch, c_pitch, g, per * g, yr, cr, smem,
                        bps))


@functools.lru_cache(maxsize=256)
@traced_build
def stream_preprocess_tables(src_w: int, src_h: int, dst_w: int, dst_h: int,
                             method: str, layout: str,
                             compute_dtype: torch.dtype,
                             sample_dtype: torch.dtype, batch: int, sms: int,
                             device: torch.device) -> PreprocessTables:
    """The band tables of one geometry and chroma layout
    (:func:`device_tables`, uploaded once per geometry) with the streaming
    preprocess kernel's block geometry for ``batch`` frames of
    ``sample_dtype`` on ``sms`` SMs, chosen once per such call: the
    candidate of :func:`preprocess_candidates` estimated fastest.
    ``layout`` is "nv12" for interleaved chroma rows or one of
    :data:`LAYOUTS` for planar chroma. Raises when no block fits, and where
    row bands start or end out of order (the kernel's H items and rings
    rely on bands that slide down the image)."""
    dense = "420" if layout == "nv12" else layout
    tabs = device_tables(src_w, src_h, dst_w, dst_h, method, dense,
                         compute_dtype, device)
    bands = _layout_bands(src_w, src_h, dst_w, dst_h, method, dense,
                          compute_dtype)
    for start, count, _ in bands[:2]:
        live = count > 0
        if (np.any(np.diff(start[live]) < 0)
                or np.any(np.diff((start + count)[live]) < 0)):
            raise ValueError("row bands start or end out of order: the "
                             "streaming kernel cannot serve them")
    cands = list(preprocess_candidates(
        bands, layout, SAMPLE_BYTES[sample_dtype],
        4 if compute_dtype == torch.float32 else 2, batch, sms))
    # a lone block's eight warps hide no latency: two or more an SM where
    # any geometry allows it
    best = min((c for c in cands if c[1][-1] >= 2), default=None) or min(
        cands, default=None)
    if best is None:
        raise ValueError(
            f"no column tile of a {dst_w}-pixel row fits a block's shared "
            f"memory ({SMEM_LIMIT} bytes) with its rings of source rows")
    return PreprocessTables(tabs.index, tabs.weights, tabs.taps, *best[1],
                            np.array(best[1][:7], np.int32))


@functools.lru_cache(maxsize=32)
def _layout_bands(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  method: str, layout: str, compute_dtype: torch.dtype):
    """The four host bands (:func:`band_table`) of :func:`device_tables`."""
    return tuple(band_table(m, compute_dtype) for m in dense_weights(
        src_w, src_h, dst_w, dst_h, method, layout))
