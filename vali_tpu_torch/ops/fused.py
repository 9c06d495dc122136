"""Fused batched video preprocess: CSC + chroma upsample + resize.

Counterpart of ``vali_tpu/ops/fused.py``: batches of decoded NV12/YUV420
frames -> model-ready RGB tensors, with resampling expressed as DENSE fp32
weight-matrix products and the 3x3 color matrix applied at the tail:

    rgb[n,o,p,c] = M[c,:] . [ (Wy_h y Wy_w^T)[n,o,p] - y_off,
                              (Wc_h u Wc_w^T)[n,o,p] - 128,
                              (Wc_h v Wc_w^T)[n,o,p] - 128 ]

The chroma weight matrices go straight from quarter-resolution planes to the
destination grid, so upsample and resize never materialize an intermediate.
This is the exact route: the banded kernels in ``ops/nv12_preprocess.py``
and ``ops/yuv420_preprocess.py`` are the fast route for the formats they
cover, and every other format takes this one.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from . import colors
from .csc import nv12_split
from .resize import LANCZOS_AA, method_conventions, phase_positions, \
    resize_weights


def _chroma_weights(n_in: int, n_out: int, full_res: int, method: str):
    """Weights mapping a subsampled chroma axis (n_in = full_res/2) directly
    onto the n_out destination grid.

    Chroma sample i sits at full-res position 2i + 0.5 (4:2:0 siting);
    destination pixel o samples full-res position (o+0.5)*scale - 0.5.
    Solving in chroma coordinates gives center (pos - 0.5) / 2.
    """
    kern, support, phase, antialias = method_conventions(method)
    scale = full_res / n_out
    dst_pos = phase_positions(n_out, scale, phase)
    centers = (dst_pos - 0.5) / 2.0
    cscale = (full_res / 2) / n_out
    fscale = max(1.0, cscale) if antialias else 1.0
    if kern is None:  # nearest
        w = np.zeros((n_out, n_in), dtype=np.float32)
        idx = np.clip(np.round(centers), 0, n_in - 1).astype(np.int64)
        w[np.arange(n_out), idx] = 1.0
        return w
    pos = np.arange(n_in)[None, :]
    w = kern((pos - centers[:, None]) / fscale)
    s = w.sum(axis=1, keepdims=True)
    return (w / np.where(s == 0.0, 1.0, s)).astype(np.float32)


#: exact_f32_matmul's shared state: the blocks open in any thread, and
#: the caller's settings saved by the first of them
_exact_lock = threading.Lock()
_exact_depth = 0
_exact_saved: Optional[Tuple[str, bool]] = None


@contextlib.contextmanager
def exact_f32_matmul():
    """Run fp32 matrix products and cuDNN convolutions in full IEEE fp32
    (TF32 off for both) inside the block, restoring the caller's settings
    afterwards.

    Both settings are process-global, so the blocks of all threads share
    one count under a lock: the first block to open saves the settings and
    turns TF32 off, nested and concurrent blocks only raise the count, and
    the last block to close restores what the first one saved. While any
    block is open, fp32 products in every thread of the process run exact:
    slower, never less exact. A change to either setting made while any
    block is open, from any thread, does not last: the last block to close
    puts back the values saved before the first one opened."""
    global _exact_depth, _exact_saved
    with _exact_lock:
        if _exact_depth == 0:
            _exact_saved = (torch.get_float32_matmul_precision(),
                            torch.backends.cudnn.allow_tf32)
            torch.set_float32_matmul_precision("highest")
            torch.backends.cudnn.allow_tf32 = False
        _exact_depth += 1
    try:
        yield
    finally:
        with _exact_lock:
            _exact_depth -= 1
            if _exact_depth == 0:
                precision, conv = _exact_saved
                torch.set_float32_matmul_precision(precision)
                torch.backends.cudnn.allow_tf32 = conv


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """uint8/uint16 samples -> exact float32 values."""
    if x.dtype == torch.uint16:
        # widen through the same-size signed view: unsigned 16-bit tensors
        # support only a few ops on every backend
        return x.view(torch.int16).to(torch.int32).bitwise_and_(
            0xFFFF).to(torch.float32)
    return x.to(torch.float32)


def sample_scale(src_fmt: PixelFormat) -> float:
    """Factor from 8-bit-referenced values (offsets, output range) to the
    input's stored units: LSB-aligned 10/12-bit formats store v10 = v8 * 4,
    P10/P12 store MSB-aligned 16-bit (v16 = v8 * 256)."""
    src_fmt = PixelFormat(src_fmt)
    if src_fmt in (PixelFormat.P10, PixelFormat.P12):
        return 256.0
    if src_fmt in (PixelFormat.YUV420_10bit, PixelFormat.YUV444_10bit):
        return 4.0
    return 1.0


def fused_preprocess(
    planes: Tuple[torch.Tensor, ...],
    src_fmt: PixelFormat,
    src_w: int,
    src_h: int,
    dst_w: int,
    dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8,
    planar: bool = False,
    method: str = LANCZOS_AA,
    normalize: Optional[Tuple[Tuple[float, float, float],
                              Tuple[float, float, float]]] = None,
) -> torch.Tensor:
    """Batched fused YUV -> resized RGB, dense fp32 resampling.

    planes: storage-layout batched planes of ``src_fmt`` on one device.
    normalize: optional (mean, std) per channel applied after scaling to
    [0,1] — fuses the model's input normalization into the same pass.
    Returns [N, dst_h, dst_w, 3] (or [N, 3, dst_h, dst_w] when planar).
    """
    if normalize is not None and out_dtype == torch.uint8:
        raise ValueError("normalize requires a float out_dtype")
    src_fmt = PixelFormat(src_fmt)
    if src_fmt in (PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12):
        y, u, v = nv12_split(planes[0], src_h)
    elif src_fmt in (PixelFormat.YUV420, PixelFormat.YUV420_10bit):
        y, u, v = planes
        y = y[:, :src_h]
        u, v = u[:, :src_h // 2], v[:, :src_h // 2]
    elif src_fmt in (PixelFormat.YUV444, PixelFormat.YUV444_10bit,
                     PixelFormat.YUV422):
        y, u, v = (p[:, :src_h] for p in planes)
    else:
        raise ValueError(f"fused_preprocess does not support {src_fmt.name}")
    return fused_resample(
        (y, u, v), preprocess_weights(src_fmt, src_w, src_h, dst_w, dst_h,
                                      method),
        src_fmt, space, crange, out_dtype, planar, normalize)


def preprocess_weights(src_fmt: PixelFormat, src_w: int, src_h: int,
                       dst_w: int, dst_h: int, method: str = LANCZOS_AA
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """The dense fp32 matrices of :func:`fused_preprocess`: ``(luma rows
    [dst_h, H], chroma rows, luma columns [dst_w, W], chroma columns)``;
    chroma takes the luma matrix along a full-resolution axis (4:4:4
    both, 4:2:2 rows)."""
    src_fmt = PixelFormat(src_fmt)
    wy_h = resize_weights(src_h, dst_h, method)
    wy_w = resize_weights(src_w, dst_w, method)
    if src_fmt in (PixelFormat.YUV444, PixelFormat.YUV444_10bit):
        return wy_h, wy_h, wy_w, wy_w  # full-resolution chroma
    wc_w = _chroma_weights(src_w // 2, dst_w, src_w, method)
    if src_fmt == PixelFormat.YUV422:
        return wy_h, wy_h, wy_w, wc_w  # full-height chroma rows
    return (wy_h, _chroma_weights(src_h // 2, dst_h, src_h, method), wy_w,
            wc_w)


def fused_resample(
    yuv: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    weights: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    src_fmt: PixelFormat,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8,
    planar: bool = False,
    normalize: Optional[Tuple[Tuple[float, float, float],
                              Tuple[float, float, float]]] = None,
) -> torch.Tensor:
    """The body of :func:`fused_preprocess` on split planes: ``y``, ``u``,
    ``v`` [N, rows, cols] resampled by ``weights`` (as
    :func:`preprocess_weights` orders them, each [n_out, n_in] over the
    rows or columns it is given), then the colour matrix and the output
    cast. A caller that holds a band of source rows passes the matching
    columns of the row matrices (``parallel/mesh.py``)."""
    src_fmt = PixelFormat(src_fmt)
    y, u, v = yuv
    mo = colors.yuv2rgb_matrix(space, crange)
    if mo is None:
        raise ValueError(f"Unsupported cc combo {space}/{crange}")
    m, y_off = mo
    m = m.astype(np.float32)
    scale = sample_scale(src_fmt)
    c_off = 128.0 * scale
    y_offset = y_off * scale

    dev = y.device
    wy_h, wc_h, wy_w, wc_w = (torch.from_numpy(np.ascontiguousarray(w)).to(
        dev) for w in weights)

    def resample(p, wh, ww):
        return torch.matmul(torch.matmul(wh, to_f32(p)), ww.T)

    with exact_f32_matmul():
        yr = resample(y, wy_h, wy_w) - y_offset
        ur = resample(u, wc_h, wc_w) - c_off
        vr = resample(v, wc_h, wc_w) - c_off

    mf = [[float(c) for c in row] for row in m]
    rgb = torch.stack([row[0] * yr + row[1] * ur + row[2] * vr
                       for row in mf], dim=-1)

    if out_dtype == torch.uint8:
        # rgb is in the input's stored units; divide back to 8-bit range
        rgb = torch.clamp(torch.round(rgb / scale), 0.0, 255.0).to(
            torch.uint8)
    else:
        rgb = (rgb / (scale * 255.0)).to(out_dtype)
        if normalize is not None:
            mean = torch.tensor(normalize[0], dtype=out_dtype, device=dev)
            std = torch.tensor(normalize[1], dtype=out_dtype, device=dev)
            rgb = (rgb - mean) / std
    if planar:
        rgb = rgb.movedim(-1, 1)
    return rgb


def letterbox_params(src_w: int, src_h: int, dst_w: int, dst_h: int
                     ) -> Tuple[int, int, int, int, float]:
    """Static letterbox geometry: aspect-preserving fit of (src_w, src_h)
    inside (dst_w, dst_h), centered.

    Returns ``(inner_w, inner_h, left, top, scale)`` — the resized content
    size, the pad offsets of its top-left corner, and the scale factor.
    Callers map model outputs (boxes, masks) back to source coordinates
    with ``src = (dst - (left, top)) / scale``.

    ``scale`` is the pre-rounding fit ratio (the YOLO-family convention),
    while ``inner_w``/``inner_h`` are round()ed — so the actual resample
    ratio can differ by up to half a pixel at the far edges for non-exact
    geometries. Callers needing exact back-mapping should use the per-axis
    effective scales ``inner_w / src_w`` and ``inner_h / src_h`` instead.
    """
    if src_w <= 0 or src_h <= 0 or dst_w <= 0 or dst_h <= 0:
        raise ValueError(
            f"letterbox_params needs positive sizes, got src {src_w}x{src_h}"
            f" dst {dst_w}x{dst_h}")
    scale = min(dst_w / src_w, dst_h / src_h)
    # round() keeps the common exact cases exact (e.g. 1920x1080 -> 640x360
    # inside 640x640) and is the convention detection stacks use.
    inner_w = max(1, min(dst_w, round(src_w * scale)))
    inner_h = max(1, min(dst_h, round(src_h * scale)))
    left = (dst_w - inner_w) // 2
    top = (dst_h - inner_h) // 2
    return inner_w, inner_h, left, top, scale


def letterbox_preprocess(
    planes: Tuple[torch.Tensor, ...],
    src_fmt: PixelFormat,
    src_w: int,
    src_h: int,
    dst_w: int,
    dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8,
    planar: bool = False,
    method: str = LANCZOS_AA,
    normalize: Optional[Tuple[Tuple[float, float, float],
                              Tuple[float, float, float]]] = None,
    pad_value: int = 114,
) -> torch.Tensor:
    """Batched fused letterbox: CSC + chroma upsample + aspect-preserving
    resize + centered constant pad (YOLO-family convention: gray 114 pad).

    The resample is :func:`fused_preprocess` onto the inner grid from
    :func:`letterbox_params`; the pad is :func:`letterbox_pad`.
    ``pad_value`` is in 8-bit display units regardless of src bit depth or
    out_dtype; float outputs get ``pad_value/255`` pushed through the same
    normalize transform as the content. Returns [N, dst_h, dst_w, 3] (or
    planar) for every source geometry.
    """
    inner_w, inner_h, left, top, _ = letterbox_params(
        src_w, src_h, dst_w, dst_h)
    inner = fused_preprocess(planes, src_fmt, src_w, src_h, inner_w,
                             inner_h, space, crange, out_dtype, False,
                             method, normalize)
    return letterbox_pad(inner, dst_w, dst_h, left, top,
                         pad_value=pad_value, normalize=normalize,
                         planar=planar)


def letterbox_pad(inner: torch.Tensor, dst_w: int, dst_h: int, left: int,
                  top: int, *, pad_value: int = 114, normalize=None,
                  planar: bool = False) -> torch.Tensor:
    """Place a channel-last [N, h, w, 3] content block onto a constant
    [N, dst_h, dst_w, 3] canvas at a fixed offset (the pad half of
    :func:`letterbox_preprocess`, reused by routes whose content resample
    runs in a kernel). ``pad_value`` semantics match letterbox_preprocess;
    the canvas dtype follows ``inner.dtype``."""
    out_dtype = inner.dtype
    n, h, w = inner.shape[:3]
    dev = inner.device
    if out_dtype == torch.uint8:
        fill = torch.full((3,), int(np.clip(pad_value, 0, 255)),
                          dtype=torch.uint8, device=dev)
    else:
        fill = torch.full((3,), pad_value / 255.0, dtype=out_dtype,
                          device=dev)
        if normalize is not None:
            mean = torch.tensor(normalize[0], dtype=out_dtype, device=dev)
            std = torch.tensor(normalize[1], dtype=out_dtype, device=dev)
            fill = ((fill - mean) / std).to(out_dtype)
    canvas = fill.expand(n, dst_h, dst_w, 3).clone()
    canvas[:, top:top + h, left:left + w] = inner
    if planar:
        canvas = canvas.movedim(-1, 1)
    return canvas
