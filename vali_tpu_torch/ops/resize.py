"""Resampling matrices and the dense batched resize.

Counterpart of ``vali_tpu/ops/resize.py``: the same Lanczos-3 / bilinear /
nearest matrices with the same phase and anti-alias conventions, so the
banded kernels and the dense torch path resample exactly like the JAX
package. Each dense ``[n_out, n_in]`` matrix is built on the host once per
(in, out, filter) and cached. :func:`resize_batch` is the ResizeSurface op
over batched planes: two dense fp32 matrix products per plane (the exact
route), or the banded resize kernels (``ops/packed_resize.py`` by default
for packed RGB on a CUDA device).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.enums import PixelFormat
from ..utils.tracing import span

#: NPP-parity Lanczos-3: corner-aligned phase, no filter scaling.
LANCZOS = "lanczos"
BILINEAR = "bilinear"
NEAREST = "nearest"
#: Anti-aliased, pixel-center variants (PIL-style) — higher quality for
#: large downscales; use in ML preprocessing pipelines.
LANCZOS_AA = "lanczos_aa"
BILINEAR_AA = "bilinear_aa"

METHODS = (LANCZOS, BILINEAR, NEAREST, LANCZOS_AA, BILINEAR_AA)

#: Formats PySurfaceResizer accepts (parity: TaskResizeSurface.cpp:293-309,
#: plus P10/P12, Y, GRAY12 and YUV422, which resize on the same paths).
SUPPORTED_FORMATS = (
    PixelFormat.RGB,
    PixelFormat.BGR,
    PixelFormat.YUV420,
    PixelFormat.YUV444,
    PixelFormat.RGB_PLANAR,
    PixelFormat.RGB_32F,
    PixelFormat.RGB_32F_PLANAR,
    PixelFormat.NV12,
    PixelFormat.P10,
    PixelFormat.P12,
    PixelFormat.Y,
    PixelFormat.GRAY12,
    PixelFormat.YUV422,
)


def method_conventions(method: str):
    """(kern, support, phase, antialias) for a resize-method string,
    mirroring resize_weights' normalization — so chroma weight builders
    resample with exactly the same kernel, phase and antialias as the luma
    path. kern is None for NEAREST."""
    antialias, phase = None, None
    m = method
    if m == LANCZOS_AA:
        m, antialias, phase = LANCZOS, True, "center"
    elif m == BILINEAR_AA:
        m, antialias, phase = BILINEAR, True, "center"
    if antialias is None:
        antialias = False
    phase = phase or "corner"
    if m == LANCZOS:
        kern, support = (lambda x: _lanczos(x, 3.0)), 3.0
    elif m == BILINEAR:
        kern, support = _bilinear, 1.0
    elif m == NEAREST:
        kern, support = None, 0.5
    else:
        raise ValueError(f"Unknown resize method {method!r}")
    return kern, support, phase, antialias


def phase_positions(n_out: int, scale: float, phase: str) -> np.ndarray:
    """Destination sample positions in source coordinates for a phase."""
    if phase == "corner":
        return np.arange(n_out) * scale
    if phase == "tex":
        return np.arange(n_out) * scale - 0.5
    return (np.arange(n_out) + 0.5) * scale - 0.5


def _lanczos(x: np.ndarray, a: float) -> np.ndarray:
    x = np.abs(x)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(x < a, out, 0.0)


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.maximum(0.0, 1.0 - x)


@functools.lru_cache(maxsize=256)
def resize_weights(n_in: int, n_out: int, method: str = LANCZOS,
                   antialias: Optional[bool] = None,
                   phase: Optional[str] = None) -> np.ndarray:
    """Dense [n_out, n_in] resampling matrix, rows normalized to 1.

    phase:
      - "corner": src = i*scale — NPP nppiResize convention.
      - "center": src = (i+0.5)*scale - 0.5 — PIL/OpenCV convention.
      - "tex":    src = i*scale - 0.5 — the tex2D convention.

    The cached array is shared by every caller: treat it as read-only.
    """
    if method == LANCZOS_AA:
        method = LANCZOS
        antialias = True if antialias is None else antialias
        phase = phase or "center"
    elif method == BILINEAR_AA:
        method = BILINEAR
        antialias = True if antialias is None else antialias
        phase = phase or "center"
    if antialias is None:
        antialias = False
    phase = phase or "corner"

    if n_in == n_out and phase != "tex":
        return np.eye(n_out, dtype=np.float32)
    scale = n_in / n_out
    if method == NEAREST:
        idx = np.minimum((np.arange(n_out) + 0.5) * scale, n_in - 1)
        w = np.zeros((n_out, n_in), dtype=np.float32)
        w[np.arange(n_out), idx.astype(np.int64)] = 1.0
        return w
    if method == LANCZOS:
        support, kern = 3.0, lambda x: _lanczos(x, 3.0)
    elif method == BILINEAR:
        support, kern = 1.0, _bilinear
    else:
        raise ValueError(f"Unknown resize method {method!r}")
    fscale = max(1.0, scale) if antialias else 1.0
    if phase == "tex":
        centers = np.arange(n_out) * scale - 0.5
    elif phase == "corner":
        centers = np.arange(n_out) * scale
    else:
        centers = (np.arange(n_out) + 0.5) * scale - 0.5  # src coords
    # Evaluate the kernel on the full [n_out, n_in] grid; the support window
    # zeroes everything else. n_in <= a few thousand, so this stays small.
    src_pos = np.arange(n_in)[None, :]
    dist = (src_pos - centers[:, None]) / fscale
    w = kern(dist)
    # Edge handling: fold out-of-range taps into the nearest edge pixel by
    # renormalizing rows (equivalent for a partition-of-unity kernel
    # evaluated with clamped taps).
    row_sum = w.sum(axis=1, keepdims=True)
    w = w / np.where(row_sum == 0.0, 1.0, row_sum)
    return w.astype(np.float32)


def round_to(x, dtype: torch.dtype):
    """Round float32 values to ``dtype`` and widen back to float32 (the
    compute dtype's cast points, kept in float32 storage)."""
    t = torch.as_tensor(x, dtype=torch.float32)
    return t.to(dtype).to(torch.float32) if dtype != torch.float32 else t


def from_f32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 results -> ``dtype``: integer types round half to even,
    then clamp to their range; float types are cast."""
    if dtype.is_floating_point:
        return x.to(dtype)
    maxv = 255.0 if dtype == torch.uint8 else 65535.0
    return torch.clamp(torch.round(x), 0.0, maxv).to(dtype)


def resize_plane(plane: torch.Tensor, out_h: int, out_w: int,
                 method: str = LANCZOS, channels: int = 1,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Resize one batched plane [N, H, W*channels] preserving dtype.

    ``channels > 1`` treats the minor dim as packed interleaved channels:
    output lane ``C*p + c`` reads input lanes ``C*q + c`` only. Two dense
    fp32 products with TF32 off. With the default float32 this is the
    exact route; ``compute_dtype=torch.bfloat16`` gives the banded
    kernels' cast points (weights and the H-pass result rounded to
    bfloat16), which makes it their plain version."""
    from .fused import exact_f32_matmul, to_f32

    n, h, wc = plane.shape
    w = wc // channels
    dev = plane.device
    wh = round_to(resize_weights(h, out_h, method), compute_dtype).to(dev)
    ww = round_to(resize_weights(w, out_w, method), compute_dtype).to(dev)
    with exact_f32_matmul():
        t = round_to(torch.matmul(wh, to_f32(plane)), compute_dtype)
        t = t.unflatten(2, (w, channels)).movedim(-1, -2)  # [N, DH, C, W]
        out = torch.matmul(t, ww.T).movedim(-2, -1)        # [N, DH, DW, C]
    return from_f32(out.reshape(n, out_h, out_w * channels), plane.dtype)


def resize_batch(planes: Sequence[torch.Tensor], fmt: PixelFormat,
                 src_w: int, src_h: int, dst_w: int, dst_h: int,
                 method: str = LANCZOS,
                 use_kernel: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Resize batched storage-layout planes of ``fmt`` to dst size.

    On a CUDA device the packed 3-channel formats (RGB/BGR/RGB_32F) route
    to the banded packed-resize kernel (``ops/packed_resize.py``; uint8
    computes in bfloat16, within the reference's 4-LSB envelope of the
    exact route; float32 stays float32). ``use_kernel=False`` forces the exact dense route,
    ``use_kernel=True`` the kernel route (its plain version on CPU
    tensors). Every other format takes the exact route; the resizer's
    ``turbo`` mode reaches the other banded kernels."""
    with span("resize_batch"):
        from .csc import nv12_merge, nv12_split
        from ..utils.device import kernel_platform_available

        fmt = PixelFormat(fmt)
        if fmt in (PixelFormat.RGB, PixelFormat.BGR, PixelFormat.RGB_32F):
            if use_kernel is None:
                use_kernel = kernel_platform_available(planes[0].device)
            if use_kernel:
                from .packed_resize import packed_resize

                return (packed_resize(planes[0], src_w=src_w, src_h=src_h,
                                      dst_w=dst_w, dst_h=dst_h,
                                      method=method),)
            return (resize_plane(planes[0], dst_h, dst_w, method,
                                 channels=3),)
        if fmt in (PixelFormat.RGB_PLANAR, PixelFormat.RGB_32F_PLANAR):
            n, h3, w = planes[0].shape
            chans = planes[0].reshape(n * 3, h3 // 3, w)
            out = resize_plane(chans, dst_h, dst_w, method)
            return (out.reshape(n, 3 * dst_h, dst_w),)
        if fmt in (PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12):
            # plane-wise, chroma as its own half-size image (reference:
            # TaskResizeSurface.cpp:132-188)
            y, u, v = nv12_split(planes[0], src_h)
            half_h, half_w = dst_h // 2, dst_w // 2
            return (nv12_merge(resize_plane(y, dst_h, dst_w, method),
                               resize_plane(u, half_h, half_w, method),
                               resize_plane(v, half_h, half_w, method)),)
        if fmt in (PixelFormat.YUV420, PixelFormat.YUV420_10bit):
            return (
                resize_plane(planes[0], dst_h, dst_w, method),
                resize_plane(planes[1], dst_h // 2, dst_w // 2, method),
                resize_plane(planes[2], dst_h // 2, dst_w // 2, method),
            )
        if fmt == PixelFormat.YUV422:
            return (
                resize_plane(planes[0], dst_h, dst_w, method),
                resize_plane(planes[1], dst_h, dst_w // 2, method),
                resize_plane(planes[2], dst_h, dst_w // 2, method),
            )
        if fmt in (PixelFormat.YUV444, PixelFormat.YUV444_10bit):
            return tuple(resize_plane(p, dst_h, dst_w, method)
                         for p in planes)
        if fmt in (PixelFormat.Y, PixelFormat.GRAY12):
            return (resize_plane(planes[0], dst_h, dst_w, method),)
        raise ValueError(f"Resize does not support {fmt.name}")
