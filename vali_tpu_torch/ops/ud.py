"""Fused Upsample-Downscale-Convert (the UDSurface op).

Counterpart of ``vali_tpu/ops/ud.py`` (reference src/TC/src/ResizeUtils.cu:
21-176, the fused chroma upsample + rescale + optional YUV->RGB, and the
per-plane Lanczos route for planar inputs, src/TC/src/UDSurface.cpp:85-94).
The bilinear texture sampling is two dense fp32 matrix products per plane
(TF32 off), and the semantics are the reference kernel's:

  - texture coordinates ``x/scale`` with the CUDA -0.5 texel offset and
    edge clamping (``resize_weights(..., phase="tex")``),
  - unorm reads (v / (2^bits - 1)), denormalization by ``2^bits`` with
    truncation (clamped instead of the reference's 8-bit wrap),
  - the fixed full-range analog-YUV matrix ``colors.UD_YUV2RGB`` with no
    luma offset, whatever the colour context,
  - float outputs stay normalized to [0, 1].

Plain PyTorch: no TPU kernel stands behind this op.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..core.enums import PixelFormat
from . import colors
from .csc import nv12_split, pack_channels
from .fused import exact_f32_matmul, to_f32
from .resize import BILINEAR, LANCZOS, resize_plane, resize_weights

F = PixelFormat

#: Parity: UDSurface::SupportedConversions (UDSurface.cpp:117-133).
SUPPORTED_CONVERSIONS: Tuple[Tuple[PixelFormat, PixelFormat], ...] = (
    (F.NV12, F.YUV444),
    (F.NV12, F.RGB),
    (F.NV12, F.RGB_32F),
    (F.NV12, F.RGB_PLANAR),
    (F.NV12, F.RGB_32F_PLANAR),
    (F.YUV420, F.YUV444),
    (F.P10, F.YUV444_10bit),
    (F.P10, F.RGB_32F),
    (F.P10, F.RGB_32F_PLANAR),
    (F.YUV420_10bit, F.YUV444_10bit),
)


def _tex_resize(plane: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resample in float32 with the UD kernel's tex coords."""
    n, h, w = plane.shape
    dev = plane.device

    def weights(n_in, n_out):
        return torch.from_numpy(resize_weights(
            n_in, n_out, BILINEAR, antialias=False, phase="tex")).to(dev)

    with exact_f32_matmul():
        tmp = torch.matmul(weights(h, out_h), to_f32(plane))
        return torch.matmul(tmp, weights(w, out_w).T)


def _denorm(c: torch.Tensor, scale: float, cap: float,
            dtype: torch.dtype) -> torch.Tensor:
    """floor(c * 2^bits), clamped to [0, cap], as ``dtype``."""
    return torch.clamp(torch.floor(c * scale), 0.0, cap).to(dtype)


def ud_batch(planes: Sequence[torch.Tensor], src_fmt: PixelFormat,
             dst_fmt: PixelFormat, src_w: int, src_h: int,
             dst_w: int, dst_h: int) -> Tuple[torch.Tensor, ...]:
    """Fused convert+resize of batched storage-layout planes."""
    src_fmt, dst_fmt = PixelFormat(src_fmt), PixelFormat(dst_fmt)
    if (src_fmt, dst_fmt) not in SUPPORTED_CONVERSIONS:
        raise KeyError(
            f"UD conversion {src_fmt.name} -> {dst_fmt.name} not supported")

    # --- planar inputs: per-plane Lanczos resize (UDPlanar route) --------
    if src_fmt in (F.YUV420, F.YUV420_10bit):
        return tuple(resize_plane(p, dst_h, dst_w, LANCZOS) for p in planes)

    # --- semi-planar (NV12 / P10): the fused texture path -----------------
    bits = 8 if src_fmt == F.NV12 else 16
    unorm = float((1 << bits) - 1)
    denorm = float(1 << bits)

    y, u, v = nv12_split(planes[0], src_h)
    y_res = _tex_resize(y, dst_h, dst_w) / unorm
    u_res = _tex_resize(u, dst_h, dst_w) / unorm
    v_res = _tex_resize(v, dst_h, dst_w) / unorm

    if dst_fmt in (F.YUV444, F.YUV444_10bit):
        out_dtype = torch.uint8 if dst_fmt == F.YUV444 else torch.uint16
        return tuple(_denorm(c, denorm, unorm, out_dtype)
                     for c in (y_res, u_res, v_res))

    m = colors.UD_YUV2RGB.astype("float32")
    n_u = u_res - 0.5
    n_v = v_res - 0.5
    r = y_res + float(m[0, 2]) * n_v
    g = y_res + float(m[1, 1]) * n_u + float(m[1, 2]) * n_v
    b = y_res + float(m[2, 1]) * n_u

    chans: List[torch.Tensor]
    if dst_fmt in (F.RGB, F.RGB_PLANAR):
        chans = [_denorm(c, denorm, 255.0, torch.uint8) for c in (r, g, b)]
    else:
        # float outputs keep the normalized [0, 1] values (Denormalize<float>
        # is a no-op in the reference kernel)
        chans = [r, g, b]
    if dst_fmt in (F.RGB, F.RGB_32F):
        return (pack_channels(chans),)
    return (torch.cat(chans, dim=1),)  # [N, 3H, W] planar
