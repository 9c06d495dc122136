"""Batched color-space / pixel-format conversions (the ConvertSurface op).

Counterpart of ``vali_tpu/ops/csc.py`` (reference
src/TC/src/TaskConvertSurface.cpp:966-1086): every conversion is a
function over BATCHED plane tensors ``[N, Hp, Wp]``; single-surface calls
are the N=1 case. The pair list and the per-pair (color space x range)
support matrix mirror the reference exactly, quirks included (NV12->RGB
rejects BT_601+MPEG, YUV444->RGB is BT_601+JPEG only).

This is the exact route: fp32 arithmetic, round half to even, clamp. On a
CUDA device NV12 -> RGB/BGR in uint8 goes to the kernel of
``ops/nv12_to_rgb.py`` instead (bf16 coefficients, within 2 LSB).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..utils.tracing import span
from . import colors

_J = ColorRange.JPEG
_M = ColorRange.MPEG
_601 = ColorSpace.BT_601
_709 = ColorSpace.BT_709


class UnsupportedConversionParams(ValueError):
    """Raised when (src,dst) pair is OK but (space, range) combo is not."""


# --------------------------------------------------------------------------
# Layout helpers (views where the strides allow)
# --------------------------------------------------------------------------


def nv12_split(plane: torch.Tensor, height: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, >= H*3/2, W] -> (y [N,H,W], u [N,H/2,W/2], v [N,H/2,W/2]).

    All three are strided views of ``plane``; rows past H*3/2 are
    ignored."""
    y = plane[:, :height, :]
    uv = plane[:, height:height * 3 // 2, :]
    n, hc, w = uv.shape
    uv = uv.unflatten(2, (w // 2, 2))
    return y, uv[..., 0], uv[..., 1]


def nv12_merge(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Inverse of :func:`nv12_split`."""
    n, hc, wc = u.shape
    uv = torch.stack([u, v], dim=-1).reshape(n, hc, wc * 2)
    return torch.cat([y, uv], dim=1)


def packed_rgb_view(plane: torch.Tensor) -> torch.Tensor:
    """[N, H, W*3] -> [N, H, W, 3]."""
    n, h, w3 = plane.shape
    return plane.reshape(n, h, w3 // 3, 3)


def packed_rgb_store(rgb: torch.Tensor) -> torch.Tensor:
    n, h, w, c = rgb.shape
    return rgb.reshape(n, h, w * c)


def planar_rgb_view(plane: torch.Tensor) -> torch.Tensor:
    """[N, 3H, W] -> [N, H, W, 3]."""
    n, h3, w = plane.shape
    return plane.reshape(n, 3, h3 // 3, w).movedim(1, -1)


def planar_rgb_store(rgb: torch.Tensor) -> torch.Tensor:
    n, h, w, c = rgb.shape
    return rgb.movedim(-1, 1).reshape(n, c * h, w)


def upsample2x_nearest(c: torch.Tensor) -> torch.Tensor:
    """Chroma 2x replication on both axes, matching NPP's 4:2:0
    upsampling."""
    return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def yuv_to_rgb_channels(y, u, v, space: ColorSpace, crange: ColorRange,
                        bit_depth: int = 8) -> Tuple[torch.Tensor, ...]:
    """Full-resolution YUV planes [N,H,W] -> float32 (r, g, b) planes.

    ``bit_depth > 8`` is the MSB-aligned uint16 layout (P010/P012:
    v16 = v8 * 256), so the offsets scale by 256."""
    from .fused import to_f32

    mo = colors.yuv2rgb_matrix(space, crange)
    if mo is None:
        raise UnsupportedConversionParams(
            f"YUV->RGB unsupported for {space.name}+{crange.name}")
    m, y_off = mo
    scale = 256.0 if bit_depth > 8 else 1.0
    c_off = 128.0 * scale
    m = [[float(c) for c in row] for row in m.astype(np.float32)]
    yf = to_f32(y) - y_off * scale
    uf = to_f32(u) - c_off
    vf = to_f32(v) - c_off
    return tuple(row[0] * yf + row[1] * uf + row[2] * vf for row in m)


def rgb_to_yuv_channels(r, g, b, space: ColorSpace, crange: ColorRange
                        ) -> Tuple[torch.Tensor, ...]:
    """float32 (r, g, b) planes -> float32 (y, u, v) planes."""
    mo = colors.rgb2yuv_matrix(space, crange)
    if mo is None:
        raise UnsupportedConversionParams(
            f"RGB->YUV unsupported for {space.name}+{crange.name}")
    m, y_off = mo
    m = [[float(c) for c in row] for row in m.astype(np.float32)]
    offs = (y_off, 128.0, 128.0)
    return tuple(row[0] * r + row[1] * g + row[2] * b + off
                 for row, off in zip(m, offs))


def unpack_channels(plane: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Packed [N, H, W*3] -> three [N,H,W] channel views."""
    x = packed_rgb_view(plane)
    return x[..., 0], x[..., 1], x[..., 2]


def pack_channels(chans) -> torch.Tensor:
    """Three [N,H,W] planes -> packed [N, H, W*3]."""
    return packed_rgb_store(torch.stack(list(chans), dim=-1))


def subsample420(c: torch.Tensor) -> torch.Tensor:
    """[N,H,W] -> [N,H/2,W/2] by 2x2 mean."""
    n, h, w = c.shape
    return c.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


# --------------------------------------------------------------------------
# Conversion registry
# --------------------------------------------------------------------------

# impl(planes, width, height, space, crange) -> planes
_Impl = Callable[..., Tuple[torch.Tensor, ...]]


class _Conv:
    __slots__ = ("impl", "combos", "default")

    def __init__(self, impl: _Impl, combos, default):
        self.impl = impl
        self.combos = combos  # None = colorspace-independent
        self.default = default


_REGISTRY: Dict[Tuple[PixelFormat, PixelFormat], _Conv] = {}


def _register(src: PixelFormat, dst: PixelFormat, combos=None,
              default=(_601, _J)):
    def deco(fn):
        _REGISTRY[(src, dst)] = _Conv(fn, combos, default)
        return fn

    return deco


F = PixelFormat


@_register(F.NV12, F.YUV420)
def _nv12_yuv420(planes, w, h, space, crange):
    return nv12_split(planes[0], h)


@_register(F.YUV420, F.NV12)
def _yuv420_nv12(planes, w, h, space, crange):
    return (nv12_merge(*planes),)


@_register(F.P10, F.NV12)
@_register(F.P12, F.NV12)
def _p16_nv12(planes, w, h, space, crange):
    # keep the top 8 bits (reference p16_nv12: DivC by 256 + 16u->8u)
    wide = planes[0].view(torch.int16).to(torch.int32).bitwise_and_(0xFFFF)
    return (wide.bitwise_right_shift_(8).to(torch.uint8),)


def _nv12_rgb_impl(planes, w, h, space, crange, swap: bool):
    y, u, v = nv12_split(planes[0], h)
    r, g, b = yuv_to_rgb_channels(y, upsample2x_nearest(u),
                                  upsample2x_nearest(v), space, crange)
    chans = (b, g, r) if swap else (r, g, b)
    return (pack_channels(_round_u8(c) for c in chans),)


@_register(F.NV12, F.RGB, combos={(_709, _J), (_709, _M), (_601, _J)},
           default=(_709, _J))
def _nv12_rgb(planes, w, h, space, crange):
    return _nv12_rgb_impl(planes, w, h, space, crange, swap=False)


@_register(F.NV12, F.BGR, combos={(_709, _J), (_709, _M), (_601, _J)},
           default=(_709, _J))
def _nv12_bgr(planes, w, h, space, crange):
    return _nv12_rgb_impl(planes, w, h, space, crange, swap=True)


@_register(F.RGB, F.RGB_PLANAR)
def _rgb_deinterleave(planes, w, h, space, crange):
    return (planar_rgb_store(packed_rgb_view(planes[0])),)


@_register(F.RGB_PLANAR, F.RGB)
def _rgb_interleave(planes, w, h, space, crange):
    return (packed_rgb_store(planar_rgb_view(planes[0])),)


@_register(F.RGB_PLANAR, F.YUV444, combos={(_601, _J), (_601, _M)})
def _rgb_planar_yuv444(planes, w, h, space, crange):
    p = planes[0]
    hh = p.shape[1] // 3
    r, g, b = (_f32(p[:, i * hh:(i + 1) * hh, :]) for i in range(3))
    return tuple(_round_u8(c)
                 for c in rgb_to_yuv_channels(r, g, b, space, crange))


@_register(F.Y, F.YUV444)
def _y_yuv444(planes, w, h, space, crange):
    y = planes[0]
    gray = torch.full_like(y, 128)
    return y, gray, gray


def _yuv420_rgb_impl(planes, w, h, space, crange, swap: bool):
    y, u, v = planes
    r, g, b = yuv_to_rgb_channels(y, upsample2x_nearest(u),
                                  upsample2x_nearest(v), space, crange)
    chans = (b, g, r) if swap else (r, g, b)
    return (pack_channels(_round_u8(c) for c in chans),)


@_register(F.YUV420, F.RGB, combos={(_601, _J), (_601, _M)})
def _yuv420_rgb(planes, w, h, space, crange):
    return _yuv420_rgb_impl(planes, w, h, space, crange, swap=False)


@_register(F.YUV420, F.BGR, combos={(_601, _J), (_601, _M)})
def _yuv420_bgr(planes, w, h, space, crange):
    return _yuv420_rgb_impl(planes, w, h, space, crange, swap=True)


@_register(F.RGB, F.YUV420, combos={(_601, _J), (_601, _M)})
def _rgb_yuv420(planes, w, h, space, crange):
    r, g, b = (_f32(c) for c in unpack_channels(planes[0]))
    y, u, v = rgb_to_yuv_channels(r, g, b, space, crange)
    return _round_u8(y), _round_u8(subsample420(u)), _round_u8(
        subsample420(v))


@_register(F.RGB, F.YUV444, combos={(_601, _J), (_601, _M)})
def _rgb_yuv444(planes, w, h, space, crange):
    r, g, b = (_f32(c) for c in unpack_channels(planes[0]))
    return tuple(_round_u8(c)
                 for c in rgb_to_yuv_channels(r, g, b, space, crange))


@_register(F.RGB, F.BGR)
@_register(F.BGR, F.RGB)
def _swap_channels(planes, w, h, space, crange):
    return (packed_rgb_store(packed_rgb_view(planes[0]).flip(-1)),)


def _yuv444_rgb_impl(planes, w, h, space, crange, swap: bool):
    r, g, b = yuv_to_rgb_channels(*planes, space, crange)
    chans = (b, g, r) if swap else (r, g, b)
    return (pack_channels(_round_u8(c) for c in chans),)


@_register(F.YUV444, F.BGR, combos={(_601, _J), (_601, _M)})
def _yuv444_bgr(planes, w, h, space, crange):
    return _yuv444_rgb_impl(planes, w, h, space, crange, swap=True)


@_register(F.YUV444, F.RGB, combos={(_601, _J)})
def _yuv444_rgb(planes, w, h, space, crange):
    return _yuv444_rgb_impl(planes, w, h, space, crange, swap=False)


@_register(F.BGR, F.YUV444, combos={(_601, _J), (_601, _M)})
def _bgr_yuv444(planes, w, h, space, crange):
    b, g, r = (_f32(c) for c in unpack_channels(planes[0]))
    return tuple(_round_u8(c)
                 for c in rgb_to_yuv_channels(r, g, b, space, crange))


@_register(F.NV12, F.Y)
def _nv12_y(planes, w, h, space, crange):
    return (planes[0][:, :h, :],)


@_register(F.RGB, F.RGB_32F)
def _rgb_to_32f(planes, w, h, space, crange):
    # nppiScale_8u32f maps [0,255] -> [0.0, 1.0]
    return (_f32(planes[0]) / 255.0,)


@_register(F.RGB, F.Y)
def _rgb_y(planes, w, h, space, crange):
    r, g, b = (_f32(c) for c in unpack_channels(planes[0]))
    wts = [float(x) for x in colors.GRAY_WEIGHTS.astype(np.float32)]
    return (_round_u8(r * wts[0] + g * wts[1] + b * wts[2]),)


@_register(F.RGB_32F, F.RGB_32F_PLANAR)
def _rgb32f_deinterleave(planes, w, h, space, crange):
    return (planar_rgb_store(packed_rgb_view(planes[0])),)


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------


def supported_conversions() -> List[Tuple[PixelFormat, PixelFormat]]:
    """Parity with ConvertSurface::GetSupportedConversions
    (TaskConvertSurface.cpp:966-994)."""
    return list(_REGISTRY.keys())


def convert_batch(
    planes: Sequence[torch.Tensor],
    src_fmt: PixelFormat,
    dst_fmt: PixelFormat,
    width: int,
    height: int,
    cc=None,
    use_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, ...]:
    """Convert batched planes [N, Hp, Wp] from src_fmt to dst_fmt.

    On a CUDA device NV12 -> RGB/BGR in uint8 routes to the kernel of
    ``ops/nv12_to_rgb.py`` (bf16 coefficients; within 2 LSB of the exact
    route). ``use_kernel=False`` forces the exact route,
    ``use_kernel=True`` the kernel route (its plain version on CPU
    tensors). Every other pair takes the exact route.

    Raises KeyError for unsupported pairs and
    UnsupportedConversionParams for unsupported (space, range) combos.
    """
    with span("convert_batch"):
        from ..utils.device import kernel_platform_available

        src_fmt, dst_fmt = PixelFormat(src_fmt), PixelFormat(dst_fmt)
        conv = _REGISTRY.get((src_fmt, dst_fmt))
        if conv is None:
            raise KeyError(
                f"Conversion {src_fmt.name} -> "
                f"{dst_fmt.name} is not supported")
        space, crange = colors.resolve_cc(cc, *conv.default)
        if conv.combos is not None and (space, crange) not in conv.combos:
            raise UnsupportedConversionParams(
                f"{src_fmt.name}->{dst_fmt.name} does "
                f"not support {space.name}+{crange.name}")
        if use_kernel is None:
            use_kernel = kernel_platform_available(planes[0].device)
        if (use_kernel and src_fmt == PixelFormat.NV12
                and dst_fmt in (PixelFormat.RGB, PixelFormat.BGR)
                and planes[0].dtype == torch.uint8):
            from .nv12_to_rgb import nv12_to_rgb

            return (nv12_to_rgb(planes[0], src_w=width, src_h=height,
                                space=space, crange=crange,
                                swap=dst_fmt == PixelFormat.BGR),)
        return tuple(conv.impl(tuple(planes), width, height, space, crange))
