"""Batched rotation (the RotateSurface op).

Counterpart of ``vali_tpu/ops/rotate.py`` (reference
src/TC/src/RotateSurface.cpp:22-218: nppiRotate_*, NPPI_INTER_LINEAR,
forward map ``dst = [cos*x + sin*y + sx, -sin*x + cos*y + sy]`` in y-down
image coordinates, out-of-frame pixels 0):

  - exact multiples of 90 degrees with the canonical shifts (the
    display-rotation path, PySurfaceRotator.cpp:47-73) are ``torch.rot90``,
    pure data movement;
  - every other angle is a bilinear gather over the inverse map in fp32,
    batched over frames, written as explicit index gathers (the sample
    positions, edge zeros and rounding are those of the JAX package, which
    ``grid_sample``'s conventions are not).

Both are plain PyTorch: no TPU kernel stands behind this op.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.enums import PixelFormat
from .fused import to_f32
from .resize import from_f32

#: Parity: PySurfaceRotator::SupportedFormats (PySurfaceRotator.cpp:34-38).
SUPPORTED_FORMATS = (
    PixelFormat.Y, PixelFormat.GRAY12, PixelFormat.RGB, PixelFormat.BGR,
    PixelFormat.RGB_PLANAR, PixelFormat.YUV420, PixelFormat.YUV422,
    PixelFormat.YUV444, PixelFormat.RGB_32F, PixelFormat.RGB_32F_PLANAR,
    PixelFormat.YUV444_10bit, PixelFormat.YUV420_10bit,
)


def normalize_right_angle(angle: float, shift_x: float, shift_y: float,
                          src_w: int, src_h: int):
    """The reference's right-angle normalization
    (PySurfaceRotator.cpp:47-73): for multiples of 90 with no shift, pick
    canonical shifts that land the rotated image at the origin."""
    if math.fmod(angle, 90.0) == 0.0 and shift_x == 0.0 and shift_y == 0.0:
        norm = int(round(angle)) % 360
        if norm == 90:
            return 90.0, 0.0, float(src_w - 1)
        if norm == 180:
            return 180.0, float(src_w - 1), float(src_h - 1)
        if norm == 270:
            return 270.0, float(src_h - 1), 0.0
        return 0.0, 0.0, 0.0
    return angle, shift_x, shift_y


def _is_canonical_right_angle(angle, sx, sy, w, h) -> bool:
    return (angle, sx, sy) in (
        (0.0, 0.0, 0.0),
        (90.0, 0.0, float(w - 1)),
        (180.0, float(w - 1), float(h - 1)),
        (270.0, float(h - 1), 0.0),
    )


def _movable(x: torch.Tensor) -> torch.Tensor:
    """A view of ``x`` that flips and gathers take: uint16 as int16 (the
    same bits; unsigned 16-bit tensors support only a few ops)."""
    return x.view(torch.int16) if x.dtype == torch.uint16 else x


def _unmovable(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(dtype) if dtype == torch.uint16 else x


def rotate_plane(plane: torch.Tensor, angle: float, shift_x: float,
                 shift_y: float, out_h: int, out_w: int,
                 channels: int = 1) -> torch.Tensor:
    """Rotate one batched plane [N, H, W*channels] -> [N, out_h,
    out_w*channels]."""
    dtype = plane.dtype
    n, h, wc = plane.shape
    w = wc // channels
    src = _movable(plane).reshape(n, h, w, channels)

    if _is_canonical_right_angle(angle, shift_x, shift_y, w, h):
        out = torch.rot90(src, int(angle) // 90, dims=(1, 2))
        if (out.shape[1], out.shape[2]) == (out_h, out_w):
            return _unmovable(out.reshape(n, out_h, out_w * channels), dtype)
        # requested canvas differs from the rotated extent (mis-sized dst,
        # or an anisotropically-subsampled plane): fall through to the
        # inverse-map sampler, which fills exactly (out_h, out_w) with
        # out-of-frame pixels zeroed — nppiRotate's semantics for a
        # mismatched dst ROI

    f32 = np.float32
    theta = f32(angle) * f32(math.pi / 180.0)
    t = torch.tensor(theta, dtype=torch.float32)
    cos_t, sin_t = float(torch.cos(t)), float(torch.sin(t))
    # inverse of dst_x = cos*x + sin*y + sx ; dst_y = -sin*x + cos*y + sy
    dev = plane.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
          - float(f32(shift_y)))
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
          - float(f32(shift_x)))
    src_x = cos_t * xs - sin_t * ys
    src_y = sin_t * xs + cos_t * ys

    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = (src_x - x0)[None, :, :, None]
    fy = (src_y - y0)[None, :, :, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def sample(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xc = torch.clamp(xi, 0, w - 1)
        yc = torch.clamp(yi, 0, h - 1)
        vals = to_f32(_unmovable(src[:, yc, xc, :], dtype))
        return vals * inside[None, :, :, None]

    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)
    out = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    return from_f32(out, dtype).reshape(n, out_h, out_w * channels)


def rotate_batch(planes: Sequence[torch.Tensor], fmt: PixelFormat,
                 src_w: int, src_h: int, dst_w: int, dst_h: int,
                 angle: float, shift_x: float = 0.0,
                 shift_y: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Rotate batched storage-layout planes. Shifts are scaled per plane for
    chroma-subsampled formats (as the reference's per-plane NPP calls
    do)."""
    fmt = PixelFormat(fmt)
    if fmt not in SUPPORTED_FORMATS:
        raise ValueError(f"Rotate does not support {fmt.name}")
    angle, shift_x, shift_y = normalize_right_angle(
        float(angle), float(shift_x), float(shift_y), src_w, src_h)

    if fmt in (PixelFormat.RGB, PixelFormat.BGR, PixelFormat.RGB_32F):
        return (rotate_plane(planes[0], angle, shift_x, shift_y,
                             dst_h, dst_w, channels=3),)
    if fmt in (PixelFormat.RGB_PLANAR, PixelFormat.RGB_32F_PLANAR):
        n, h3, w = planes[0].shape
        chans = planes[0].reshape(n * 3, h3 // 3, w)
        out = rotate_plane(chans, angle, shift_x, shift_y, dst_h, dst_w)
        return (out.reshape(n, 3 * dst_h, dst_w),)

    right = _is_canonical_right_angle(angle, shift_x, shift_y, src_w, src_h)
    out_planes = []
    for plane in planes:
        ph, pw = plane.shape[1], plane.shape[2]
        rx, ry = pw / src_w, ph / src_h
        # per-plane normalized right angles need re-derived shifts
        a2, sx2, sy2 = angle, shift_x * rx, shift_y * ry
        oh = int(round(dst_h * ph / src_h))
        ow = int(round(dst_w * pw / src_w))
        if right:
            k = int(angle) // 90
            rot_shape = (pw, ph) if k % 2 else (ph, pw)
            if rot_shape != (oh, ow):
                # Anisotropic subsampling (YUV422 chroma at 90/270): the
                # subsampling axis does not rotate with the content, so
                # rotate full-resolution chroma and re-subsample the new
                # horizontal axis (2-tap mean, the 4:2:2 siting average).
                full = _unmovable(
                    _movable(plane).repeat_interleave(2, dim=2), plane.dtype)
                a3, sx3, sy3 = normalize_right_angle(
                    angle, 0.0, 0.0, pw * 2, ph)
                rot = rotate_plane(full, a3, sx3, sy3, oh, ow * 2)
                pair = (to_f32(rot[:, :, 0::2]) + to_f32(rot[:, :, 1::2])) \
                    * 0.5
                out_planes.append(from_f32(pair, plane.dtype))
                continue
            a2, sx2, sy2 = normalize_right_angle(angle, 0.0, 0.0, pw, ph)
        out_planes.append(rotate_plane(plane, a2, sx2, sy2, oh, ow))
    return tuple(out_planes)
