"""NV12 -> packed RGB / BGR at full resolution.

Counterpart of ``pallas_nv12_to_rgb`` / ``_pallas_nv12_to_rgb_jit``
(``vali_tpu/ops/pallas_fused.py``). On a CUDA tensor the wrapper launches
the Hopper kernel of ``csrc/nv12_to_rgb.cu``; on a CPU tensor it runs the
plain PyTorch version, which has the kernel's cast points. Any other
device raises.

Cast points (the TPU kernel's): the 3x3 coefficients are rounded to the
compute dtype (bfloat16 by default), the per-channel offset
``-(m[c,0]*y_off + (m[c,1]+m[c,2])*128)`` stays float32 and comes from the
unrounded matrix, and each channel is
``round_half_even(clip((y*m0 + (u*m1 + v*m2)) + off))`` in fp32. With
bfloat16 coefficients every product of a uint8 sample is exact in fp32.
This is not the exact route of ``csc.convert_batch`` (fp32 matrix,
offsets subtracted first): it stays within 2 LSB of it.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from . import colors
from .banded import resolve_compute_dtype
from .csc import nv12_split, upsample2x_nearest
from .resize import round_to


def coefficients(space: ColorSpace, crange: ColorRange, swap: bool,
                 compute_dtype: torch.dtype) -> np.ndarray:
    """12 float32: the 3x3 matrix rounded to ``compute_dtype`` with row c
    for output channel c (BGR swaps the rows), then the three offsets."""
    mo = colors.yuv2rgb_matrix(space, crange)
    if mo is None:
        raise ValueError(f"Unsupported cc combo {space}/{crange}")
    m, y_off = mo
    m = m.astype(np.float32)
    order = (2, 1, 0) if swap else (0, 1, 2)
    off = np.zeros(3, dtype=np.float32)
    for c_out, c in enumerate(order):
        # the same float32 expression as the TPU kernel's offset lanes
        off[c_out] = -(m[c, 0] * y_off + (m[c, 1] + m[c, 2]) * 128.0)
    rounded = round_to(m[list(order)], compute_dtype).numpy()
    return np.concatenate([rounded.reshape(-1), off]).astype(np.float32)


def _checked(nv12, src_w, src_h, space, crange, swap, compute_dtype):
    """Validate the arguments; the packed coefficients."""
    if (nv12.dim() != 3 or nv12.shape[1] < src_h * 3 // 2
            or nv12.shape[2] != src_w):
        raise ValueError(
            f"NV12 plane shape {tuple(nv12.shape)} does not match "
            f"{src_w}x{src_h}")
    if nv12.dtype != torch.uint8:
        raise ValueError(f"nv12_to_rgb is 8-bit only, got {nv12.dtype}")
    if src_w % 2 or src_h % 2:
        raise ValueError(f"NV12 needs even dims, got {src_w}x{src_h}")
    cdt = resolve_compute_dtype(compute_dtype, hbd=False)
    return coefficients(space, crange, swap, cdt)


def csc_channels(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 k: np.ndarray) -> List[torch.Tensor]:
    """The three float32 output channels of full-resolution float32 planes
    in the kernel's order, ``(y*m0 + (u*m1 + v*m2)) + off``, with the 12
    coefficients ``k`` of :func:`coefficients`."""
    chans = []
    for c in range(3):
        m0, m1, m2 = (float(x) for x in k[3 * c:3 * c + 3])
        chans.append((y * m0 + (u * m1 + v * m2)) + float(k[9 + c]))
    return chans


def pack_channels(chans: Sequence[torch.Tensor]) -> torch.Tensor:
    """Three uint8 [B, H, W] channels -> packed [B, H, 3W]."""
    b, h, w = chans[0].shape
    return torch.stack(list(chans), dim=-1).reshape(b, h, 3 * w)


def nv12_to_rgb_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                      space: ColorSpace = ColorSpace.BT_709,
                      crange: ColorRange = ColorRange.JPEG,
                      swap: bool = False, compute_dtype=None
                      ) -> torch.Tensor:
    """Plain PyTorch version of :func:`nv12_to_rgb` (any device)."""
    k = _checked(nv12, src_w, src_h, space, crange, swap, compute_dtype)
    y, u, v = (p.to(torch.float32) for p in nv12_split(nv12, src_h))
    u, v = upsample2x_nearest(u), upsample2x_nearest(v)
    return pack_channels([torch.clamp(torch.round(x), 0.0, 255.0).to(
        torch.uint8) for x in csc_channels(y, u, v, k)])


def nv12_to_rgb(
    nv12: torch.Tensor,  # [B, >= H*3/2, W] uint8
    *,
    src_w: int,
    src_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.JPEG,
    swap: bool = False,  # True -> BGR
    compute_dtype=None,
) -> torch.Tensor:
    """NV12 batch -> packed RGB (or BGR) uint8 [B, H, 3W].

    Nearest chroma upsample on both axes and the CSC of
    ``colors.yuv2rgb_matrix``; bfloat16 coefficients by default,
    ``compute_dtype=torch.float32`` keeps them in float32. Rows past H*3/2
    and a batch stride larger than the plane are accepted; rows must be
    contiguous."""
    if nv12.device.type == "cpu":
        return nv12_to_rgb_plain(nv12, src_w=src_w, src_h=src_h,
                                 space=space, crange=crange, swap=swap,
                                 compute_dtype=compute_dtype)
    if nv12.device.type != "cuda":
        raise ValueError(
            f"nv12_to_rgb runs on CUDA or CPU tensors, got {nv12.device}")
    k = _checked(nv12, src_w, src_h, space, crange, swap, compute_dtype)
    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    from ._cuda_build import check, load_kernels

    lib = load_kernels()
    B = nv12.shape[0]
    out = torch.empty((B, src_h, 3 * src_w), dtype=torch.uint8,
                      device=nv12.device)
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_to_rgb_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), B, src_h,
            src_w, k.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "nv12_to_rgb")
    nv12_to_rgb.launches += 1
    return out


#: kernel launches made by the wrapper (CPU calls are not counted)
nv12_to_rgb.launches = 0
