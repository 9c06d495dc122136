"""Banded fused planar I420 -> planar RGB preprocess.

Counterpart of ``pallas_yuv420_preprocess``
(``vali_tpu/ops/pallas_fused.py``): what the multi-stream pipeline runs on
software-decoded H.264/HEVC (YUV420, YUV420_10bit). On a CUDA tensor the
wrapper launches the Hopper kernel of ``csrc/banded_preprocess.cu``; on a
CPU tensor it runs the plain PyTorch version, which has the kernel's cast
points. Any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.enums import ColorRange, ColorSpace
from ..utils.tracing import count, span
from .banded import (OUT_KINDS, banded_plain, resolve_compute_dtype,
                     sm_count, stream_preprocess_tables, tail_params)
from .resize import LANCZOS_AA


def _checked(y, u, v, src_w, src_h, space, crange, out_dtype, normalize,
             bit_depth, compute_dtype):
    """Validate the arguments; (compute dtype, packed tail)."""
    H, W = src_h, src_w
    if (y.dim() != 3 or u.dim() != 3 or v.dim() != 3
            or y.shape[1] < H or y.shape[2] != W or u.shape[1] < H // 2
            or u.shape[2] != W // 2 or u.shape != v.shape
            or y.shape[0] != u.shape[0]):
        raise ValueError(
            f"Plane shapes {tuple(y.shape)}/{tuple(u.shape)}/"
            f"{tuple(v.shape)} do not match YUV420 {W}x{H}")
    if y.dtype not in (torch.uint8, torch.uint16) or not (
            y.dtype == u.dtype == v.dtype):
        raise ValueError(f"YUV420 planes must all be uint8 or all uint16, "
                         f"got {y.dtype}/{u.dtype}/{v.dtype}")
    if not (y.device == u.device == v.device):
        raise ValueError("YUV420 planes must be on one device")
    hbd = y.dtype == torch.uint16  # LSB-aligned high bit depth
    if bit_depth is None:
        bit_depth = 10 if hbd else 8
    return (resolve_compute_dtype(compute_dtype, hbd),
            tail_params(space, crange, float(1 << (bit_depth - 8)),
                        out_dtype, normalize))


def yuv420_preprocess_plain(
    y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *, src_w: int,
    src_h: int, dst_w: int, dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8, method: str = LANCZOS_AA,
    normalize=None, bit_depth=None, compute_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`yuv420_preprocess` (any device)."""
    cdt, tail = _checked(y, u, v, src_w, src_h, space, crange, out_dtype,
                         normalize, bit_depth, compute_dtype)
    return banded_plain(y, u, v, src_w=src_w, src_h=src_h, dst_w=dst_w,
                        dst_h=dst_h, method=method, layout="420",
                        compute_dtype=cdt, tail=tail, out_dtype=out_dtype)


def yuv420_preprocess(
    y: torch.Tensor,  # [B, >= H, W] uint8 / uint16 (LSB-aligned 10-bit)
    u: torch.Tensor,  # [B, >= H/2, W/2]
    v: torch.Tensor,
    *,
    src_w: int,
    src_h: int,
    dst_w: int,
    dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8,
    method: str = LANCZOS_AA,
    normalize=None,
    bit_depth=None,
    compute_dtype=None,
) -> torch.Tensor:
    """Planar I420 batch -> planar RGB [B, 3, dst_h, dst_w].

    Same banded design as the NV12 kernel; the half-width U and V planes
    resample directly. uint16 input always computes in float32
    (``bit_depth`` defaults to 10); ``compute_dtype``: bfloat16 (uint8
    default) or float32 (the exactness knob). Planes may carry extra rows
    and a batch stride larger than the plane; rows must be contiguous."""
    if y.device.type == "cpu":
        return yuv420_preprocess_plain(
            y, u, v, src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h,
            space=space, crange=crange, out_dtype=out_dtype, method=method,
            normalize=normalize, bit_depth=bit_depth,
            compute_dtype=compute_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"yuv420_preprocess runs on CUDA or CPU tensors, "
                         f"got {y.device}")
    with span("yuv420_preprocess"):
        with span("yuv420_preprocess.checks"):
            cdt, tail = _checked(y, u, v, src_w, src_h, space, crange,
                                 out_dtype, normalize, bit_depth,
                                 compute_dtype)
            if y.stride(2) != 1 or u.stride(2) != 1 or v.stride(2) != 1:
                raise ValueError("YUV420 rows must be contiguous (stride 1)")
        B = y.shape[0]
        with span("yuv420_preprocess.tables"):
            tabs = stream_preprocess_tables(src_w, src_h, dst_w, dst_h,
                                            method, "420", cdt, y.dtype, B,
                                            sm_count(y.device), y.device)
        with span("yuv420_preprocess.alloc"):
            out = torch.empty((B, 3, dst_h, dst_w), dtype=out_dtype,
                              device=y.device)
        with span("yuv420_preprocess.launch"):
            from ._cuda_build import check, load_kernels

            lib = load_kernels()
            with torch.cuda.device(y.device):
                rc = lib.yuv420_preprocess_launch(
                    y.data_ptr(), u.data_ptr(), v.data_ptr(),
                    y.element_size(), y.stride(0), y.stride(1), u.stride(0),
                    u.stride(1), v.stride(0), v.stride(1), B, src_h, src_w,
                    dst_h, dst_w, *tabs.args(),
                    tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    int(cdt == torch.float32), out.data_ptr(),
                    OUT_KINDS[out_dtype],
                    torch.cuda.current_stream().cuda_stream)
            check(lib, rc, "yuv420_preprocess")
            count("launches.yuv420_preprocess")
        return out
