"""Banded fused NV12 / P010 / P012 -> planar RGB preprocess.

Counterpart of ``pallas_nv12_preprocess`` (``vali_tpu/ops/pallas_fused.py``).
On a CUDA tensor the wrapper launches the Hopper kernel of
``csrc/banded_preprocess.cu``; on a CPU tensor it runs the plain PyTorch
version, which has the kernel's cast points. Any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.enums import ColorRange, ColorSpace
from ..utils.tracing import count, span
from .banded import (OUT_KINDS, banded_plain, resolve_compute_dtype,
                     sm_count, stream_preprocess_tables, tail_params)
from .csc import nv12_split
from .resize import LANCZOS_AA


def _checked(nv12, src_w, src_h, space, crange, out_dtype, normalize,
             compute_dtype):
    """Validate the arguments; (compute dtype, packed tail)."""
    H, W = src_h, src_w
    if nv12.dim() != 3 or nv12.shape[1] < H * 3 // 2 or nv12.shape[2] != W:
        raise ValueError(
            f"NV12 plane shape {tuple(nv12.shape)} does not match {W}x{H}")
    if nv12.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"NV12 plane must be uint8 or uint16, got "
                         f"{nv12.dtype}")
    hbd = nv12.dtype == torch.uint16  # MSB-aligned high bit depth
    return (resolve_compute_dtype(compute_dtype, hbd),
            tail_params(space, crange, 256.0 if hbd else 1.0, out_dtype,
                        normalize))


def nv12_preprocess_plain(
    nv12: torch.Tensor, *, src_w: int, src_h: int, dst_w: int, dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8, method: str = LANCZOS_AA,
    normalize=None, compute_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`nv12_preprocess` (any device)."""
    cdt, tail = _checked(nv12, src_w, src_h, space, crange, out_dtype,
                         normalize, compute_dtype)
    y, u, v = nv12_split(nv12, src_h)
    return banded_plain(y, u, v, src_w=src_w, src_h=src_h, dst_w=dst_w,
                        dst_h=dst_h, method=method, layout="420",
                        compute_dtype=cdt, tail=tail, out_dtype=out_dtype)


def nv12_preprocess(
    nv12: torch.Tensor,  # [B, >= H*3/2, W] uint8 (NV12) / uint16 (P10/P12,
                         # MSB-aligned 16-bit like NVDEC P010/P012)
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
    compute_dtype=None,
) -> torch.Tensor:
    """Fused NV12/P10/P12 batch -> planar RGB [B, 3, dst_h, dst_w].

    uint8 input computes in bfloat16 by default (fp32 sums, the H-pass
    result rounded to bfloat16 between the passes); uint16 input always
    computes in float32. ``compute_dtype=torch.float32`` is the exactness
    knob for uint8 input. Rows past H*3/2 and a batch stride larger than
    the plane are accepted; rows must be contiguous."""
    if nv12.device.type == "cpu":
        return nv12_preprocess_plain(
            nv12, src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h,
            space=space, crange=crange, out_dtype=out_dtype, method=method,
            normalize=normalize, compute_dtype=compute_dtype)
    if nv12.device.type != "cuda":
        raise ValueError(f"nv12_preprocess runs on CUDA or CPU tensors, got "
                         f"{nv12.device}")
    with span("nv12_preprocess"):
        with span("nv12_preprocess.checks"):
            cdt, tail = _checked(nv12, src_w, src_h, space, crange,
                                 out_dtype, normalize, compute_dtype)
            if nv12.stride(2) != 1:
                raise ValueError("NV12 rows must be contiguous (stride 1)")
        B = nv12.shape[0]
        with span("nv12_preprocess.tables"):
            tabs = stream_preprocess_tables(src_w, src_h, dst_w, dst_h,
                                            method, "nv12", cdt, nv12.dtype,
                                            B, sm_count(nv12.device),
                                            nv12.device)
        with span("nv12_preprocess.alloc"):
            out = torch.empty((B, 3, dst_h, dst_w), dtype=out_dtype,
                              device=nv12.device)
        with span("nv12_preprocess.launch"):
            from ._cuda_build import check, load_kernels

            lib = load_kernels()
            with torch.cuda.device(nv12.device):
                rc = lib.nv12_preprocess_launch(
                    nv12.data_ptr(), nv12.element_size(), nv12.stride(0),
                    nv12.stride(1), B, src_h, src_w, dst_h, dst_w,
                    *tabs.args(),
                    tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    int(cdt == torch.float32), out.data_ptr(),
                    OUT_KINDS[out_dtype],
                    torch.cuda.current_stream().cuda_stream)
            check(lib, rc, "nv12_preprocess")
            count("launches.nv12_preprocess")
        return out
