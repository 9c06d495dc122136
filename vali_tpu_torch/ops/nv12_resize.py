"""Banded NV12 / P010 / P012 resize.

Counterpart of ``pallas_nv12_resize`` (``vali_tpu/ops/pallas_fused.py``):
``[B, >= H*3/2, W]`` uint8 (NV12) or MSB-aligned uint16 (P10/P12) ->
``[B, DH*3/2, DW]`` in the same dtype. Luma resizes as one image; the
interleaved UV rows at row H resize as their own half-size image
(``resize_weights(H/2, DH/2)``, ``resize_weights(W/2, DW/2)``), the two
channels of a pair kept apart (reference ancestor
TaskResizeSurface.cpp:132-188). On a CUDA tensor the wrapper launches the
Hopper kernel of ``csrc/banded_resize.cu`` (lane stride 1 for luma, 2 for
chroma), both parts into one output tensor; on a CPU tensor it runs the
plain PyTorch version, which has the kernel's cast points. Any other
device raises.
"""

from __future__ import annotations

import torch

from ..utils.tracing import count, span
from .banded import (IN_KINDS, resize_compute_dtype, sm_count,
                     stream_resize_tables)
from .resize import LANCZOS_AA, resize_plane


def _checked(nv12, src_w, src_h, dst_w, dst_h, compute_dtype):
    """Validate the arguments; the compute dtype."""
    if (nv12.dim() != 3 or nv12.shape[1] < src_h * 3 // 2
            or nv12.shape[2] != src_w):
        raise ValueError(
            f"NV12 plane shape {tuple(nv12.shape)} does not match "
            f"{src_w}x{src_h}")
    if nv12.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"NV12 plane must be uint8 or uint16, got "
                         f"{nv12.dtype}")
    if (src_w % 2 or src_h % 2 or dst_w % 2 or dst_h % 2 or dst_w <= 0
            or dst_h <= 0):
        raise ValueError("NV12 resize needs even, positive dims")
    return resize_compute_dtype(nv12.dtype, compute_dtype)


def nv12_resize_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                      dst_w: int, dst_h: int, method: str = LANCZOS_AA,
                      compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`nv12_resize` (any device)."""
    cdt = _checked(nv12, src_w, src_h, dst_w, dst_h, compute_dtype)
    luma = resize_plane(nv12[:, :src_h], dst_h, dst_w, method,
                        compute_dtype=cdt)
    chroma = resize_plane(nv12[:, src_h:src_h * 3 // 2], dst_h // 2,
                          dst_w // 2, method, channels=2, compute_dtype=cdt)
    return torch.cat([luma, chroma], dim=1)


def nv12_resize(
    nv12: torch.Tensor,  # [B, >= H*3/2, W] uint8 / uint16 (P10/P12)
    *,
    src_w: int,
    src_h: int,
    dst_w: int,
    dst_h: int,
    method: str = LANCZOS_AA,
    compute_dtype=None,
) -> torch.Tensor:
    """Banded NV12/P10/P12 resize -> [B, dst_h*3/2, dst_w], same dtype.

    uint8 computes in bfloat16 by default (fp32 sums, the H-pass result
    rounded to bfloat16); ``compute_dtype=torch.float32`` is the exactness
    knob; uint16 always computes in float32. Rows past H*3/2 and a batch
    stride larger than the plane are accepted; rows must be
    contiguous."""
    with span("nv12_resize"):
        if nv12.device.type == "cpu":
            return nv12_resize_plain(nv12, src_w=src_w, src_h=src_h,
                                     dst_w=dst_w, dst_h=dst_h, method=method,
                                     compute_dtype=compute_dtype)
        if nv12.device.type != "cuda":
            raise ValueError(f"nv12_resize runs on CUDA or CPU tensors, got "
                             f"{nv12.device}")
        with span("nv12_resize.checks"):
            cdt = _checked(nv12, src_w, src_h, dst_w, dst_h, compute_dtype)
            if nv12.stride(2) != 1:
                raise ValueError("NV12 rows must be contiguous (stride 1)")
        B = nv12.shape[0]
        with span("nv12_resize.tables"):
            sms = sm_count(nv12.device)
            luma = stream_resize_tables(src_h, dst_h, src_w, dst_w, method,
                                        cdt, 1, nv12.dtype, B, sms,
                                        nv12.device)
            chroma = stream_resize_tables(src_h // 2, dst_h // 2, src_w // 2,
                                          dst_w // 2, method, cdt, 2,
                                          nv12.dtype, B, sms, nv12.device)
        with span("nv12_resize.alloc"):
            out = torch.empty((B, dst_h * 3 // 2, dst_w), dtype=nv12.dtype,
                              device=nv12.device)
        with span("nv12_resize.launch"):
            from ._cuda_build import check, load_kernels

            lib = load_kernels()
            with torch.cuda.device(nv12.device):
                rc = lib.nv12_resize_launch(
                    nv12.data_ptr(), IN_KINDS[nv12.dtype], nv12.stride(0),
                    nv12.stride(1), B, src_h, src_w, dst_h, dst_w,
                    *luma.args(), *chroma.args(), int(cdt == torch.float32),
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            check(lib, rc, "nv12_resize")
            count("launches.nv12_resize")
        return out
