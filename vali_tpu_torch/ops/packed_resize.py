"""Banded separable resize of packed 3-channel samples.

Counterpart of ``pallas_packed_resize`` (``vali_tpu/ops/pallas_fused.py``):
packed RGB/BGR/RGB_32F ``[B, >= H, W*3]`` -> ``[B, DH, DW*3]`` in the same
dtype; output lane ``3*p + c`` reads input lanes ``3*q + c`` only. On a
CUDA tensor the wrapper launches the Hopper kernel of
``csrc/banded_resize.cu`` (lane stride 3); on a CPU tensor it runs the
plain PyTorch version, which has the kernel's cast points. Any other
device raises.
"""

from __future__ import annotations

import torch

from ..utils.tracing import count, span
from .banded import (IN_KINDS, resize_compute_dtype, sm_count,
                     stream_resize_tables)
from .resize import LANCZOS_AA, resize_plane

CHANNELS = 3


def _checked(plane, src_w, src_h, dst_w, dst_h, compute_dtype):
    """Validate the arguments; the compute dtype."""
    if (plane.dim() != 3 or plane.shape[1] < src_h or src_h <= 0
            or src_w <= 0 or plane.shape[2] != src_w * CHANNELS):
        raise ValueError(
            f"packed plane shape {tuple(plane.shape)} does not match "
            f"{src_w}x{src_h}x{CHANNELS}")
    if dst_h <= 0 or dst_w <= 0:
        raise ValueError(f"bad destination size {dst_w}x{dst_h}")
    return resize_compute_dtype(plane.dtype, compute_dtype)


def packed_resize_plain(plane: torch.Tensor, *, src_w: int, src_h: int,
                        dst_w: int, dst_h: int, method: str = LANCZOS_AA,
                        compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`packed_resize` (any device)."""
    cdt = _checked(plane, src_w, src_h, dst_w, dst_h, compute_dtype)
    return resize_plane(plane[:, :src_h], dst_h, dst_w, method,
                        channels=CHANNELS, compute_dtype=cdt)


def packed_resize(
    plane: torch.Tensor,  # [B, >= H, W*3] uint8 / uint16 / float32
    *,
    src_w: int,
    src_h: int,
    dst_w: int,
    dst_h: int,
    method: str = LANCZOS_AA,
    compute_dtype=None,
) -> torch.Tensor:
    """Banded resize of packed RGB -> [B, dst_h, dst_w*3], same dtype.

    uint8 computes in bfloat16 by default (within the reference's 4-LSB
    envelope of the exact route); ``compute_dtype=torch.float32`` is the
    exactness knob. uint16
    and float32 always compute in float32; float samples are not
    quantised. Rows past H and a batch stride larger than the plane are
    accepted; rows must be contiguous."""
    if plane.device.type == "cpu":
        return packed_resize_plain(plane, src_w=src_w, src_h=src_h,
                                   dst_w=dst_w, dst_h=dst_h, method=method,
                                   compute_dtype=compute_dtype)
    if plane.device.type != "cuda":
        raise ValueError(f"packed_resize runs on CUDA or CPU tensors, got "
                         f"{plane.device}")
    with span("packed_resize"):
        with span("packed_resize.checks"):
            cdt = _checked(plane, src_w, src_h, dst_w, dst_h, compute_dtype)
            if plane.stride(2) != 1:
                raise ValueError("packed rows must be contiguous (stride 1)")
        B = plane.shape[0]
        with span("packed_resize.tables"):
            tabs = stream_resize_tables(src_h, dst_h, src_w, dst_w, method,
                                        cdt, CHANNELS, plane.dtype, B,
                                        sm_count(plane.device), plane.device)
        with span("packed_resize.alloc"):
            out = torch.empty((B, dst_h, dst_w * CHANNELS), dtype=plane.dtype,
                              device=plane.device)
        with span("packed_resize.launch"):
            from ._cuda_build import check, load_kernels

            lib = load_kernels()
            with torch.cuda.device(plane.device):
                rc = lib.packed_resize_launch(
                    plane.data_ptr(), IN_KINDS[plane.dtype], plane.stride(0),
                    plane.stride(1), B, src_h, src_w, dst_h, dst_w,
                    *tabs.args(), int(cdt == torch.float32), out.data_ptr(),
                    out.stride(0), out.stride(1),
                    torch.cuda.current_stream().cuda_stream)
            check(lib, rc, "packed_resize")
            count("launches.packed_resize")
        return out
