"""Banded separable resize of independent planes.

Counterpart of ``pallas_plane_resize`` (``vali_tpu/ops/pallas_fused.py``):
``[B, >= H, W]`` uint8 / uint16 / float32 planes -> ``[B, DH, DW]`` in the
same dtype (Y, GRAY12, each plane of YUV420/444, the channels of
RGB_PLANAR). On a CUDA tensor the wrapper launches the Hopper kernel of
``csrc/banded_resize.cu`` (lane stride 1); on a CPU tensor it runs the
plain PyTorch version, which has the kernel's cast points. Any other
device raises.
"""

from __future__ import annotations

import torch

from ..utils.tracing import count, span
from .banded import (IN_KINDS, resize_compute_dtype, sm_count,
                     stream_resize_tables)
from .resize import LANCZOS_AA, resize_plane


def _checked(plane, src_h, dst_h, dst_w, compute_dtype):
    """Validate the arguments; the compute dtype."""
    if plane.dim() != 3 or plane.shape[1] < src_h or src_h <= 0:
        raise ValueError(
            f"plane shape {tuple(plane.shape)} does not hold {src_h} rows")
    if dst_h <= 0 or dst_w <= 0:
        raise ValueError(f"bad destination size {dst_w}x{dst_h}")
    return resize_compute_dtype(plane.dtype, compute_dtype)


def plane_resize_plain(plane: torch.Tensor, *, src_h: int, dst_h: int,
                       dst_w: int, method: str = LANCZOS_AA,
                       compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`plane_resize` (any device)."""
    cdt = _checked(plane, src_h, dst_h, dst_w, compute_dtype)
    return resize_plane(plane[:, :src_h], dst_h, dst_w, method,
                        compute_dtype=cdt)


def plane_resize(
    plane: torch.Tensor,  # [B, >= H, W] uint8 / uint16 / float32
    *,
    src_h: int,
    dst_h: int,
    dst_w: int,
    method: str = LANCZOS_AA,
    compute_dtype=None,
) -> torch.Tensor:
    """Banded resize of independent planes -> [B, dst_h, dst_w].

    uint8 computes in bfloat16 by default (fp32 sums, the H-pass result
    rounded to bfloat16); ``compute_dtype=torch.float32`` is the exactness
    knob. uint16 and float32 always compute in float32; float planes are
    not quantised. Rows past H and a batch stride larger than the plane are
    accepted; rows must be contiguous."""
    if plane.device.type == "cpu":
        return plane_resize_plain(plane, src_h=src_h, dst_h=dst_h,
                                  dst_w=dst_w, method=method,
                                  compute_dtype=compute_dtype)
    if plane.device.type != "cuda":
        raise ValueError(f"plane_resize runs on CUDA or CPU tensors, got "
                         f"{plane.device}")
    with span("plane_resize"):
        launch, out = prepare_plane_resize(plane, src_h=src_h, dst_h=dst_h,
                                           dst_w=dst_w, method=method,
                                           compute_dtype=compute_dtype)
        with span("plane_resize.launch"):
            launch()
            count("launches.plane_resize")
        return out


def prepare_plane_resize(plane: torch.Tensor, *, src_h: int, dst_h: int,
                         dst_w: int, method: str = LANCZOS_AA,
                         compute_dtype=None):
    """The kernel's launch on a CUDA ``plane``, prepared: ``(launch,
    out)``. ``launch()`` runs the kernel into ``out`` on the stream that
    was current when it was prepared, without the wrapper's host work
    (tables, output, arguments) and without counting; :func:`plane_resize`
    launches through it once a call."""
    with span("plane_resize.checks"):
        cdt = _checked(plane, src_h, dst_h, dst_w, compute_dtype)
        if plane.stride(2) != 1:
            raise ValueError("plane rows must be contiguous (stride 1)")
    B, _, W = plane.shape
    with span("plane_resize.tables"):
        tabs = stream_resize_tables(src_h, dst_h, W, dst_w, method, cdt, 1,
                                    plane.dtype, B, sm_count(plane.device),
                                    plane.device)
    with span("plane_resize.alloc"):
        out = torch.empty((B, dst_h, dst_w), dtype=plane.dtype,
                          device=plane.device)
    with span("plane_resize.launch"):
        from ._cuda_build import check, load_kernels

        lib = load_kernels()
        with torch.cuda.device(plane.device):
            args = (plane.data_ptr(), IN_KINDS[plane.dtype], plane.stride(0),
                    plane.stride(1), B, src_h, W, dst_h, dst_w, *tabs.args(),
                    int(cdt == torch.float32), out.data_ptr(), out.stride(0),
                    out.stride(1), torch.cuda.current_stream().cuda_stream)

    def launch():
        with torch.cuda.device(plane.device):
            rc = lib.plane_resize_launch(*args)
        check(lib, rc, "plane_resize")
    return launch, out
