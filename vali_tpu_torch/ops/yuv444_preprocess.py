"""Banded fused planar 4:4:4 -> planar RGB preprocess.

Counterpart of ``pallas_yuv444_preprocess``
(``vali_tpu/ops/pallas_fused.py``): what the multi-stream pipeline runs on
4:4:4 H.264/HEVC (screen and professional capture) and C444 y4m, which
decode to YUV444. All three planes are full resolution, so one band set
serves every plane. On a CUDA tensor the wrapper launches the Hopper kernel
of ``csrc/banded_preprocess.cu``; on a CPU tensor it runs the plain PyTorch
version, which has the kernel's cast points. Any other device raises.
"""

from __future__ import annotations

import torch

from ..core.enums import ColorRange, ColorSpace
from ..utils.tracing import span
from .banded import banded_plain, launch_planar_u8, planar_u8_checked
from .resize import LANCZOS_AA


def _checked(y, u, v, src_w, src_h, space, crange, out_dtype, normalize,
             compute_dtype):
    return planar_u8_checked(
        "YUV444", y, u, v, src_w=src_w, src_h=src_h, chroma_w=src_w,
        space=space, crange=crange, out_dtype=out_dtype, normalize=normalize,
        compute_dtype=compute_dtype)


def yuv444_preprocess_plain(
    y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *, src_w: int,
    src_h: int, dst_w: int, dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8, method: str = LANCZOS_AA,
    normalize=None, compute_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`yuv444_preprocess` (any device)."""
    cdt, tail = _checked(y, u, v, src_w, src_h, space, crange, out_dtype,
                         normalize, compute_dtype)
    return banded_plain(y, u, v, src_w=src_w, src_h=src_h, dst_w=dst_w,
                        dst_h=dst_h, method=method, layout="444",
                        compute_dtype=cdt, tail=tail, out_dtype=out_dtype)


def yuv444_preprocess(
    y: torch.Tensor,  # [B, >= H, W] uint8 each
    u: torch.Tensor,
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
    compute_dtype=None,
) -> torch.Tensor:
    """Planar YUV444 batch -> planar RGB [B, 3, dst_h, dst_w].

    ``compute_dtype``: bfloat16 (the default) or float32 (the exactness
    knob). Planes may carry extra rows and a batch stride larger than the
    plane; rows must be contiguous."""
    if y.device.type == "cpu":
        return yuv444_preprocess_plain(
            y, u, v, src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h,
            space=space, crange=crange, out_dtype=out_dtype, method=method,
            normalize=normalize, compute_dtype=compute_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"yuv444_preprocess runs on CUDA or CPU tensors, "
                         f"got {y.device}")
    with span("yuv444_preprocess"):
        with span("yuv444_preprocess.checks"):
            cdt, tail = _checked(y, u, v, src_w, src_h, space, crange,
                                 out_dtype, normalize, compute_dtype)
        return launch_planar_u8(
            "yuv444_preprocess", y, u, v, src_w=src_w, src_h=src_h,
            dst_w=dst_w, dst_h=dst_h, method=method, layout="444",
            compute_dtype=cdt, tail=tail, out_dtype=out_dtype)
