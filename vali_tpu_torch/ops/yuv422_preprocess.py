"""Banded fused planar 4:2:2 -> planar RGB preprocess.

Counterpart of ``pallas_yuv422_preprocess``
(``vali_tpu/ops/pallas_fused.py``): what the multi-stream pipeline runs on
MJPEG camera streams (``AV_PIX_FMT_YUVJ422P`` decodes to YUV422). 4:2:2
chroma is full height and half width, so the chroma H pass takes the luma
row bands and only the W pass differs. On a CUDA tensor the wrapper
launches the Hopper kernel of ``csrc/banded_preprocess.cu``; on a CPU tensor
it runs the plain PyTorch version, which has the kernel's cast points. Any
other device raises.
"""

from __future__ import annotations

import torch

from ..core.enums import ColorRange, ColorSpace
from ..utils.tracing import span
from .banded import banded_plain, launch_planar_u8, planar_u8_checked
from .resize import LANCZOS_AA


def _checked(y, u, v, src_w, src_h, space, crange, out_dtype, normalize,
             compute_dtype):
    if src_w % 2:
        raise ValueError(f"YUV422 width must be even, got {src_w}")
    return planar_u8_checked(
        "YUV422", y, u, v, src_w=src_w, src_h=src_h, chroma_w=src_w // 2,
        space=space, crange=crange, out_dtype=out_dtype, normalize=normalize,
        compute_dtype=compute_dtype)


def yuv422_preprocess_plain(
    y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *, src_w: int,
    src_h: int, dst_w: int, dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8, method: str = LANCZOS_AA,
    normalize=None, compute_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`yuv422_preprocess` (any device)."""
    cdt, tail = _checked(y, u, v, src_w, src_h, space, crange, out_dtype,
                         normalize, compute_dtype)
    return banded_plain(y, u, v, src_w=src_w, src_h=src_h, dst_w=dst_w,
                        dst_h=dst_h, method=method, layout="422",
                        compute_dtype=cdt, tail=tail, out_dtype=out_dtype)


def yuv422_preprocess(
    y: torch.Tensor,  # [B, >= H, W] uint8
    u: torch.Tensor,  # [B, >= H, W/2] uint8 (full height, half width)
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
    """Planar YUV422 batch -> planar RGB [B, 3, dst_h, dst_w].

    ``compute_dtype``: bfloat16 (the default) or float32 (the exactness
    knob). Planes may carry extra rows and a batch stride larger than the
    plane; rows must be contiguous."""
    if y.device.type == "cpu":
        return yuv422_preprocess_plain(
            y, u, v, src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h,
            space=space, crange=crange, out_dtype=out_dtype, method=method,
            normalize=normalize, compute_dtype=compute_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"yuv422_preprocess runs on CUDA or CPU tensors, "
                         f"got {y.device}")
    with span("yuv422_preprocess"):
        with span("yuv422_preprocess.checks"):
            cdt, tail = _checked(y, u, v, src_w, src_h, space, crange,
                                 out_dtype, normalize, compute_dtype)
        return launch_planar_u8(
            "yuv422_preprocess", y, u, v, src_w=src_w, src_h=src_h,
            dst_w=dst_w, dst_h=dst_h, method=method, layout="422",
            compute_dtype=cdt, tail=tail, out_dtype=out_dtype)
