"""Fused NV12 / P010 / P012 -> planar RGB preprocess.

Counterpart of ``pallas_nv12_preprocess`` (``vali_tpu/ops/pallas_fused.py``).
On a CUDA tensor the wrapper launches one of two Hopper kernels, chosen by
what it observes of the call (:func:`nv12_route`): uint8 samples computed
in bfloat16 into a uint8 output take the tensor-core kernel of
``csrc/nv12_wgmma_preprocess.cu`` (S2's block at 16-row strips) wherever
that block takes the geometry (:func:`~.banded.static2_refusal`); every
other call (uint16 samples, ``compute_dtype=torch.float32``, float
outputs, ``normalize``, a refused geometry) takes the FMA kernel of
``csrc/banded_preprocess.cu``. On a CPU tensor it runs the plain PyTorch
version, which has the kernels' cast points. Any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..core.enums import ColorRange, ColorSpace
from ..utils.tracing import count, span, traced_build
from .banded import (OUT_KINDS, Static2Device, banded_plain,
                     resolve_compute_dtype, sm_count, static2_device_tables,
                     static2_refusal, stream_preprocess_tables, tail_params)
from .csc import nv12_split
from .resize import LANCZOS_AA

#: the tensor-core route's strips: output rows a block (wgmma's N) and the
#: alignment of their source windows, the lab's fastest arm (T16)
WGMMA_TILE = 16
WGMMA_ALIGN = 8


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


@functools.lru_cache(maxsize=64)
@traced_build
def _wgmma_tables(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  method: str, device: torch.device
                  ) -> Optional[Tuple[Static2Device, tuple]]:
    """The tensor-core route's tables on ``device`` and their launch
    arguments, or None where its block refuses the geometry: decided and
    uploaded once per geometry, method and device."""
    geo = (src_w, src_h, dst_w, dst_h, method, WGMMA_TILE, WGMMA_ALIGN)
    if static2_refusal(*geo):
        return None
    t = static2_device_tables(*geo, device)
    return t, t.args()


def _route_tables(nv12: torch.Tensor, cdt: torch.dtype,
                  out_dtype: torch.dtype, src_w: int, src_h: int,
                  dst_w: int, dst_h: int, method: str):
    """:func:`_wgmma_tables` where the call takes the tensor-core route
    (uint8 samples, bfloat16 compute, uint8 output: the block's tail
    stores uint8 only), else None."""
    if (nv12.dtype != torch.uint8 or cdt != torch.bfloat16
            or out_dtype != torch.uint8):
        return None
    return _wgmma_tables(src_w, src_h, dst_w, dst_h, method, nv12.device)


def nv12_route(
    nv12: torch.Tensor, *, src_w: int, src_h: int, dst_w: int, dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8, method: str = LANCZOS_AA,
    normalize=None, compute_dtype=None,
) -> str:
    """The kernel :func:`nv12_preprocess` launches for these arguments:
    "wgmma" (``csrc/nv12_wgmma_preprocess.cu``) or "banded"
    (``csrc/banded_preprocess.cu``). It reads the samples' dtype and the
    call's arguments, never the samples; for a CPU tensor it says what a
    CUDA tensor of the same dtype would take (the tables it caches then
    live on the CPU). Raises as :func:`nv12_preprocess` does for arguments
    it refuses."""
    cdt, _ = _checked(nv12, src_w, src_h, space, crange, out_dtype,
                      normalize, compute_dtype)
    tabs = _route_tables(nv12, cdt, out_dtype, src_w, src_h, dst_w, dst_h,
                         method)
    return "banded" if tabs is None else "wgmma"


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
    the plane are accepted; rows must be contiguous. On a card the kernel
    is :func:`nv12_route`'s: the tensor cores' sums lie within the
    kernels' uint8 envelope of the FMA kernel's (1 LSB on fewer than 1e-3
    of the samples)."""
    if nv12.device.type == "cpu":
        return nv12_preprocess_plain(
            nv12, src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h,
            space=space, crange=crange, out_dtype=out_dtype, method=method,
            normalize=normalize, compute_dtype=compute_dtype)
    return _on_card(nv12, True, src_w, src_h, dst_w, dst_h, space, crange,
                    out_dtype, method, normalize, compute_dtype)


def _nv12_preprocess_banded(
    nv12: torch.Tensor, *, src_w: int, src_h: int, dst_w: int, dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype: torch.dtype = torch.uint8, method: str = LANCZOS_AA,
    normalize=None, compute_dtype=None,
) -> torch.Tensor:
    """:func:`nv12_preprocess` on a CUDA tensor through the FMA kernel of
    ``csrc/banded_preprocess.cu`` whatever the call: what the card tests,
    ``chip_smoke.py`` and ``lab/preprocess_ab.py`` hold the tensor-core
    route and the FMA kernel's own block geometries to."""
    return _on_card(nv12, False, src_w, src_h, dst_w, dst_h, space, crange,
                    out_dtype, method, normalize, compute_dtype)


def _on_card(nv12, routed, src_w, src_h, dst_w, dst_h, space, crange,
             out_dtype, method, normalize, compute_dtype) -> torch.Tensor:
    """One launch on a CUDA tensor: the tensor-core kernel where
    ``routed`` and the call takes that route, else the FMA kernel. Counts
    ``launches.nv12_preprocess`` and ``routes.nv12_preprocess.<wgmma or
    banded>``."""
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
            s2 = (_route_tables(nv12, cdt, out_dtype, src_w, src_h, dst_w,
                                dst_h, method) if routed else None)
            if s2 is None:
                tabs = stream_preprocess_tables(
                    src_w, src_h, dst_w, dst_h, method, "nv12", cdt,
                    nv12.dtype, B, sm_count(nv12.device), nv12.device)
        with span("nv12_preprocess.alloc"):
            out = torch.empty((B, 3, dst_h, dst_w), dtype=out_dtype,
                              device=nv12.device)
        with span("nv12_preprocess.launch"):
            from ._cuda_build import check, load_kernels

            lib = load_kernels()
            tail_p = tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            with torch.cuda.device(nv12.device):
                stream = torch.cuda.current_stream().cuda_stream
                if s2 is not None:
                    rc = lib.nv12_wgmma_preprocess_launch(
                        nv12.data_ptr(), nv12.stride(0), nv12.stride(1),
                        nv12.shape[1], B, src_h, src_w, dst_h, dst_w,
                        tail_p, *s2[1], out.data_ptr(), stream)
                else:
                    rc = lib.nv12_preprocess_launch(
                        nv12.data_ptr(), nv12.element_size(),
                        nv12.stride(0), nv12.stride(1), B, src_h, src_w,
                        dst_h, dst_w, *tabs.args(), tail_p,
                        int(cdt == torch.float32), out.data_ptr(),
                        OUT_KINDS[out_dtype], stream)
            check(lib, rc, "nv12_preprocess")
            count("launches.nv12_preprocess")
            count("routes.nv12_preprocess."
                  + ("banded" if s2 is None else "wgmma"))
        return out
