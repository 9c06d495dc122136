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

Which kernel a launch takes depends on the geometry alone
(:func:`staged_route`, decided again by the launcher in C):

- the staged block (``csrc/convert_staged.cuh``) where TMA can describe
  the buffer: a width that is a multiple of 16, a 16-byte aligned start
  and row and batch strides that are positive multiples of 16 bytes (rows
  past H*3/2 and a batch stride larger than the plane included). Its CSC
  runs as ``wgmma`` products over the per-group matrices :func:`b_image`
  with bfloat16 coefficients, and on the CUDA cores with float32 ones;
- a per-pixel kernel for every other geometry (a width of 40, an odd
  pitch, an unaligned view).

All give the same bits. The device tables (:func:`device_table`: B of the
products, or the float32 coefficients) are built once per space, range,
swap, compute dtype and device.

The functions that make B take the TPU notebook ``convert_lab.py``'s
per-group matrices (:func:`group_mats`) at ``wgmma``'s k16, columns
permuted (:func:`column_map`) so that a thread's accumulators are
consecutive output bytes; the convert lab (``lab/convert_staged.py``)
makes its V1 / V2 from them too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..utils.tracing import count, span, traced_build
from . import colors
from .banded import bf16_bits, core_matrix_order, resolve_compute_dtype
from .csc import nv12_split, upsample2x_nearest
from .resize import round_to


#: the products' N and the pixels of one product's group: V1 (the
#: product's bf16 route) and the convert lab's V2
N = {"V1": 48, "V2": 24}
GROUP = {"V1": 16, "V2": 8}


@functools.lru_cache(maxsize=64)
def coefficients(space: ColorSpace, crange: ColorRange, swap: bool,
                 compute_dtype: torch.dtype) -> np.ndarray:
    """12 float32: the 3x3 matrix rounded to ``compute_dtype`` with row c
    for output channel c (BGR swaps the rows), then the three offsets.
    Built once per argument tuple; the array is read-only."""
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
    k = np.concatenate([rounded.reshape(-1), off]).astype(np.float32)
    k.flags.writeable = False
    return k


def group_mats(m: np.ndarray, pixels: int) -> Tuple[np.ndarray,
                                                    np.ndarray]:
    """The notebook's dense group matrices of ``pixels`` pixels for the 3x3
    matrix ``m`` (row c: output channel c's Y, U, V coefficients): ``Ag``
    [P, 3P] takes pixel p's luma to columns 3p + c, ``Bg`` [P, 3P] chroma
    byte 2 (p // 2) (U) and 2 (p // 2) + 1 (V) to them."""
    m = np.asarray(m, np.float32).reshape(3, 3)
    p = np.arange(pixels)
    ag = np.zeros((pixels, 3 * pixels), np.float32)
    bg = np.zeros((pixels, 3 * pixels), np.float32)
    for c in range(3):
        ag[p, 3 * p + c] = m[c, 0]
        bg[2 * (p // 2), 3 * p + c] = m[c, 1]
        bg[2 * (p // 2) + 1, 3 * p + c] = m[c, 2]
    return ag, bg


def column_map(n: int) -> np.ndarray:
    """[n] the group's output byte (3 pixel + channel) of accumulator
    column c of an m64nNk16 product: thread tq = (c mod 8) / 2 holds
    columns 8 j + 2 tq + e, which become its bytes n / 4 tq + 2 j + e."""
    c = np.arange(n)
    return n // 4 * ((c % 8) // 2) + 2 * (c // 8) + c % 2


def b_matrices(space: ColorSpace, crange: ColorRange, variant: str = "V1",
               swap: bool = False) -> List[np.ndarray]:
    """B matrices [16, N] (float32, bf16-exact) of the staged products,
    columns in accumulator order, from the bf16-rounded coefficients
    (rows in output order: BGR's swapped): V1 ``Ag16`` and ``Bg16``, the
    lab's V2 ``[Ag8; Bg8]``."""
    m = coefficients(space, crange, swap, torch.bfloat16)[:9]
    ag, bg = group_mats(m, GROUP[variant])
    cols = column_map(N[variant])
    mats = [ag, bg] if variant == "V1" else [np.concatenate([ag, bg])]
    return [np.ascontiguousarray(x[:, cols]) for x in mats]


def b_image(space: ColorSpace, crange: ColorRange, variant: str = "V1",
            swap: bool = False) -> np.ndarray:
    """uint16 bf16 bits of :func:`b_matrices` as the kernel reads them:
    each matrix in K-major core matrices (leading byte offset 128, stride
    256; ``ops/banded.core_matrix_order``), V1's ``Ag16`` then ``Bg16``."""
    return np.concatenate([core_matrix_order(bf16_bits(x.T))
                           for x in b_matrices(space, crange, variant,
                                               swap)])


def table(space: ColorSpace, crange: ColorRange, swap: bool,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """The staged route's table on the host: bfloat16 compute the bits of
    V1's B (:func:`b_image`, int16), float32 the nine coefficients."""
    if compute_dtype == torch.bfloat16:
        return torch.from_numpy(
            b_image(space, crange, "V1", swap).view(np.int16).copy())
    return torch.from_numpy(
        coefficients(space, crange, swap, torch.float32)[:9].copy())


@functools.lru_cache(maxsize=64)
@traced_build
def device_table(space: ColorSpace, crange: ColorRange, swap: bool,
                 compute_dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """:func:`table` on ``device``, uploaded once (read-only)."""
    return table(space, crange, swap, compute_dtype).to(device)


def staged_route(nv12: torch.Tensor, src_w: int) -> bool:
    """Whether a launch on ``nv12`` takes the staged TMA block (else the
    per-pixel kernel): the launcher's rule (``convert_staged::tma_ok``) for
    the wrapper's own output, which is contiguous and aligned."""
    bs, rs = (nv12.stride(i) * nv12.element_size() for i in (0, 1))
    ptr = nv12.data_ptr()
    return (src_w % 16 == 0 and ptr % 16 == 0 and rs > 0 and bs > 0
            and rs % 16 == 0 and bs % 16 == 0)


@functools.lru_cache(maxsize=64)
def _coef_pointer(space: ColorSpace, crange: ColorRange, swap: bool,
                  compute_dtype: torch.dtype):
    """The launcher's float pointer to :func:`coefficients`, made once
    (it keeps a reference to the array)."""
    return coefficients(space, crange, swap, compute_dtype).ctypes.data_as(
        ctypes.POINTER(ctypes.c_float))


def _checked(nv12, src_w, src_h, space, crange, swap, compute_dtype):
    """Validate the arguments; the compute dtype and the packed
    coefficients."""
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
    return cdt, coefficients(space, crange, swap, cdt)


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
    _, k = _checked(nv12, src_w, src_h, space, crange, swap, compute_dtype)
    y, u, v = (p.to(torch.float32) for p in nv12_split(nv12, src_h))
    u, v = upsample2x_nearest(u), upsample2x_nearest(v)
    return pack_channels([torch.clamp(torch.round(x), 0.0, 255.0).to(
        torch.uint8) for x in csc_channels(y, u, v, k)])


def prepare_nv12_to_rgb(nv12: torch.Tensor, *, src_w: int, src_h: int,
                        space: ColorSpace = ColorSpace.BT_709,
                        crange: ColorRange = ColorRange.JPEG,
                        swap: bool = False, compute_dtype=None):
    """The kernel's launch on a CUDA ``nv12``, prepared: ``(launch, out)``.
    ``launch()`` runs the kernel into ``out`` on the stream that was
    current when it was prepared, without the wrapper's host work (checks,
    tables, output, arguments) and without counting; :func:`nv12_to_rgb`
    launches through it once a call."""
    with span("nv12_to_rgb.checks"):
        cdt, _ = _checked(nv12, src_w, src_h, space, crange, swap,
                          compute_dtype)
        if nv12.stride(2) != 1:
            raise ValueError("NV12 rows must be contiguous (stride 1)")
    B = nv12.shape[0]
    with span("nv12_to_rgb.tables"):
        tab = device_table(space, crange, swap, cdt, nv12.device)
        coef = _coef_pointer(space, crange, swap, cdt)
    with span("nv12_to_rgb.alloc"):
        out = torch.empty((B, src_h, 3 * src_w), dtype=torch.uint8,
                          device=nv12.device)
    with span("nv12_to_rgb.launch"):
        from ._cuda_build import check, load_kernels

        lib = load_kernels()
        args = (nv12.data_ptr(), nv12.stride(0), nv12.stride(1),
                nv12.shape[1], B, src_h, src_w, coef,
                int(cdt == torch.float32), tab.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(nv12.device).cuda_stream)

    def launch():
        with torch.cuda.device(nv12.device):
            rc = lib.nv12_to_rgb_launch(*args)
        check(lib, rc, "nv12_to_rgb")
    return launch, out


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
    contiguous. The geometry picks the kernel (:func:`staged_route`)."""
    if nv12.device.type == "cpu":
        return nv12_to_rgb_plain(nv12, src_w=src_w, src_h=src_h,
                                 space=space, crange=crange, swap=swap,
                                 compute_dtype=compute_dtype)
    if nv12.device.type != "cuda":
        raise ValueError(
            f"nv12_to_rgb runs on CUDA or CPU tensors, got {nv12.device}")
    with span("nv12_to_rgb"):
        launch, out = prepare_nv12_to_rgb(
            nv12, src_w=src_w, src_h=src_h, space=space, crange=crange,
            swap=swap, compute_dtype=compute_dtype)
        with span("nv12_to_rgb.launch"):
            launch()
            count("launches.nv12_to_rgb")
        return out
