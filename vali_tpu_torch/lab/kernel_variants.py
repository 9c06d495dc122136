"""NV12 kernel-variant lab: the product preprocess kernel's design
experiments, run on the card.

Counterpart of the TPU notebook ``bench_kernel_variants.py`` (its ``main``,
``main_floor``, ``main_modes``, ``main_multiframe``, ``main_static``,
``main_sweep2``, ``main_combo``, ``main_transposed`` and ``main_grouped``).
Nine wrappers over the kernels of ``csrc/nv12_variants.cu``,
``csrc/nv12_prodlike.cu``, ``csrc/nv12_staged.cu``,
``csrc/nv12_static2.cu``, ``csrc/nv12_combo.cu``, ``csrc/nv12_chains.cu``
and ``csrc/nv12_grouped.cu`` (the labs' library,
``ops/_cuda_build.load_lab_kernels``), each beside its
plain PyTorch version, with the same dispatch as the product wrappers: a
CUDA tensor launches the kernel, a CPU tensor runs the plain version, any
other device raises.

- :func:`stream_floor` (``dma_floor``): streams every byte of each
  [rows, W] frame and writes ``(f[:DH, :DW] + f[rows-DH:, :DW]) & 255`` on
  all three channels; its rate is the measured bound of the NV12 kernels.
- :func:`prod_like` (``prod_like``): S2's tensor-core block with a phase
  knocked out — ``mode`` full (S2), hpass (the H chains only) or wpass (no
  H chain) — at a chosen strip height (the TPU's H-pass ``tile``).
- :func:`variant_kernel` (``variant_kernel``): S2's tensor-core block at
  16-row strips with the H pass's frame operand converted to bf16 once a
  stage into shared memory and read by a ``wgmma`` descriptor (TMA boxes
  into a landing ring); B and C convert by two cast chains (equal values)
  and run the chroma W pass over the interleaved H rows, D converts by
  C's chain and keeps S2's deinterleaved chroma W pass.
- :func:`multiframe` (``multiframe_kernel``): G frames per block on
  32-row strips: the combo's block (G = 2, 4, 8), S2's at G = 1.
- :func:`static_kernel` (``static_kernel``): S2's tensor-core block at
  the TPU's static windows (strips of ``tile`` rows, align 8) with the H
  chains' A built from the ring's bytes by the TPU's short cast chain
  (u8 -> i32 -> bf16, S) or long one (u8 -> i32 -> f32 -> bf16, Slong).
- :func:`static_kernel2` (``static_kernel2``): strips of ``tile`` rows over
  windows aligned to ``align`` rows, zero taps included, both resize
  passes on the tensor cores with the strip height as N (wgmma fed by a
  cp.async ring, one block per 64-column output tile).
- :func:`combo_kernel` (``combo_kernel``): G frames per block on S2's
  strips of ``tile`` rows, S2's tensor-core block with each chunk's W
  weights loaded once for the G frames.
- :func:`transposed_chroma` (``transposed_chroma_kernel``): S2's
  tensor-core block with the chroma H rows kept interleaved as the chain
  leaves them and read MN-major by the chroma W pass.
- :func:`grouped_kernel` (``grouped_kernel``): the H pass as a dense
  block-diagonal product on the tensor cores (wgmma fed by a cp.async
  ring), the W pass there too (or, by a build knob, the product's).
Rows too wide for full-width H rows in one block run in output-column
ranges; the lab line says so.

Every full-function variant (B, C, D, full, M*, S*, combo*, T*, G)
computes the product kernel's function, so on the card it is held to
``nv12_preprocess``: all of them run on the tensor cores and sum in their
own order, so within the kernels' envelope, their differing samples
counted. Their plain version is ``nv12_preprocess_plain``, except S2's,
the combo's, full's, M*'s, S's, Slong's and T's (S2's at their strip
height) and G's, which compute from their own host tables. ``wpass`` and the floor read the last DH rows of the buffer
as given, as the TPU functions do, so their results depend on the
buffer's row count.

Run the lab (64 x 1080p -> 224 on ``cuda:0``; ``--device cpu`` runs the
plain versions at 8 x 256x144 -> 96x64 and times nothing)::

    python -m vali_tpu_torch.lab.kernel_variants [NAME ...] [--device cpu]

Names: ``A`` (the product kernel), ``B``, ``C``, ``D``, ``floor``,
``full``, ``hpass``, ``wpass`` (a number after a mode sets the strip
height: ``full32``; 16 without), ``M2``, ``M4``, ``M8``, ``S``, ``Slong``,
``T`` (a number sets the strip height: ``S16``; 32 without),
``S2t{tile}a{align}`` (``S2t32a8``), ``combo{G}x{tile}`` (``combo2x32``),
``G``. Each prints one line: ms per batch, spread, maxdiff against
its reference, frames/s, and the bound.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import subprocess
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops.banded import (COMBO_ALIGN, COMBO_SPLITS, GROUP_STRIP,
                          STATIC2_W_STEPS, DeviceTables, combo_refusal,
                          core_matrix_order, dense_weights, device_tables,
                          grouped_refusal,
                          grouped_tables, grouped_w_tables, static2_refusal,
                          static2_device_tables, static2_tables,
                          static2_w_tables,
                          strip_window_bands, tail_params, w_pass_tail_plain)
from ..ops.fused import exact_f32_matmul, to_f32
from ..ops.nv12_preprocess import nv12_preprocess, nv12_preprocess_plain
from ..ops.resize import LANCZOS_AA, round_to
from .chains import CHAINS_ALIGN, CHAINS_TILE, chains_refusal
from .prodlike import (MODES, PRODLIKE_ALIGN, PRODLIKE_TILE, PRODLIKE_TILES,
                       prodlike_device, prodlike_n, prodlike_refusal)
from .staged import (STAGED_ALIGN, STAGED_TILE, STAGED_VARIANTS,
                     staged_device, staged_refusal, tma_ok)
from .timing import bound_ms, preprocess_work, time_cuda

#: the strip height of multiframe's blocks (the notebook's default tile)
MULTIFRAME_TILE = 32
#: multiframe's frames a block: S2's block at 1, the combo's instances
MULTIFRAME_FRAMES = (1, 2, 4, 8)
VARIANTS = tuple(STAGED_VARIANTS)
#: int32 words of the stream floor's sink
SINK_WORDS = 64

DEFAULT_NAMES = ("A", "B", "C", "D", "floor", "full", "hpass", "wpass",
                 "full4", "full8", "full24", "full32", "full48", "hpass32",
                 "wpass32", "M2", "M4", "M8", "S", "Slong", "S16",
                 "Slong16", "S2t32a8", "S2t16a8", "S2t24a8", "S2t48a8",
                 "S2t32a32", "combo2x32", "combo4x32", "combo2x64",
                 "combo1x64", "combo2x16", "combo4x16", "T", "T16", "G")
CARD_SIZE = (64, 1920, 1080, 224, 224)   # batch, W, H, DW, DH
CPU_SIZE = (8, 256, 144, 96, 64)


def _on_cpu(what: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return False


def _checked(nv12, src_w, src_h, space, crange) -> np.ndarray:
    """Validate an NV12 uint8 buffer [B, >= H*3/2, W]; the packed tail."""
    if (nv12.dim() != 3 or nv12.shape[1] < src_h * 3 // 2
            or nv12.shape[2] != src_w):
        raise ValueError(f"NV12 buffer shape {tuple(nv12.shape)} does not "
                         f"match {src_w}x{src_h}")
    if nv12.dtype != torch.uint8:
        raise ValueError(f"the NV12 lab takes uint8 samples, got "
                         f"{nv12.dtype}")
    return tail_params(space, crange, 1.0, torch.uint8, None)


def _call(what: str, launcher: str, nv12: torch.Tensor, tail: np.ndarray,
          tabs: DeviceTables, *knobs, src_w: int, src_h: int, dst_w: int,
          dst_h: int) -> torch.Tensor:
    """One launch of a lab launcher that takes the frames, the geometry,
    ``tabs`` and the tail, then its ``knobs``, the output and the stream,
    on a checked CUDA buffer."""
    from ..ops._cuda_build import check, load_lab_kernels

    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    lib = load_lab_kernels()
    B = nv12.shape[0]
    out = torch.empty((B, 3, dst_h, dst_w), dtype=torch.uint8,
                      device=nv12.device)
    with torch.cuda.device(nv12.device):
        rc = getattr(lib, launcher)(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, src_h, src_w, dst_h, dst_w, tabs.index.data_ptr(),
            tabs.weights.data_ptr(), *tabs.taps,
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *knobs,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(lib, rc, what)
    return out


def _product_tables(nv12: torch.Tensor, src_w: int, src_h: int, dst_w: int,
                    dst_h: int) -> DeviceTables:
    return device_tables(src_w, src_h, dst_w, dst_h, LANCZOS_AA, "420",
                         torch.bfloat16, nv12.device)


def _floor_checked(nv12, rows, W, DH, DW) -> None:
    if nv12.dim() != 3 or nv12.shape[1] != rows or nv12.shape[2] != W:
        raise ValueError(f"buffer shape {tuple(nv12.shape)} is not "
                         f"[B, {rows}, {W}]")
    if nv12.dtype != torch.uint8:
        raise ValueError(f"the stream floor takes uint8, got {nv12.dtype}")
    if not (0 <= DH <= rows and 0 <= DW <= W):
        raise ValueError(f"output {DW}x{DH} does not fit a {W}x{rows} "
                         f"frame")


def stream_floor_plain(nv12: torch.Tensor, *, rows: int, W: int, DH: int,
                       DW: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`stream_floor` (any device)."""
    _floor_checked(nv12, rows, W, DH, DW)
    s = (nv12[:, :DH, :DW].to(torch.int32)
         + nv12[:, rows - DH:, :DW].to(torch.int32))
    return (s & 255).to(torch.uint8).unsqueeze(1).expand(
        -1, 3, -1, -1).contiguous()


def stream_floor(nv12: torch.Tensor, *, rows: int, W: int, DH: int,
                 DW: int, sink: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Stream every byte of each [rows, W] frame of ``nv12`` [B, rows, W]
    uint8; returns [B, 3, DH, DW] = (f[:DH, :DW] + f[rows-DH:, :DW]) & 255.

    On the card each block XORs the words it read into one of the int32
    words of ``sink`` (a fresh zeroed one of SINK_WORDS when None), so the
    XOR of the sink after a call on a zeroed sink is the XOR of every
    32-bit word of the frames (16-byte aligned rows)."""
    _floor_checked(nv12, rows, W, DH, DW)
    if _on_cpu("stream_floor", nv12):
        return stream_floor_plain(nv12, rows=rows, W=W, DH=DH, DW=DW)
    from ..ops._cuda_build import check, load_lab_kernels

    if nv12.stride(2) != 1:
        raise ValueError("rows must be contiguous (stride 1)")
    if sink is None:
        sink = torch.zeros(SINK_WORDS, dtype=torch.int32, device=nv12.device)
    if (sink.dtype != torch.int32 or sink.device != nv12.device
            or not sink.is_contiguous() or sink.numel() < 1):
        raise ValueError("sink must be a contiguous int32 tensor on the "
                         "frames' device")
    lib = load_lab_kernels()
    B = nv12.shape[0]
    out = torch.empty((B, 3, DH, DW), dtype=torch.uint8, device=nv12.device)
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_stream_floor_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), B, rows, W, DH,
            DW, sink.data_ptr(), sink.numel(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "stream_floor")
    stream_floor.launches += 1
    return out


def prod_like_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                    dst_w: int, dst_h: int, mode: str = "full",
                    rows_per_block: int = PRODLIKE_TILE,
                    space: ColorSpace = ColorSpace.BT_709,
                    crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """Plain PyTorch version of :func:`prod_like` (any device), with the
    kernel's cast points: bf16 weights, fp32 products with TF32 off, the
    H-pass rows rounded to bf16. full is :func:`static_kernel2_plain` at
    (rows_per_block, 8); hpass and wpass do not depend on the strip
    height."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    tail = _checked(nv12, src_w, src_h, space, crange)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    if mode == "full":
        return static_kernel2_plain(nv12, **geo, tile=rows_per_block,
                                    align=PRODLIKE_ALIGN, space=space,
                                    crange=crange)
    if mode == "hpass":
        yh, ch = _hpass_sums(nv12, **geo)
        x = torch.clamp(torch.round(yh + ch), 0.0, 255.0).to(torch.uint8)
        return x.unsqueeze(1).expand(-1, 3, -1, -1).contiguous()
    bf = torch.bfloat16
    dw = dense_weights(src_w, src_h, dst_w, dst_h, LANCZOS_AA, "420")
    dev = nv12.device
    rows = nv12.shape[1]
    yh = to_f32(nv12[:, :dst_h])
    ch = to_f32(nv12[:, rows - dst_h:])
    wyw, wcw = (round_to(m, bf).to(dev) for m in (dw.luma_w, dw.chroma_w))
    return w_pass_tail_plain(yh, ch[..., 0::2], ch[..., 1::2], wyw, wcw,
                             tail, torch.uint8)


def _hpass_sums(nv12: torch.Tensor, *, src_w: int, src_h: int, dst_w: int,
                dst_h: int):
    """hpass's H sums at its output samples: the luma and the interleaved
    chroma H rows' first dst_w columns, [B, dst_h, dst_w] fp32 of bf16
    values (fp32 products with TF32 off, rounded to bf16)."""
    bf = torch.bfloat16
    dw = dense_weights(src_w, src_h, dst_w, dst_h, LANCZOS_AA, "420")
    wyh, wch = (round_to(m, bf).to(nv12.device) for m in (dw.luma_h,
                                                          dw.chroma_h))
    uv = nv12[:, src_h:src_h * 3 // 2]   # interleaved U/V rows
    with exact_f32_matmul():
        yh = round_to(torch.matmul(wyh, to_f32(nv12[:, :src_h])), bf)
        ch = round_to(torch.matmul(wch, to_f32(uv)), bf)
    return yh[..., :dst_w], ch[..., :dst_w]


def hpass_tolerance(nv12: torch.Tensor, *, src_w: int, src_h: int,
                    dst_w: int, dst_h: int) -> torch.Tensor:
    """[B, 3, dst_h, dst_w]: how far hpass's kernel may lie from
    :func:`prod_like_plain` at each sample. hpass stores round(bf16(yh) +
    bf16(ch)); the tensor cores' fp32 sums may round an H sum to the
    neighbouring bf16 value, and an ulp of bf16 is 1 at 128-255 and 2 at
    256-511, where the stored sum moves by it. So a sample may lie 1 LSB
    plus the two sums' ulps (at the plain version's sums) off, rounded
    down: 1 where both sums are under 64, 2 or 3 above (the lab also holds
    hpass to fewer than 1e-3 of its samples differing)."""
    def ulp(v):   # bf16: 8 significant bits
        return torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8)

    yh, ch = _hpass_sums(nv12, src_w=src_w, src_h=src_h, dst_w=dst_w,
                         dst_h=dst_h)
    tol = torch.floor(ulp(yh) + ulp(ch)) + 1
    return tol.unsqueeze(1).expand(-1, 3, -1, -1)


def prod_like(nv12: torch.Tensor, *, src_w: int, src_h: int, dst_w: int,
              dst_h: int, mode: str = "full",
              rows_per_block: int = PRODLIKE_TILE,
              space: ColorSpace = ColorSpace.BT_709,
              crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """S2's tensor-core block (:func:`static_kernel2`) with a phase
    knocked out, on strips of ``rows_per_block`` output rows over windows
    aligned to 8 rows: ``mode`` full (S2's kernel itself at its strip
    heights; 4-row strips run S2's block at wgmma's N = 8 with B's columns
    4-7 zero), hpass (every H chain, no W pass; out
    = clip(round(yh[:DH, :DW] + ch[:DH, :DW])) on every channel, ch the
    interleaved chroma H row, each column stored by one block) or wpass (no
    H chain; yh = frame rows 0..DH-1, ch = the buffer's last DH rows, then
    S2's W pass and tail). [B, 3, dst_h, dst_w] uint8, within the kernels'
    envelope of its plain version (the tensor cores sum in their own
    order; hpass within :func:`hpass_tolerance`); on the CPU
    :func:`prod_like_plain` itself. Raises ValueError for a strip height
    the mode does not run (full: 4 and S2's, 8 to 48; hpass and wpass: 16,
    32) or whose block does not fit shared memory
    (:func:`~vali_tpu_torch.lab.prodlike.prodlike_refusal`), on either
    device."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if rows_per_block < 1:
        raise ValueError(f"rows_per_block must be >= 1, got "
                         f"{rows_per_block}")
    tail = _checked(nv12, src_w, src_h, space, crange)
    if mode == "hpass" and dst_w > src_w:
        raise ValueError("hpass keeps the first dst_w H-pass columns: "
                         "dst_w must not exceed src_w")
    if mode == "wpass" and dst_h > nv12.shape[1]:
        raise ValueError("wpass reads the buffer's last dst_h rows: dst_h "
                         "must not exceed its rows")
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = prodlike_refusal(**geo, mode=mode, tile=rows_per_block)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("prod_like", nv12):
        return prod_like_plain(nv12, **geo, mode=mode,
                               rows_per_block=rows_per_block, space=space,
                               crange=crange)
    if mode == "full" and rows_per_block not in PRODLIKE_TILES["full"]:
        out = _static2_launch(nv12, tail, geo, rows_per_block,
                              PRODLIKE_ALIGN)
        prod_like.launches += 1
        return out
    from ..ops._cuda_build import check, load_lab_kernels

    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    args, _ = prodlike_device(src_w, src_h, dst_w, dst_h, mode,
                              rows_per_block, nv12.device)
    lib = load_lab_kernels()
    B = nv12.shape[0]
    out = torch.empty((B, 3, dst_h, dst_w), dtype=torch.uint8,
                      device=nv12.device)
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_prodlike_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, src_h, src_w, dst_h, dst_w,
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), MODES[mode],
            rows_per_block, *args, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "prod_like")
    prod_like.launches += 1
    return out


def staged_launch(nv12: torch.Tensor, tail: np.ndarray, *, src_w: int,
                  src_h: int, dst_w: int, dst_h: int, variant: str,
                  tile: int = STAGED_TILE) -> torch.Tensor:
    """One ``nv12_staged_launch`` of ``variant`` on strips of ``tile`` rows
    on a checked CUDA buffer (TMA staging where the view allows it)."""
    from ..ops._cuda_build import check, load_lab_kernels

    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    args, _ = staged_device(src_w, src_h, dst_w, dst_h, variant, tile,
                            nv12.device)
    lib = load_lab_kernels()
    B = nv12.shape[0]
    out = torch.empty((B, 3, dst_h, dst_w), dtype=torch.uint8,
                      device=nv12.device)
    with torch.cuda.device(nv12.device):
        rc = lib.nv12_staged_launch(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, src_h, src_w, dst_h, dst_w,
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            STAGED_VARIANTS[variant], tile,
            int(tma_ok(nv12, src_w, src_h)), *args, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "variant_kernel")
    return out


def variant_kernel(nv12: torch.Tensor, *, src_w: int, src_h: int,
                   dst_w: int, dst_h: int,
                   space: ColorSpace = ColorSpace.BT_709,
                   crange: ColorRange = ColorRange.MPEG,
                   variant: str = "B") -> torch.Tensor:
    """The product function with the H pass's frame operand converted to
    bf16 once: S2's block at strips of 16 rows over windows aligned to 8
    rows, each stage's window rows landed raw by TMA, converted once
    (cast chains u8->i32->f32->bf16 for B, u8->i32->bf16 for C and D: equal
    values) into the layout ``wgmma`` reads A from shared memory, both
    resize passes on the tensor cores; B and C run the chroma W pass over
    the interleaved H rows (U and V weights each zero at the other plane's
    columns), D over the deinterleaved U and V rows. [B, 3, dst_h, dst_w]
    uint8, within the kernels' envelope of :func:`nv12_preprocess`; on the
    CPU :func:`nv12_preprocess_plain`. Raises ValueError for a geometry
    whose shared memory does not fit the kernel
    (:func:`~vali_tpu_torch.lab.staged.staged_refusal`), on either
    device."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    tail = _checked(nv12, src_w, src_h, space, crange)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = staged_refusal(**geo, method=LANCZOS_AA, variant=variant)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("variant_kernel", nv12):
        return nv12_preprocess_plain(nv12, **geo, space=space, crange=crange)
    out = staged_launch(nv12, tail, **geo, variant=variant)
    variant_kernel.launches += 1
    return out


def multiframe(nv12: torch.Tensor, *, src_w: int, src_h: int, dst_w: int,
               dst_h: int, gframes: int = 4,
               space: ColorSpace = ColorSpace.BT_709,
               crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """The product function with ``gframes`` consecutive frames per block
    (B % gframes == 0) on 32-row strips over windows aligned to 8 rows
    (the notebook's defaults): the combo's tensor-core block at (gframes,
    32) for G = 2, 4, 8 (:func:`combo_kernel`: each chunk's W weights
    loaded once for the frames a warpgroup sums; 8 frames in two rounds of
    4), S2's (:func:`static_kernel2`) for G = 1. [B, 3, dst_h, dst_w]
    uint8, bit for bit the combo's (S2's) at those arguments, within the
    kernels' envelope of :func:`nv12_preprocess`; on the CPU
    :func:`static_kernel2_plain` at (32, 8). Raises ValueError for a batch
    that is not a multiple of ``gframes``, a G the block does not run, or
    a geometry whose shared memory does not fit it, on either device."""
    tail = _checked(nv12, src_w, src_h, space, crange)
    if gframes < 1 or nv12.shape[0] % gframes:
        raise ValueError(f"batch {nv12.shape[0]} is not a multiple of "
                         f"gframes={gframes}")
    if gframes not in MULTIFRAME_FRAMES:
        raise ValueError(f"multiframe runs {MULTIFRAME_FRAMES} frames a "
                         f"block, got gframes={gframes}")
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    t = MULTIFRAME_TILE
    why = (static2_refusal(**geo, method=LANCZOS_AA, tile=t, align=COMBO_ALIGN)
           if gframes == 1 else
           combo_refusal(**geo, method=LANCZOS_AA, gframes=gframes, tile=t))
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("multiframe", nv12):
        return static_kernel2_plain(nv12, **geo, tile=t, align=COMBO_ALIGN,
                                    space=space, crange=crange)
    out = (_static2_launch(nv12, tail, geo, t, COMBO_ALIGN) if gframes == 1
           else _combo_launch(nv12, tail, geo, gframes, t))
    multiframe.launches += 1
    return out


def static2_h_rows(nv12: torch.Tensor, *, src_w: int, src_h: int,
                   dst_w: int, dst_h: int, tile: int = 32, align: int = 8):
    """The H rows of :func:`static_kernel2_plain`: luma and interleaved
    chroma [B, dst_h, src_w] fp32 of bf16 values, S2's strip-window bands
    at (tile, align) as dense products (fp32 with TF32 off, rounded to
    bf16)."""
    dev = nv12.device
    bf = torch.bfloat16
    dense = []
    for (start, count, w), n_in in zip(
            strip_window_bands(src_w, src_h, dst_w, dst_h, LANCZOS_AA, tile,
                               align), (src_h, src_h // 2)):
        d = np.zeros((len(start), n_in), np.float32)
        for o in range(len(start)):
            d[o, start[o]:start[o] + count[o]] = w[o, :count[o]]
        dense.append(torch.from_numpy(d).to(dev))
    uv = nv12[:, src_h:src_h * 3 // 2]   # interleaved U/V rows
    with exact_f32_matmul():
        yh = round_to(torch.matmul(dense[0], to_f32(nv12[:, :src_h])), bf)
        ch = round_to(torch.matmul(dense[1], to_f32(uv)), bf)
    return yh, ch


def static2_w_pass_plain(yh: torch.Tensor, uh: torch.Tensor,
                         vh: torch.Tensor, tail: np.ndarray, *, src_w: int,
                         src_h: int, dst_w: int, dst_h: int) -> torch.Tensor:
    """The W pass and tail of :func:`static_kernel2_plain` over H rows
    ``yh`` [B, dst_h, src_w] and ``uh``, ``vh`` [B, dst_h, src_w / 2]:
    the dense bf16 column weights, fp32 with TF32 off."""
    bf = torch.bfloat16
    dw = dense_weights(src_w, src_h, dst_w, dst_h, LANCZOS_AA, "420")
    wyw, wcw = (round_to(m, bf).to(yh.device)
                for m in (dw.luma_w, dw.chroma_w))
    return w_pass_tail_plain(yh, uh, vh, wyw, wcw, tail, torch.uint8)


def static_kernel2_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                         dst_w: int, dst_h: int, tile: int = 32,
                         align: int = 8,
                         space: ColorSpace = ColorSpace.BT_709,
                         crange: ColorRange = ColorRange.MPEG
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`static_kernel2` (any device): the
    product's plain version with its H pass built from S2's strip-window
    tables, so that it checks them."""
    tail = _checked(nv12, src_w, src_h, space, crange)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    yh, ch = static2_h_rows(nv12, **geo, tile=tile, align=align)
    return static2_w_pass_plain(yh, ch[..., 0::2], ch[..., 1::2], tail,
                                **geo)


def _strip_block_work(batch: int, src_w: int, src_h: int, dst_w: int,
                      dst_h: int, tile: int, align: int, w_steps: int):
    """(bytes, operations) of one batch of S2's block: the product's bytes;
    the FLOPs its tables make it issue, zeros included — per strip and
    chunk of 64 frame bytes (each tile's chunks,
    :func:`~vali_tpu_torch.ops.banded.static2_w_tables`), the H chains'
    [64, 16] A times [16, tile] B each of its k_luma / 16 + k_chroma / 16
    k-steps and ``w_steps`` W k-steps at N = tile — and the tail."""
    geo = (src_w, src_h, dst_w, dst_h, LANCZOS_AA)
    t = static2_tables(*geo, tile, align)
    per_chunk = 64 * 16 * tile * ((t.k_luma + t.k_chroma) // 16 + w_steps)
    chunks = int(static2_w_tables(*geo).heads[:, 2].sum())
    return preprocess_work(batch, src_w, src_h, dst_w, dst_h,
                           h_fmas=t.luma.shape[0] * chunks * per_chunk,
                           w_fmas=0)


def static2_work(batch: int, src_w: int, src_h: int, dst_w: int,
                 dst_h: int, tile: int, align: int):
    """(bytes, operations) of one S2 batch (:func:`_strip_block_work`): its
    W pass's 4 luma k-steps at N = tile and 2 chroma k-steps at N = 2
    tile."""
    luma_w, chroma_w = STATIC2_W_STEPS
    return _strip_block_work(batch, src_w, src_h, dst_w, dst_h, tile, align,
                             luma_w + 2 * chroma_w)


def prodlike_work(batch: int, src_w: int, src_h: int, dst_w: int,
                  dst_h: int, mode: str, tile: int):
    """(bytes, operations) of one batch of :func:`prod_like` in ``mode``
    at strips of ``tile`` rows, each writing the planar output. full: S2's
    (:func:`static2_work` at (tile, 8)), the NV12 frames read and the
    FLOPs its tables make it issue, zeros included, per strip and chunk at
    wgmma's N (8 for 4-row strips). wpass: two DH-row slabs a frame read
    and the W k-steps of every chunk alone (and the tail). hpass: what its
    output needs, the luma and interleaved chroma bytes of the first
    dst_w columns and their H sums (the windows' taps, zeros included, at
    N; and one add and round a pixel), though the kernel reads and sums
    every column of its tiles' chunks."""
    geo = (src_w, src_h, dst_w, dst_h, LANCZOS_AA)
    t = static2_tables(*geo, tile, PRODLIKE_ALIGN)
    chunks = int(static2_w_tables(*geo).heads[:, 2].sum())
    # FMAs of one k-step [64, 16] x [16, N] over every strip and chunk
    n_strips = prodlike_n(tile) * t.luma.shape[0]
    step = 64 * 16 * n_strips * chunks
    h_steps = (t.k_luma + t.k_chroma) // 16
    luma_w, chroma_w = STATIC2_W_STEPS
    w_steps = luma_w + 2 * chroma_w
    sizes = (batch, src_w, src_h, dst_w, dst_h)
    if mode == "hpass":
        _, ops = preprocess_work(*sizes, w_pass=False, h_fmas=(
            n_strips * (t.k_luma + t.k_chroma) * dst_w))
        return batch * (src_h * dst_w + (src_h // 2) * dst_w
                        + 3 * dst_h * dst_w), ops
    if mode == "wpass":
        return preprocess_work(*sizes, h_pass=False, w_fmas=step * w_steps)
    return preprocess_work(*sizes, h_fmas=step * (h_steps + w_steps),
                           w_fmas=0)


def combo_work(batch: int, src_w: int, src_h: int, dst_w: int,
               dst_h: int, tile: int):
    """(bytes, operations) of one combo batch at any frames a block (they
    divide the W weights' reads, not the products): S2's at (tile, align
    8) (:func:`static2_work`), since each frame's chunks get S2's H chains
    and W products at N = tile, or, where the warpgroups split a strip's
    rows, two of each at N = tile / 2."""
    return static2_work(batch, src_w, src_h, dst_w, dst_h, tile,
                        COMBO_ALIGN)


def combo_w_fragment_bytes(batch: int, src_w: int, src_h: int, dst_w: int,
                           dst_h: int, gframes: int, tile: int) -> int:
    """Bytes of W-pass A fragments one combo batch reads (from L2): each
    chunk's 6 k-steps of [128, 8] bf16 once a block, round and warpgroup
    that sums it — one warpgroup a chunk in the chunks split, both in the
    frames, rounds and rows splits; gframes / 4 rounds in the rounds
    split, one in the others — for strips x batch / gframes blocks a tile.
    S2 at the same strip height is gframes = 1 in the chunks split."""
    chunks = int(static2_w_tables(src_w, src_h, dst_w, dst_h,
                                  LANCZOS_AA).heads[:, 2].sum())
    split = COMBO_SPLITS.get((gframes, tile), "chunks")
    readers = 1 if split == "chunks" else 2
    rounds = gframes // 4 if split == "rounds" else 1
    strips = -(-dst_h // tile)
    return (chunks * 6 * 128 * 16 * readers * rounds * strips
            * (batch // gframes))


def staged_work(batch: int, src_w: int, src_h: int, dst_w: int,
                dst_h: int, variant: str, tile: int = STAGED_TILE):
    """(bytes, operations) of one batch of the staged kernel
    (:func:`variant_kernel`, :func:`_strip_block_work`): S2's H chains, 4
    luma W k-steps at N = tile, then D's 2 chroma k-steps at N = 2 tile
    or B's and C's 8 (4 U, 4 V over the interleaved H rows) at N =
    tile."""
    return _strip_block_work(batch, src_w, src_h, dst_w, dst_h, tile,
                             STAGED_ALIGN, 8 if variant == "D" else 12)


def _static2_device(src_w, src_h, dst_w, dst_h, tile, align, device):
    """S2's launch arguments after the tile on ``device`` (the product's
    :func:`~vali_tpu_torch.ops.banded.static2_device_tables`, uploaded
    once per geometry), with the tables they point into."""
    t = static2_device_tables(src_w, src_h, dst_w, dst_h, LANCZOS_AA, tile,
                              align, device)
    return t.args(), t


def _s2_tables_launch(launcher: str, what: str, nv12: torch.Tensor,
                      tail: np.ndarray, geo: dict, knobs: tuple, tile: int,
                      align: int) -> torch.Tensor:
    """One launch of a launcher that takes S2's tables at (tile, align)
    after the frames, the geometry, the tail and its ``knobs``, on a
    checked CUDA buffer; counts nothing."""
    from ..ops._cuda_build import check, load_lab_kernels

    if nv12.stride(2) != 1:
        raise ValueError("NV12 rows must be contiguous (stride 1)")
    args, _ = _static2_device(geo["src_w"], geo["src_h"], geo["dst_w"],
                              geo["dst_h"], tile, align, nv12.device)
    lib = load_lab_kernels()
    B = nv12.shape[0]
    out = torch.empty((B, 3, geo["dst_h"], geo["dst_w"]), dtype=torch.uint8,
                      device=nv12.device)
    with torch.cuda.device(nv12.device):
        rc = getattr(lib, launcher)(
            nv12.data_ptr(), nv12.stride(0), nv12.stride(1), nv12.shape[1],
            B, geo["src_h"], geo["src_w"], geo["dst_h"], geo["dst_w"],
            tail.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *knobs,
            *args, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(lib, rc, what)
    return out


def _static2_launch(nv12, tail, geo, tile, align) -> torch.Tensor:
    """One ``nv12_static2_launch`` (S2 at (tile, align))."""
    return _s2_tables_launch("nv12_static2_launch", "static_kernel2", nv12,
                             tail, geo, (tile,), tile, align)


def _combo_launch(nv12, tail, geo, gframes, tile) -> torch.Tensor:
    """One ``nv12_combo_launch`` at (gframes, tile) on S2's tables at
    (tile, COMBO_ALIGN)."""
    return _s2_tables_launch("nv12_combo_launch", "combo_kernel", nv12, tail,
                             geo, (gframes, tile), tile, COMBO_ALIGN)


def static_kernel2(nv12: torch.Tensor, *, src_w: int, src_h: int,
                   dst_w: int, dst_h: int, tile: int = 32, align: int = 8,
                   space: ColorSpace = ColorSpace.BT_709,
                   crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """S2: the product function on strips of ``tile`` output rows whose
    source windows start at multiples of ``align`` rows and share one
    length; every output row runs over its strip's whole window, zero
    weights included, and where wgmma's k-step needs more (K a multiple
    of 16) the windows widen further with zero rows. Both resize passes
    run on the tensor cores with the strip height as N: one block per
    output tile of 64 columns, strip and frame, the stacked windows
    streamed through a cp.async ring, each chunk's bf16 H rows multiplied
    at once by its W weights (N = tile luma, 2 tile U and V), fp32 sums;
    then the product's tail. [B, 3, dst_h, dst_w] uint8, within the
    kernels' envelope of :func:`nv12_preprocess` (the tensor cores sum in
    their own order); on the CPU :func:`static_kernel2_plain` itself.
    Raises ValueError for tile or align < 1, and for a strip height that
    is not a multiple of 8 up to 48 or a geometry whose shared memory does
    not fit the kernel (:func:`~vali_tpu_torch.ops.banded.static2_refusal`),
    on either device."""
    tail = _checked(nv12, src_w, src_h, space, crange)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    strip_window_bands(src_w, src_h, dst_w, dst_h, LANCZOS_AA, tile,
                       align)   # refuses tile or align < 1
    why = static2_refusal(**geo, method=LANCZOS_AA, tile=tile, align=align)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("static_kernel2", nv12):
        return static_kernel2_plain(nv12, **geo, tile=tile, align=align,
                                    space=space, crange=crange)
    out = _static2_launch(nv12, tail, geo, tile, align)
    static_kernel2.launches += 1
    return out


def combo_kernel(nv12: torch.Tensor, *, src_w: int, src_h: int,
                 dst_w: int, dst_h: int, gframes: int = 2, tile: int = 32,
                 space: ColorSpace = ColorSpace.BT_709,
                 crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """COMBO: the product function with ``gframes`` frames per block (B %
    gframes == 0) on S2's strips of ``tile`` output rows over windows
    aligned to 8 rows (the notebook's ALIGN), zero taps included. Both
    resize passes run on the tensor cores as in S2 (one block per 64-column
    output tile, strip and G frames, the stacked windows streamed through
    a cp.async ring, the block walking the G frames of a column group
    before the next), each chunk's W weights loaded once for the G frames
    and each frame's W products into its own accumulators; then the
    product's tail. [B, 3, dst_h, dst_w] uint8, within the kernels'
    envelope of :func:`nv12_preprocess` (the tensor cores sum in their own
    order), equal to S2 at the same strip height where the warpgroups
    split the chunks as S2's do (:data:`COMBO_SPLITS`); on the CPU
    :func:`static_kernel2_plain` at (tile, 8). Raises ValueError for a
    batch that is not a multiple of ``gframes``, for tile < 1, and for a
    (gframes, tile) the kernel does not run or a geometry whose shared
    memory does not fit it
    (:func:`~vali_tpu_torch.ops.banded.combo_refusal`), on either
    device."""
    tail = _checked(nv12, src_w, src_h, space, crange)
    if gframes < 1 or nv12.shape[0] % gframes:
        raise ValueError(f"batch {nv12.shape[0]} is not a multiple of "
                         f"gframes={gframes}")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = combo_refusal(**geo, method=LANCZOS_AA, gframes=gframes,
                        tile=tile)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("combo_kernel", nv12):
        return static_kernel2_plain(nv12, **geo, tile=tile,
                                    align=COMBO_ALIGN, space=space,
                                    crange=crange)
    out = _combo_launch(nv12, tail, geo, gframes, tile)
    combo_kernel.launches += 1
    return out


def _chains_checked(nv12, geo, tile, space, crange) -> np.ndarray:
    """Validate a call of S / Slong / T at strips of ``tile`` rows; the
    packed tail."""
    tail = _checked(nv12, geo["src_w"], geo["src_h"], space, crange)
    strip_window_bands(geo["src_w"], geo["src_h"], geo["dst_w"],
                       geo["dst_h"], LANCZOS_AA, tile,
                       CHAINS_ALIGN)   # refuses tile < 1
    why = chains_refusal(**geo, tile=tile)
    if why:
        raise ValueError(f"{geo['src_w']}x{geo['src_h']} -> "
                         f"{geo['dst_w']}x{geo['dst_h']}: {why}")
    return tail


def static_kernel(nv12: torch.Tensor, *, src_w: int, src_h: int,
                  dst_w: int, dst_h: int, shortchain: bool = True,
                  tile: int = CHAINS_TILE,
                  space: ColorSpace = ColorSpace.BT_709,
                  crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """S: the product function on the TPU's static windows (strips of
    ``tile`` output rows, 16 or 32, over windows aligned to 8 rows, zero
    taps included) on S2's tensor-core block, the H chains' A built from
    the ring's raw bytes by the TPU's short cast chain u8 -> i32 -> bf16
    (``shortchain``, S) or its long one u8 -> i32 -> f32 -> bf16 (Slong):
    equal values, so S2's bits at (tile, 8). [B, 3, dst_h, dst_w] uint8,
    within the kernels' envelope of :func:`nv12_preprocess`; on the CPU
    :func:`static_kernel2_plain` at (tile, 8). Raises ValueError for a
    strip height it does not run or a geometry S2 refuses
    (:func:`~vali_tpu_torch.lab.chains.chains_refusal`), on either
    device."""
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    tail = _chains_checked(nv12, geo, tile, space, crange)
    if _on_cpu("static_kernel", nv12):
        return static_kernel2_plain(nv12, **geo, tile=tile,
                                    align=CHAINS_ALIGN, space=space,
                                    crange=crange)
    out = _s2_tables_launch("nv12_chains_launch", "static_kernel", nv12,
                            tail, geo, (int(shortchain), tile), tile,
                            CHAINS_ALIGN)
    static_kernel.launches += 1
    return out


def transposed_chroma(nv12: torch.Tensor, *, src_w: int, src_h: int,
                      dst_w: int, dst_h: int, tile: int = CHAINS_TILE,
                      space: ColorSpace = ColorSpace.BT_709,
                      crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """T: the product function on S2's tensor-core block at strips of
    ``tile`` output rows (16 or 32) over windows aligned to 8 rows, the
    chroma H sums kept interleaved as the chain leaves them (the TPU's
    ``ch`` before its transpose) and read by the chroma W pass as an
    MN-major operand whose n runs over U of 8 rows, then V of the same 8.
    [B, 3, dst_h, dst_w] uint8, S2's bits at (tile, 8), within the
    kernels' envelope of :func:`nv12_preprocess`; on the CPU
    :func:`static_kernel2_plain` at (tile, 8). Raises ValueError for a
    strip height it does not run or a geometry S2 refuses, on either
    device."""
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    tail = _chains_checked(nv12, geo, tile, space, crange)
    if _on_cpu("transposed_chroma", nv12):
        return static_kernel2_plain(nv12, **geo, tile=tile,
                                    align=CHAINS_ALIGN, space=space,
                                    crange=crange)
    out = _s2_tables_launch("nv12_tchroma_launch", "transposed_chroma",
                            nv12, tail, geo, (tile,), tile, CHAINS_ALIGN)
    transposed_chroma.launches += 1
    return out


def _strip_rows(src_h: int, gt) -> np.ndarray:
    """[strips, k_pad] frame rows of each strip's stacked window in G's
    tables ``gt``: the luma window, the chroma window (under the src_h luma
    rows), then row 0 for the zero rows of the padding."""
    ly, lc = gt.luma_rows, gt.chroma_rows
    rows = np.zeros((gt.weights.shape[0], gt.k_pad), np.int64)
    rows[:, :ly] = gt.starts[:, :1] + np.arange(ly)
    rows[:, ly:ly + lc] = src_h + gt.starts[:, 1:] + np.arange(lc)
    return rows


#: G's W pass in the default build of csrc/nv12_grouped.cu (its
#: NV12_GROUPED_WPASS): "mma" on the tensor cores or "banded" on the CUDA
#: cores
GROUPED_WPASS = "mma"


def grouped_work(batch: int, src_w: int, src_h: int, dst_w: int,
                 dst_h: int, wpass: str = GROUPED_WPASS):
    """(bytes, operations) of one G batch: the product's bytes; the FLOPs
    its dense products issue, zeros included — [16, k_pad] weights times
    every column of each strip's window, and with the mma W pass [64, 16]
    A fragments times the 8 luma (16 chroma: U and V) H rows each k-step of
    each strip — and the tail."""
    gt = grouped_tables(src_w, src_h, dst_w, dst_h, LANCZOS_AA)
    strips = gt.weights.shape[0]
    w_fmas = None
    if wpass == "mma":
        nk = grouped_w_tables(src_w, src_h, dst_w, dst_h,
                              LANCZOS_AA).heads[:, :, 2].sum(axis=0)
        w_fmas = strips * 64 * 16 * GROUP_STRIP * int(nk[0] + 2 * nk[1])
    return preprocess_work(batch, src_w, src_h, dst_w, dst_h,
                           h_fmas=strips * 16 * gt.k_pad * src_w,
                           w_fmas=w_fmas)


def grouped_kernel_plain(nv12: torch.Tensor, *, src_w: int, src_h: int,
                         dst_w: int, dst_h: int,
                         space: ColorSpace = ColorSpace.BT_709,
                         crange: ColorRange = ColorRange.MPEG
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`grouped_kernel` (any device): G's
    block-diagonal matrices times the stacked windows, fp32 with TF32 off,
    rounded to bf16, then the dense bf16 W pass and the product's tail."""
    tail = _checked(nv12, src_w, src_h, space, crange)
    dev = nv12.device
    bf = torch.bfloat16
    gt = grouped_tables(src_w, src_h, dst_w, dst_h, LANCZOS_AA)
    rows = torch.from_numpy(_strip_rows(src_h, gt)).to(dev)
    x = to_f32(nv12[:, rows])                     # [B, strips, K, W]
    with exact_f32_matmul():
        h = round_to(torch.matmul(torch.from_numpy(gt.weights).to(dev), x),
                     bf)
    B = nv12.shape[0]
    yh = h[:, :, :GROUP_STRIP].reshape(B, -1, src_w)[:, :dst_h]
    ch = h[:, :, GROUP_STRIP:].reshape(B, -1, src_w)[:, :dst_h]
    dw = dense_weights(src_w, src_h, dst_w, dst_h, LANCZOS_AA, "420")
    wyw, wcw = (round_to(m, bf).to(dev) for m in (dw.luma_w, dw.chroma_w))
    return w_pass_tail_plain(yh, ch[..., 0::2], ch[..., 1::2], wyw, wcw,
                             tail, torch.uint8)


@functools.lru_cache(maxsize=8)
def _grouped_device(src_w, src_h, dst_w, dst_h, device):
    """G's launch arguments after the tail on ``device``, uploaded once
    per geometry: B in bf16 core-matrix order, the window starts, the
    window lengths and K, the W pass's heads and bf16 A fragments."""
    gt = grouped_tables(src_w, src_h, dst_w, dst_h, LANCZOS_AA)
    wt = grouped_w_tables(src_w, src_h, dst_w, dst_h, LANCZOS_AA)
    keep = (torch.from_numpy(core_matrix_order(gt.weights)).to(
                device, torch.bfloat16),
            torch.from_numpy(gt.starts).to(device),
            torch.from_numpy(wt.heads.reshape(-1)).to(device),
            torch.from_numpy(wt.frags).to(device, torch.bfloat16))
    args = (keep[0].data_ptr(), keep[1].data_ptr(), gt.luma_rows,
            gt.chroma_rows, gt.k_pad, *(k.data_ptr() for k in keep[2:]))
    return args, keep


def grouped_kernel(nv12: torch.Tensor, *, src_w: int, src_h: int,
                   dst_w: int, dst_h: int,
                   space: ColorSpace = ColorSpace.BT_709,
                   crange: ColorRange = ColorRange.MPEG) -> torch.Tensor:
    """G: the product function with its resize passes on the tensor cores,
    one block per 8-row strip: the transposed H product, 64 frame columns
    times a [K, 16] bf16 block-diagonal B (the strip's luma and chroma rows
    over their stacked windows), wgmma with fp32 sums fed by a cp.async
    ring, rounded to bf16; then the W pass (GROUPED_WPASS: wgmma over each
    64-column tile's band, or the product's banded loop) and the product's
    tail. [B, 3, dst_h, dst_w] uint8, within the kernels' envelope of
    :func:`nv12_preprocess` (the tensor cores sum in their own order).
    Raises ValueError for a geometry whose windows or shared memory do not
    fit the kernel, on either device."""
    tail = _checked(nv12, src_w, src_h, space, crange)
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    why = grouped_refusal(**geo, method=LANCZOS_AA)
    if why:
        raise ValueError(f"{src_w}x{src_h} -> {dst_w}x{dst_h}: {why}")
    if _on_cpu("grouped_kernel", nv12):
        return grouped_kernel_plain(nv12, **geo, space=space, crange=crange)
    args, _ = _grouped_device(src_w, src_h, dst_w, dst_h, nv12.device)
    out = _call("grouped_kernel", "nv12_grouped_launch", nv12, tail,
                _product_tables(nv12, **geo), *args, **geo)
    grouped_kernel.launches += 1
    return out


#: kernel launches made by each wrapper (CPU calls are not counted)
stream_floor.launches = 0
prod_like.launches = 0
variant_kernel.launches = 0
multiframe.launches = 0
static_kernel.launches = 0
static_kernel2.launches = 0
combo_kernel.launches = 0
transposed_chroma.launches = 0
grouped_kernel.launches = 0
WRAPPERS = (stream_floor, prod_like, variant_kernel, multiframe,
            static_kernel, static_kernel2, combo_kernel, transposed_chroma,
            grouped_kernel)


# --- the lab ----------------------------------------------------------------

class Case(NamedTuple):
    """One lab name: the wrapper it launches, the call, the plain version
    of its function, and whether that function is the product kernel's."""
    wrapper: Callable
    call: Callable[[torch.Tensor], torch.Tensor]
    plain: Callable[[torch.Tensor], torch.Tensor]
    full_function: bool
    frames: int      # frames the call needs at least (multiframe G)
    work: tuple      # (bytes, operations) of one batch of B frames
    exact: bool = True   # bit-equal to its reference (the tensor cores'
    #                      B-D, G, S2, combo, prod_like, M*, S*, T*:
    #                      envelope)
    note: str = ""       # how the kernel ran, for the lab line
    # per-sample bound against the plain version where the envelope's
    # 1 LSB does not hold (hpass: hpass_tolerance), on the given frames
    tol: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def tolerance(self, frames: torch.Tensor):
        """How far the kernel may lie from its plain version on
        ``frames``: ``tol`` or the envelope's 1 LSB."""
        return self.tol(frames) if self.tol else 1


def _tiles_note(dst_w: int) -> str:
    tiles = -(-dst_w // 64)
    return (f"in {tiles} column ranges, one 64-column output tile each"
            if tiles > 1 else "")


def case(name: str, batch: int, rows: int, src_w: int, src_h: int,
         dst_w: int, dst_h: int) -> Case:
    """The :class:`Case` of a lab name on [batch, rows, src_w] frames."""
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    full = preprocess_work(batch, src_w, src_h, dst_w, dst_h)
    product = (lambda x: nv12_preprocess_plain(x, **geo))
    if name == "A":
        return Case(nv12_preprocess, lambda x: nv12_preprocess(x, **geo),
                    product, True, 1, full)
    if name in VARIANTS:
        return Case(variant_kernel,
                    lambda x: variant_kernel(x, **geo, variant=name),
                    product, True, 1,
                    staged_work(batch, **geo, variant=name), exact=False)
    if name == "floor":
        fl = dict(rows=rows, W=src_w, DH=dst_h, DW=dst_w)
        out = batch * 3 * dst_h * dst_w
        return Case(stream_floor, lambda x: stream_floor(x, **fl),
                    lambda x: stream_floor_plain(x, **fl), False, 1,
                    (batch * rows * src_w + out, batch * rows * src_w // 4
                     + 2 * out))
    m = re.fullmatch(r"M(\d+)", name)
    if m:
        g = int(m.group(1))
        return Case(multiframe, lambda x: multiframe(x, **geo, gframes=g),
                    lambda x: static_kernel2_plain(
                        x, **geo, tile=MULTIFRAME_TILE, align=COMBO_ALIGN),
                    True, g, combo_work(batch, **geo, tile=MULTIFRAME_TILE),
                    exact=False, note=_tiles_note(dst_w))
    m = re.fullmatch(r"(S|Slong|T)(\d*)", name)
    if m:
        arm, tile = m.group(1), int(m.group(2) or CHAINS_TILE)
        call = ((lambda x: transposed_chroma(x, **geo, tile=tile))
                if arm == "T" else
                (lambda x: static_kernel(x, **geo, shortchain=arm == "S",
                                         tile=tile)))
        return Case(
            transposed_chroma if arm == "T" else static_kernel, call,
            lambda x: static_kernel2_plain(x, **geo, tile=tile,
                                           align=CHAINS_ALIGN),
            True, 1, static2_work(batch, **geo, tile=tile,
                                  align=CHAINS_ALIGN),
            exact=False, note=_tiles_note(dst_w))
    if name == "G":
        return Case(grouped_kernel, lambda x: grouped_kernel(x, **geo),
                    lambda x: grouped_kernel_plain(x, **geo), True, 1,
                    grouped_work(batch, **geo), exact=False)
    m = re.fullmatch(r"S2t(\d+)a(\d+)", name)
    if m:
        tile, align = int(m.group(1)), int(m.group(2))
        return Case(
            static_kernel2,
            lambda x: static_kernel2(x, **geo, tile=tile, align=align),
            lambda x: static_kernel2_plain(x, **geo, tile=tile, align=align),
            True, 1, static2_work(batch, **geo, tile=tile, align=align),
            exact=False, note=_tiles_note(dst_w))
    m = re.fullmatch(r"combo(\d+)x(\d+)", name)
    if m:
        g, tile = int(m.group(1)), int(m.group(2))
        return Case(
            combo_kernel,
            lambda x: combo_kernel(x, **geo, gframes=g, tile=tile),
            lambda x: static_kernel2_plain(x, **geo, tile=tile,
                                           align=COMBO_ALIGN),
            True, g, combo_work(batch, **geo, tile=tile),
            exact=False, note=_tiles_note(dst_w))
    m = re.fullmatch(r"(full|hpass|wpass)(\d*)", name)
    if m:
        mode, strip = m.group(1), int(m.group(2) or PRODLIKE_TILE)
        return Case(
            prod_like,
            lambda x: prod_like(x, **geo, mode=mode, rows_per_block=strip),
            lambda x: prod_like_plain(x, **geo, mode=mode,
                                      rows_per_block=strip), mode == "full",
            1, prodlike_work(batch, **geo, mode=mode, tile=strip),
            exact=False, note=_tiles_note(dst_w),
            tol=((lambda x: hpass_tolerance(x, **geo)) if mode == "hpass"
                 else None))
    raise ValueError(f"unknown lab name {name!r}: one of {DEFAULT_NAMES}, "
                     f"a mode with a strip height (full16), M{{G}}, S, "
                     f"Slong or T with a strip height (T16), "
                     f"S2t{{tile}}a{{align}} or combo{{G}}x{{tile}}")


def make_frames(batch: int, rows: int, width: int, device,
                seed: int = 0) -> torch.Tensor:
    """[batch, rows, width] uint8 frames of uniform random samples from
    ``numpy.random.default_rng(seed)``, as the TPU notebook makes them."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (batch, rows, width), dtype=np.uint8)
    return torch.from_numpy(x).to(device)


def run(names: Sequence[str], frames: torch.Tensor, *, src_w: int,
        src_h: int, dst_w: int, dst_h: int,
        log: Callable[[str], None] = print) -> List[Dict[str, object]]:
    """Run each lab name on ``frames`` [B, rows, src_w]: its maxdiff on the
    first max(2, G) frames against its reference (the product kernel for
    the full-function variants, else the plain version) and by how much
    it passes its limit there (``excess``, 0 when within: 0 where the case
    is exact, the envelope's 1 LSB against the product,
    :meth:`Case.tolerance` against the plain version), and on the card
    its time per batch. Logs one line per name; returns one dict per
    name."""
    batch, rows = frames.shape[0], frames.shape[1]
    geo = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    on_card = frames.device.type == "cuda"
    results = []
    for name in names:
        c = case(name, batch, rows, **geo)
        head = frames[:max(2, c.frames)]
        ref = (nv12_preprocess(head, **geo) if c.full_function
               else c.plain(head))
        diff = (c.call(head).int() - ref.int()).abs()
        maxdiff = int(diff.max().item())
        ndiff = int((diff > 0).sum().item())
        limit = (0 if c.exact else 1 if c.full_function
                 else c.tolerance(head))
        excess = int((diff - limit).clamp(min=0).max().item())
        bound, bound_by = bound_ms(*c.work)
        row = dict(name=name, maxdiff=maxdiff, ndiff=ndiff, excess=excess,
                   bound_ms=bound, bound_by=bound_by, ms=None, spread=None)
        # G's differing samples (of the head frames), and how a kernel ran
        extra = "".join(
            [f"  differing={ndiff} of {diff.numel()}" if not c.exact else "",
             f"  ({c.note})" if c.note else ""])
        if on_card:
            ms, spread = time_cuda(c.call, frames)
            row.update(ms=ms, spread=spread,
                       fps=batch / (ms * 1e-3),
                       gbps=c.work[0] / (ms * 1e-3) / 1e9)
            log(f"{name}: {ms:.4f} ms/batch  spread={spread:.1%}  "
                f"maxdiff={maxdiff}  fps={row['fps']:,.0f}  "
                f"GB/s={row['gbps']:.1f}  bound={bound:.4f} ms "
                f"({bound_by}){extra}")
        else:
            log(f"{name}: maxdiff={maxdiff} (plain version on the CPU; "
                f"not timed){extra}")
        results.append(row)
    times = {r["name"]: r["ms"] for r in results}
    if on_card and all(times.get(k) for k in ("full", "hpass", "wpass")):
        log(f"H/W split: hpass {times['hpass']:.4f} ms = "
            f"{times['hpass'] / times['full']:.1%} of full "
            f"{times['full']:.4f} ms, wpass {times['wpass']:.4f} ms = "
            f"{times['wpass'] / times['full']:.1%}")
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.kernel_variants",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(DEFAULT_NAMES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("kernel_variants: no CUDA device (use --device cpu for "
                  "the plain versions)", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        batch, W, H, DW, DH = CARD_SIZE
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"{torch.cuda.get_device_name(0)} ({smi}) torch="
              f"{torch.__version__} cuda={torch.version.cuda}", flush=True)
    else:
        device = torch.device("cpu")
        batch, W, H, DW, DH = CPU_SIZE
    rows = H * 3 // 2
    print(f"{batch} x {W}x{H} NV12 (rows={rows}) -> {DW}x{DH} uint8, bf16 "
          f"compute, BT.709 MPEG, lanczos_aa", flush=True)
    frames = make_frames(batch, rows, W, device)
    run(args.names, frames, src_w=W, src_h=H, dst_w=DW, dst_h=DH,
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
