"""Host side of lab kernel ``staged`` (``csrc/nv12_staged.cu``), the
Hopper form of the notebook's ``variant_kernel`` B / C / D: S2's block
(:func:`~vali_tpu_torch.ops.banded.static2_tables` at strips of
``tile`` rows aligned to STAGED_ALIGN rows) with the H pass's frame
operand converted once a stage into shared memory and read by a
``wgmma`` descriptor.

- :func:`operand_offsets` is the operand buffer's layout (where the
  converter writes each window sample) and :func:`descriptor_read` how
  ``wgmma`` reads a [64, 16] k-step of A back through a descriptor, for
  MN-major and K-major operands without swizzle; :func:`operand_image` is
  the inverse, the shared-memory image of a matrix (the card's descriptor
  test).
- :func:`interleaved_w_tables` are B's and C's W tables: S2's chunks
  (:func:`~vali_tpu_torch.ops.banded.static2_w_tables`), each with its 4
  luma k-steps, 4 k-steps of U weights over the chunk's 64 interleaved
  chroma columns (zero at the V columns) and 4 of V weights (zero at the
  U columns). D takes S2's tables as they are.
- :func:`staged_smem_bytes`, :func:`staged_refusal` and
  :func:`staged_device` (the launch arguments, uploaded once a
  geometry).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.banded import (SMEM_LIMIT, SM_SMEM, BLOCK_RESERVED_SMEM,
                          bf16_bits, core_matrix_order, fragment_order,
                          static2_tables, static2_w_tables)
from ..ops.resize import LANCZOS_AA

#: the launcher's variant numbers
STAGED_VARIANTS = {"B": 0, "C": 1, "D": 2}
#: the strip heights each variant is built for (csrc/nv12_staged.cu)
STAGED_TILES = {"B": (16,), "C": (16,), "D": (16, 32)}
#: the lab names' strip height and every strip's window alignment
STAGED_TILE = 16
STAGED_ALIGN = 8
#: slots of the landing ring
STAGED_SLOTS = 2
#: bytes between the operand's K blocks (8 window rows of 16 bytes)
OPERAND_LBO = 128
#: a stage's frame bytes, a chunk's (one warpgroup's)
STAGE_COLS = 128
CHUNK = 64


def operand_pitch(kst: int) -> int:
    """Bytes between the operand's M blocks for ``kst`` window rows: the
    blocks' K rows of 16 bytes, and 16 spare bytes (a quarter warp's
    stores then fall in distinct banks)."""
    return 16 * kst + 16


def operand_m(col: np.ndarray) -> np.ndarray:
    """The operand's M row of a chunk column: S2's order, M rows 16 w ..
    16 w + 7 the even columns of 16 w .. 16 w + 15 and the next 8 the odd
    ones, so that a thread's accumulators hold two adjacent columns."""
    col = np.asarray(col)
    return 16 * (col // 16) + (col % 16) // 2 + 8 * (col % 2)


def operand_offsets(kst: int) -> np.ndarray:
    """[kst, 64] byte offset, in a warpgroup's operand buffer, of window
    row k at chunk column c: MN-major core matrices of 8 rows (K) of 8
    M elements, M block m // 8 ``operand_pitch(kst)`` bytes apart, K block
    k // 8 OPERAND_LBO apart."""
    k = np.arange(kst)[:, None]
    m = operand_m(np.arange(CHUNK))[None, :]
    return ((m // 8) * operand_pitch(kst) + (k // 8) * OPERAND_LBO
            + (k % 8) * 16 + (m % 8) * 2)


def _element_offsets(lbo: int, sbo: int, mn_major: bool) -> np.ndarray:
    """[64, 16] byte offset of A[m, k] of one k-step from its descriptor's
    start: without swizzle, M blocks of 8 ``sbo`` apart and K blocks of 8
    ``lbo`` apart; inside a core matrix 8 rows of 16 bytes, a row 8
    contiguous M elements (MN-major) or K elements (K-major)."""
    m = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    inner = ((k % 8) * 16 + (m % 8) * 2 if mn_major
             else (m % 8) * 16 + (k % 8) * 2)
    return (m // 8) * sbo + (k // 8) * lbo + inner


def descriptor_read(buf: np.ndarray, start: int, lbo: int, sbo: int,
                    mn_major: bool = True) -> np.ndarray:
    """The [64, 16] A of one k-step as ``wgmma`` reads it from the bytes
    ``buf`` (uint8) through a descriptor at byte ``start``."""
    off = start + _element_offsets(lbo, sbo, mn_major)
    lo = buf[off].astype(np.uint16)
    hi = buf[off + 1].astype(np.uint16)
    return lo | (hi << 8)


def operand_image(a: np.ndarray, lbo: int, sbo: int,
                  mn_major: bool) -> np.ndarray:
    """The shared-memory bytes (uint8) from which a descriptor at byte 0
    reads the [64, 16] uint16 (bf16 bits) ``a``: the inverse of
    :func:`descriptor_read`; bytes no element takes are 0."""
    off = _element_offsets(lbo, sbo, mn_major)
    buf = np.zeros(-(-(int(off.max()) + 2) // 16) * 16, np.uint8)
    buf[off] = (a & 0xFF).astype(np.uint8)
    buf[off + 1] = (a >> 8).astype(np.uint8)
    return buf


def convert_stage(window: np.ndarray) -> np.ndarray:
    """A warpgroup's operand buffer after the converter: ``window`` [kst,
    64] uint8 (a landed stage's 64 columns) as bf16 bits at
    :func:`operand_offsets`, as uint8 bytes; spare bytes 0."""
    kst = window.shape[0]
    buf = np.zeros(8 * operand_pitch(kst), np.uint8)
    off = operand_offsets(kst)
    bits = bf16_bits(window.astype(np.float32))
    buf[off] = (bits & 0xFF).astype(np.uint8)
    buf[off + 1] = (bits >> 8).astype(np.uint8)
    return buf


def bf16_values(bits: np.ndarray) -> np.ndarray:
    """float32 values of uint16 bf16 bits."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def fragment_matrix(frags: np.ndarray) -> np.ndarray:
    """[..., K / 16, 128, 8] register fragments of wgmma's A (ops/banded.py
    fragment_order) back to [..., 64, K]: the inverse of fragment_order."""
    *lead, nk, _, _ = frags.shape
    t = np.arange(128)
    m0 = 16 * (t // 32) + (t % 32) // 4
    k = 2 * (t % 4)
    rows = np.stack([m0, m0, m0 + 8, m0 + 8] * 2, axis=1)
    cols = np.stack([k, k + 1, k, k + 1, k + 8, k + 9, k + 8, k + 9], axis=1)
    out = np.zeros((*lead, 64, 16 * nk), frags.dtype)
    for s in range(nk):
        out[..., rows, 16 * s + cols] = frags[..., s, :, :]
    return out


class StagedWTables(NamedTuple):
    """B's and C's W pass (csrc/nv12_staged.cu): ``heads`` [tiles, 4]
    int32, S2's (first chunk, first byte column x0, chunks, 0); ``frags``
    [chunks, 12, 128, 8] float32 of bf16 values, per chunk of 64 frame
    bytes the A fragments of its 4 luma k-steps, 4 U k-steps and 4 V
    k-steps over the chunk's 64 interleaved chroma columns."""
    heads: np.ndarray
    frags: np.ndarray


@functools.lru_cache(maxsize=16)
def interleaved_w_tables(src_w: int, src_h: int, dst_w: int, dst_h: int,
                         method: str) -> StagedWTables:
    """Build B's and C's W tables from S2's: each chunk's chroma weights
    per pixel [64, 32] laid at the even (U) or odd (V) columns of the
    chunk's 64 interleaved chroma columns, zeros at the other plane's."""
    s2 = static2_w_tables(src_w, src_h, dst_w, dst_h, method)
    per_pixel = fragment_matrix(s2.frags[:, 4:])          # [chunks, 64, 32]
    chunks = per_pixel.shape[0]
    au = np.zeros((chunks, 64, CHUNK), np.float32)
    av = np.zeros((chunks, 64, CHUNK), np.float32)
    au[:, :, 0::2] = per_pixel
    av[:, :, 1::2] = per_pixel
    frags = np.concatenate(
        [s2.frags[:, :4], np.stack([fragment_order(a) for a in au]),
         np.stack([fragment_order(a) for a in av])], axis=1)
    return StagedWTables(s2.heads, frags)


def staged_smem_bytes(variant: str, tile: int, k_luma: int,
                      k_chroma: int) -> int:
    """Shared memory of one block: the landing ring of STAGED_SLOTS [k_luma
    + k_chroma, 128] byte stages (or the partial W sums the warpgroups
    trade at the end, the larger), two operand buffers, B_y and B_c in
    bf16, each warpgroup's H rows of a chunk (tile luma rows of 64 columns;
    D: tile U and tile V rows of 32 pixels, B and C: tile interleaved
    chroma rows of 64 columns; 8-column groups padded by 16 bytes) and the
    ring's barriers."""
    kst = k_luma + k_chroma
    ring = max(STAGED_SLOTS * kst * STAGE_COLS, 4 * (tile // 2 + tile) * 128)
    gy, gc = 16 * tile + 16, 32 * tile + 16
    chunk = 8 * gy + (4 * gc if variant == "D" else 8 * gy)
    return (ring + 16 * operand_pitch(kst) + 2 * kst * tile + 2 * chunk
            + 8 * STAGED_SLOTS)


def blocks_per_sm(variant: str, tile: int, k_luma: int,
                  k_chroma: int) -> int:
    """Blocks an SM holds by shared memory, capped by the kernel's launch
    bounds (two at T = 16, one above)."""
    smem = staged_smem_bytes(variant, tile, k_luma, k_chroma)
    return min(2 if tile <= 16 else 1, SM_SMEM // (smem + BLOCK_RESERVED_SMEM))


def staged_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                   method: str, variant: str, tile: int = STAGED_TILE
                   ) -> str:
    """Why the staged kernel cannot take this geometry, variant and strip,
    or "" when it can: a (variant, tile) it is not built for, or a block's
    shared memory over a block's."""
    if variant not in STAGED_TILES:
        return f"variant must be one of {tuple(STAGED_TILES)}, got {variant!r}"
    if tile not in STAGED_TILES[variant]:
        return (f"the staged kernel builds {variant} for strips of "
                f"{' or '.join(map(str, STAGED_TILES[variant]))} rows, got "
                f"tile={tile}")
    t = static2_tables(src_w, src_h, dst_w, dst_h, method, tile,
                       STAGED_ALIGN)
    smem = staged_smem_bytes(variant, tile, t.k_luma, t.k_chroma)
    if smem > SMEM_LIMIT:
        return (f"the staged kernel's landing ring, operand buffers, "
                f"weights and H rows need {smem} B of shared memory, over a "
                f"block's {SMEM_LIMIT} B")
    return ""


def tma_ok(nv12: torch.Tensor, src_w: int, src_h: int) -> bool:
    """Whether the kernel stages ``nv12`` by TMA: a 16-byte aligned start,
    row and batch strides that are multiples of 16 bytes, and rows and
    columns at least a box's (else its element loads fill the ring)."""
    return (nv12.data_ptr() % 16 == 0 and nv12.stride(1) % 16 == 0
            and nv12.stride(0) % 16 == 0 and src_w >= STAGE_COLS
            and src_h * 3 // 2 >= 16)


@functools.lru_cache(maxsize=16)
def staged_device(src_w: int, src_h: int, dst_w: int, dst_h: int,
                  variant: str, tile: int, device: torch.device):
    """The launch arguments after ``tma`` on ``device``, uploaded once per
    geometry: per strip B_y then B_c in bf16 core-matrix order, the window
    starts, K of each window, the W heads and bf16 A fragments (S2's for
    D, :func:`interleaved_w_tables` for B and C); with the tensors they
    point into."""
    geo = (src_w, src_h, dst_w, dst_h, LANCZOS_AA)
    t = static2_tables(*geo, tile, STAGED_ALIGN)
    wt = (static2_w_tables(*geo) if variant == "D"
          else interleaved_w_tables(*geo))
    b = np.concatenate([core_matrix_order(t.luma),
                        core_matrix_order(t.chroma)], axis=1)
    keep = (torch.from_numpy(b).to(device, torch.bfloat16),
            torch.from_numpy(t.starts).to(device),
            torch.from_numpy(wt.heads).to(device),
            torch.from_numpy(wt.frags).to(device, torch.bfloat16))
    args = (keep[0].data_ptr(), keep[1].data_ptr(), t.k_luma, t.k_chroma,
            keep[2].data_ptr(), keep[3].data_ptr())
    return args, keep
