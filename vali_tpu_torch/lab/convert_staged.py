"""Host side of the convert lab's staged kernels V1 and V2
(``csrc/nv12_convert_staged.cu``), the Hopper form of the notebook
``convert_lab.py``'s ``variant_kernel``: the NV12 -> packed RGB CSC as
``wgmma`` products over a once-converted bf16 operand.

- The functions that make B are the product's (``ops/nv12_to_rgb.py``,
  whose bf16 route runs V1's block): ``group_mats``, the notebook's dense
  per-group matrices (``Ag`` for luma, ``Bg`` for interleaved chroma) at
  any group width; ``b_matrices``, the kernel's B at wgmma's k16 (V1:
  ``Ag16``, ``Bg16``; V2: ``[Ag8; Bg8]``), columns permuted by
  ``column_map``; and ``b_image``, their bf16 bytes in K-major core
  matrices, uploaded once per (space, range, variant, device) by
  :func:`staged_device`.
- :func:`operand_offsets` is where the converter writes each landed
  sample in the operand (chroma twice: the replication), :func:`k_steps`
  the descriptors' starts the products read, :func:`thread_bytes` which
  accumulator of which thread becomes which output byte, and
  :func:`out_offsets` where the epilogue stores a word in the output tile
  (128-byte swizzle). The CPU tests walk them against
  :func:`~vali_tpu_torch.ops.nv12_to_rgb.nv12_to_rgb_plain`.
- :func:`staged_smem_bytes`: one block's shared memory.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace
from ..ops.nv12_to_rgb import (GROUP, N, b_image, b_matrices,  # noqa: F401
                               column_map, group_mats)
from .staged import bf16_bits

#: the launcher's variant numbers
VARIANTS = {"V1": 1, "V2": 2}
#: a tile: output rows (wgmma's M) by pixels; a span's pixels
BAND, TILE_W, SPAN = 64, 128, 16
#: landing slots
SLOTS = 3
#: the operand: K blocks 128 B apart, M blocks 32 K blocks and 16 spare
#: bytes apart
OPERAND_LBO = 128
OPERAND_SBO = 32 * OPERAND_LBO + 16
OPERAND_BYTES = BAND // 8 * OPERAND_SBO
#: bytes of an output box row; an output tile (64 rows x 384 B as three
#: boxes)
OUT_BOX = 128
OUT_BYTES = 3 * BAND * OUT_BOX


@functools.lru_cache(maxsize=16)
def staged_device(space: ColorSpace, crange: ColorRange, variant: str,
                  device: torch.device) -> torch.Tensor:
    """:func:`b_image` on ``device``, uploaded once (read-only)."""
    bits = b_image(space, crange, variant).view(np.int16)
    return torch.from_numpy(bits.copy()).to(device)


def k_block(variant: str, span, plane, half):
    """K block of ``span`` that holds ``plane`` (0 luma, 1 chroma) half
    ``half``: V1 luma 0-7, 8-15, chroma 0-7, 8-15; V2 [luma | chroma] of
    its first group, then of its second."""
    span, plane, half = (np.asarray(x) for x in (span, plane, half))
    inner = 2 * plane + half if variant == "V1" else plane + 2 * half
    return 4 * span + inner


def _half_slot(variant: str, b):
    """(half, element in the K block) of byte b (0..15) of a span."""
    b = np.asarray(b)
    if variant == "V1":
        return b // 8, b % 8
    return (b % 4) // 2, 2 * (b // 4) + b % 2


def operand_offsets(variant: str, plane: int) -> np.ndarray:
    """Byte offsets in the operand of a tile's landed samples: luma
    (``plane`` 0) [64 rows, 128 pixels], chroma (1) [32 rows, 128 bytes, 2]
    (chroma row i lands at A rows 2 i and 2 i + 1)."""
    x = np.arange(TILE_W)
    half, e = _half_slot(variant, x % SPAN)
    kb = k_block(variant, x // SPAN, plane, half)
    col = kb * OPERAND_LBO + 2 * e
    if plane == 0:
        m = np.arange(BAND)[:, None]
        return (m // 8) * OPERAND_SBO + (m % 8) * 16 + col[None, :]
    i = np.arange(BAND // 2)[:, None, None]
    m = 2 * i + np.arange(2)[None, None, :]
    return (m // 8) * OPERAND_SBO + (m % 8) * 16 + col[None, :, None]


def convert_tile(luma: np.ndarray, chroma: np.ndarray,
                 variant: str) -> np.ndarray:
    """The operand's bytes (uint8) after the converter: ``luma`` [64, 128]
    and ``chroma`` [32, 128] uint8 samples as bf16 bits at
    :func:`operand_offsets`; spare bytes 0."""
    buf = np.zeros(OPERAND_BYTES, np.uint8)
    for plane, x in ((0, luma), (1, chroma)):
        off = operand_offsets(variant, plane)
        bits = bf16_bits(x.astype(np.float32))
        if plane:
            bits = np.repeat(bits[..., None], 2, axis=-1)
        buf[off] = (bits & 0xFF).astype(np.uint8)
        buf[off + 1] = (bits >> 8).astype(np.uint8)
    return buf


def k_steps(variant: str, span: int) -> List[Tuple[int, int, int]]:
    """The products of ``span``: (operand byte where the k-step's
    descriptor starts, B matrix index, first accumulator)."""
    base = 4 * span * OPERAND_LBO
    second = 2 * OPERAND_LBO
    if variant == "V1":
        return [(base, 0, 0), (base + second, 1, 0)]
    return [(base, 0, 0), (base + second, 0, 12)]


def thread_bytes() -> np.ndarray:
    """[128 threads, 2 row halves, 12] (accumulator index, tile row,
    byte of the span's 48) of each byte a thread stores: thread byte i of
    row half h is accumulator 4 (i // 2) + 2 h + i % 2, span byte 12 tq +
    i of row 16 warp + lane // 4 + 8 h, in both variants (V2's second
    group's 12 accumulators follow its first's)."""
    t = np.arange(128)[:, None, None]
    h = np.arange(2)[None, :, None]
    i = np.arange(12)[None, None, :]
    acc = 4 * (i // 2) + 2 * h + i % 2
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * h
    byte = 12 * (t % 4) + i
    return np.stack(np.broadcast_arrays(acc, row, byte), axis=-1)


def accumulator_columns(variant: str) -> np.ndarray:
    """[128 threads, 24] (product, row, column of that product's D) of
    each accumulator index: wgmma's fragment, d[4 j + 2 h + e] at row
    16 warp + lane // 4 + 8 h, column 8 j + 2 (lane % 4) + e; V2's
    accumulators 12-23 are its second group's."""
    t = np.arange(128)[:, None]
    a = np.arange(24)[None, :]
    n12 = 12 if variant == "V2" else 24
    prod, d = a // n12, a % n12
    j, h, e = d // 4, (d % 4) // 2, d % 2
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * h
    col = 8 * j + 2 * (t % 4) + e
    return np.stack(np.broadcast_arrays(prod, row, col), axis=-1)


def out_offsets(row, byte) -> np.ndarray:
    """Byte offset in the output tile of byte ``byte`` (0..383) of tile
    row ``row``: box byte // 128, its 16-byte chunk XORed with row mod 8
    (the output map's 128-byte swizzle)."""
    row, byte = np.asarray(row), np.asarray(byte)
    return ((byte // OUT_BOX) * BAND * OUT_BOX + row * OUT_BOX
            + ((byte % OUT_BOX) ^ ((row % 8) << 4)))


def staged_smem_bytes(variant: str) -> int:
    """Shared memory of one block: the ring, the output tile, the
    operand, B and the ring's barriers."""
    b_bytes = 2 * 16 * N[variant] * (2 if variant == "V1" else 1)
    return (SLOTS * (BAND + BAND // 2) * TILE_W + OUT_BYTES
            + OPERAND_BYTES + b_bytes + 8 * SLOTS)
