"""Host side of lab kernels ``static_kernel`` (S, Slong) and
``transposed_chroma`` (T) (``csrc/nv12_chains.cu``): S2's tensor-core
block with its H chains' cast chain or its chroma H rows' layout changed.

The kernels read S2's tables at (tile, 8) (``ops/banded.py``
``static2_tables``, ``static2_w_tables``), the TPU's windows at its
TILE = 32, ALIGN = 8, and at S2's best strip, 16 rows. This module holds
what the kernels add to S2's block, as numpy models that the CPU tests
hold to the kernel's own arithmetic and addresses:

- :func:`chain_bits` / :func:`chain_word`: the three cast chains of a ring
  byte into a bf16 element of A (``wgmma_common.cuh`` ``Chain``) and the
  32-bit word two of them make;
- :func:`tchroma_store_offset`, :func:`tchroma_row`:
  where T's chroma chain stores each thread's sums (the chroma W operand
  MN-major) and which accumulator column of the chroma W product holds
  U or V of which strip row;
- :func:`operand_offset` / :func:`operand_image`: the byte of element
  (k, n) of a B operand that ``wgmma`` reads through a descriptor without
  swizzle, K-major or MN-major, and the image that places a matrix there
  (the card probe ``nv12_chains_probe_launch``).

:func:`chains_refusal` refuses what the kernels do not run before any
launch, on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.banded import STATIC2_TILES, static2_refusal
from ..ops.resize import LANCZOS_AA

#: the strip heights nv12_chains.cu is compiled for: the TPU's tile and
#: S2's best on the card
CHAINS_TILES = (16, 32)
#: the windows start on multiples of this many rows (the notebook's ALIGN)
CHAINS_ALIGN = 8
#: the strip height of the lab names without a number (the TPU's tile)
CHAINS_TILE = 32
#: the cast chains, as wgmma_common.cuh numbers them
CHAINS = {"magic": 0, "short": 1, "long": 2}
#: the chroma layouts of static2_passes.cuh
CLAYOUTS = {"split": 0, "transposed": 1}


def chains_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                   tile: int) -> str:
    """Why nv12_chains.cu cannot take this geometry and strip height, or
    "" when it can: a strip height it is not compiled for, or S2's refusal
    at (tile, 8)."""
    if tile in STATIC2_TILES and tile not in CHAINS_TILES:
        return (f"static_kernel and transposed_chroma run strips of "
                f"{' and '.join(map(str, CHAINS_TILES))} rows, got "
                f"tile={tile}")
    return static2_refusal(src_w, src_h, dst_w, dst_h, LANCZOS_AA, tile,
                           CHAINS_ALIGN)


def _bits(t: torch.Tensor) -> np.ndarray:
    """uint16 bits of a bf16 tensor."""
    return t.view(torch.int16).numpy().view(np.uint16)


def chain_bits(x: np.ndarray, chain: str) -> np.ndarray:
    """uint16 bf16 bits of uint8 ``x`` cast by ``chain``: "magic" (2^23 +
    x less 2^23 in float32, then rounded to bf16), "short" (u8 -> i32 ->
    bf16) or "long" (u8 -> i32 -> f32 -> bf16)."""
    i = torch.from_numpy(np.asarray(x, np.uint8).astype(np.int32))
    if chain == "magic":
        big = torch.tensor(8388608.0, dtype=torch.float32)
        return _bits(((big + i.float()) - big).to(torch.bfloat16))
    if chain == "short":
        return _bits(i.to(torch.bfloat16))
    if chain == "long":
        return _bits(i.to(torch.float32).to(torch.bfloat16))
    raise ValueError(f"chain must be one of {tuple(CHAINS)}, got {chain!r}")


def chain_word(lo: np.ndarray, hi: np.ndarray, chain: str) -> np.ndarray:
    """uint32 words of the A fragment that ``pack_bytes`` builds: the bf16
    of byte ``lo`` in the low half, of ``hi`` in the high half."""
    return (chain_bits(lo, chain).astype(np.uint32)
            | chain_bits(hi, chain).astype(np.uint32) << 16)


def group_bytes(n: int) -> int:
    """Bytes of one group of 8 chroma pixels of a warpgroup's chroma H rows
    at strip height ``n`` (static2_passes.cuh kGroupC: 2 n rows of 16
    bytes, and 16 of padding)."""
    return 32 * n + 16


def tchroma_row(n):
    """(plane, row) of column ``n`` of T's chroma W operand (and of its
    accumulator D_uv): U (0) of rows 8 j .. 8 j + 7 at n = 16 j .., then V
    (1) of the same rows at n = 16 j + 8 ..."""
    n = np.asarray(n)
    return n // 8 % 2, 8 * (n // 16) + n % 8


def tchroma_store_offset(n: int, warp, lane, j, plane):
    """Byte offset, from a warpgroup's chroma H rows at strip height
    ``n``, of the 4-byte word in which T's chroma chain stores thread
    (warp, lane)'s ``plane`` sums of rows 8 j + 2 tq (+1) of its pixel 8
    warp + lane // 4 (static2_passes.cuh store_chroma_mn)."""
    warp, lane = np.asarray(warp), np.asarray(lane)
    c = 8 * warp + lane // 4
    return (c // 8 * group_bytes(n) + c % 8 * 16 + 4 * (lane % 4)
            + 256 * np.asarray(j) + 128 * np.asarray(plane))


def operand_offset(k, n, lbo: int, sbo: int, mn_major: bool):
    """Byte of element (k, n) of a wgmma B operand [16 K, N] read through a
    descriptor without swizzle: core matrices lbo bytes apart along K and
    sbo along N; in a core matrix 8 rows of 16 bytes, each 8 contiguous n
    of one k (MN-major) or 8 contiguous k of one n (K-major)."""
    k, n = np.asarray(k), np.asarray(n)
    inner = k % 8 * 16 + n % 8 * 2 if mn_major else n % 8 * 16 + k % 8 * 2
    return k // 8 * lbo + n // 8 * sbo + inner


def operand_image(bits: np.ndarray, lbo: int, sbo: int,
                  mn_major: bool) -> np.ndarray:
    """uint8 bytes, a multiple of 16, from which a descriptor at byte 0
    reads [16, N] uint16 bf16 ``bits`` as B; bytes no element takes are
    0."""
    k, n = np.meshgrid(np.arange(bits.shape[0]), np.arange(bits.shape[1]),
                       indexing="ij")
    off = operand_offset(k, n, lbo, sbo, mn_major)
    buf = np.zeros(-(-(int(off.max()) + 2) // 16) * 16, np.uint8)
    buf[off] = (bits & 0xFF).astype(np.uint8)
    buf[off + 1] = (bits >> 8).astype(np.uint8)
    return buf
