"""Host side of lab kernel ``prod_like`` (``csrc/nv12_prodlike.cu``): S2's
tensor-core block in the notebook's three modes — full, hpass (the H
chains alone) and wpass (no H chain) — at its strip heights. full at S2's
strip heights is S2 itself (``csrc/nv12_static2.cu``); the source runs
full at 4 rows, hpass and wpass.

The kernel reads S2's tables (``ops/banded.py`` ``static2_tables`` at
(tile, 8), ``static2_w_tables``) with three additions, built here:

- :func:`prodlike_b`: B_y and B_c in core-matrix order at wgmma's N
  (:func:`prodlike_n`), so that 4-row strips run N = 8 with B's columns
  4-7 zero;
- :func:`hpass_owners`: per output tile the frame columns its block stores
  in hpass, each column once, by the lowest tile whose chunks hold it;
- :func:`wpass_ring_rows`: the frame rows wpass's ring carries, as the
  kernel's ``row_of`` picks them.

:func:`prodlike_refusal` refuses what the kernel does not run before any
launch, on either device; :func:`prodlike_device` uploads one geometry's
launch arguments once.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.banded import (SMEM_LIMIT, STATIC2_CHUNK, STATIC2_STAGE_COLS,
                          STATIC2_STAGES, STATIC2_TILES, core_matrix_order,
                          static2_tables, static2_w_tables)
from ..ops.resize import LANCZOS_AA

#: the kernel's modes, as nv12_prodlike_launch numbers them
MODES = {"full": 0, "hpass": 1, "wpass": 2}
#: the strip heights each mode is compiled for (nv12_prodlike.cu)
PRODLIKE_TILES: Dict[str, Tuple[int, ...]] = {
    "full": (4,), "hpass": (16, 32), "wpass": (16, 32)}
#: the strip heights the lab runs each mode at: full also at S2's, on S2
PRODLIKE_STRIPS: Dict[str, Tuple[int, ...]] = {
    **PRODLIKE_TILES, "full": PRODLIKE_TILES["full"] + STATIC2_TILES}
#: the windows start on multiples of this many rows (the notebook's ALIGN)
PRODLIKE_ALIGN = 8
#: the lab's default strip height: S2's best on the card (PERF.md)
PRODLIKE_TILE = 16


def prodlike_n(tile: int) -> int:
    """wgmma's N for strips of ``tile`` rows: the strip height, or 8 for a
    4-row strip (wgmma has no N = 4)."""
    return max(tile, 8)


def prodlike_b(src_w: int, src_h: int, dst_w: int, dst_h: int,
               tile: int) -> np.ndarray:
    """[strips, (k_luma + k_chroma) N] float32 of bf16 values: per strip
    of ``tile`` rows S2's B_y then B_c (``static2_tables`` at (tile, 8))
    widened with zero columns to N = :func:`prodlike_n`, each in wgmma's
    K-major core-matrix order."""
    t = static2_tables(src_w, src_h, dst_w, dst_h, LANCZOS_AA, tile,
                       PRODLIKE_ALIGN)
    n = prodlike_n(tile)
    parts = []
    for m in (t.luma, t.chroma):
        wide = np.zeros((m.shape[0], n, m.shape[2]), np.float32)
        wide[:, :tile] = m
        parts.append(core_matrix_order(wide))
    return np.concatenate(parts, axis=1)


@functools.lru_cache(maxsize=16)
def hpass_owners(src_w: int, src_h: int, dst_w: int,
                 dst_h: int) -> np.ndarray:
    """[tiles, 2] int32: per output tile of 64 columns the frame columns
    [lo, hi) its hpass block stores. Column p < dst_w belongs to the
    lowest tile whose chunks (``static2_w_tables``: STATIC2_CHUNK bytes
    each from x0) hold it; a tile that holds none stores none (0, 0).
    Raises ValueError where a column lies in no tile's chunks, or a tile's
    columns do not form one range."""
    heads = static2_w_tables(src_w, src_h, dst_w, dst_h, LANCZOS_AA).heads
    x0 = heads[:, 1].astype(np.int64)
    end = x0 + STATIC2_CHUNK * heads[:, 2]
    p = np.arange(dst_w)
    holds = (x0[:, None] <= p) & (p < end[:, None])     # [tiles, dst_w]
    if not holds.any(axis=0).all():
        missing = p[~holds.any(axis=0)]
        raise ValueError(f"prod_like's hpass keeps frame columns 0 .. "
                         f"{dst_w - 1}, but no tile's chunks hold column "
                         f"{int(missing[0])}")
    owner = holds.argmax(axis=0)
    own = np.zeros((len(heads), 2), np.int32)
    for t in range(len(heads)):
        cols = p[owner == t]
        if len(cols):
            if cols[-1] - cols[0] + 1 != len(cols):
                raise ValueError(f"hpass: tile {t}'s columns are not one "
                                 f"range")
            own[t] = (cols[0], cols[-1] + 1)
    return own


def wpass_ring_rows(tile: int, o0: int, dst_h: int,
                    buf_rows: int) -> np.ndarray:
    """The 2 ``tile`` buffer rows wpass's ring carries for the strip whose
    first output row is ``o0``: rows o0 .. o0 + tile - 1 (the luma H rows'
    stand-in), then buf_rows - dst_h + o0 .. (the chroma's), each clamped
    to the buffer's last row (rows past dst_h are read, never stored)."""
    k = np.arange(2 * tile)
    rows = np.where(k < tile, o0 + k, buf_rows - dst_h + o0 + k - tile)
    return np.minimum(rows, buf_rows - 1)


def prodlike_smem_bytes(mode: str, tile: int, k_luma: int,
                        k_chroma: int) -> int:
    """Shared memory of one block (static2_passes.cuh smem_bytes): S2's
    ring of the stacked window rows (or the traded W sums, the larger) at
    N = :func:`prodlike_n`; B_y and B_c, which wpass does not read (its
    ring holds 2 ``tile`` frame rows); the two warpgroups' H rows of a
    chunk, which hpass does not keep."""
    n = prodlike_n(tile)
    kst = 2 * tile if mode == "wpass" else k_luma + k_chroma
    ring = max(STATIC2_STAGES * kst * STATIC2_STAGE_COLS,
               4 * (n // 2 + n) * 128)
    b = 0 if mode == "wpass" else 2 * kst * n
    chunk = 0 if mode == "hpass" else 8 * (16 * n + 16) + 4 * (32 * n + 16)
    return ring + b + 2 * chunk


def prodlike_refusal(src_w: int, src_h: int, dst_w: int, dst_h: int,
                     mode: str, tile: int) -> str:
    """Why the lab cannot run ``mode`` at strips of ``tile`` rows on this
    geometry, or "" when it can: a block's shared memory over a block's
    (64-row strips at 1080p -> 224), a strip height the mode does not
    run (:data:`PRODLIKE_STRIPS`), or (hpass) a column no tile holds."""
    t = static2_tables(src_w, src_h, dst_w, dst_h, LANCZOS_AA, tile,
                       PRODLIKE_ALIGN)
    smem = prodlike_smem_bytes(mode, tile, t.k_luma, t.k_chroma)
    if smem > SMEM_LIMIT:
        return (f"prod_like's ring, weights and H rows at {tile}-row strips "
                f"need {smem} B of shared memory, over a block's "
                f"{SMEM_LIMIT} B")
    if tile not in PRODLIKE_STRIPS[mode]:
        return (f"prod_like's tensor-core kernels run {mode} on strips of "
                f"{', '.join(map(str, PRODLIKE_STRIPS[mode]))} rows, got "
                f"{tile}")
    if mode == "hpass":
        try:
            hpass_owners(src_w, src_h, dst_w, dst_h)
        except ValueError as e:
            return str(e)
    return ""


@functools.lru_cache(maxsize=32)
def prodlike_device(src_w: int, src_h: int, dst_w: int, dst_h: int,
                    mode: str, tile: int, device: torch.device):
    """``nv12_prodlike_launch``'s arguments after the tile on ``device``,
    uploaded once per geometry, mode and strip height: B (bf16, :func:`prodlike_b`) and
    the window starts (0 in wpass), K of each window (``tile`` in wpass),
    S2's W heads and bf16 fragments, and (hpass; else 0) the owned
    columns; with the tensors they point into."""
    geo = (src_w, src_h, dst_w, dst_h)
    wt = static2_w_tables(*geo, LANCZOS_AA)
    keep = [torch.from_numpy(wt.heads).to(device),
            torch.from_numpy(wt.frags).to(device, torch.bfloat16)]
    b = starts = owned = 0
    ky = kc = tile
    if mode != "wpass":
        t = static2_tables(*geo, LANCZOS_AA, tile, PRODLIKE_ALIGN)
        keep += [torch.from_numpy(prodlike_b(*geo, tile)).to(
                     device, torch.bfloat16),
                 torch.from_numpy(t.starts).to(device)]
        b, starts = keep[2].data_ptr(), keep[3].data_ptr()
        ky, kc = t.k_luma, t.k_chroma
    if mode == "hpass":
        keep.append(torch.from_numpy(hpass_owners(*geo)).to(device))
        owned = keep[-1].data_ptr()
    args = (b, starts, ky, kc, keep[0].data_ptr(), keep[1].data_ptr(), owned)
    return args, tuple(keep)
