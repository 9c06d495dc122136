"""Host tables and layout of the product kernel ``nv12_to_rgb``
(``csrc/nv12_to_rgb.cu`` over ``csrc/convert_staged.cuh``, host side
``ops/nv12_to_rgb.py``) on the CPU: the persistent blocks' tile walk, a
numpy walk of both routes (the bf16 one through the B it uploads, the
operand, the products read through their descriptors and the epilogue's
stores; the f32 one through channel()'s float32 arithmetic and its
16-byte stores) into the swizzled output tile, boxes clipped to the frame,
against ``nv12_to_rgb_plain`` bit for bit at every supported colour
space, range and swap, and against the JAX package's Pallas kernel in
interpret mode; the device tables; and the routing rule (which geometries
take the per-pixel kernel)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vali_tpu.core.enums import ColorRange as JRange
from vali_tpu.core.enums import ColorSpace as JSpace
from vali_tpu.ops.pallas_fused import pallas_nv12_to_rgb
from vali_tpu_torch.core.enums import ColorRange, ColorSpace
from vali_tpu_torch.lab import convert_staged as cs
from vali_tpu_torch.lab.staged import bf16_values, descriptor_read
from vali_tpu_torch.ops import _cuda_build
from vali_tpu_torch.ops import nv12_to_rgb as n2r
from vali_tpu_torch.ops.nv12_to_rgb import (b_image, coefficients,
                                            device_table, nv12_to_rgb,
                                            nv12_to_rgb_plain, staged_route,
                                            table)
from vali_tpu_torch.utils.tracing import counters

SPACES = [(ColorSpace.BT_709, ColorRange.MPEG),
          (ColorSpace.BT_709, ColorRange.JPEG),
          (ColorSpace.BT_601, ColorRange.MPEG),
          (ColorSpace.BT_601, ColorRange.JPEG)]
BAND, TILE_W = 64, 128


def tile_of(t: int, bands: int, tiles_w: int):
    """(column tile, band, frame) of tile t, as the kernel decodes it."""
    per_frame = bands * tiles_w
    z, r = divmod(t, per_frame)
    band, col = divmod(r, tiles_w)
    return col, band, z


def block_tiles(block: int, grid: int, tiles: int):
    """The tiles block ``block`` of ``grid`` persistent blocks walks:
    block, block + grid, ... below tiles (n = ceil((tiles - block) /
    grid))."""
    n = (tiles - block + grid - 1) // grid
    return [block + i * grid for i in range(n)]


@pytest.mark.parametrize("batch,h,w,resident", [
    (64, 1080, 1920, 264), (1, 1080, 1920, 264), (3, 150, 336, 264),
    (2, 1080, 144, 7)])
def test_persistent_walk_takes_each_tile_once(batch, h, w, resident):
    """min(tiles, resident) blocks; each tile taken by exactly one block,
    the blocks' i-th tiles side by side (consecutive tile numbers); at N =
    1 1080p 17 bands x 15 tiles = 255 tiles, one a block."""
    bands, tiles_w = -(-h // BAND), -(-w // TILE_W)
    tiles = batch * bands * tiles_w
    grid = min(tiles, resident)
    seen = np.zeros(tiles, np.int64)
    for k in range(grid):
        walk = block_tiles(k, grid, tiles)
        assert walk and walk[0] == k
        np.add.at(seen, walk, 1)
    assert (seen == 1).all()
    cells = {tile_of(t, bands, tiles_w) for t in range(tiles)}
    assert len(cells) == tiles
    assert {c[2] for c in cells} == set(range(batch))
    if (batch, h, w) == (1, 1080, 1920):
        assert (bands, tiles_w, tiles, grid) == (17, 15, 255, 255)


def _boxes(buf, rows_avail, h, z, col, band):
    """A tile's three load boxes as TMA lands them (zero past the width or
    the buffer's rows): luma [64, 128] and chroma [32, 128]."""
    batch, rows, w = buf.shape
    pad = np.zeros((rows + 2 * BAND + h, w + TILE_W), np.uint8)
    pad[:rows_avail, :w] = buf[z, :rows_avail]
    x0, y0 = col * TILE_W, band * BAND
    luma = pad[y0:y0 + BAND, x0:x0 + TILE_W]
    crow = h + band * (BAND // 2)
    chroma = pad[crow:crow + BAND // 2, x0:x0 + TILE_W]
    return luma, chroma


def _b_read(bits: np.ndarray, n: int) -> np.ndarray:
    """[16, n] float32 that a K-major descriptor (leading byte offset 128,
    stride 256) reads from one B image's uint16 bits."""
    k = np.arange(16)[:, None]
    c = np.arange(n)[None, :]
    byte = (c // 8) * 256 + (k // 8) * 128 + (c % 8) * 16 + (k % 8) * 2
    return bf16_values(bits[byte // 2])


def _bf16_tile(luma, chroma, bs, off):
    """The bf16 route's output tile (uint8 [OUT_BYTES]): the operand, each
    span's two products through their descriptors (exact in float32), the
    epilogue's bytes at their swizzled offsets, each stored once."""
    acc_at = cs.accumulator_columns("V1")
    tb = cs.thread_bytes()
    chan = np.arange(12) % 3
    op = cs.convert_tile(luma, chroma, "V1")
    tile = np.zeros(cs.OUT_BYTES, np.uint8)
    stores = np.zeros(cs.OUT_BYTES, np.int64)
    for sp in range(TILE_W // cs.SPAN):
        d = np.zeros((64, 48))
        for start, b, _ in cs.k_steps("V1", sp):
            a = bf16_values(descriptor_read(
                op, start, cs.OPERAND_LBO, cs.OPERAND_SBO,
                mn_major=False)).astype(np.float64)
            d += a @ bs[b]
        acc = d[acc_at[..., 1], acc_at[..., 2]]
        assert np.array_equal(acc, acc.astype(np.float32))
        vals = np.take_along_axis(acc, tb[..., 0].reshape(128, -1),
                                  axis=1).reshape(128, 2, 12).astype(
                                      np.float32)
        q = np.rint(np.clip(vals + off[chan], 0.0, 255.0)).astype(np.uint8)
        o = cs.out_offsets(tb[..., 1], 48 * sp + tb[..., 2])
        tile[o] = q
        np.add.at(stores, o, 1)
    assert (stores == 1).all()
    return tile


def _f32_tile(luma, chroma, k):
    """The f32 route's output tile: item (row m, span s) of thread m + 64 s
    mod 128, channel() of its 16 pixels in float32 (products, the chroma
    sum, then the luma term and the offset; round, clip), its 48 bytes as
    three 16-byte words at their swizzled offsets, each stored once."""
    tile = np.zeros(cs.OUT_BYTES, np.uint8)
    stores = np.zeros(cs.OUT_BYTES, np.int64)
    m = np.float32(k[:9]).reshape(3, 3)
    off = np.float32(k[9:])
    for idx in range(BAND * TILE_W // 16):
        row, s = idx % 64, idx // 64
        y = luma[row, 16 * s:16 * s + 16].astype(np.float32)
        c = chroma[row // 2, 16 * s:16 * s + 16].astype(np.float32)
        u, v = np.repeat(c[0::2], 2), np.repeat(c[1::2], 2)
        out = np.zeros((16, 3), np.uint8)
        for ch in range(3):
            x = (y * m[ch, 0] + (u * m[ch, 1] + v * m[ch, 2])) + off[ch]
            out[:, ch] = np.clip(np.rint(x), 0, 255)
        flat = out.reshape(-1)
        for j in range(3):
            o = cs.out_offsets(row, 48 * s + 16 * j)
            assert o % 16 == 0
            tile[o:o + 16] = flat[16 * j:16 * j + 16]
            stores[o:o + 16] += 1
    assert (stores == 1).all()
    return tile


def product_walk(buf: np.ndarray, rows_avail: int, h: int, w: int, space,
                 crange, swap: bool, f32: bool) -> np.ndarray:
    """The product kernel's output [B, h, 3w] replayed in numpy from the
    tables the wrapper uploads (:func:`~ops.nv12_to_rgb.table`): every
    tile's boxes, its route's output tile, and the tile's three store
    boxes (x = 384 col + 128 b, skipped at or past the row's 3w bytes,
    rows clipped to h)."""
    batch = buf.shape[0]
    k = coefficients(space, crange, swap,
                     torch.float32 if f32 else torch.bfloat16)
    tab = table(space, crange, swap,
                torch.float32 if f32 else torch.bfloat16).numpy()
    if not f32:
        bits = tab.view(np.uint16)
        bs = [_b_read(bits[j:j + 16 * 48], 48) for j in (0, 16 * 48)]
    else:
        assert np.array_equal(tab, k[:9])
    bands, tiles_w = -(-h // BAND), -(-w // TILE_W)
    out = np.zeros((batch, h, 3 * w), np.uint8)
    rr, bb = np.arange(64)[:, None], np.arange(384)[None, :]
    for t in range(batch * bands * tiles_w):
        col, band, z = tile_of(t, bands, tiles_w)
        luma, chroma = _boxes(buf, rows_avail, h, z, col, band)
        tile = (_f32_tile(luma, chroma, k) if f32
                else _bf16_tile(luma, chroma, bs, k[9:]))
        full = tile[cs.out_offsets(rr, bb)]
        y0 = band * BAND
        for b in range(3):
            x = 384 * col + 128 * b
            if x >= 3 * w:
                continue
            nr, nc = min(64, h - y0), min(128, 3 * w - x)
            out[z, y0:y0 + nr, x:x + nc] = full[:nr, 128 * b:128 * b + nc]
    return out


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("swap", [False, True], ids=["rgb", "bgr"])
@pytest.mark.parametrize("space,crange", SPACES)
def test_walk_equals_the_plain_version(space, crange, swap, f32):
    """Both routes at every space, range and swap, on frames of a width
    that is not a multiple of 128 (the last column tile half past the
    frame) and a height that leaves a short last band, from a buffer with
    rows past H*3/2."""
    b, w, h, rows = 2, 144, 150, 240
    frames = np.random.default_rng(w + h + int(swap)).integers(
        0, 256, (b, rows, w), dtype=np.uint8)
    got = product_walk(frames, rows, h, w, space, crange, swap, f32)
    want = nv12_to_rgb_plain(
        torch.from_numpy(frames), src_w=w, src_h=h, space=space,
        crange=crange, swap=swap,
        compute_dtype=torch.float32 if f32 else None).numpy()
    assert np.array_equal(got, want)


def test_walk_at_a_frame_of_whole_tiles_equals_the_jax_kernel():
    """The bf16 route's walk (BGR, BT.601 JPEG, 2 x 256x128: whole tiles)
    against the JAX package's Pallas kernel in interpret mode, bit for
    bit."""
    b, w, h = 2, 256, 128
    frames = np.random.default_rng(5).integers(
        0, 256, (b, h * 3 // 2, w), dtype=np.uint8)
    got = product_walk(frames, h * 3 // 2, h, w, ColorSpace.BT_601,
                       ColorRange.JPEG, True, False)
    want = pallas_nv12_to_rgb(jnp.asarray(frames), src_w=w, src_h=h,
                              space=JSpace.BT_601, crange=JRange.JPEG,
                              swap=True, interpret=True)
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("swap", [False, True], ids=["rgb", "bgr"])
@pytest.mark.parametrize("space,crange", SPACES)
def test_tables_hold_the_swapped_coefficients(space, crange, swap):
    """bf16: V1's Ag16 / Bg16 of the bf16 coefficients with rows in output
    order, columns in accumulator order; read back through B's descriptor
    they put channel c of pixel p's luma and chroma at the accumulator
    column whose output byte is 3 p + c. f32: the nine f32 coefficients,
    BGR's rows swapped. Both cached per device."""
    m = coefficients(space, crange, swap, torch.bfloat16)[:9].reshape(3, 3)
    bits = table(space, crange, swap, torch.bfloat16).numpy().view(
        np.uint16)
    assert np.array_equal(bits, b_image(space, crange, "V1", swap))
    ag, bg = (_b_read(bits[j:j + 768], 48) for j in (0, 768))
    byte = n2r.column_map(48)
    p, c = byte // 3, byte % 3
    for col in range(48):
        want_a = np.zeros(16, np.float32)
        want_a[p[col]] = m[c[col], 0]
        want_b = np.zeros(16, np.float32)
        want_b[2 * (p[col] // 2)] = m[c[col], 1]
        want_b[2 * (p[col] // 2) + 1] = m[c[col], 2]
        assert np.array_equal(ag[:, col], want_a)
        assert np.array_equal(bg[:, col], want_b)
    f = table(space, crange, swap, torch.float32).numpy()
    mo = coefficients(space, crange, False, torch.float32)[:9].reshape(3, 3)
    assert np.array_equal(f.reshape(3, 3), mo[::-1] if swap else mo)
    cpu = torch.device("cpu")
    for cdt in (torch.bfloat16, torch.float32):
        t = device_table(space, crange, swap, cdt, cpu)
        assert t is device_table(space, crange, swap, cdt, cpu)
        assert torch.equal(t, table(space, crange, swap, cdt))


def test_coefficients_are_built_once_and_read_only():
    k = coefficients(ColorSpace.BT_709, ColorRange.MPEG, True,
                     torch.bfloat16)
    assert k is coefficients(ColorSpace.BT_709, ColorRange.MPEG, True,
                             torch.bfloat16)
    with pytest.raises(ValueError):
        k[0] = 0.0


def _view(batch, rows, w, pitch, off=0, extra_batch_bytes=0):
    """A [batch, rows, w] uint8 view with the given row pitch, start
    offset and batch stride of rows * pitch + extra_batch_bytes."""
    bs = rows * pitch + extra_batch_bytes
    flat = torch.zeros(batch * bs + off + 64, dtype=torch.uint8)
    return torch.as_strided(flat, (batch, rows, w), (bs, pitch, 1), off)


@pytest.mark.parametrize("case,staged", [
    (dict(w=1920, pitch=1920), True),         # 1080p, packed
    (dict(w=144, pitch=144), True),           # width 144
    (dict(w=1920, pitch=1984), True),         # padded pitch
    (dict(w=1920, pitch=1920, extra_batch_bytes=4096), True),
    (dict(w=40, pitch=40), False),            # width not a multiple of 16
    (dict(w=1920, pitch=1921), False),        # odd pitch
    (dict(w=1920, pitch=1928), False),        # pitch not a multiple of 16
    (dict(w=1920, pitch=1984, off=1), False),  # unaligned start
    (dict(w=1920, pitch=1920, extra_batch_bytes=8), False),
])
def test_geometry_alone_picks_the_route(case, staged):
    """The staged TMA block where TMA can describe the buffer (width a
    multiple of 16, 16-byte aligned start, row and batch strides positive
    multiples of 16 bytes), else the per-pixel kernel; rows past H*3/2
    and a batch stride larger than the plane stay on the staged route."""
    case = dict(case)
    w = case.pop("w")
    x = _view(2, 1620 + 8, w, **case)
    assert staged_route(x, w) == staged


def test_route_query_prototype_matches_its_signature():
    """The product library's queries (``_cuda_build._QUERIES``) follow
    their C prototypes, as the launchers do."""
    import ctypes

    text = open(os.path.join(_cuda_build._PKG_DIR,
                             "csrc/nv12_to_rgb.cu")).read()
    for name, argtypes in _cuda_build._QUERIES.items():
        params = re.search(r"int %s\(([^)]*)\)" % name, text).group(1)
        want = ["ptr" if "*" in p else "ll" if "long long" in p else "int"
                for p in params.split(",")]
        got = ["ll" if t is ctypes.c_longlong else
               "int" if t is ctypes.c_int else "ptr" for t in argtypes]
        assert got == want, name
    assert "nv12_to_rgb_launch" in _cuda_build._SIGNATURES


def test_header_is_part_of_the_build_key():
    """Both libraries rebuild when the shared block changes."""
    assert "csrc/convert_staged.cuh" in _cuda_build._HEADERS
    for src in ("nv12_to_rgb.cu", "nv12_convert_staged.cu"):
        text = open(os.path.join(_cuda_build._PKG_DIR, "csrc", src)).read()
        assert '#include "convert_staged.cuh"' in text


def test_cpu_route_is_the_plain_version_and_counts_no_launch():
    b, w, h = 2, 40, 32
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (b, h * 3 // 2, w), dtype=np.uint8))
    before = counters().get("launches.nv12_to_rgb", 0)
    for kw in ({}, {"compute_dtype": torch.float32, "swap": True}):
        assert torch.equal(nv12_to_rgb(x, src_w=w, src_h=h, **kw),
                           nv12_to_rgb_plain(x, src_w=w, src_h=h, **kw))
    assert counters().get("launches.nv12_to_rgb", 0) == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        nv12_to_rgb(x.to("meta"), src_w=w, src_h=h)
