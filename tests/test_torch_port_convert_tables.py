"""Host tables and layout models of the convert lab's staged kernels V1
and V2 (``csrc/nv12_convert_staged.cu``, ``lab/convert_staged.py``) on the
CPU: the dense group matrices against the TPU notebook ``convert_lab.py``'s
``_group_mats``, and a numpy walk of what the kernel does with them (the
operand the converter writes, the B bytes it uploads, the products read
through their descriptors, the epilogue's bytes and its shared-memory
stores) against ``nv12_to_rgb_plain`` bit for bit.

The notebook builds a 64 x 1080p NV12 array when it is imported and keeps
its geometry in module globals (``H, W``), so it is imported once, in a
module fixture that sets them and restores them afterwards."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vali_tpu_torch.core.enums import ColorRange, ColorSpace  # noqa: E402
from vali_tpu_torch.lab import convert_lab as cl  # noqa: E402
from vali_tpu_torch.lab import convert_staged as cs  # noqa: E402
from vali_tpu_torch.lab.staged import (bf16_values,  # noqa: E402
                                       descriptor_read)
from vali_tpu_torch.lab.timing import (BF16_OPS_PER_S,  # noqa: E402
                                       bound_ms, convert_work)
from vali_tpu_torch.ops.nv12_to_rgb import (coefficients,  # noqa: E402
                                            nv12_to_rgb_plain)

H, W = 216, 256
SPACES = [(ColorSpace.BT_709, ColorRange.MPEG),
          (ColorSpace.BT_709, ColorRange.JPEG),
          (ColorSpace.BT_601, ColorRange.MPEG),
          (ColorSpace.BT_601, ColorRange.JPEG)]
#: the H100's shared memory a block may use, and an SM's (less 1 KB
#: reserved a block)
SMEM_LIMIT, SM_SMEM = 232448, 233472


@pytest.fixture(scope="module")
def nb():
    mod = importlib.import_module("convert_lab")
    saved = (mod.H, mod.W)
    mod.H, mod.W = H, W
    yield mod
    mod.H, mod.W = saved


@pytest.mark.parametrize("pixels", [16, 8])
def test_group_mats_equal_the_notebooks(nb, pixels):
    """With the notebook's coefficients the port's dense matrices are the
    notebook's ``_group_mats`` at the kernel's group widths."""
    m, _ = nb.colors.yuv2rgb_matrix(nb.SPACE, nb.CRANGE)
    ag, bg = cs.group_mats(m, pixels)
    nag, nbg, _ = nb._group_mats(pixels)
    assert np.array_equal(ag, nag) and np.array_equal(bg, nbg)


@pytest.mark.parametrize("variant", ["V1", "V2"])
def test_b_columns_are_the_dense_columns_permuted(variant):
    """B's columns are the dense group matrices' in accumulator order, and
    column_map is a permutation that gives thread tq the group's bytes
    N/4 tq .. N/4 tq + N/4 - 1."""
    n = cs.N[variant]
    cols = cs.column_map(n)
    assert sorted(cols) == list(range(n))
    tq = (np.arange(n) % 8) // 2
    assert np.array_equal(cols // (n // 4), tq)
    k = coefficients(ColorSpace.BT_709, ColorRange.MPEG, False,
                     torch.bfloat16)
    ag, bg = cs.group_mats(k[:9], cs.GROUP[variant])
    dense = [ag, bg] if variant == "V1" else [np.concatenate([ag, bg])]
    got = cs.b_matrices(ColorSpace.BT_709, ColorRange.MPEG, variant)
    assert all(np.array_equal(g, d[:, cols]) for g, d in zip(got, dense))


def _decode(off):
    """(A row, K block, element) of operand byte offsets."""
    mb, rem = off // cs.OPERAND_SBO, off % cs.OPERAND_SBO
    return 8 * mb + (rem % 128) // 16, rem // 128, (rem % 16) // 2


@pytest.mark.parametrize("variant", ["V1", "V2"])
def test_each_sample_lands_in_its_own_slot(variant):
    """Every (row, pixel, plane) of a tile lands in exactly one 2-byte slot
    of the operand (chroma row i twice: at A rows 2 i and 2 i + 1), inside
    its K blocks, every slot of the 32 K blocks x 64 rows taken once."""
    luma = cs.operand_offsets(variant, 0)
    chroma = cs.operand_offsets(variant, 1)
    every = np.concatenate([luma.ravel(), chroma.ravel()])
    assert (every % 2 == 0).all() and every.max() < cs.OPERAND_BYTES
    assert len(np.unique(every)) == every.size == 2 * 64 * 128
    m, kb, _ = _decode(luma)
    assert np.array_equal(m, np.broadcast_to(np.arange(64)[:, None],
                                             m.shape))
    mc, kc, _ = _decode(chroma)
    i = np.arange(32)[:, None, None]
    assert np.array_equal(mc, np.broadcast_to(2 * i + np.arange(2),
                                              mc.shape))
    # a span's luma and chroma fill its four K blocks, nothing else
    span = np.arange(128) // 16
    assert np.array_equal(kb // 4, np.broadcast_to(span, kb.shape))
    assert np.array_equal(kc // 4, np.broadcast_to(span[:, None], kc.shape))
    if variant == "V2":   # [luma 8 | chroma 8] of a group: one k-step
        x = np.arange(128) % 16
        group = (x % 4) // 2
        assert np.array_equal(kb[0] % 4, 2 * group)
        assert np.array_equal(kc[0, :, 0] % 4, 2 * group + 1)


def _b_read(bits: np.ndarray, n: int) -> np.ndarray:
    """[16, n] float32 that a K-major descriptor (leading byte offset 128,
    stride 256) reads from one B image's uint16 bits."""
    k = np.arange(16)[:, None]
    c = np.arange(n)[None, :]
    byte = (c // 8) * 256 + (k // 8) * 128 + (c % 8) * 16 + (k % 8) * 2
    return bf16_values(bits[byte // 2])


def staged_walk(frames: np.ndarray, h: int, w: int, space, crange,
                variant: str) -> np.ndarray:
    """The kernel's output [B, h, 3w] replayed in numpy: each tile's TMA
    boxes (zeros past the buffer), the converter's operand, each span's
    products read through their descriptors (float64: they must be exact
    in float32), the accumulators as wgmma's fragments hold them, the
    epilogue's float32 arithmetic, its stores into the swizzled output
    tile (each byte once), and the tile's TMA store clipped to the frame."""
    n = cs.N[variant]
    img = cs.b_image(space, crange, variant)
    layer = 16 * n
    bs = [_b_read(img[j:j + layer], n) for j in range(0, img.size, layer)]
    off = coefficients(space, crange, False, torch.bfloat16)[9:]
    acc_at = cs.accumulator_columns(variant)            # [128, 24, 3]
    tb = cs.thread_bytes()                              # [128, 2, 12, 3]
    chan = np.arange(12) % 3
    batch, rows, _ = frames.shape
    buf = np.zeros((batch, rows + 2 * cs.BAND, w + cs.TILE_W), np.uint8)
    buf[:, :rows, :w] = frames
    out = np.zeros((batch, h, 3 * w), np.uint8)
    rr, bb = np.arange(64)[:, None], np.arange(384)[None, :]
    for z in range(batch):
        for band in range(-(-h // cs.BAND)):
            for col in range(-(-w // cs.TILE_W)):
                x0, y0 = col * cs.TILE_W, band * cs.BAND
                luma = buf[z, y0:y0 + 64, x0:x0 + 128]
                chroma = buf[z, h + y0 // 2:h + y0 // 2 + 32, x0:x0 + 128]
                op = cs.convert_tile(luma, chroma, variant)
                tile = np.zeros(cs.OUT_BYTES, np.uint8)
                stores = np.zeros(cs.OUT_BYTES, np.int64)
                for sp in range(cs.TILE_W // cs.SPAN):
                    d = np.zeros((2, 64, n))
                    for start, b, a0 in cs.k_steps(variant, sp):
                        a = bf16_values(descriptor_read(
                            op, start, cs.OPERAND_LBO, cs.OPERAND_SBO,
                            mn_major=False)).astype(np.float64)
                        d[a0 // 12 if variant == "V2" else 0] += a @ bs[b]
                    acc = d[acc_at[..., 0], acc_at[..., 1], acc_at[..., 2]]
                    assert np.array_equal(acc, acc.astype(np.float32))
                    vals = np.take_along_axis(
                        acc, tb[..., 0].reshape(128, -1), axis=1).reshape(
                            128, 2, 12).astype(np.float32)
                    x = vals + off[chan]
                    q = np.rint(np.clip(x, 0.0, 255.0)).astype(np.uint8)
                    o = cs.out_offsets(tb[..., 1], 48 * sp + tb[..., 2])
                    tile[o] = q
                    np.add.at(stores, o, 1)
                assert (stores == 1).all()
                full = tile[cs.out_offsets(rr, bb)]
                nr, nc = min(64, h - y0), min(384, 3 * w - 384 * col)
                out[z, y0:y0 + nr, 384 * col:384 * col + nc] = full[:nr, :nc]
    return out


@pytest.mark.parametrize("space,crange", SPACES)
@pytest.mark.parametrize("geom", [(2, 256, 144), (2, 336, 150)])
@pytest.mark.parametrize("variant", ["V1", "V2"])
def test_walk_equals_the_plain_version(variant, geom, space, crange):
    b, w, h = geom
    frames = np.random.default_rng(w + h).integers(
        0, 256, (b, h * 3 // 2, w), dtype=np.uint8)
    got = staged_walk(frames, h, w, space, crange, variant)
    want = nv12_to_rgb_plain(torch.from_numpy(frames), src_w=w, src_h=h,
                             space=space, crange=crange).numpy()
    assert np.array_equal(got, want)


def test_epilogue_stores_fall_in_distinct_banks():
    """Each byte of the output tile is written once over a tile's spans,
    and one warp's 4-byte store (one span, row half and word) touches 32
    distinct banks."""
    tb = cs.thread_bytes()
    seen = np.zeros(cs.OUT_BYTES, np.int64)
    for sp in range(8):
        for hh in range(2):
            for k in range(3):
                row = tb[:, hh, 4 * k, 1]
                byte = 48 * sp + tb[:, hh, 4 * k, 2]
                word = cs.out_offsets(row, byte)
                assert (word % 4 == 0).all()
                for warp in range(4):
                    banks = (word[32 * warp:32 * warp + 32] // 4) % 32
                    assert len(np.unique(banks)) == 32
                for e in range(4):
                    np.add.at(seen, word + e, 1)
    assert (seen == 1).all()


def test_smem_fits_two_blocks_an_sm():
    for variant, want in (("V1", 97432), ("V2", 95128)):
        smem = cs.staged_smem_bytes(variant)
        assert smem == want and 2 * (smem + 1024) <= SM_SMEM
        assert smem <= SMEM_LIMIT


def test_work_counts_the_issued_flops():
    """V1 issues 192 FLOP a pixel of whole tiles, V2 96: at 64 x 1080p
    (17 bands of 64 rows) 0.026 and 0.013 ms, under the bytes' 0.178."""
    b, w, h = cl.CARD_SIZE
    rows = h * 3 // 2
    for variant, ms in (("V1", 0.0260), ("V2", 0.0130)):
        nbytes, ops = convert_work(b, w, h, rows, variant=variant)
        assert ops == b * 1088 * 1920 * cs.N[variant] * 4
        assert ops / BF16_OPS_PER_S * 1e3 == pytest.approx(ms, abs=1e-4)
        bound, by = bound_ms(*cl.case(variant, b, rows, w, h).work)
        assert by == "bytes" and bound == pytest.approx(0.178, abs=1e-3)
        assert nbytes == convert_work(b, w, h, rows)[0]


def test_wrapper_cpu_route_and_refusals():
    """The CPU route is the plain version and counts no launch; a bad
    variant, a non-uint8 buffer and a device other than CUDA or the CPU
    are refused before any launch; the B image is cached per device."""
    b, w, h = 2, 336, 150
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (b, h * 3 // 2, w), dtype=np.uint8))
    before = cl.convert_variant.launches
    for variant in cl.VARIANTS:
        got = cl.convert_variant(x, src_w=w, src_h=h, variant=variant,
                                 space=ColorSpace.BT_601,
                                 crange=ColorRange.JPEG)
        assert torch.equal(got, nv12_to_rgb_plain(
            x, src_w=w, src_h=h, space=ColorSpace.BT_601,
            crange=ColorRange.JPEG))
    with pytest.raises(ValueError, match="variant"):
        cl.convert_variant(x, src_w=w, src_h=h, variant="V3")
    with pytest.raises(ValueError, match="uint8"):
        cl.convert_variant(x.to(torch.int16), src_w=w, src_h=h)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cl.convert_variant(x.to("meta"), src_w=w, src_h=h)
    assert cl.convert_variant.launches == before
    cpu = torch.device("cpu")
    img = cs.staged_device(ColorSpace.BT_709, ColorRange.MPEG, "V1", cpu)
    assert img is cs.staged_device(ColorSpace.BT_709, ColorRange.MPEG,
                                   "V1", cpu)
    assert img.numel() * 2 == 2 * 16 * 48 * 2
    assert cs.staged_device(ColorSpace.BT_709, ColorRange.MPEG, "V2",
                            cpu).numel() * 2 == 16 * 24 * 2
