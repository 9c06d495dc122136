"""The NV12 lab's S, Slong and T (``csrc/nv12_chains.cu``: S2's
tensor-core block with the TPU's cast chains, or with the chroma H rows
kept interleaved and read MN-major) on the CPU: the three cast chains give
equal bf16 bits on every byte; a numpy model of T's chroma stores and of
``wgmma``'s MN-major read puts every sum once, 4-byte aligned and
bank-conflict free, where the chroma W product reads it, in the
accumulator rows of the thread's luma sums; a walk of S2's block with T's
layout gives ``static_kernel2_plain``'s bits; the wrappers' CPU routes and
refusals."""

import os
import re

import numpy as np
import pytest
import torch

from vali_tpu_torch.core.enums import ColorRange, ColorSpace
from vali_tpu_torch.lab import chains
from vali_tpu_torch.lab import kernel_variants as kv
from vali_tpu_torch.ops import banded
from vali_tpu_torch.ops.nv12_preprocess import nv12_preprocess_plain
from vali_tpu_torch.ops.resize import LANCZOS_AA

#: (src_w, src_h, dst_w, dst_h): the lab's, then the card tests' shapes
#: (tests/test_torch_port_static2_tables.py)
GEOMETRIES = [(1920, 1080, 224, 224), (162, 90, 50, 20), (130, 62, 34, 30),
              (256, 96, 48, 40), (256, 144, 96, 64), (256, 96, 32, 32)]
TILES = chains.CHAINS_TILES


# --- the cast chains ---------------------------------------------------------

@pytest.mark.parametrize("chain", list(chains.CHAINS))
def test_every_byte_is_exact_in_bf16_by_each_chain(chain):
    """All 256 byte values through each chain (S2's magic add, the TPU's
    short u8 -> i32 -> bf16 and long u8 -> i32 -> f32 -> bf16) give the
    bf16 bits of the byte's exact value: the three chains build equal A
    registers."""
    x = np.arange(256, dtype=np.uint8)
    want = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    got = chains.chain_bits(x, chain)
    assert np.array_equal(got, want.view(torch.int16).numpy().view(
        np.uint16))
    assert np.array_equal(got, chains.chain_bits(x, "magic"))
    # back to float: the byte itself
    f = (got.astype(np.uint32) << 16).view(np.float32)
    assert np.array_equal(f, x.astype(np.float32))


def test_chain_words_are_equal_on_every_byte_pair():
    """The 32-bit A word of every (low, high) byte pair (pack_bytes: the
    low byte's bf16 in the low half, as prmt 0x5410 and cvt.rn.bf16x2.f32
    place it) is the same in the three chains."""
    lo, hi = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8), indexing="ij")
    words = [chains.chain_word(lo, hi, c) for c in chains.CHAINS]
    for w in words[1:]:
        assert np.array_equal(w, words[0])
    assert np.array_equal(words[0] & 0xFFFF, chains.chain_bits(lo, "long"))
    assert np.array_equal(words[0] >> 16, chains.chain_bits(hi, "short"))
    with pytest.raises(ValueError, match="chain"):
        chains.chain_bits(lo, "medium")


# --- T's chroma layout ------------------------------------------------------

def _threads(n):
    """Every (warp, lane, j, plane) of a warpgroup's chroma stores at strip
    height ``n``, as broadcast arrays."""
    return np.meshgrid(np.arange(4), np.arange(32), np.arange(n // 8),
                       np.arange(2), indexing="ij")


@pytest.mark.parametrize("n", TILES)
def test_t_stores_each_sum_once_where_the_w_pass_reads_it(n):
    """T's stores at N = 16 and 32: each thread's two 4-byte words of each
    row group (U, then V of rows 8 j + 2 tq (+1) of its pixel) are 4-byte
    aligned; every (pixel, U / V, row) of the chunk's 32 pixels and N rows
    is stored exactly once; and wgmma's MN-major read of each k-step (the
    descriptor of S2's chroma W pass: K groups kGroupC bytes apart, N
    groups 128) finds at (k, n) the sum of pixel 16 i + k, plane and row
    tchroma_row(n)."""
    warp, lane, j, plane = _threads(n)
    off = chains.tchroma_store_offset(n, warp, lane, j, plane)
    assert (off % 4 == 0).all()
    pixel = 8 * warp + lane // 4
    stored = {}
    for e in range(2):
        row = 8 * j + 2 * (lane % 4) + e
        for a, key in zip((off + 2 * e).ravel(),
                          zip(pixel.ravel(), plane.ravel(), row.ravel())):
            assert key not in stored.values()
            assert a not in stored
            stored[int(a)] = tuple(int(v) for v in key)
    assert len(stored) == 32 * 2 * n
    g = chains.group_bytes(n)
    assert max(stored) < 4 * g
    for i in range(2):   # the chunk's two chroma k-steps
        k, nn = np.meshgrid(np.arange(16), np.arange(2 * n), indexing="ij")
        addr = 2 * i * g + chains.operand_offset(k, nn, g, 128, True)
        p, r = chains.tchroma_row(nn)
        for a, kk, pp, rr in zip(addr.ravel(), k.ravel(), p.ravel(),
                                 r.ravel()):
            assert stored[int(a)] == (16 * i + kk, pp, rr)


@pytest.mark.parametrize("n", TILES)
def test_t_warp_stores_hit_32_banks(n):
    """For one j, a warp's U stores fill one 128-byte core matrix (its 8
    pixels as K rows, 16 bytes each) and its V stores the next: 32
    distinct banks each, where S2's split layout takes four 2-byte stores
    a thread."""
    for warp in range(4):
        for j in range(n // 8):
            for plane in range(2):
                off = chains.tchroma_store_offset(n, warp, np.arange(32), j,
                                                  plane)
                banks = off // 4 % 32
                assert len(set(banks.tolist())) == 32
                assert off.max() - off.min() == 124
                assert off.min() % 128 == (warp * chains.group_bytes(n)) % 128


def _d_frag(w, g, t, i):
    """(row m, column n) of accumulator i of thread (warp w, lane 4 g + t)
    in wgmma's fp32 D layout."""
    return 16 * w + g + 8 * (i % 4 // 2), 8 * (i // 4) + 2 * t + i % 2


@pytest.mark.parametrize("n", TILES)
def test_t_accumulators_hold_the_rows_of_the_luma_sums(n):
    """Each thread's D_uv accumulators 8 j + e (U) and 8 j + 4 + e (V), the
    indices T's epilogue takes, lie in the output column and strip row of
    its luma accumulator 4 j + e: the CSC epilogue changes only
    compile-time indices."""
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for j in range(n // 8):
                for e in range(4):
                    m, row = _d_frag(w, g, t, 4 * j + e)
                    for idx, plane in ((8 * j + e, 0), (8 * j + 4 + e, 1)):
                        mu, nu = _d_frag(w, g, t, idx)
                        assert mu == m
                        assert tuple(chains.tchroma_row(nu)) == (plane, row)
                    assert row == 8 * j + 2 * t + (e & 1)


@pytest.mark.parametrize("n", TILES)
def test_t_n_order_holds_each_plane_row_once(n):
    """The 2 N columns of T's chroma operand hold U and V of each of the N
    strip rows once, U and V of rows 8 j .. 8 j + 7 in 16 columns from 16
    j."""
    plane, row = chains.tchroma_row(np.arange(2 * n))
    assert set(zip(plane.tolist(), row.tolist())) == {
        (p, r) for p in range(2) for r in range(n)}
    assert (row // 8 == np.arange(2 * n) // 16).all()


@pytest.mark.parametrize("n,mn", [(32, True), (64, True), (32, False),
                                  (64, False)])
def test_probe_operand_image_reads_back(n, mn):
    """The card probe's B image (T's chroma W operand at 16- and 32-row
    strips: N = 32, 64, leading byte offset kGroupC, stride 128) reads
    back through the descriptor's addresses as the matrix, and fits the
    probe's 256 words."""
    bits = np.random.default_rng(n).integers(0, 1 << 16, (16, n)).astype(
        np.uint16)
    lbo = chains.group_bytes(n // 2)
    img = chains.operand_image(bits, lbo, 128, mn)
    assert img.size % 16 == 0 and img.size // 16 <= 256
    k, nn = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    off = chains.operand_offset(k, nn, lbo, 128, mn)
    back = img[off].astype(np.uint16) | img[off + 1].astype(np.uint16) << 8
    assert np.array_equal(back, bits)


# --- a walk of S2's block with T's layout ------------------------------------

def _t_walk(nv12, geo, tile):
    """S2's block at (tile, 8) with T's chroma layout: per strip, output
    tile and chunk, the chroma chain's bf16 sums (the plain version's
    strip-window H rows at the chunk's byte columns) stored into a chunk
    buffer by T's store addresses, read back k-step by k-step through the
    MN-major descriptor, the operand's columns n taken as U or V of
    tchroma_row(n); then the W pass and tail over the U and V rows so
    gathered."""
    src_w, src_h, dst_w, dst_h = geo
    x = torch.from_numpy(nv12)
    yh, ch = kv.static2_h_rows(x, src_w=src_w, src_h=src_h, dst_w=dst_w,
                               dst_h=dst_h, tile=tile, align=8)
    ch = ch.numpy()
    bits = (ch.view(np.uint32) >> 16).astype(np.uint16)   # exact bf16
    b = nv12.shape[0]
    wt = banded.static2_w_tables(*geo, LANCZOS_AA)
    strips = -(-dst_h // tile)
    g = chains.group_bytes(tile)
    uv = np.zeros((2, b, strips * tile, src_w // 2), np.uint16)
    warp, lane, j, plane = _threads(tile)
    off = chains.tchroma_store_offset(tile, warp, lane, j, plane)
    k, nn = np.meshgrid(np.arange(16), np.arange(2 * tile), indexing="ij")
    rd_plane, rd_row = chains.tchroma_row(nn)
    for s in range(strips):
        for first, x0, nchunks, _ in wt.heads:
            for c in range(nchunks):
                img = np.zeros((b, 2 * g), np.uint16)  # 4 groups of g bytes
                for e in range(2):
                    row = s * tile + 8 * j + 2 * (lane % 4) + e
                    col = x0 + 64 * c + 16 * warp + 2 * (lane // 4) + plane
                    ok = (row < dst_h) & (col < src_w)
                    val = np.zeros((b,) + row.shape, np.uint16)
                    val[:, ok] = bits[:, row[ok], col[ok]]
                    img[:, (off + 2 * e) // 2] = val
                for i in range(2):
                    addr = (2 * i * g + chains.operand_offset(
                        k, nn, g, 128, True)) // 2
                    px = x0 // 2 + 32 * c + 16 * i + k
                    ok = px < src_w // 2
                    uv[rd_plane[ok], :, s * tile + rd_row[ok], px[ok]] = \
                        img[:, addr[ok]].T
    u, v = (torch.from_numpy((p[:, :dst_h].astype(np.uint32) << 16).view(
        np.float32)) for p in uv)
    tail = banded.tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0,
                              torch.uint8, None)
    return kv.static2_w_pass_plain(yh, u, v, tail, src_w=src_w,
                                   src_h=src_h, dst_w=dst_w, dst_h=dst_h)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("geo,batch", [(GEOMETRIES[1], 3),
                                       (GEOMETRIES[2], 2),
                                       (GEOMETRIES[3], 2),
                                       (GEOMETRIES[4], 2)])
def test_t_layout_walk_equals_static_kernel2_plain(geo, batch, tile):
    """The walk of S2's block with T's chroma layout gives
    static_kernel2_plain at (tile, 8) bit for bit: T's stores, its
    MN-major read and its epilogue's indices only move the chroma sums, so
    the W pass sums the same H rows S2's does."""
    src_w, src_h, dst_w, dst_h = geo
    x = np.random.default_rng(src_w + tile).integers(
        0, 256, (batch, src_h * 3 // 2, src_w), dtype=np.uint8)
    got = _t_walk(x, geo, tile)
    want = kv.static_kernel2_plain(torch.from_numpy(x), src_w=src_w,
                                   src_h=src_h, dst_w=dst_w, dst_h=dst_h,
                                   tile=tile, align=8)
    assert torch.equal(got, want)


# --- the wrappers -------------------------------------------------------------

@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("geo", GEOMETRIES[1:])
def test_cpu_routes_are_s2_plain_and_the_product_plain(geo, tile):
    """On the CPU, S, Slong and T at 16 and 32 rows are
    static_kernel2_plain at (tile, 8), which is the product's plain
    version bit for bit; no launch is counted."""
    src_w, src_h, dst_w, dst_h = geo
    g = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    x = kv.make_frames(2, src_h * 3 // 2, src_w, "cpu", seed=tile)
    want = nv12_preprocess_plain(x, **g)
    before = [w.launches for w in kv.WRAPPERS]
    for out in (kv.static_kernel(x, **g, tile=tile),
                kv.static_kernel(x, **g, shortchain=False, tile=tile),
                kv.transposed_chroma(x, **g, tile=tile)):
        assert torch.equal(out, want)
    assert torch.equal(want, kv.static_kernel2_plain(x, **g, tile=tile,
                                                     align=8))
    assert [w.launches for w in kv.WRAPPERS] == before
    assert chains.chains_refusal(*geo, tile=tile) == ""


@pytest.mark.parametrize("geo,tile,why", [
    ((256, 144, 96, 64), 8, "strips of 16 and 32 rows"),
    ((256, 144, 96, 64), 24, "strips of 16 and 32 rows"),
    ((256, 144, 96, 64), 48, "strips of 16 and 32 rows"),
    ((256, 144, 96, 64), 12, "multiple of 8"),
    ((256, 144, 96, 64), 64, "up to 48"),
    ((256, 144, 96, 64), 0, "tile and align"),
    ((3840, 2160, 224, 224), 32, "shared memory"),
])
def test_wrappers_refuse_before_any_launch(geo, tile, why):
    """A strip height nv12_chains.cu is not compiled for, one S2 does not
    take, and a geometry whose block passes a block's shared memory raise
    the same ValueError on the CPU as on the card, before any launch."""
    src_w, src_h, dst_w, dst_h = geo
    x = torch.zeros((1, src_h * 3 // 2, src_w), dtype=torch.uint8)
    g = dict(src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h)
    before = [w.launches for w in kv.WRAPPERS]
    for call in (lambda: kv.static_kernel(x, **g, tile=tile),
                 lambda: kv.static_kernel(x, **g, shortchain=False,
                                          tile=tile),
                 lambda: kv.transposed_chroma(x, **g, tile=tile)):
        with pytest.raises(ValueError, match=why):
            call()
    assert [w.launches for w in kv.WRAPPERS] == before


def test_lab_cases_of_the_six_arms():
    """The lab's S, Slong, T (32 rows) and S16, Slong16, T16: full-function
    cases held to the envelope (the tensor cores' sums), S2's work and
    plain version at their strip, the tiles note at 1080p."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    for name, wrapper, tile in (("S", kv.static_kernel, 32),
                                ("Slong", kv.static_kernel, 32),
                                ("T", kv.transposed_chroma, 32),
                                ("S16", kv.static_kernel, 16),
                                ("Slong16", kv.static_kernel, 16),
                                ("T16", kv.transposed_chroma, 16)):
        c = kv.case(name, 64, 1620, **geo)
        assert c.wrapper is wrapper and c.full_function and not c.exact
        assert c.work == kv.case(f"S2t{tile}a8", 64, 1620, **geo).work
        assert "one 64-column output tile each" in c.note
        assert name in kv.DEFAULT_NAMES
    with pytest.raises(ValueError, match="unknown lab name"):
        kv.case("Sfast", 8, 216, **geo)


def test_the_source_compiles_the_tiles_the_host_admits():
    """nv12_chains.cu's launch switch has a case for each of CHAINS_TILES
    and no other; each launcher is in the labs' library."""
    from vali_tpu_torch.ops import _cuda_build as cb

    path = os.path.join(cb._PKG_DIR, "csrc", "nv12_chains.cu")
    text = open(path).read()
    body = text[text.index("int launch_tile("):]
    body = body[:body.index("\n}\n")]
    assert tuple(int(t) for t in re.findall(r"case (\d+):", body)) == TILES
    assert "csrc/nv12_chains.cu" in cb._LAB_SOURCES
    for name in ("nv12_chains_launch", "nv12_tchroma_launch",
                 "nv12_chains_probe_launch"):
        assert name in cb._LAB_SIGNATURES
