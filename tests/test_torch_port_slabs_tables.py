"""The host tables of lab kernel ``slabs`` (vali_tpu_torch/lab/
resize_diag.py ``slabs_plane_tables``, read by csrc/nv12_slabs.cu) on the
CPU, at one 4K -> 1080p frame and at the card tests' shapes for nslabs 2,
4, 6 and 16: the pieces of each window and their cuts, the B_p against
``aligned``'s B, the k-steps each piece issues, the boxes each barrier
expects, a numpy replay of the pieces through both passes against
``slabs_resize_plain``, and the refusal. No card and no JAX needed:
test_torch_port_resize_diag.py holds the wrapper's CPU route to the TPU
notebook."""

import numpy as np
import pytest
import torch

from vali_tpu_torch.lab import resize_diag as rd
from vali_tpu_torch.ops.banded import core_matrix_order

R = rd.ALIGNED_ROWS
K4 = (1, 3840, 2160, 1920, 1080)
SHAPES = [K4, (3, 512, 288, 256, 144), (2, 322, 150, 202, 70),
          (3, 256, 96, 120, 40)]
IDS = ["4K", "3x512x288", "2x322x150", "3x256x96"]
NSLABS = [2, 4, 6, 16]


def _planes(shape, nslabs):
    """(row0, n_in, channels, SlabsPlane) of luma and chroma."""
    _, w, h, dw, dh = shape
    y, c = rd._slabs_planes(w, h, dw, dh, nslabs, 8, 32)
    return [(0, h, 1, y), (h, h // 2, 2, c)]


def _issued(p, s):
    return range(p.pfirst[s], p.pfirst[s + 1])


def _b_of(p, q):
    """[R, k_pad] B_p of issued piece ``q``: its blocks at its k-steps."""
    ks0, nks, first, _ = p.pieces[q]
    b = np.zeros((R, p.tables.k_pad), np.float32)
    b[:, 16 * ks0:16 * (ks0 + nks)] = np.concatenate(
        list(p.bp[first:first + nks]), axis=1)
    return b


@pytest.mark.parametrize("nslabs", NSLABS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_pieces_cover_each_window_cut_at_every_slab_edge(shape, nslabs):
    """Each strip's cuts run over its window's k_pad rows once, in order,
    and end exactly where a window row's buffer row is a multiple of the
    slab height."""
    slab = rd.slab_rows(shape[2], nslabs)
    for row0, _, _, p in _planes(shape, nslabs):
        t = p.tables
        strips = t.weights.shape[0]
        assert (np.unique(p.cuts[:, 0]) == np.arange(strips)).all()
        for s in range(strips):
            cuts = p.cuts[p.cuts[:, 0] == s, 1:]
            assert cuts[0, 0] == 0 and cuts[-1, 1] == t.k_pad
            assert (cuts[1:, 0] == cuts[:-1, 1]).all()
            assert (cuts[:, 1] > cuts[:, 0]).all()
            buffer_row = row0 + t.starts[s] + np.arange(1, t.k_pad)
            edges = np.flatnonzero(buffer_row % slab == 0) + 1
            assert (cuts[1:, 0] == edges).all()


@pytest.mark.parametrize("nslabs", NSLABS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_b_pieces_are_disjoint_and_sum_to_aligned_b(shape, nslabs):
    """The B_p of a strip's issued pieces have disjoint supports that sum
    exactly to aligned's B; each lies in one piece's rows, so in one slab;
    the pieces not issued weigh nothing; the pieces go in slab order."""
    slab = rd.slab_rows(shape[2], nslabs)
    for row0, _, _, p in _planes(shape, nslabs):
        t = p.tables
        for s in range(t.weights.shape[0]):
            total = np.zeros_like(t.weights[s])
            support = np.zeros(t.weights[s].shape, np.int32)
            slabs = []
            for q in _issued(p, s):
                b = _b_of(p, q)
                total += b
                support += b != 0
                rows = np.flatnonzero(b.any(axis=0))
                owner = np.unique((row0 + t.starts[s] + rows) // slab)
                assert len(owner) == 1, (s, q)
                slabs.append(owner[0])
            assert np.array_equal(total, t.weights[s])
            assert support.max() <= 1
            assert slabs == sorted(set(slabs))
            cuts = p.cuts[p.cuts[:, 0] == s, 1:]
            live = [a for a, e in cuts if t.weights[s][:, a:e].any()]
            assert len(live) == len(slabs)


@pytest.mark.parametrize("nslabs", NSLABS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_each_piece_issues_exactly_its_nonzero_k_steps(shape, nslabs):
    """A piece issues the k-steps of its B_p that hold a nonzero weight and
    no other: none skipped, none all zero; its blocks of ``bp`` are those
    k-steps in order, and the blocks of a strip are consecutive; a block's
    shared memory holds k_pad / 16 blocks for the first piece and the later
    pieces' blocks."""
    for _, _, _, p in _planes(shape, nslabs):
        t = p.tables
        block = 0
        for s in range(t.weights.shape[0]):
            for q in _issued(p, s):
                ks0, nks, first, _ = p.pieces[q]
                assert first == block
                block += nks
                b = _b_of(p, q).reshape(R, -1, 16)
                live = np.flatnonzero(b.any(axis=(0, 2)))
                assert np.array_equal(live, np.arange(ks0, ks0 + nks))
                for i in range(nks):
                    assert p.bp[first + i].any()
                    assert np.array_equal(p.bp[first + i], b[:, ks0 + i])
        assert block == len(p.bp)
        # shared memory: the first piece at its window k-steps, then the
        # later pieces' blocks
        assert p.blocks == t.k_pad // 16 + max(
            int(p.pieces[p.pfirst[s] + 1:p.pfirst[s + 1], 1].sum())
            for s in range(t.weights.shape[0]))


def _swizzle(x):
    return x ^ ((x >> 3) & 0x70)


@pytest.mark.parametrize("nslabs", NSLABS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_barriers_expect_their_boxes_bytes(shape, nslabs):
    """Per stage, each piece's barrier expects the bytes of its boxes (its
    last ``boxes`` k-steps, one [16, 128] box each); a k-step's box goes to
    one barrier, that of the first piece that issues it, so every k-step a
    piece reads has landed once its barrier and those before have
    completed; at most SLABS_MAX_PIECES barriers a stage. A replay of the
    boxes as TMA lays them (window row k at k * 128, its 16-byte chunks
    swizzled by k mod 8) read back at the kernel's fragment offsets gives
    each k-step's window rows."""
    tq = np.arange(4)[:, None]
    j = np.arange(4)[None, :]
    ccol = np.arange(0, rd.ALIGNED_STAGE_COLS, 2)[:, None, None]
    off = _swizzle((2 * tq + (j & 1) + 8 * (j >> 1)) * rd.ALIGNED_STAGE_COLS
                   + ccol)
    for _, _, _, p in _planes(shape, nslabs):
        t = p.tables
        assert p.most_pieces <= rd.SLABS_MAX_PIECES
        for s in range(t.weights.shape[0]):
            owner = {}
            for n, q in enumerate(_issued(p, s)):
                ks0, nks, _, boxes = p.pieces[q]
                assert 0 <= boxes <= nks
                mine = list(range(ks0 + nks - boxes, ks0 + nks))
                expected = boxes * rd.SLABS_BOX_BYTES
                assert expected == sum(16 * rd.ALIGNED_STAGE_COLS
                                       for _ in mine)
                for k in mine:
                    assert k not in owner
                    owner[k] = n
                for k in range(ks0, ks0 + nks):
                    assert owner.get(k, n + 1) <= n, (s, q, k)
            stage = np.zeros(t.k_pad * rd.ALIGNED_STAGE_COLS, np.int32)
            rows = np.arange(t.k_pad)[:, None]
            x = rows * rd.ALIGNED_STAGE_COLS + np.arange(
                rd.ALIGNED_STAGE_COLS)[None, :]
            for k in owner:
                box = slice(16 * k, 16 * k + 16)
                stage[_swizzle(x[box])] = x[box]   # window row k, byte c
            for k in owner:
                got = stage[16 * k * rd.ALIGNED_STAGE_COLS + off]
                want = ((16 * k + 2 * tq + (j & 1) + 8 * (j >> 1))
                        * rd.ALIGNED_STAGE_COLS + ccol)
                assert np.array_equal(got, np.broadcast_to(want, got.shape))


def _replay(nv12, shape, nslabs):
    """Both passes of the slabs kernel in numpy from its tables: per strip
    and range each issued piece's k-steps times its B_p blocks into a fresh
    fp32 partial (window rows past the plane and columns past the row read
    as zero, as TMA fills them), the partials added in slab order, rounded
    to bf16, then aligned's W pass (round half to even and clip)."""
    b, w, h, dw, dh = shape
    out = np.zeros((b, dh * 3 // 2, dw), np.uint8)
    for (row0, n_in, ch, p), orow0, ow in zip(_planes(shape, nslabs),
                                               (0, dh), (dw, dw // 2)):
        t = p.tables
        n_out = dh if ch == 1 else dh // 2
        plane = np.zeros((b, n_in + t.k_pad, w), np.float32)
        plane[:, :n_in] = nv12[:, row0:row0 + n_in]
        for s in range(t.weights.shape[0]):
            win = plane[:, t.starts[s]:t.starts[s] + t.k_pad]
            for t0, n, x0, hw in p.ranges.tolist():
                x = np.zeros((b, t.k_pad, hw * ch), np.float32)
                cols = x0 * ch + np.arange(hw * ch)
                x[..., cols < w] = win[..., cols[cols < w]]
                acc = None
                for q in _issued(p, s):
                    ks0, nks, first, _ = p.pieces[q]
                    bq = np.concatenate(list(p.bp[first:first + nks]), axis=1)
                    part = bq @ x[:, 16 * ks0:16 * (ks0 + nks)]
                    acc = part if acc is None else acc + part
                hr = torch.from_numpy(acc).to(torch.bfloat16).float()
                hr = torch.cat([hr[..., c::ch] for c in range(ch)], dim=1)
                for tile in range(t0, t0 + n):
                    first, c0, nk = t.heads[tile].tolist()
                    a = np.zeros((64, 16 * nk), np.float32)
                    # the W weights as the fragments carry them
                    fr = t.frags[first:first + nk]
                    tt = np.arange(128)
                    m0 = 16 * (tt // 32) + tt % 32 // 4
                    k0 = 2 * (tt % 4)
                    rr = m0[:, None] + np.array([0, 0, 8, 8, 0, 0, 8, 8])
                    cc = k0[:, None] + np.array([0, 1, 0, 1, 8, 9, 8, 9])
                    for ks in range(nk):
                        a[rr, 16 * ks + cc] = fr[ks]
                    hk = hr[..., c0 - x0:c0 - x0 + 16 * nk].numpy()
                    d = np.einsum("mk,bnk->bmn", a, hk)
                    qv = np.clip(np.rint(d), 0, 255).astype(np.uint8)
                    px = rd.ALIGNED_W_TILE * tile + np.arange(64)
                    keep = px < ow
                    for c in range(ch):
                        vals = qv[:, keep, c * R:(c + 1) * R]
                        o = R * s + np.arange(R)
                        ok = o < n_out
                        out[:, orow0 + o[ok][:, None], ch * px[keep] + c] = \
                            vals[..., ok].transpose(0, 2, 1)
    return out


@pytest.mark.parametrize("nslabs", NSLABS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_replay_within_the_envelope_of_the_plain_version(shape, nslabs):
    """A numpy replay of the pieces (fp32 partials in slab order, rounded
    to bf16, then the W pass) is within 1 LSB on fewer than 1e-3 of the
    samples of slabs_resize_plain."""
    b, w, h, dw, dh = shape
    x = np.random.default_rng(w + h + nslabs).integers(
        0, 256, (b, h * 3 // 2, w), dtype=np.uint8)
    got = _replay(x, shape, nslabs)
    want = rd.slabs_resize_plain(torch.from_numpy(x), src_w=w, src_h=h,
                                 dst_w=dw, dst_h=dh, nslabs=nslabs).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("nslabs", NSLABS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_refusal_admits_the_lab_and_test_points(shape, nslabs):
    """The lab's sweep (nslabs 2, 4, 6 at 4K) and the card tests' shapes
    launch, two blocks an SM; most windows are one piece."""
    _, w, h, dw, dh = shape
    assert rd.slabs_refusal(w, h, dw, dh, nslabs, 8, 32) == ""
    for _, _, ch, p in _planes(shape, nslabs):
        assert rd.slabs_smem_bytes(ch, p.hcols, p.tables.k_pad, p.blocks) \
            <= rd.ALIGNED_TWO_BLOCKS
    if shape == K4 and nslabs <= 6:
        y, c = _planes(shape, nslabs)[0][3], _planes(shape, nslabs)[1][3]
        straddle = sum(int((np.diff(q.pfirst) > 1).sum()) for q in (y, c))
        assert 1 <= straddle <= 10


@pytest.mark.parametrize("geo,nslabs,why", [
    ((256, 768, 128, 120), 48, "9 pieces, over the kernel's 8"),
    ((8192, 64, 512, 32), 2, "two to an SM"),
    ((3840, 2160, 64, 16), 4, "windows of .* rows exceed"),
])
def test_refusal_refuses_before_any_launch(geo, nslabs, why):
    """A window cut into more pieces than the kernel has barriers, a block
    that does not fit two to an SM, or aligned's own refusal raises
    ValueError, on the CPU too, before anything is launched."""
    import re

    w, h, dw, dh = geo
    assert re.search(why, rd.slabs_refusal(w, h, dw, dh, nslabs, 8, 32))
    x = torch.zeros((1, h * 3 // 2, w), dtype=torch.uint8)
    before = rd.slabs_resize.launches
    with pytest.raises(ValueError, match=why):
        rd.slabs_resize(x, src_w=w, src_h=h, dst_w=dw, dst_h=dh,
                        nslabs=nslabs)
    assert rd.slabs_resize.launches == before


def test_device_tables_are_cached_and_in_core_matrix_order():
    """The launcher's arguments are built once per geometry: per plane
    aligned's eight with B the pieces' blocks in core-matrix order, then
    the strips' first pieces, the pieces and the blocks of B a strip."""
    cpu = torch.device("cpu")
    args, keep = rd._slabs_device(512, 288, 256, 144, 16, 8, 32, cpu)
    assert rd._slabs_device(512, 288, 256, 144, 16, 8, 32, cpu)[0] is args
    assert len(args) == 22
    for i, (_, _, _, p) in enumerate(_planes(SHAPES[1], 16)):
        b = keep[7 * i]
        assert b.dtype == torch.bfloat16
        assert torch.equal(b.float(), torch.from_numpy(
            core_matrix_order(p.bp)))
        assert args[11 * i + 2] == p.tables.k_pad
        assert args[11 * i + 10] == p.blocks
        assert torch.equal(keep[7 * i + 6].view(-1, 4),
                           torch.from_numpy(p.pieces))
