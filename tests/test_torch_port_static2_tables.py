"""The host tables of the NV12 lab's S2 kernel (``csrc/nv12_static2.cu``,
built by ``vali_tpu_torch.ops.banded``) on the CPU, at the lab's 1080p ->
224 and at the card tests' shapes, for every point of the notebook's
sweep: every window inside its plane, B the bf16 strip-window bands
widened only with zeros and read back in the order the kernel's wgmma
descriptors take it, the W fragments the bf16 column weights; a numpy walk
of the tables through both passes, as the kernel's blocks run them, within
the uint8 envelope of ``static_kernel2_plain``; the FLOPs the tables issue;
and the refusal."""

import math
import re

import numpy as np
import pytest
import torch

from vali_tpu_torch.core.enums import ColorRange, ColorSpace
from vali_tpu_torch.lab import kernel_variants as kv
from vali_tpu_torch.ops import banded
from vali_tpu_torch.ops.banded import core_matrix_order
from vali_tpu_torch.ops.resize import LANCZOS_AA, round_to

#: (tile, align) of the notebook's sweep (main_sweep2) and the lab's names
SWEEP = [(32, 8), (16, 8), (24, 8), (48, 8), (32, 32)]
#: (src_w, src_h, dst_w, dst_h): the lab's, then the card tests' shapes
GEOMETRIES = [(1920, 1080, 224, 224), (162, 90, 50, 20), (130, 62, 34, 30),
              (256, 96, 48, 40), (256, 144, 96, 64), (256, 96, 32, 32)]


def _bands(geo):
    return banded._nv12_bands(*geo, LANCZOS_AA)[:2]


def _tables(geo, tile, align):
    return (banded.static2_tables(*geo, LANCZOS_AA, tile, align),
            banded.static2_w_tables(*geo, LANCZOS_AA))


def _b_as_read(m):
    """[strips, N, K] of B as the kernel's descriptors read it from the
    core-matrix order the wrapper uploads: element (n, k) of a strip at
    (k // 16) N 16 + (n // 8) 128 + (k mod 16 // 8) 64 + (n mod 8) 8 +
    k mod 8 (k-steps N * 32 bytes apart, 8-row groups 256 bytes, k halves
    128 bytes)."""
    n_rows, k_cols = m.shape[1:]
    flat = core_matrix_order(m)
    n = np.arange(n_rows)[:, None]
    k = np.arange(k_cols)[None, :]
    idx = ((k // 16) * n_rows * 16 + (n // 8) * 128 + (k % 16 // 8) * 64
           + (n % 8) * 8 + k % 8)
    return flat[:, idx]


def _a_as_read(frags):
    """[64, 16 nk] of A from [nk, 128, 8] fragments as wgmma reads A from
    registers: thread t (warp w, lane l) holds rows 16 w + l // 4 (+8) at
    k 2 (l mod 4) (+1, +8, +9) of each k-step, in the order a0..a7."""
    t = np.arange(128)
    m0 = 16 * (t // 32) + t % 32 // 4
    k0 = 2 * (t % 4)
    rows = m0[:, None] + np.array([0, 0, 8, 8, 0, 0, 8, 8])[None, :]
    cols = k0[:, None] + np.array([0, 1, 0, 1, 8, 9, 8, 9])[None, :]
    a = np.zeros((64, 16 * len(frags)), np.float32)
    for ks in range(len(frags)):
        a[rows, 16 * ks + cols] = frags[ks]
    return a


def _w_as_read(wt, tile):
    """(x0, chunks, luma A [64, 64 chunks], chroma A [64, 32 chunks]) of
    one output tile, its chunks' fragments read back in order."""
    first, x0, chunks, _ = wt.heads[tile]
    f = wt.frags[first:first + chunks]
    return (x0, chunks, _a_as_read(f[:, :4].reshape(-1, 128, 8)),
            _a_as_read(f[:, 4:].reshape(-1, 128, 8)))


@pytest.mark.parametrize("tile,align", SWEEP)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_windows_lie_inside_their_planes(geo, tile, align):
    """Each strip's window starts on a multiple of ``align`` rows (or is
    pulled back to end with its plane) inside the plane; K is the
    notebook's window length rounded up to 16, and the rows past the plane
    (which the kernel reads as the last row) weigh 0."""
    src_w, src_h, dst_w, dst_h = geo
    t, _ = _tables(geo, tile, align)
    strips = -(-dst_h // tile)
    assert t.starts.shape == (strips, 2)
    for p, (m, n_in) in enumerate(((t.luma, src_h), (t.chroma, src_h // 2))):
        ws, length, _ = banded.strip_window_bands(*geo, LANCZOS_AA, tile,
                                                  align)[p]
        L = int(length[0])
        assert m.shape == (strips, tile, -(-L // 16) * 16)
        st = t.starts[:, p]
        assert (st >= 0).all() and (st + L <= n_in).all()
        assert ((st % align == 0) | (st == n_in - L)).all()
        past = st[:, None] + np.arange(m.shape[2])[None, :] >= n_in
        assert not m.transpose(0, 2, 1)[past].any()
        assert not m[:, :, L:].any()


@pytest.mark.parametrize("tile,align", SWEEP)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_b_is_the_bf16_strip_window_bands(geo, tile, align):
    """B read through the descriptors' layout holds each output row's bf16
    band at its rows of the strip's window and zeros elsewhere (rows past
    dst_h all zero); each row's weights sum as its band's do."""
    src_w, src_h, dst_w, dst_h = geo
    t, _ = _tables(geo, tile, align)
    for p, m in enumerate((t.luma, t.chroma)):
        assert np.array_equal(_b_as_read(m), m)
        start, count, w = _bands(geo)[p]
        for o in range(m.shape[0] * tile):
            s, r = divmod(o, tile)
            want = np.zeros(m.shape[2], np.float32)
            if o < dst_h:
                off = int(start[o] - t.starts[s, p])
                want[off:off + count[o]] = w[o, :count[o]]
                assert math.fsum(m[s, r]) == math.fsum(w[o])
            assert np.array_equal(m[s, r], want), (p, o)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_w_fragments_are_the_bf16_column_weights(geo):
    """Each tile's chunks start on a byte column that is a multiple of 32,
    come in an even count, and read back through wgmma's fragment layout
    hold the bf16 luma weights of the tile's columns at luma columns x0 +
    64 j + k and the chroma weights at chroma pixels x0 / 2 + 32 j + k,
    every nonzero weight of the tile covered, zeros past the row."""
    src_w, src_h, dst_w, dst_h = geo
    _, wt = _tables(geo, 16, 8)
    dw = banded.dense_weights(*geo, LANCZOS_AA, "420")
    wy, wc = (round_to(m, torch.bfloat16).numpy()
              for m in (dw.luma_w, dw.chroma_w))
    tiles = -(-dst_w // 64)
    assert wt.heads.shape == (tiles, 4)
    first = np.concatenate([[0], np.cumsum(wt.heads[:, 2])[:-1]])
    assert (wt.heads[:, 0] == first).all() and (wt.heads[:, 3] == 0).all()
    assert wt.frags.shape == (wt.heads[:, 2].sum(), 6, 128, 8)
    for tile in range(tiles):
        x0, chunks, ay, ac = _w_as_read(wt, tile)
        assert x0 % 32 == 0 and chunks % 2 == 0 and 0 <= x0 < src_w
        oc = np.arange(64 * tile, min(64 * (tile + 1), dst_w))
        want_y = np.zeros((64, src_w + 64 * chunks), np.float32)
        want_y[:len(oc), :src_w] = wy[oc]
        want_c = np.zeros((64, src_w // 2 + 32 * chunks), np.float32)
        want_c[:len(oc), :src_w // 2] = wc[oc]
        assert np.array_equal(ay, want_y[:, x0:x0 + 64 * chunks])
        assert np.array_equal(ac, want_c[:, x0 // 2:x0 // 2 + 32 * chunks])
        assert math.fsum(ay.ravel()) == math.fsum(wy[oc].ravel())
        assert math.fsum(ac.ravel()) == math.fsum(wc[oc].ravel())
        assert 64 * (chunks - 2) < (src_w - x0)   # no chunk pair past the row


def _walk(nv12, geo, tile, align):
    """Both passes of S2's kernel in numpy from its tables, block by block
    and chunk by chunk as it runs them (fp32 sums, H rows rounded to bf16,
    each warpgroup's W sums over its own chunks added at the end), then
    the product's tail; and the FLOPs its products issue."""
    src_w, src_h, dst_w, dst_h = geo
    b = nv12.shape[0]
    t, wt = _tables(geo, tile, align)
    bmat = (_b_as_read(t.luma), _b_as_read(t.chroma))
    h_steps = sum(m.shape[2] // 16 for m in bmat)
    strips = bmat[0].shape[0]
    sums = np.zeros((3, b, strips * tile, dst_w), np.float32)
    flops = 0
    for s in range(strips):
        for tile_i in range(wt.heads.shape[0]):
            x0, chunks, ay, ac = _w_as_read(wt, tile_i)
            cols = 64 * chunks
            h = []
            for p, (n_in, row0) in enumerate(((src_h, 0),
                                              (src_h // 2, src_h))):
                k = bmat[p].shape[2]
                rows = row0 + np.minimum(t.starts[s, p] + np.arange(k),
                                         n_in - 1)
                x = np.zeros((b, k, cols), np.float32)
                n = min(cols, src_w - x0)
                x[..., :n] = nv12[:, rows, x0:x0 + n]
                h.append(torch.from_numpy(bmat[p][s] @ x).to(
                    torch.bfloat16).float().numpy())   # [b, tile, cols]
            planes = (h[0], h[1][..., 0::2], h[1][..., 1::2])
            part = np.zeros((2, 3, b, tile, 64), np.float32)
            for j in range(chunks):
                flops += 2 * 64 * 16 * tile * (h_steps + 4 + 2 * 2)
                for c, (hp, a, w) in enumerate(zip(
                        planes, (ay, ac, ac), (64, 32, 32))):
                    hj = hp[..., w * j:w * (j + 1)]    # [b, tile, w]
                    part[j % 2, c] += np.einsum(
                        "mk,brk->brm", a[:, w * j:w * (j + 1)], hj)
            p0 = 64 * tile_i
            n = min(64, dst_w - p0)
            sums[:, :, s * tile:(s + 1) * tile, p0:p0 + n] = \
                (part[0] + part[1])[..., :n]
    eye = torch.eye(dst_w)
    tail = banded.tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0,
                              torch.uint8, None)
    y, u, v = (torch.from_numpy(x[:, :dst_h]) for x in sums)
    return banded.w_pass_tail_plain(y, u, v, eye, eye, tail,
                                    torch.uint8).numpy(), flops


@pytest.mark.parametrize("tile,align", SWEEP)
@pytest.mark.parametrize("geo,batch", [(GEOMETRIES[0], 1),
                                       (GEOMETRIES[1], 3),
                                       (GEOMETRIES[2], 2),
                                       (GEOMETRIES[3], 2)])
def test_tables_walk_equals_static_kernel2_plain(geo, batch, tile, align):
    """A numpy walk of the tables through both passes is within 1 LSB of
    static_kernel2_plain on fewer than 1e-3 of the samples (fp32 sums in
    another order), and its products issue the FLOPs static2_work counts
    (with the product's bytes)."""
    src_w, src_h, dst_w, dst_h = geo
    x = np.random.default_rng(src_w + tile + align).integers(
        0, 256, (batch, src_h * 3 // 2, src_w), dtype=np.uint8)
    got, flops = _walk(x, geo, tile, align)
    want = kv.static_kernel2_plain(torch.from_numpy(x), src_w=src_w,
                                   src_h=src_h, dst_w=dst_w, dst_h=dst_h,
                                   tile=tile, align=align).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    from vali_tpu_torch.lab.timing import CSC_OPS
    nbytes, ops = kv.static2_work(batch, *geo, tile=tile, align=align)
    assert ops == batch * (flops + CSC_OPS * dst_h * dst_w)
    assert nbytes == batch * (src_h * 3 // 2 * src_w + 3 * dst_h * dst_w)


def test_work_at_1080p_and_g_unchanged():
    """At 64 x 1080p -> 224 the lab's S2 cases report the FLOPs their
    tables issue — more at taller strips, t48 over t32 — and G's case
    keeps its count."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    gflop = {f"S2t{t}a{a}": kv.case(f"S2t{t}a{a}", 64, 1620, **geo).work[1]
             / 1e9 for t, a in SWEEP}
    assert gflop["S2t16a8"] < gflop["S2t32a8"] < gflop["S2t48a8"]
    assert gflop["S2t32a8"] < gflop["S2t32a32"]
    assert all(10 < g < 60 for g in gflop.values()), gflop
    assert kv.case("G", 64, 1620, **geo).work == kv.grouped_work(64, **geo)
    assert kv.grouped_work(64, **geo) == (208699392, 18358796288)


SHAPES = GEOMETRIES + [(256, 144, 96, 64), (322, 150, 202, 70)]


@pytest.mark.parametrize("tile,align", SWEEP + [(8, 8), (40, 8)])
@pytest.mark.parametrize("geo", SHAPES)
def test_refusal_admits_the_sweep_and_the_test_shapes(geo, tile, align):
    """Every sweep point launches at the lab's size and the card tests'
    shapes: no refusal, the block within a block's shared memory."""
    assert banded.static2_refusal(*geo, LANCZOS_AA, tile, align) == ""
    t, _ = _tables(geo, tile, align)
    assert banded.static2_smem_bytes(tile, t.k_luma, t.k_chroma) \
        <= banded.SMEM_LIMIT


@pytest.mark.parametrize("geo,tile,why", [
    ((256, 144, 96, 64), 12, "multiple of 8"),
    ((256, 144, 96, 64), 20, "multiple of 8"),
    ((256, 144, 96, 64), 56, "up to 48"),
    ((3840, 2160, 224, 32), 32, "shared memory"),
])
def test_refusal_refuses_what_does_not_fit(geo, tile, why):
    """A strip height that is not a multiple of 8 up to 48, or a geometry
    whose windows make the ring pass a block's shared memory, is refused
    before any launch, on the CPU too, with the wrapper's launch count
    unchanged."""
    assert re.search(why, banded.static2_refusal(*geo, LANCZOS_AA, tile, 8))
    sw, sh, dw, dh = geo
    x = torch.zeros((1, sh * 3 // 2, sw), dtype=torch.uint8)
    before = kv.static_kernel2.launches
    with pytest.raises(ValueError, match=why):
        kv.static_kernel2(x, src_w=sw, src_h=sh, dst_w=dw, dst_h=dh,
                          tile=tile, align=8)
    assert kv.static_kernel2.launches == before


def test_smem_bytes_match_the_kernel_layout():
    """The block's shared memory as the kernel lays it out: the ring (or
    the traded W sums), B_y and B_c, two warpgroups' H rows of a chunk;
    t48a8 at 1080p, the largest of the sweep, fits with one block an
    SM."""
    t = banded.static2_tables(1920, 1080, 224, 224, LANCZOS_AA, 48, 8)
    assert (t.k_luma, t.k_chroma) == (272, 144)
    kst = 416
    want = 3 * kst * 128 + 2 * kst * 48 + 2 * (8 * 784 + 4 * 1552)
    assert banded.static2_smem_bytes(48, 272, 144) == want == 224640
    # a tiny window: the traded sums (4 (T / 2 + T) 128 bytes) set the size
    assert banded.static2_smem_bytes(48, 16, 16) == \
        36864 + 2 * 32 * 48 + 2 * (8 * 784 + 4 * 1552)
