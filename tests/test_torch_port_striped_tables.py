"""The host tables of the resize lab's ``striped`` kernel
(``csrc/nv12_striped.cu``, built by ``vali_tpu_torch.lab.resize_diag``) on
the CPU, at the lab's 4K -> 1080p and at the card tests' shapes: the
stripe cuts, the tiles each stripe owns, the halo each stripe copies and
the peers it copies it from; a numpy replay of a cluster's walk through
``aligned``'s tables (each stripe's own H rows, the halo copies, the W
products of its tiles) equal to a replay of ``aligned``'s own walk and
within the uint8 envelope of ``striped_resize_plain``; the FLOPs, shared
memory and halo bytes of each instance; and the refusal, before any
launch."""

import re

import numpy as np
import pytest
import torch

from vali_tpu_torch.lab import resize_diag as rd
from vali_tpu_torch.ops.banded import core_matrix_order

R = rd.ALIGNED_ROWS
#: (src_w, src_h, dst_w, dst_h): the lab's, the CPU lab's and the card
#: tests' geometries
GEOMETRIES = [(3840, 2160, 1920, 1080), (512, 288, 256, 144),
              (322, 150, 202, 70), (256, 96, 120, 40)]
NWS = list(range(1, 9))


def _planes(geo, nw, store="dyn"):
    """(row0, out row0, n_in, n_out, px, ow, channels, StripedPlane) of
    luma and chroma."""
    sw, sh, dw, dh = geo
    y, c = rd._striped_planes(sw, sh, dw, dh, nw, store)
    return [(0, 0, sh, dh, sw, dw, 1, y),
            (sh, dh, sh // 2, dh // 2, sw // 2, dw // 2, 2, c)]


def _halo_sources(p, s):
    """(pixel, stripe, its group there) of each column group of stripe
    ``s``'s halo, as the kernel finds it: the stripe ``min(c // spx,
    nw - 1)`` that owns those 8 pixels."""
    _, _, own, held = p.stripes[s].tolist()
    x0 = s * p.spx
    out = []
    for c in range(x0 + own, x0 + held, 8):
        peer = min(c // p.spx, len(p.stripes) - 1)
        out.append((c, peer, (c - peer * p.spx) // 8))
    return out


def _b_as_read(t):
    """[strips, R, k_pad] of B as the descriptors read it from the
    core-matrix order the wrapper uploads."""
    flat = core_matrix_order(t.weights)
    n = np.arange(R)[:, None]
    k = np.arange(t.k_pad)[None, :]
    idx = ((k // 16) * R * 16 + (n // 8) * 128 + (k % 16 // 8) * 64
           + (n % 8) * 8 + k % 8)
    return flat[:, idx].astype(np.float64)


def _a_as_read(frags, nk):
    """[64, 16 nk] of a tile's A from its register fragments."""
    t = np.arange(128)
    m0 = 16 * (t // 32) + t % 32 // 4
    k0 = 2 * (t % 4)
    rows = m0[:, None] + np.array([0, 0, 8, 8, 0, 0, 8, 8])[None, :]
    cols = k0[:, None] + np.array([0, 1, 0, 1, 8, 9, 8, 9])[None, :]
    a = np.zeros((64, 16 * nk), np.float64)
    for ks in range(nk):
        a[rows, 16 * ks + cols] = frags[ks]
    return a


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).double().numpy()


def _h_rows(win, bmat, ch, c0, c1, px):
    """The bf16 H rows [b, ch R, c1 - c0] of pixels c0 .. c1 - 1 of a
    strip (chroma: R U rows, then R V rows), the pixels past the plane's
    ``px`` zeros. Sums in float64 are exact, so they do not depend on the
    columns a product takes."""
    cols = np.arange(c0 * ch, c1 * ch)
    x = np.zeros(win.shape[:2] + (len(cols),))
    inside = cols < px * ch
    x[..., inside] = win[..., cols[inside]]
    h = _bf16(bmat @ x)
    return np.concatenate([h[..., c::ch] for c in range(ch)], axis=1)


def _w_tile(out, h, a, tile, s, orow0, n_out, ow, ch):
    """A tile's W product over its band's H rows ``h`` [b, ch R, 16 nk],
    rounded, clipped and stored (each sample once: the caller checks)."""
    d = (h @ a.T).transpose(0, 2, 1)      # [b, 64, ch R]
    q = np.clip(np.rint(d), 0, 255).astype(np.uint8)
    p = rd.ALIGNED_W_TILE * tile + np.arange(64)
    keep = p < ow
    o = R * s + np.arange(R)
    ok = o < n_out
    for c in range(ch):
        vals = q[:, keep, c * R:(c + 1) * R][..., ok].transpose(0, 2, 1)
        out[:, orow0 + o[ok][:, None], ch * p[keep] + c] = vals


def _aligned_walk(nv12, geo):
    """aligned8x32's walk: per strip and column range its H rows, then the
    W products of the range's tiles."""
    sw, sh, dw, dh = geo
    out = np.zeros((nv12.shape[0], dh * 3 // 2, dw), np.uint8)
    for row0, orow0, n_in, n_out, px, ow, ch, p in _planes(geo, 1):
        t = p.tables
        plane = nv12[:, row0:row0 + n_in].astype(np.float64)
        bmat = _b_as_read(t)
        amat = [_a_as_read(t.frags[first:first + nk], nk)
                for first, _, nk in t.heads]
        for s in range(bmat.shape[0]):
            win = plane[:, np.minimum(t.starts[s] + np.arange(t.k_pad),
                                      n_in - 1)]
            for t0, n, x0, hw in t.ranges.tolist():
                h = _h_rows(win, bmat[s], ch, x0, x0 + hw, px)
                for tile in range(t0, t0 + n):
                    _, c0, nk = t.heads[tile].tolist()
                    _w_tile(out, h[..., c0 - x0:c0 - x0 + 16 * nk],
                            amat[tile], tile, s, orow0, n_out, ow, ch)
    return out


def _cluster_walk(nv12, geo, nw):
    """The striped kernel's walk of each (strip, frame) cluster: every
    stripe's H rows of its own pixels into its buffer, then each halo
    group copied from the stripe that owns it (the kernel's ``min(c //
    spx, nw - 1)``) into the buffer right after the stripe's own, then the
    W products of the stripe's tiles (``order``) over its buffer. Returns
    the output, the times each tile was run and the groups copied."""
    sw, sh, dw, dh = geo
    out = np.zeros((nv12.shape[0], dh * 3 // 2, dw), np.uint8)
    runs, copied = {}, 0
    for row0, orow0, n_in, n_out, px, ow, ch, p in _planes(geo, nw):
        t = p.tables
        plane = nv12[:, row0:row0 + n_in].astype(np.float64)
        bmat = _b_as_read(t)
        amat = [_a_as_read(t.frags[first:first + nk], nk)
                for first, _, nk in t.heads]
        runs[ch] = np.zeros(len(t.heads), int)
        for s in range(bmat.shape[0]):
            win = plane[:, np.minimum(t.starts[s] + np.arange(t.k_pad),
                                      n_in - 1)]
            bufs = []
            for z, (_, _, own, held) in enumerate(p.stripes.tolist()):
                buf = np.full(win.shape[:1] + (ch * R, held), np.nan)
                x0 = z * p.spx
                buf[..., :own] = _h_rows(win, bmat[s], ch, x0, x0 + own, px)
                bufs.append(buf)
            for z, (_, _, own, held) in enumerate(p.stripes.tolist()):
                for c, peer, g in _halo_sources(p, z):
                    assert peer > z and (c - z * p.spx) % 8 == 0
                    src = bufs[peer][..., 8 * g:8 * g + 8]
                    assert not np.isnan(src).any()   # the peer's own rows
                    bufs[z][..., c - z * p.spx:c - z * p.spx + 8] = src
                    copied += s == 0
            for z, (first, n, _, _) in enumerate(p.stripes.tolist()):
                x0 = z * p.spx
                for tile in p.order[first:first + n].tolist():
                    _, c0, nk = t.heads[tile].tolist()
                    h = bufs[z][..., c0 - x0:c0 - x0 + 16 * nk]
                    assert c0 >= x0 and not np.isnan(h).any()
                    _w_tile(out, h, amat[tile], tile, s, orow0, n_out, ow,
                            ch)
                    runs[ch][tile] += s == 0
    return out, runs, copied


def _frames(geo, batch=1):
    sw, sh, _, _ = geo
    return np.random.default_rng(sw + sh).integers(
        0, 256, (batch, sh * 3 // 2, sw), dtype=np.uint8)


_ALIGNED = {}


def _aligned_reference(geo):
    if geo not in _ALIGNED:
        _ALIGNED[geo] = _aligned_walk(_frames(geo), geo)
    return _ALIGNED[geo]


@pytest.mark.parametrize("nw", NWS)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_cuts_ownership_and_halo_sources(geo, nw):
    """Stripes of src_w // nw bytes rounded down to 16 (the last taking the
    rest up to the row's pixels rounded up to 16), the same bytes in both
    planes; each tile owned by the stripe holding its band's first column
    and listed once in ``order``, stripe by stripe; each stripe holding its
    own pixels and its tiles' bands, the halo past its own in whole groups
    of 8 held by stripes to its right."""
    sw, sh, dw, dh = geo
    cut = rd.striped_stripe_bytes(sw, nw)
    assert cut == sw // nw // 16 * 16 and cut % 16 == 0
    for _, _, n_in, n_out, px, ow, ch, p in _planes(geo, nw):
        t = p.tables
        assert p.spx * ch == cut and p.spx % 8 == 0
        wp = -(-px // 16) * 16
        first, count, own, held = p.stripes.T
        assert len(p.stripes) == nw
        assert (own[:-1] == p.spx).all() and own[-1] == wp - (nw - 1) * p.spx
        assert own.sum() == wp and (held >= own).all()
        assert (held % 8 == 0).all() and p.hcols == held.max()
        assert sorted(p.order.tolist()) == list(range(len(t.heads)))
        assert (first == np.concatenate([[0], np.cumsum(count)[:-1]])).all()
        c0, nk = t.heads[:, 1], t.heads[:, 2]
        for z in range(nw):
            x0 = z * p.spx
            mine = p.order[first[z]:first[z] + count[z]]
            assert (p.owner[mine] == z).all()
            assert ((x0 <= c0[mine]) & (c0[mine] < x0 + own[z])).all()
            reach = (c0[mine] + 16 * nk[mine] - x0).max(initial=own[z])
            assert held[z] == max(own[z], reach)
            halo = _halo_sources(p, z)
            assert [c for c, _, _ in halo] == list(
                range(x0 + own[z], x0 + held[z], 8))
            for c, peer, g in halo:
                px0 = peer * p.spx
                assert px0 <= c < px0 + own[peer] and g == (c - px0) // 8
        assert p.wcols == 16 * nk.max()
        relay = rd._striped_planes(*geo, nw, "relay")[ch - 1]
        assert (relay.stripes[:, 3] == relay.stripes[:, 2]).all()


@pytest.mark.parametrize("nw", NWS)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_cluster_walk_equals_aligned_walk(geo, nw):
    """A numpy replay of the clusters' walk (own H rows, halo copies from
    the peers, W products of each stripe's tiles) runs every tile once a
    strip, reads no row it did not write, and gives aligned8x32's walk bit
    for bit (exact float64 sums, bf16 H rows), within the uint8 envelope
    of striped_resize_plain."""
    sw, sh, dw, dh = geo
    x = _frames(geo)
    got, runs, copied = _cluster_walk(x, geo, nw)
    for ch, p in zip((1, 2), rd._striped_planes(*geo, nw, "dyn")):
        assert (runs[ch] == 1).all()
    halo = sum(int((p.stripes[:, 3] - p.stripes[:, 2]).sum()) // 8
               for p in rd._striped_planes(*geo, nw, "dyn"))
    assert copied == halo
    assert np.array_equal(got, _aligned_reference(geo))
    want = rd.striped_resize_plain(torch.from_numpy(x), src_w=sw, src_h=sh,
                                   dst_w=dw, dst_h=dh, nw=nw).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_at_4k_halos_cross_one_edge_and_stripes_own_tiles():
    """At 16 x 4K -> 1080p every stripe of the A/B's instances owns tiles
    and copies its halo from the next stripe alone; at the card tests'
    322-pixel rows some stripes own no tile and a halo spans several."""
    for nw in (2, 3, 5, 6):
        for p in rd._striped_planes(3840, 2160, 1920, 1080, nw, "dyn"):
            assert (p.stripes[:, 1] > 0).all()
            for z in range(nw):
                assert {peer for _, peer, _ in _halo_sources(p, z)} <= {z + 1}
    _, c = rd._striped_planes(322, 150, 202, 70, 7, "dyn")
    assert (c.stripes[:, 1] == 0).any()
    assert max(len({peer for _, peer, _ in _halo_sources(c, z)})
               for z in range(7)) > 1


#: per 4K instance (nw, store): (luma, chroma) shared memory of a block
SMEM_4K = {(2, "dyn"): (173120, 171040), (3, "dyn"): (130880, 137760),
           (5, "dyn"): (97088, 104480), (6, "dyn"): (88640, 96160),
           (3, "unroll"): (130880, 137760), (3, "relay"): (120320, 119040)}


@pytest.mark.parametrize("nw,store", list(SMEM_4K))
def test_work_shared_memory_and_halo_at_4k(nw, store):
    """Every instance issues aligned8x32's W products and each row's H
    columns once (34.01 GFLOP at 16 x 4K, against aligned8x32's 34.81, the
    product's bytes); a block's shared memory is its H rows (own and
    halo), B and the ring: two blocks an SM at nw 5 and 6, one at 2 and 3;
    the relay store's W block holds the widest tile band."""
    geo = (3840, 2160, 1920, 1080)
    nbytes, ops = rd.striped_work(16, *geo)
    assert (nbytes, ops) == (248832000, 34011611136)
    assert rd.aligned_work(16, *geo, 8, 32) == (248832000, 34813771776)
    smem = tuple(rd.striped_smem_bytes(ch, p.hcols, p.tables.k_pad)
                 for ch, p in zip((1, 2),
                                  rd._striped_planes(*geo, nw, store)))
    assert smem == SMEM_4K[(nw, store)]
    assert (max(smem) <= rd.ALIGNED_TWO_BLOCKS) == (nw >= 5)
    if store == "relay":
        y, c = rd._striped_planes(*geo, nw, store)
        assert rd.striped_w_smem_bytes(1, y.wcols) == 192 // 8 * 528
        assert rd.striped_w_smem_bytes(2, c.wcols) == 160 // 8 * 1040
        assert rd.striped_scratch_elems(16, *geo) * 2 == 16 * (
            34 * 3840 * 32 * 2 + 17 * 1920 * 64 * 2)
    assert rd.striped_refusal(*geo, nw, store) == ""


@pytest.mark.parametrize("geo", GEOMETRIES[1:])
def test_work_counts_each_row_once_at_small_shapes(geo):
    """Away from 4K too: the H products cover the row's pixels rounded up
    to 16 once a strip, whatever nw, and the W products are aligned's."""
    sw, sh, dw, dh = geo
    nbytes, ops = rd.striped_work(2, *geo)
    a_bytes, a_ops = rd.aligned_work(2, *geo, 8, 32)
    assert nbytes == a_bytes
    h = 0
    for ch, t in zip((1, 2), rd._aligned_planes(*geo, 8, 32)):
        h += (t.weights.shape[0] * R * t.k_pad * ch
              * (int(t.ranges[:, 3].sum()) - -(-(sw // ch) // 16) * 16))
    assert a_ops - ops == 2 * 2 * h


def test_halo_bytes_grow_with_the_stripes():
    """The bf16 H rows the clusters trade a batch: each stripe's halo, 32
    rows (chroma U and V) of 2 bytes, per strip and frame."""
    geo = (3840, 2160, 1920, 1080)
    halos = [rd.striped_halo_bytes(16, *geo, nw) for nw in (2, 3, 5, 6)]
    assert halos == sorted(halos) and halos[0] > 0
    assert rd.striped_halo_bytes(16, *geo, 1) == 0


@pytest.mark.parametrize("nw,store,why", [
    (0, "dyn", r"nw must be >= 1"),
    (33, "relay", r"narrower than 16 bytes"),
    (9, "dyn", r"dyn store runs the 9 stripes .* cluster"),
    (9, "unroll", r"unroll store .* cluster of at most 8"),
    (3, "lanes", r"store must be one of"),
])
def test_refusal_before_any_launch_on_either_device(nw, store, why):
    """A store, nw or stripe the kernel cannot take is refused with its
    reason before any launch: on the CPU, and on a device that is neither
    (the refusal comes before the device's dispatch); the relay store,
    which runs no cluster, takes more than 8 stripes."""
    geo = dict(src_w=512, src_h=288, dst_w=256, dst_h=144)
    assert re.search(why, rd.striped_refusal(**geo, nw=nw, store=store))
    before = rd.striped_resize.launches
    for dev in ("cpu", "meta"):
        x = torch.zeros((1, 432, 512), dtype=torch.uint8, device=dev)
        with pytest.raises(ValueError, match=why):
            rd.striped_resize(x, **geo, nw=nw, store=store)
    assert rd.striped_resize.launches == before
    assert rd.striped_refusal(**geo, nw=9, store="relay") == ""


@pytest.mark.parametrize("geo,why", [
    ((3840, 2160, 64, 16), r"windows of .* rows exceed"),
    ((3840, 2160, 1920, 1080), r"shared memory"),
])
def test_refusal_of_windows_and_shared_memory(geo, why):
    """Windows past ALIGNED_MAX_K rows, and one stripe's H rows of a 4K
    row (nw = 1) that pass a block's shared memory, are refused before any
    launch."""
    assert re.search(why, rd.striped_refusal(*geo, 1, "dyn"))
    sw, sh, dw, dh = geo
    x = torch.zeros((1, sh * 3 // 2, sw), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match=why):
        rd.striped_resize(x, src_w=sw, src_h=sh, dst_w=dw, dst_h=dh, nw=1)
