"""The host plan of lab kernel ``streamed`` (vali_tpu_torch/lab/
resize_diag.py ``streamed_plan``, read by csrc/nv12_streamed.cu) on the
CPU: its column ranges, ring, runs and blocks at 16 x 4K -> 1080p and at
the card tests' shapes for bands 64 and 256, a numpy replay of the
producer / consumer schedule over the ring with the kernel's slot and
swizzle arithmetic, and the refusal. No card and no JAX needed: the
kernel's arithmetic is ``aligned``'s (tests/test_torch_port_aligned_tables
.py holds it to the plain version), and test_torch_port_resize_diag.py
holds the wrapper's CPU route to the TPU notebook."""

import numpy as np
import pytest
import torch

from vali_tpu_torch.lab import resize_diag as rd
from vali_tpu_torch.ops.banded import SMEM_LIMIT

K4 = (16, 3840, 2160, 1920, 1080)
SHAPES = [K4, (3, 512, 288, 256, 144), (2, 322, 150, 202, 70),
          (3, 256, 96, 120, 40)]
IDS = ["16x4K", "3x512x288", "2x322x150", "3x256x96"]
SMS = 132


def _plans(shape, band, sms=SMS):
    b, w, h, dw, dh = shape
    return rd.streamed_plan(w, h, dw, dh, band, b, sms)


def _strip_cost(p):
    """The tensor-core steps of one strip of each range (the plan's unit of
    work)."""
    t = p.tables
    ksteps = np.array([t.heads[r[0]:r[0] + r[1], 2].sum() for r in p.ranges])
    return (2 * rd._chunks(p.ranges, p.channels) * (t.k_pad // 16)
            + p.channels * ksteps)


@pytest.mark.parametrize("band", [64, 256])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_ranges_cover_their_tiles_bands(shape, band):
    """The ranges split the W tiles into consecutive runs; each range's H
    columns start on 16 bytes and cover every tile's band of source
    pixels."""
    for p in _plans(shape, band):
        heads, ch = p.tables.heads, p.channels
        assert p.ranges[0, 0] == 0
        assert (p.ranges[1:, 0] == p.ranges[:-1, 0] + p.ranges[:-1, 1]).all()
        assert p.ranges[-1, 0] + p.ranges[-1, 1] == len(heads)
        assert (p.ranges[:, 2] * ch % 16 == 0).all()
        assert (p.ranges[:, 3] % 16 == 0).all()
        for t0, n, x0, hpx in p.ranges:
            c0 = heads[t0:t0 + n, 1]
            assert (c0 >= x0).all()
            assert (c0 + 16 * heads[t0:t0 + n, 2] <= x0 + hpx).all()


@pytest.mark.parametrize("band", [64, 256])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_ring_h_rows_and_b_fit_a_block(shape, band):
    """Ring, H rows, B and barriers fit a block's shared memory; the ring
    holds every band one window spans (plus one in flight where it fits),
    and each slot's boxes start on the 128-byte swizzle's 1024-byte
    atoms."""
    for p in _plans(shape, band):
        t = p.tables
        assert rd.streamed_smem_bytes(p.channels, p.hcols, t.k_pad,
                                      p.slots, band, p.chunks) <= SMEM_LIMIT
        lo, hi = p.strip_bands()
        span = int((hi - lo).max()) + 1
        assert p.slots in (span, span + 1)
        assert band * rd.STREAMED_CHUNK % 1024 == 0
    if shape == K4:  # the chosen widths (PERF.md)
        y, c = _plans(shape, band)
        want = {64: ((8, 5, 4), (8, 5, 4)),
                256: ((30, 2, 3), (15, 3, 2))}[band]
        assert ((len(y.ranges), y.chunks, y.slots),
                (len(c.ranges), c.chunks, c.slots)) == want


@pytest.mark.parametrize("band", [64, 256])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_strip_is_walked_once(shape, band):
    """Over all runs every (range, frame, strip) of each plane is walked
    exactly once, each run a stretch of consecutive strips of one walk;
    the blocks take consecutive runs, at most one block an SM."""
    frames = shape[0]
    for p in _plans(shape, band):
        strips = p.tables.weights.shape[0]
        seen = np.zeros((len(p.ranges), frames, strips), np.int32)
        for r, f, s0, n in p.runs:
            assert n >= 1 and 0 <= s0 and s0 + n <= strips
            seen[r, f, s0:s0 + n] += 1
        assert (seen == 1).all()
        assert p.blocks[0] == 0 and p.blocks[-1] == len(p.runs)
        assert (np.diff(p.blocks) >= 1).all()
        assert len(p.blocks) - 1 <= SMS


@pytest.mark.parametrize("band", [64, 256])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_work_per_block_is_even(shape, band):
    """Each block's work (tensor-core steps) is within one strip's of the
    mean; at 16 x 4K, within 5 % of it."""
    for p in _plans(shape, band):
        cost = _strip_cost(p)
        work = np.array([sum(int(cost[r]) * n
                             for r, _, _, n in p.runs[a:e])
                         for a, e in zip(p.blocks, p.blocks[1:])])
        assert work.max() - work.mean() <= cost.max()
        assert work.mean() - work.min() <= cost.max()
        if shape == K4:
            assert work.max() <= 1.05 * work.mean()


def _swizzle(x):
    return x ^ ((x >> 3) & 0x70)


def _frame(seed):
    """A plane's bytes as a function of (frame, row, byte): a hash, so
    that a 4K batch needs no buffer."""
    def val(f, r, c):
        h = (np.asarray(f, np.uint64) * np.uint64(2654435761)
             + np.asarray(r, np.uint64) * np.uint64(40503)
             + np.asarray(c, np.uint64) * np.uint64(9973) + np.uint64(seed))
        return ((h * np.uint64(0x9E3779B1)) >> np.uint64(11)).astype(
            np.uint8)
    return val


def _replay_block(p, bi, val, nbytes):
    """The kernel's schedule of block ``bi`` over one plane whose rows of
    ``nbytes`` bytes are ``val(frame, row, byte)``: at the block's start
    and after each strip's H pass, every band whose slot has been released
    is copied into it as TMA lays it out (swizzled, zeros past the plane),
    and the next strip's B; at every strip's H pass every window row of
    every chunk is read back at the kernel's ring offsets and held to the
    plane. Checks that no slot is rewritten before its band is released
    and that no strip waits for a band or a B never issued. Returns, per
    strip but the last of a run, whether every band of the next strip was
    issued before its W pass."""
    t, band, slots, ch = p.tables, p.band, p.slots, p.channels
    rows = p.n_in
    lo, hi = p.strip_bands()
    box = band * rd.STREAMED_CHUNK
    slot_bytes = box * p.chunks
    ring = np.full(slots * slot_bytes, 0xA5, np.uint8)
    holds = [None] * slots           # band counter each slot holds
    runs = p.runs[p.blocks[bi]:p.blocks[bi + 1]]
    # every band the block copies, in order: (run, band)
    order = [(ri, b) for ri, (_, _, s0, ns) in enumerate(runs)
             for b in range(lo[s0], hi[s0 + ns - 1] + 1)]
    state = dict(issued=0, released=0, b=None)

    def stage(released):
        assert released >= state["released"]
        state["released"] = released
        while (state["issued"] < len(order)
               and state["issued"] < released + slots):
            k = state["issued"]
            assert holds[k % slots] is None or holds[k % slots] < released
            ri, bnd = order[k]
            r, f = runs[ri][0], runs[ri][1]
            xb0 = p.ranges[r][2] * ch
            x = np.arange(box)
            rr = bnd * band + x // rd.STREAMED_CHUNK
            for c in range(rd._chunks(p.ranges[r:r + 1], ch)[0]):
                cc = xb0 + c * rd.STREAMED_CHUNK + x % rd.STREAMED_CHUNK
                vals = np.where((rr < rows) & (cc < nbytes), val(f, rr, cc),
                                0).astype(np.uint8)
                ring[k % slots * slot_bytes + c * box + _swizzle(x)] = vals
            holds[k % slots] = k
            state["issued"] += 1

    stage(0)
    if len(runs):
        state["b"] = runs[0][2]
    ahead, n = [], 0
    tq = np.arange(4)[:, None]
    j = np.arange(4)[None, :]
    ccol = np.arange(0, rd.STREAMED_CHUNK, 2)[:, None, None, None]
    ks = np.arange(t.k_pad // 16)[None, :, None, None]
    for ri, (r, f, s0, ns) in enumerate(runs):
        xb0, hbytes = p.ranges[r][2] * ch, p.ranges[r][3] * ch
        lo0 = lo[s0]
        for s in range(s0, s0 + ns):
            assert n + hi[s] - lo0 < state["issued"], "a band never issued"
            assert state["b"] == s, "B of the strip never issued"
            row = np.minimum(t.starts[s] + 16 * ks + 2 * tq + (j & 1)
                             + 8 * (j >> 1), rows - 1)
            k = n + row // band - lo0
            assert all(holds[kk % slots] == kk for kk in np.unique(k))
            for c in range(-(-hbytes // rd.STREAMED_CHUNK)):
                off = (k % slots * slot_bytes + c * box
                       + _swizzle(row % band * rd.STREAMED_CHUNK + ccol))
                col = xb0 + c * rd.STREAMED_CHUNK + ccol
                want = np.where(col < nbytes, val(f, row, col), 0)
                assert (ring[off] == want).all()
            last = s == s0 + ns - 1
            next_lo = hi[s] + 1 if last else lo[s + 1]
            stage(n + next_lo - lo0)
            state["b"] = (s + 1 if not last else runs[ri + 1][2]
                          if ri + 1 < len(runs) else None)
            if not last:
                ahead.append(n + hi[s + 1] - lo0 < state["issued"])
        n += hi[s0 + ns - 1] - lo0 + 1
    assert state["issued"] == len(order)
    return ahead


@pytest.mark.parametrize("band", [64, 256])
@pytest.mark.parametrize("shape", SHAPES[1:], ids=IDS[1:])
def test_schedule_replay_at_the_card_tests_shapes(shape, band):
    """Every block of both planes: each window row resident in the slot
    the kernel reads, at the kernel's swizzled offset, when its strip's H
    pass reads it; no slot reissued while a strip that reads it runs."""
    for p in _plans(shape, band):
        for bi in range(len(p.blocks) - 1):
            _replay_block(p, bi, _frame(band + p.channels), shape[1])


@pytest.mark.parametrize("band", [64, 256])
def test_schedule_replay_at_4k(band):
    """The replay on the first, a middle and the last block of each plane
    at 16 x 4K -> 1080p; where the ring has a slot beyond the window's
    bands, the next strip's bands are all issued before each W pass (so
    they land under it)."""
    for p in _plans(K4, band):
        lo, hi = p.strip_bands()
        span = int((hi - lo).max()) + 1
        nb = len(p.blocks) - 1
        for bi in (0, nb // 2, nb - 1):
            ahead = _replay_block(p, bi, _frame(band), K4[1])
            if p.slots == span + 1:
                assert ahead and all(ahead)


def test_staged_bytes_and_work():
    """At 16 x 4K -> 1080p band 64 stages 1.3-1.45x the frame into shared
    memory (whole 128-byte chunks, the restarts' cold windows), band 256
    2-2.3x (one tile a luma range); the lab counts aligned's FLOPs at
    8x32 as the kernel's work."""
    b, w, h, dw, dh = K4
    frame = b * h * 3 // 2 * w
    staged = {band: sum(rd.streamed_staged_bytes(p)
                        for p in _plans(K4, band)) for band in (64, 256)}
    assert 1.3 * frame < staged[64] < 1.45 * frame
    assert 2.0 * frame < staged[256] < 2.3 * frame
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    assert rd.case("streamed64", b, **geo).work == rd.aligned_work(
        b, **geo, h_align=8, w_align=32)
    assert not rd.case("streamed256", b, **geo).exact


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_refusal_admits_the_sweep_points(shape):
    b, w, h, dw, dh = shape
    for band in (64, 256):
        assert rd.streamed_refusal(w, h, dw, dh, band) == ""


@pytest.mark.parametrize("band,why", [
    (8, "source rows of a strip"),
    (100, "multiple of 8"),
    (4096, "shared memory"),
])
def test_refusal_refuses_before_any_launch(band, why):
    """A band under the notebook's least, off the swizzle's atom, or whose
    ring does not fit beside one W tile's H rows raises ValueError, on the
    CPU too, before anything is launched."""
    b, w, h, dw, dh = K4
    assert why in rd.streamed_refusal(w, h, dw, dh, band)
    x = torch.zeros((1, 3 * 96 // 2, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match=why):
        rd.streamed_resize(x, src_w=256, src_h=96, dst_w=120, dst_h=40,
                           band=band)


def test_refusal_of_a_band_taller_than_a_box():
    """Where a ring of 512-row bands fits (a narrow frame) the band is
    still one TMA box too tall."""
    why = rd.streamed_refusal(64, 1024, 32, 512, 512)
    assert "TMA box" in why


def test_plan_is_cached_and_split_over_the_sms():
    """The plan is built once per geometry, band, batch and SM count, and
    the blocks of each plane are at most the SMs."""
    a = _plans(K4, 64)
    assert _plans(K4, 64) is a
    few = _plans(K4, 64, sms=7)
    assert all(len(p.blocks) - 1 == 7 for p in few)
    assert all(len(p.blocks) - 1 == SMS for p in a)
