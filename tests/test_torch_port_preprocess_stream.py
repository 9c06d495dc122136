"""CPU tests of the streaming preprocess kernel's block geometry
(``vali_tpu_torch/ops/banded.py`` ``stream_preprocess_tables``, the host half
of ``csrc/banded_preprocess.cu``).

The kernel itself runs only on a card (``tests/test_torch_port_cuda.py``).
Here a numpy walk replays its block schedule — column tiles, strips of
output rows in stages, luma and chroma rows through rings filled two
stages ahead of the stage that reads them — and checks that every row is
resident in its ring when it is read, then sums the bands from the rings and the H rows at the tiles' window
offsets in float64 and holds the result to the dense resampling matrices.
"""

import numpy as np
import pytest
import torch

from vali_tpu_torch.ops import banded
from vali_tpu_torch.ops.resize import LANCZOS, LANCZOS_AA

CPU = torch.device("cpu")
SMS = 132   # an H100's SMs
LAYOUTS = ("nv12", "420", "422", "444")

# (src_h, src_w, dst_h, dst_w): chip_smoke.py's shapes, then a sweep
CHIP_SHAPES = [
    (1080, 1920, 224, 224),     # the pipeline's batches
    (1080, 1920, 360, 640),     # the letterbox launch's inner shape
]
SWEEP = [
    (96, 256, 40, 120),         # downscale
    (62, 96, 96, 130),          # upscale 62 -> 96 rows
    (64, 64, 64, 64),           # identity
    (62, 130, 30, 34),          # widths that are not whole vectors
    (150, 322, 70, 202),        # dst not a multiple of the strip or tile
]


def _sample(layout, wide):
    """(sample dtype, compute dtype): uint16 samples (NV12 and I420 only)
    compute in float32."""
    if wide:
        return torch.uint16, torch.float32
    return torch.uint8, torch.bfloat16


def _tables(geo, method, layout, sample=torch.uint8, compute=torch.bfloat16,
            batch=64):
    h, w, dh, dw = geo
    return banded.stream_preprocess_tables(w, h, dw, dh, method, layout,
                                           compute, sample, batch, SMS, CPU)


def _forced(t, block):
    """``t`` with the block geometry ``block`` (a candidate's tuple)."""
    return banded.PreprocessTables(t.index, t.weights, t.taps, *block,
                                   np.array(block[:7], np.int32))


def _unpack(t, dh, dw):
    """The four bands of the uploaded tables: (start, count, weights) of
    luma rows, chroma rows, luma columns, chroma columns (column weights
    [dw, taps])."""
    index = t.index.numpy()
    weights = t.weights.numpy().astype(np.float64)
    hy_k, hc_k, wy_k, wc_k = t.taps
    out, at = [], 0
    for n, k in ((dh, hy_k), (dh, hc_k)):
        start = index[len(out) * 2 * dh:][:dh]
        count = index[len(out) * 2 * dh + dh:][:dh]
        out.append((start, count, weights[at:at + n * k].reshape(n, k)))
        at += n * k
    for i, k in enumerate((wy_k, wc_k)):
        start = index[4 * dh + 2 * i * dw:][:dw]
        count = index[4 * dh + (2 * i + 1) * dw:][:dw]
        out.append((start, count, weights[at:at + k * dw].reshape(k, dw).T))
        at += k * dw
    return out


def _band_rows(start, count):
    """The source rows of the bands ``start[i] .. start[i] + count[i] - 1``
    back to back."""
    total = int(count.sum())
    first = np.repeat(np.cumsum(count) - count, count)
    return np.repeat(start, count) + np.arange(total) - first


def _walk_plane(t, rows_band, o0, o1, ring, src=None, pitch=None,
                lane0=0):
    """Replay one plane's schedule over the strip [o0, o1): the ring of
    ``ring`` rows filled two stages ahead of the H pass. Checks every read;
    with ``src`` [rows, lanes] also returns {output row: H row over the
    window lanes from ``lane0``} summed from the rows the ring holds."""
    hs, hc, hw = rows_band
    G = t.stage_rows
    stages = -(-(o1 - o0) // G)
    slots = np.full(ring, -1)
    state = {"fetched": -1}

    def fetch(s):
        r0, r1 = o0 + s * G, min(o0 + (s + 1) * G, o1)
        live = hc[r0:r1] > 0
        if s >= stages or not live.any():
            return
        lo, hi = hs[r0:r1][live].min(), (hs + hc - 1)[r0:r1][live].max()
        rows = np.arange(max(lo, state["fetched"] + 1), hi + 1)
        assert len(rows) <= ring, ("a stage brings more rows than the ring",
                                   o0, s)
        slots[rows % ring] = rows
        state["fetched"] = max(state["fetched"], hi)

    out = {}
    for s in range(banded.LOOKAHEAD):
        fetch(s)
    for s in range(stages):
        fetch(s + banded.LOOKAHEAD)
        r0, r1 = o0 + s * G, min(o0 + (s + 1) * G, o1)
        rows = _band_rows(hs[r0:r1], hc[r0:r1])
        assert (slots[rows % ring] == rows).all(), ("H", o0, s)
        if src is None:
            continue
        for r in range(r0, r1):
            band_rows = np.arange(hs[r], hs[r] + hc[r])
            x = np.zeros((len(band_rows), pitch))
            seg = src[band_rows, lane0:lane0 + pitch]
            x[:, :seg.shape[1]] = seg
            out[r] = hw[r, :hc[r]] @ x
    return out


def _walk(t, geo, layout, sample, frame=None):
    """Replay the kernel's schedule for one frame (or only the residency
    and coverage checks without one). ``frame`` is (y [h, w], u, v) planes
    of the layout; returns the float64 (Y, U, V) W-pass sums [dh, dw]."""
    h, w, dh, dw = geo
    vr = banded.STREAM_VEC_BYTES // banded.SAMPLE_BYTES[sample]
    nc, cc = banded._CHROMA_RINGS[layout]
    hy, hc, wy, wc = _unpack(t, dh, dw)
    assert t.strip_rows % t.stage_rows == 0
    covered = np.zeros(dw, np.int64)
    sums = None if frame is None else np.zeros((3, dh, dw))
    if frame is not None and layout == "nv12":   # interleaved UV lanes
        uv = np.empty((frame[1].shape[0], 2 * frame[1].shape[1]))
        uv[:, 0::2], uv[:, 1::2] = frame[1], frame[2]
        c_planes = [uv]
    elif frame is not None:
        c_planes = [frame[1], frame[2]]
    for p0 in range(0, dw, t.tile_w):
        cols = min(t.tile_w, dw - p0)
        covered[p0:p0 + cols] += 1
        y_lane0 = wy[0][p0:p0 + cols].min() // vr * vr
        c_lane0 = wc[0][p0:p0 + cols].min() * cc // vr * vr
        y_nl = (wy[0] + wy[1])[p0:p0 + cols].max() - y_lane0
        c_nl = (wc[0] + wc[1])[p0:p0 + cols].max() * cc - c_lane0
        assert 0 < y_nl <= t.y_pitch and 0 < c_nl <= t.c_pitch
        for o0 in range(0, dh, t.strip_rows):
            o1 = min(o0 + t.strip_rows, dh)
            if frame is None:
                _walk_plane(t, hy, o0, o1, t.y_ring)
                _walk_plane(t, hc, o0, o1, t.c_ring)
                continue
            ys = _walk_plane(t, hy, o0, o1, t.y_ring,
                             frame[0].astype(np.float64), t.y_pitch, y_lane0)
            cs = [_walk_plane(t, hc, o0, o1, t.c_ring,
                              c.astype(np.float64), t.c_pitch, c_lane0)
                  for c in c_planes]
            for r in range(o0, o1):
                for q in range(p0, p0 + cols):
                    n = wy[1][q]
                    at = wy[0][q] - y_lane0
                    sums[0, r, q] = ys[r][at:at + n] @ wy[2][q, :n]
                    n = wc[1][q]
                    at = wc[0][q] * cc - c_lane0
                    for i in range(2):
                        row = cs[0][r] if nc == 1 else cs[i][r]
                        lanes = at + cc * np.arange(n) + (i if nc == 1 else 0)
                        sums[1 + i, r, q] = row[lanes] @ wc[2][q, :n]
    assert (covered == 1).all()
    return sums


def _geo_layouts(geos):
    return [(g, lay) for g in geos for lay in LAYOUTS
            if lay == "444" or g[1] % 2 == 0]


@pytest.mark.parametrize("method", [LANCZOS_AA, LANCZOS])
@pytest.mark.parametrize("geo", CHIP_SHAPES + SWEEP)
def test_row_bands_start_and_end_non_decreasing(geo, method):
    """The rings slide down the image and the tiles along the row: both
    rely on luma and chroma bands whose first and last source index never
    decrease, each inside its plane."""
    h, w, dh, dw = geo
    for layout in ("420", "422", "444"):
        if layout != "444" and w % 2:
            continue
        dense = banded.dense_weights(w, h, dw, dh, method, layout)
        ins = (h, h // 2 if layout == "420" else h, w,
               w if layout == "444" else w // 2)
        for m, n_in in zip(dense, ins):
            start, count, _ = banded.band_table(m, torch.float32)
            assert (np.diff(start) >= 0).all()
            assert (np.diff(start + count) >= 0).all()
            assert (start >= 0).all() and (start + count <= n_in).all()


@pytest.mark.parametrize("method", [LANCZOS_AA, LANCZOS])
@pytest.mark.parametrize("geo,layout", _geo_layouts(CHIP_SHAPES + SWEEP))
def test_every_row_is_resident_when_it_is_read(geo, layout, method):
    """The block schedule, at the batch sizes the card sees (one frame, an
    odd count, the pipeline's 64), never sums a row from a ring slot that
    holds another row, and its tiles cover every output column once."""
    wide_ok = layout in ("nv12", "420")
    for wide in ((False, True) if wide_ok else (False,)):
        sample, compute = _sample(layout, wide)
        for batch in (1, 3, 64):
            _walk(_tables(geo, method, layout, sample, compute, batch), geo,
                  layout, sample)


@pytest.mark.parametrize("method", [LANCZOS_AA, LANCZOS])
@pytest.mark.parametrize("geo,layout", _geo_layouts(SWEEP))
def test_walk_sums_equal_the_dense_matrices(geo, layout, method):
    """Summing each row band from the ring the H pass reads and each column
    band from the H rows at the tile's window offsets (interleaved UV lanes
    for NV12) gives the dense resampling of every plane (float64)."""
    h, w, dh, dw = geo
    rng = np.random.default_rng(h * w + len(layout))
    ch = h // 2 if layout in ("nv12", "420") else h
    cw = w if layout == "444" else w // 2
    frame = (rng.integers(0, 256, (h, w)), rng.integers(0, 256, (ch, cw)),
             rng.integers(0, 256, (ch, cw)))
    dense = banded.dense_weights(w, h, dw, dh, method,
                                 "420" if layout == "nv12" else layout)
    for batch in (1, 64):
        t = _tables(geo, method, layout, batch=batch)
        sums = _walk(t, geo, layout, torch.uint8, frame)
        hy, hc, wy, wc = _unpack(t, dh, dw)

        def dense_of(band, n_out, n_in):
            m = np.zeros((n_out, n_in))
            for o in range(n_out):
                m[o, band[0][o]:band[0][o] + band[1][o]] = \
                    band[2][o, :band[1][o]]
            return m
        ry, rc = dense_of(hy, dh, h), dense_of(hc, dh, ch)
        cy, cc = dense_of(wy, dw, w), dense_of(wc, dw, cw)
        for i, (x, r, c) in enumerate(((frame[0], ry, cy),
                                       (frame[1], rc, cc),
                                       (frame[2], rc, cc))):
            np.testing.assert_allclose(sums[i], r @ x @ c.T, rtol=1e-9,
                                       atol=1e-6)
        # the tables are the dense matrices' bands, weights rounded to bf16
        np.testing.assert_allclose(ry, dense.luma_h, atol=2e-2)


@pytest.mark.parametrize("geo,layout", _geo_layouts(CHIP_SHAPES + SWEEP))
def test_shared_memory_fits_a_block(geo, layout):
    for method in (LANCZOS_AA, LANCZOS):
        for wide in ((False, True) if layout in ("nv12", "420")
                     else (False,)):
            sample, compute = _sample(layout, wide)
            for cdt in ((compute, torch.float32) if not wide
                        else (compute,)):
                t = _tables(geo, method, layout, sample, cdt,
                            batch=1 + 63 * (method == LANCZOS_AA))
                sb = banded.SAMPLE_BYTES[sample]
                smem = banded.preprocess_smem(
                    t.y_pitch, t.c_pitch, t.stage_rows, t.strip_rows,
                    t.y_ring, t.c_ring, t.tile_w, t.taps[2], t.taps[3],
                    layout, sb, 4 if cdt == torch.float32 else 2)
                assert smem == t.smem <= banded.SMEM_LIMIT
                assert t.y_pitch * sb % 16 == 0
                assert t.c_pitch * sb % 16 == 0
                assert 1 <= t.blocks_per_sm <= \
                    banded.PREPROCESS_BLOCKS_PER_SM
                assert list(t.geometry) == list(t[3:10])


def test_the_packer_raises_where_no_block_fits():
    """A 100,000-row frame shrunk to 8 rows needs rings of tens of
    thousands of rows: no tile fits, and the packer says so rather than
    pick a shape the kernel does not take."""
    for layout in LAYOUTS:
        with pytest.raises(ValueError, match="shared memory"):
            banded.stream_preprocess_tables(64, 100000, 32, 8, LANCZOS_AA,
                                            layout, torch.bfloat16,
                                            torch.uint8, 1, SMS, CPU)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rings_are_sized_by_ring_rows(layout):
    """The preprocess rings are sized by the resize's rule: each plane's
    ring is ``ring_rows`` of its own row bands at the block's stage
    height (4:2:0 chroma slides at half the luma rate), and ``ring_rows``
    refuses bands that do not slide down."""
    for geo in CHIP_SHAPES + SWEEP:
        h, w, dh, dw = geo
        if layout != "444" and w % 2:
            continue
        bands = banded._layout_bands(w, h, dw, dh, LANCZOS_AA,
                                     "420" if layout == "nv12" else layout,
                                     torch.bfloat16)
        for _, block in banded.preprocess_candidates(bands, layout, 1, 2, 64,
                                                     SMS):
            g = block[3]
            assert block[5] == banded.ring_rows(*bands[0][:2], g)
            assert block[6] == banded.ring_rows(*bands[1][:2], g)
    with pytest.raises(ValueError, match="out of order"):
        banded.ring_rows(np.array([0, 4, 2, 6], np.int32),
                         np.full(4, 3, np.int32), 1)


#: a block geometry of the 64 x 1080p -> 224 NV12 sweep (column tile 19,
#: 4-row stages, one 224-row strip) that gave other bits in a build whose
#: H items summed four rows; replayed here at every stage and strip height
SWEPT_TILE = 19


@pytest.mark.parametrize("layout", LAYOUTS)
def test_swept_geometries_replay(layout):
    """Every candidate block of the 1080p -> 224 sweep with the column tile
    of SWEPT_TILE, at every stage and strip height, keeps its windows
    within its pitches, every row resident when it is read, and covers
    every output column once."""
    geo = CHIP_SHAPES[0]
    h, w, dh, dw = geo
    t = _tables(geo, LANCZOS_AA, layout)
    bands = banded._layout_bands(w, h, dw, dh, LANCZOS_AA,
                                 "420" if layout == "nv12" else layout,
                                 torch.bfloat16)
    blocks = [b for _, b in banded.preprocess_candidates(
        bands, layout, 1, 2, 64, SMS) if b[0] == SWEPT_TILE]
    assert any(b[3] == 4 and b[4] == 224 for b in blocks)
    for block in blocks:
        _walk(_forced(t, block), geo, layout, torch.uint8)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forced_geometry_sums_equal_the_dense_matrices(layout):
    """A forced block (tiles of 7 columns, 2-row stages, 6-row strips) over
    a ragged geometry sums every plane as the dense matrices do."""
    geo = (150, 322, 70, 202)
    h, w, dh, dw = geo
    t = _tables(geo, LANCZOS_AA, layout)
    bands = banded._layout_bands(w, h, dw, dh, LANCZOS_AA,
                                 "420" if layout == "nv12" else layout,
                                 torch.bfloat16)
    block = next(b for _, b in banded.preprocess_candidates(
        bands, layout, 1, 2, 3, SMS) if b[0] == 7 and b[3] == 2
        and b[4] == 8)
    rng = np.random.default_rng(19)
    ch = h // 2 if layout in ("nv12", "420") else h
    cw = w if layout == "444" else w // 2
    frame = (rng.integers(0, 256, (h, w)), rng.integers(0, 256, (ch, cw)),
             rng.integers(0, 256, (ch, cw)))
    sums = _walk(_forced(t, block), geo, layout, torch.uint8, frame)
    whole = _walk(t, geo, layout, torch.uint8, frame)
    np.testing.assert_allclose(sums, whole, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_blocks_keep_two_or_more_an_sm(layout):
    """Where a geometry with two or more blocks an SM exists, the packer
    picks one; strips are whole stages."""
    for geo in CHIP_SHAPES:
        h, w, dh, dw = geo
        for batch in (1, 3, 64):
            t = _tables(geo, LANCZOS_AA, layout, batch=batch)
            assert t.blocks_per_sm >= 2
            assert t.strip_rows % t.stage_rows == 0
            assert t.stage_rows <= t.strip_rows <= \
                -(-dh // t.stage_rows) * t.stage_rows


def test_preprocess_tables_are_cached_and_share_the_uploads():
    """A call's tables and geometry are cached per batch; the uploaded band
    tables are those of ``device_tables`` for every batch size and sample
    type of one geometry and compute type (both caches emptied first:
    the tests before this one fill ``device_tables``' 32 entries)."""
    banded.device_tables.cache_clear()
    banded.stream_preprocess_tables.cache_clear()
    geo = (96, 256, 40, 120)
    a = _tables(geo, LANCZOS_AA, "420")
    assert a is _tables(geo, LANCZOS_AA, "420")
    dt = banded.device_tables(256, 96, 120, 40, LANCZOS_AA, "420",
                              torch.bfloat16, CPU)
    for other in (_tables(geo, LANCZOS_AA, "420", batch=1),
                  _tables(geo, LANCZOS_AA, "nv12", batch=7)):
        assert other.index is dt.index and other.weights is dt.weights
    assert a.args()[2:6] == dt.taps


def test_pick_is_the_cheapest_candidate_with_two_blocks():
    """The pick is the least estimated cost of the candidates with two or
    more blocks an SM, and every candidate fits a block."""
    bands = banded._layout_bands(1920, 1080, 224, 224, LANCZOS_AA, "420",
                                 torch.bfloat16)
    cands = list(banded.preprocess_candidates(bands, "420", 1, 2, 64, SMS))
    assert all(geo[7] <= banded.SMEM_LIMIT for _, geo in cands)
    t = banded.stream_preprocess_tables(1920, 1080, 224, 224, LANCZOS_AA,
                                        "420", torch.bfloat16, torch.uint8,
                                        64, SMS, CPU)
    assert min(c for c in cands if c[1][-1] >= 2)[1] == tuple(t[3:12])
