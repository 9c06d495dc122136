"""CPU tests of the streaming resize kernel's block geometry
(``vali_tpu_torch/ops/banded.py`` ``stream_resize_tables``, the host half of
``csrc/banded_resize.cu``).

The kernel itself runs only on a card (``tests/test_torch_port_cuda.py``).
Here a numpy walk replays its block schedule — column tiles, strips of
output rows in stages, the ring of source rows filled LOOKAHEAD stages
ahead —
and checks that every band it reads is resident when it is read, then
sums the bands from the ring and the H rows in float64 and holds the
result to the dense resampling matrices.
"""

import numpy as np
import pytest
import torch

from vali_tpu_torch.ops import banded
from vali_tpu_torch.ops.resize import LANCZOS, LANCZOS_AA, resize_weights

CPU = torch.device("cpu")
SMS = 132   # an H100's SMs
SAMPLES = (torch.uint8, torch.uint16, torch.float32)

# (src_h, src_w, dst_h, dst_w): chip_smoke.py's shapes, then a sweep
CHIP_SHAPES = [
    (1080, 1920, 224, 224),     # two-stage convert + resize
    (1080, 1920, 360, 640),     # Surface path A
    (2160, 3840, 1080, 1920),   # 4K Y -> 1080p, NV12 luma
    (1080, 1920, 540, 960),     # stacked U/V, NV12 chroma
]
SWEEP = [
    (96, 256, 40, 120),         # downscale
    (62, 130, 96, 200),         # upscale, widths not x4
    (130, 62, 200, 96),
    (64, 64, 64, 64),           # identity
    (48, 64, 20, 36),
    (150, 322, 70, 202),        # dst_h % 8 != 0, tiles that do not divide
]


def _bands(n_in, n_out, method):
    return banded.band_table(resize_weights(n_in, n_out, method),
                             torch.float32)


def _tables(geo, method, channels, sample=torch.uint8,
            compute=torch.bfloat16, batch=64):
    h, w, dh, dw = geo
    if sample != torch.uint8:
        compute = torch.float32
    return banded.stream_resize_tables(h, dh, w, dw, method, compute,
                                       channels, sample, batch, SMS, CPU)


def _band_rows(start, count):
    """The source rows of the bands ``start[i] .. start[i] + count[i] - 1``
    back to back."""
    total = int(count.sum())
    first = np.repeat(np.cumsum(count) - count, count)
    return np.repeat(start, count) + np.arange(total) - first


def _walk(t, geo, channels, sample, x=None):
    """Replay the kernel's schedule for one frame ``x`` [src_h, src_w * C]
    (or only the residency checks when ``x`` is None). Returns the float64
    output, or None."""
    h, w, dh, dw = geo
    vec = banded.STREAM_VEC_BYTES // banded.SAMPLE_BYTES[sample]
    index = t.index.numpy()
    hs, hc = index[:dh], index[dh:2 * dh]
    ws, wc = index[2 * dh:2 * dh + dw], index[2 * dh + dw:]
    hk, wk = t.taps
    weights = t.weights.numpy().astype(np.float64)
    hw = weights[:dh * hk].reshape(dh, hk)
    ww = weights[dh * hk:].reshape(wk, dw)
    G, D, R, C = t.stage_rows, t.ring_rows, t.strip_rows, channels
    assert R % G == 0
    out = None if x is None else np.zeros((dh, dw * C))
    covered = np.zeros(dw, np.int64)
    for p0 in range(0, dw, t.tile_w):
        cols = min(t.tile_w, dw - p0)
        covered[p0:p0 + cols] += 1
        lane0 = ws[p0:p0 + cols].min() * C // vec * vec
        nl = (ws + wc)[p0:p0 + cols].max() * C - lane0
        assert lane0 % vec == 0 and 0 < nl <= t.pitch
        if x is not None:
            # per output lane of the tile, its window offsets and weights
            p = np.arange(p0, p0 + cols)
            k = np.arange(wk)
            at = ((ws[p] * C - lane0)[:, None, None]
                  + np.arange(C)[None, :, None] + C * k[None, None, :])
            wt = np.where(k[None, :] < wc[p][:, None], ww[:, p].T, 0.0)
            at = np.where(k[None, None, :] < wc[p][:, None, None], at, 0)
        for o0 in range(0, dh, R):
            o1 = min(o0 + R, dh)
            slots = np.full(D, -1)          # the source row each slot holds
            ring = None if x is None else np.zeros((D, t.pitch))
            fetched = -1

            def fetch(s):
                nonlocal fetched
                r0, r1 = o0 + s * G, min(o0 + (s + 1) * G, o1)
                live = hc[r0:r1] > 0
                if not live.any():
                    return
                lo = hs[r0:r1][live].min()
                hi = (hs + hc - 1)[r0:r1][live].max()
                rows = np.arange(max(lo, fetched + 1), hi + 1)
                slots[rows % D] = rows
                if x is not None and len(rows):
                    seg = x[rows, lane0:lane0 + t.pitch]
                    ring[rows % D] = 0
                    ring[rows % D, :seg.shape[1]] = seg
                fetched = max(fetched, hi)

            stages = -(-(o1 - o0) // G)
            for s in range(min(banded.LOOKAHEAD, stages)):
                fetch(s)
            for s in range(stages):
                if s + banded.LOOKAHEAD < stages:   # in flight while stage
                    fetch(s + banded.LOOKAHEAD)     # s is summed
                r0, r1 = o0 + s * G, min(o0 + (s + 1) * G, o1)
                need = _band_rows(hs[r0:r1], hc[r0:r1])
                assert (slots[need % D] == need).all(), (p0, o0, s)
                if x is None:
                    continue
                for r in range(r0, r1):
                    rows = np.arange(hs[r], hs[r] + hc[r])
                    mid = hw[r, :hc[r]] @ ring[rows % D]
                    lanes = (mid[at] * wt[:, None, :]).sum(-1)
                    out[r, p0 * C:(p0 + cols) * C] = lanes.reshape(-1)
    assert (covered == 1).all()
    return out


@pytest.mark.parametrize("method", [LANCZOS_AA, LANCZOS])
@pytest.mark.parametrize("geo", CHIP_SHAPES + SWEEP)
def test_band_starts_and_ends_never_decrease(geo, method):
    """The ring slides down the image and the tiles along the row: both
    rely on bands whose first and last source index never decrease."""
    h, w, dh, dw = geo
    for n_in, n_out in ((h, dh), (w, dw), (h // 2, dh // 2)):
        start, count, _ = _bands(n_in, n_out, method)
        assert (np.diff(start) >= 0).all()
        assert (np.diff(start + count) >= 0).all()
        assert (start >= 0).all() and (start + count <= n_in).all()


@pytest.mark.parametrize("method", [LANCZOS_AA, LANCZOS])
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("geo", CHIP_SHAPES + SWEEP)
def test_every_band_is_resident_when_its_row_is_summed(geo, channels,
                                                       method):
    """The block schedule at the batch sizes the card sees (one frame, an
    odd count, the timed batches) never reads a ring slot that holds
    another row, and its tiles cover every output column once."""
    for sample in SAMPLES:
        for batch in (1, 3, 16, 64):
            t = _tables(geo, method, channels, sample, batch=batch)
            _walk(t, geo, channels, sample)


@pytest.mark.parametrize("method", [LANCZOS_AA, LANCZOS])
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("geo", SWEEP)
def test_walk_sums_equal_the_dense_matrices(geo, channels, method):
    """Summing each band from the ring slots and each column band from the
    H rows at the window offsets gives the dense resampling (float64)."""
    h, w, dh, dw = geo
    rng = np.random.default_rng(h * w + channels)
    x = rng.integers(0, 256, (h, w * channels)).astype(np.float64)
    for batch in (1, 64):
        t = _tables(geo, method, channels, batch=batch)
        out = _walk(t, geo, channels, torch.uint8, x=x)
        index = t.index.numpy()
        hw = t.weights.numpy().astype(np.float64)
        wh = np.zeros((dh, h))
        start, count = index[:dh], index[dh:2 * dh]
        hk = t.taps[0]
        for r in range(dh):
            wh[r, start[r]:start[r] + count[r]] = \
                hw[r * hk:r * hk + count[r]]
        ws, wc = index[2 * dh:2 * dh + dw], index[2 * dh + dw:]
        wcol = hw[dh * hk:].reshape(t.taps[1], dw)
        wwd = np.zeros((dw, w))
        for p in range(dw):
            wwd[p, ws[p]:ws[p] + wc[p]] = wcol[:wc[p], p]
        ref = np.einsum("rwc,pw->rpc", (wh @ x).reshape(dh, w, channels),
                        wwd, optimize=True).reshape(dh, -1)
        np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("geo", CHIP_SHAPES + SWEEP)
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_shared_memory_fits_a_block(geo, channels):
    for method in (LANCZOS_AA, LANCZOS):
        for sample in SAMPLES:
            for compute in ((torch.bfloat16, torch.float32)
                            if sample == torch.uint8 else (torch.float32,)):
                t = _tables(geo, method, channels, sample, compute,
                            batch=1 + 63 * (method == LANCZOS_AA))
                mid = 4 if compute == torch.float32 else 2
                smem = banded.stream_smem(
                    t.pitch, t.stage_rows, t.ring_rows, t.tile_w, t.taps[1],
                    banded.SAMPLE_BYTES[sample], mid)
                assert smem == t.smem <= banded.SMEM_LIMIT
                assert t.pitch * banded.SAMPLE_BYTES[sample] % 16 == 0
                assert 1 <= t.blocks_per_sm <= banded.MAX_BLOCKS_PER_SM


def test_the_packer_raises_where_no_block_fits():
    """A 100,000-row image shrunk to 8 rows needs a ring of tens of
    thousands of rows: no tile fits, and the packer says so rather than
    pick a shape the kernel does not take."""
    with pytest.raises(ValueError, match="shared memory"):
        banded.stream_resize_tables(100000, 8, 64, 32, LANCZOS_AA,
                                    torch.bfloat16, 1, torch.uint8, 1, SMS,
                                    CPU)


def test_ring_rows_refuses_bands_that_do_not_slide_down():
    start = np.array([0, 4, 2, 6], np.int32)
    count = np.full(4, 3, np.int32)
    with pytest.raises(ValueError, match="out of order"):
        banded.ring_rows(start, count, 1)
    assert banded.ring_rows(np.sort(start), count, 1) == \
        {1: 5, 2: 7}[banded.LOOKAHEAD]


@pytest.mark.parametrize("geo", CHIP_SHAPES)
def test_strips_are_whole_stages_and_fill_the_card(geo):
    """Strips are whole stages; the grid has at least half the blocks the
    SMs hold, where the image has that many stages; a larger batch never
    makes the strips shorter at one tile and stage height."""
    h, w, dh, dw = geo
    for batch in (1, 2, 7, 64, 256):
        t = _tables(geo, LANCZOS_AA, 1, batch=batch)
        stages = -(-dh // t.stage_rows)
        assert t.strip_rows % t.stage_rows == 0
        assert t.stage_rows <= t.strip_rows <= stages * t.stage_rows
        tiles = -(-dw // t.tile_w)
        blocks = batch * tiles * -(-dh // t.strip_rows)
        assert 2 * blocks >= min(SMS * t.blocks_per_sm,
                                 batch * tiles * stages)


def test_stream_tables_are_cached_per_geometry_and_sample():
    """A call's tables and geometry are cached; the uploaded band tables
    are shared by every batch size, channel count and sample type of one
    geometry and compute type."""
    a = _tables((96, 256, 40, 120), LANCZOS_AA, 1)
    assert a is _tables((96, 256, 40, 120), LANCZOS_AA, 1)
    assert a is not _tables((96, 256, 40, 120), LANCZOS_AA, 1, torch.uint16)
    for other in (_tables((96, 256, 40, 120), LANCZOS_AA, 1, batch=1),
                  _tables((96, 256, 40, 120), LANCZOS_AA, 3, batch=7)):
        assert other.index is a.index and other.weights is a.weights
    f32 = _tables((96, 256, 40, 120), LANCZOS_AA, 1, torch.uint16)
    assert f32.index is _tables((96, 256, 40, 120), LANCZOS_AA, 2,
                                torch.float32).index


def test_stream_geometry_is_the_cheapest_candidate():
    """The packer's pick is the least estimated cost of the candidates the
    resize lab's sweep times, and every candidate fits a block."""
    bands = banded.stream_bands(1080, 360, 1920, 640, LANCZOS,
                                torch.bfloat16, CPU)
    cands = list(banded.stream_candidates(bands.rows, bands.cols, 3, 1, 2,
                                          1, SMS))
    assert all(geo[5] <= banded.SMEM_LIMIT for _, geo in cands)
    assert min(cands)[1] == banded.stream_geometry(bands.rows, bands.cols,
                                                   3, 1, 2, 1, SMS)
