"""The host tables of the resize lab's knock-outs on ``aligned``'s block
(``csrc/nv12_phases.cu``, built by ``vali_tpu_torch.lab.resize_diag``)
on the CPU, at the lab's 4K -> 1080p and at the card tests' shapes: a
numpy walk of the blocks' sink shares (from the ring where they lie in a
window, by element loads where not) that folds every byte of a plane
exactly once; h_only's owned corner pixels; a numpy walk of each mode
through the tables within its plain version's tolerance; h_only's
tolerance at the bf16 steps; the FLOPs each mode issues; the refusal; and
the instances the source compiles."""

import os
import re

import numpy as np
import pytest
import torch

from vali_tpu_torch.lab import resize_diag as rd
from vali_tpu_torch.ops import _cuda_build

from tests.test_torch_port_aligned_tables import _a_as_read, _b_as_read

R = rd.ALIGNED_ROWS
#: (src_w, src_h, dst_w, dst_h): the lab's, then the card tests' shapes
GEOMETRIES = [(3840, 2160, 1920, 1080), (512, 288, 256, 144),
              (322, 150, 202, 70), (256, 96, 120, 40), (256, 144, 128, 72),
              (256, 96, 64, 48)]


def _planes(geo):
    """(n_in, row bytes, channels, tables) of luma and chroma at 8x32."""
    sw, sh, dw, dh = geo
    y, c = rd._aligned_planes(sw, sh, dw, dh, *rd.PHASES_ALIGN)
    return [(sh, sw, 1, y), (sh // 2, sw, 2, c)]


def _shares(t, n_in, row_bytes, channels, own_rows, own_cols):
    """Per (strip, range) block the rectangles of plane bytes it folds, as
    aligned_block.cuh's kWOnly / kDma folds them: rows x bytes [r0, r1) x
    [c0, c1), the first from its ring (its window's rows, the stages'
    columns), the rest by element loads; and how many bytes came from
    the ring."""
    kp = t.k_pad
    out, ring = [], 0
    for s, (lo, hi) in enumerate(own_rows.tolist()):
        w0 = int(t.starts[s])
        for r, (clo, chi) in enumerate(own_cols.tolist()):
            xb0 = int(t.ranges[r, 2]) * channels
            hbytes = int(t.ranges[r, 3]) * channels
            rc1 = min(xb0 + -(-hbytes // 128) * 128, row_bytes)
            wr0, wr1 = max(lo, w0), min(hi, w0 + kp)
            rects = [(wr0, wr1, max(clo, xb0), min(chi, rc1)),
                     (lo, min(hi, w0), clo, chi),
                     (max(lo, w0 + kp), hi, clo, chi),
                     (wr0, wr1, clo, min(chi, xb0)),
                     (wr0, wr1, max(clo, rc1), chi)]
            rects = [q if q[1] > q[0] and q[3] > q[2] else None
                     for q in rects]
            if rects[0]:
                ring += (wr1 - wr0) * (rects[0][3] - rects[0][2])
            out.append([q for q in rects if q])
    return out, ring


def _fold_counts(t, n_in, row_bytes, channels):
    own_rows, own_cols = rd.sink_partition(t, n_in, row_bytes, channels)
    shares, ring = _shares(t, n_in, row_bytes, channels, own_rows, own_cols)
    count = np.zeros((n_in, row_bytes), np.int32)
    for rects in shares:
        for r0, r1, c0, c1 in rects:
            count[r0:r1, c0:c1] += 1
    return count, ring


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_sink_partition_folds_every_byte_once(geo):
    """Every byte of each plane lies in exactly one block's share: the XOR
    of the sink is the frames' XOR. At 4K every share lies in its block's
    window and ring (overlapping windows), so no byte takes an element
    load."""
    for n_in, row_bytes, ch, t in _planes(geo):
        count, ring = _fold_counts(t, n_in, row_bytes, ch)
        assert (count == 1).all(), (ch, np.argwhere(count != 1)[:3])
        if geo[0] == 3840:
            assert ring == n_in * row_bytes


def test_sink_partition_covers_rows_no_window_reads():
    """Windows that leave rows between them (and start below row 0's), or
    column ranges that leave bytes between them: the blocks fold those by
    element loads, each byte still once."""
    n_in, row_bytes, ch, t = _planes(GEOMETRIES[1])[0]
    strips = len(t.starts)
    gappy = t._replace(
        starts=(8 + np.arange(strips) * (t.k_pad + 24)).clip(
            0, n_in - t.k_pad).astype(np.int32),
        ranges=np.array([[0, 2, 16, 64], [2, 2, 160, 96]], np.int32))
    count, ring = _fold_counts(gappy, n_in, row_bytes, ch)
    assert (count == 1).all()
    assert 0 < ring < n_in * row_bytes


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_h_only_owners_store_each_corner_pixel_once(geo):
    """The pixels below LANE_TILE are stored once, each by a range whose H
    columns hold it, the lowest such range; ranges past the corner store
    none."""
    sw, sh, dw, dh = geo
    y = _planes(geo)[0][3]
    lanes = min(rd.LANE_TILE, dw, sw)
    own = rd.phases_tables(*geo)[4]
    assert np.array_equal(own, rd.h_only_owners(y, lanes))
    seen = np.zeros(lanes, int)
    for r, (lo, hi) in enumerate(own.tolist()):
        seen[lo:hi] += 1
        x0, n = int(y.ranges[r, 2]), int(y.ranges[r, 3])
        assert hi <= lo or (x0 <= lo and hi <= x0 + n)
        for q in range(r):
            qx0, qn = int(y.ranges[q, 2]), int(y.ranges[q, 3])
            assert hi <= lo or lo >= qx0 + qn
    assert (seen == 1).all()


def test_h_only_owners_refuse_an_uncovered_pixel():
    y = _planes(GEOMETRIES[1])[0][3]
    narrow = y._replace(ranges=np.array([[0, 4, 32, 64]], np.int32))
    with pytest.raises(ValueError, match="no column range holds pixel 0"):
        rd.h_only_owners(narrow, 128)


def _h_sums(x, t, n_in, row0, channels, sw):
    """[b, strips * R, sw bytes] bf16-rounded H sums of a plane from the
    tables, each range's columns as its block computes them (fp32 sums)."""
    b = x.shape[0]
    plane = x[:, row0:row0 + n_in].astype(np.float32)
    bmat = _b_as_read(t)
    out = np.zeros((b, bmat.shape[0] * R, sw), np.float32)
    for s in range(bmat.shape[0]):
        rows = np.minimum(t.starts[s] + np.arange(t.k_pad), n_in - 1)
        win = plane[:, rows]
        h = np.einsum("nk,bkc->bnc", bmat[s], win)
        out[:, s * R:(s + 1) * R] = torch.from_numpy(h).to(
            torch.bfloat16).float().numpy()
    return out


def _walk(x, geo, mode):
    """The luma output of a knock-out in numpy, block by block as
    aligned_block.cuh runs the mode from the tables: h_only stores the
    owned corner pixels' low bytes, zeros elsewhere; w_only multiplies
    strip 0's H rows (the frame's first rows) and the other strips' zeros
    by each tile's A; dma_only copies the corner."""
    sw, sh, dw, dh = geo
    b = x.shape[0]
    y = _planes(geo)[0][3]
    rows_out = min(32, dh, sh * 3 // 2)
    lanes = min(rd.LANE_TILE, dw, sw)
    out = np.zeros((b, dh, dw), np.uint8)
    if mode == "dma_only":
        out[:, :rows_out, :lanes] = x[:, :rows_out, :lanes]
    elif mode == "h_only":
        sums = _h_sums(x, y, sh, 0, 1, sw)[:, :dh]
        for lo, hi in rd.phases_tables(*geo)[4].tolist():
            out[..., lo:hi] = (np.trunc(sums[..., lo:hi]).astype(np.int64)
                               & 255).astype(np.uint8)
    elif mode == "w_only":
        h = np.zeros((b, dh, sw), np.float32)
        h[:, :rows_out] = x[:, :rows_out]
        for t0, n, x0, hw in y.ranges.tolist():
            for tile in range(t0, t0 + n):
                first, c0, nk = y.heads[tile].tolist()
                a = _a_as_read(y.frags[first:first + nk], nk)
                cols = c0 + np.arange(16 * nk)
                hk = np.where(cols < sw, h[..., np.minimum(cols, sw - 1)], 0)
                d = np.einsum("mk,bok->bom", a, hk)
                p = rd.ALIGNED_W_TILE * tile + np.arange(64)
                keep = p < dw
                out[..., p[keep]] = np.clip(np.rint(d[..., keep]), 0, 255)
    return out


@pytest.mark.parametrize("mode", ["h_only", "w_only", "dma_only"])
@pytest.mark.parametrize("geo", GEOMETRIES[1:])
def test_walk_is_within_the_plain_versions_tolerance(geo, mode):
    """A numpy walk of each mode through the tables lies within its lab
    case's tolerance of resize_phases_plain (h_only: the low bytes mod
    256 within h_only_tolerance; w_only: the uint8 envelope; dma_only:
    equal), on frames whose H sums ring past 0 and 255."""
    sw, sh, dw, dh = geo
    x = np.random.default_rng(sw + sh).integers(
        0, 256, (2, sh * 3 // 2, sw), dtype=np.uint8)
    x[1, :sh] = np.where((np.arange(sh) // 6) % 2, 255, 0).astype(
        np.uint8)[:, None]
    got = torch.from_numpy(_walk(x, geo, mode))
    c = rd.case(mode, 2, *geo)
    assert c.within(got, torch.from_numpy(x))
    if mode == "dma_only":
        assert torch.equal(got, c.plain(torch.from_numpy(x)))


@pytest.mark.parametrize("v,want", [
    (0.4, 1), (-0.6, 1), (127.5, 1), (255.0, 1), (255.9, 1), (256.0, 2),
    (300.7, 2), (511.0, 2), (512.0, 4), (-3.4, 1), (-255.0, 1),
    (-256.0, 2), (-300.0, 2)])
def test_h_sum_tolerance_is_one_bf16_ulp_at_least_1(v, want):
    assert int(rd.h_sum_tolerance(torch.tensor([v]))[0]) == want


@pytest.mark.parametrize("v", [255.5, 255.9, 256.0, 257.0, 511.0, 510.0,
                               512.0, -0.4, -1.0, -1.2, -255.9, -256.0,
                               -300.0, 127.9, 128.0, 0.0])
def test_a_sum_one_ulp_apart_stays_within_the_tolerance(v):
    """Where the tensor cores' sum rounds to the bf16 value one ulp from
    the plain version's, the stored low bytes lie within h_sum_tolerance
    of each other the nearer way round: 255.x against 256 reads 255
    against 0, 511 against 512 reads 255 against 0, -1 against -0.99 reads
    255 against 0."""
    b = torch.tensor([v]).to(torch.bfloat16)
    tol = int(rd.h_sum_tolerance(b.float())[0])
    for step in (-1, 1):
        n = torch.nextafter(b, torch.tensor([step * 1e9]).to(torch.bfloat16))
        lo = (b.float().to(torch.int32) & 255).to(torch.uint8)
        hi = (n.float().to(torch.int32) & 255).to(torch.uint8)
        assert int(rd.wrap_distance(lo, hi)[0]) <= tol, (v, step, lo, hi)


def test_h_only_tolerance_is_zero_past_the_corner():
    geo = dict(src_w=256, src_h=96, dst_w=200, dst_h=40)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 144, 256), dtype=np.uint8))
    tol = rd.h_only_tolerance(x, **geo)
    assert tol.shape == (2, 40, 200)
    assert (tol[..., :128] >= 1).all() and not tol[..., 128:].any()


def test_phases_work_at_4k():
    """16 x 4K -> 1080p: 232.2 MB in and out a batch for every mode (the
    frames and the luma rows; 0.069 ms at 3.35 TB/s); the products issued
    from aligned's tables at 8x32 and its 4 column ranges, zeros included:
    h_only the H products of both planes, w_only the luma W products, both
    the sum; aligned8x32 issues both's and the chroma W products."""
    geo = (3840, 2160, 1920, 1080)
    work = {m: rd.phases_work(16, *geo, mode=m) for m in rd.MODES}
    assert {w[0] for w in work.values()} == {232243200}
    assert work["dma_only"][1] == 0
    assert work["h_only"][1] == 16845373440
    assert work["w_only"][1] == 12691963904
    assert work["both"][1] == work["h_only"][1] + work["w_only"][1]
    (yh, yw), (ch, cw) = (rd._plane_fmas(t, c) for _, _, c, t in
                          _planes(geo))
    assert work["h_only"][1] == 2 * 16 * (yh + ch)
    assert rd.aligned_work(16, *geo, 8, 32)[1] == \
        work["both"][1] + 2 * 16 * cw


@pytest.mark.parametrize("geo,why", [
    ((3840, 2160, 64, 16), "windows of .* rows exceed"),
    ((8192, 64, 64, 32), "shared memory"),
])
def test_refusal_refuses_before_a_launch(geo, why):
    """What aligned's block at 8x32 cannot take is refused by the
    knock-outs too, on the CPU as on the card."""
    assert re.search(why, rd.phases_refusal(*geo))
    sw, sh, dw, dh = geo
    x = torch.zeros((1, sh * 3 // 2, sw), dtype=torch.uint8)
    for mode in rd.MODES:
        with pytest.raises(ValueError, match=why):
            rd.resize_phases(x, src_w=sw, src_h=sh, dst_w=dw, dst_h=dh,
                             mode=mode)


def test_source_instances_signature_and_the_cuda_core_lab_gone():
    """nv12_phases.cu compiles the modes with H products per K / 16 (1 to
    16, as aligned) and the others once; both and aligned run
    aligned_block.cuh's block; the launchers' ctypes signatures are the
    labs'; csrc/nv12_resize_variants.cu and its kernels are gone."""
    csrc = os.path.join(_cuda_build._PKG_DIR, "csrc")
    src = open(os.path.join(csrc, "nv12_phases.cu")).read()
    assert re.findall(r"NV12_PHASES_NK\((\d+)\)", src) == [
        str(n) for n in range(1, 17)]
    assert "launch_nk<0, CH, MODE>" in src
    for name in ("nv12_phases.cu", "nv12_skewed.cu", "nv12_aligned.cu"):
        assert '#include "aligned_block.cuh"' in open(
            os.path.join(csrc, name)).read()
        assert f"csrc/{name}" in _cuda_build._LAB_SOURCES
    assert "csrc/aligned_block.cuh" in _cuda_build._HEADERS
    for name in ("nv12_resize_phases_launch", "nv12_resize_skewed_launch"):
        assert name in _cuda_build._LAB_SIGNATURES
    assert not os.path.exists(os.path.join(csrc, "nv12_resize_variants.cu"))
    assert "csrc/nv12_resize_variants.cu" not in _cuda_build._LAB_SOURCES
    for name in os.listdir(csrc):
        text = open(os.path.join(csrc, name)).read()
        assert "strip_kernel" not in text and "skewed_plane(" not in text, \
            name
