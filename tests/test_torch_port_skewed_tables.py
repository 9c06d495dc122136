"""The host tables and the frame walk of the resize lab's ``skewed`` kernel
(``csrc/nv12_skewed.cu``, built by ``vali_tpu_torch.lab.resize_diag``) on
the CPU: the column ranges cut so that two H buffers, B and the ring leave
a block two to an SM, each range's H columns covering its tiles' bands; a
numpy walk of its tables through both passes, skewed across frames over
two H buffers, within the uint8 envelope of ``nv12_resize_plain`` and
issuing the FLOPs ``skewed_work`` counts; the
grid's groups of frames and each block's steps (every (range, strip,
plane, frame) once, the H buffers handed off without overlap); the
refusal of other alignments; and the instances the source compiles."""

import os
import re

import numpy as np
import pytest
import torch

from vali_tpu_torch.lab import resize_diag as rd
from vali_tpu_torch.ops import _cuda_build
from vali_tpu_torch.ops.nv12_resize import nv12_resize_plain

from tests.test_torch_port_aligned_tables import _walk as _aligned_walk

#: (src_w, src_h, dst_w, dst_h): the lab's, then the card tests' shapes
GEOMETRIES = [(3840, 2160, 1920, 1080), (512, 288, 256, 144),
              (322, 150, 202, 70), (256, 96, 120, 40), (256, 96, 64, 48)]


def _planes(geo):
    sw, sh, dw, dh = geo
    return zip((1, 2), rd._skewed_planes(sw, sh, dw, dh))


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_ranges_fit_two_blocks_an_sm_and_cover_every_band(geo):
    """The fewest column ranges whose block (two H buffers, B, the ring)
    fits two to an SM; each range's H columns start on 16 bytes and hold
    every tile band of its run; the runs split the tiles in order; the
    windows and fragments are aligned's at 8x32."""
    sw, sh, dw, dh = geo
    for (ch, t), a in zip(_planes(geo),
                          rd._aligned_planes(sw, sh, dw, dh, 8, 32)):
        assert rd.skewed_smem_bytes(ch, t.hcols, t.k_pad) \
            <= rd.ALIGNED_TWO_BLOCKS
        n = len(t.ranges)
        if n > 1:
            fewer = rd._column_ranges(t.heads, ch, n - 1)
            assert rd.skewed_smem_bytes(ch, int(fewer[:, 3].max()),
                                        t.k_pad) > rd.ALIGNED_TWO_BLOCKS
        assert t.ranges[0, 0] == 0 and t.ranges[:, 1].sum() == len(t.heads)
        assert (t.ranges[1:, 0] == (t.ranges[:-1, 0]
                                    + t.ranges[:-1, 1])).all()
        for t0, k, x0, hw in t.ranges.tolist():
            assert x0 * ch % 16 == 0 and hw % 16 == 0
            for tile in range(t0, t0 + k):
                _, c0, nk = t.heads[tile].tolist()
                assert x0 <= c0 and c0 + 16 * nk <= x0 + hw
        for f in ("starts", "weights", "heads", "frags"):
            assert np.array_equal(getattr(t, f), getattr(a, f))


def test_4k_takes_eight_ranges_for_two_blocks_an_sm():
    """At 4K aligned's 4 ranges would need 179,456 B (luma) and 177,280 B
    (chroma) with the second H buffer: one block an SM. 8 ranges need
    111,872 B and 110,720 B, two an SM, for 6 % more H columns."""
    geo = (3840, 2160, 1920, 1080)
    y, c = rd._skewed_planes(*geo)
    ay, ac = rd._aligned_planes(*geo, 8, 32)
    assert rd.skewed_smem_bytes(1, ay.hcols, ay.k_pad) == 179456
    assert rd.skewed_smem_bytes(2, ac.hcols, ac.k_pad) == 177280
    assert (len(y.ranges), len(c.ranges)) == (8, 8)
    assert rd.skewed_smem_bytes(1, y.hcols, y.k_pad) == 111872
    assert rd.skewed_smem_bytes(2, c.hcols, c.k_pad) == 110720
    assert (int(y.ranges[:, 3].sum()), int(c.ranges[:, 3].sum())) == \
        (4288, 2144)
    assert rd.skewed_work(16, *geo) == (248832000, 35883319296)


def skewed_walk(nv12, geo, g, monkeypatch):
    """The skewed kernel in numpy: aligned's walk on the skewed tables'
    column ranges, each block taking the steps of :func:`_steps` with
    ``g`` frames a block (None: the batch) over two H buffers; the output
    and the FLOPs a frame."""
    monkeypatch.setattr(rd, "_aligned_planes",
                        lambda *a: rd._skewed_planes(*a[:4]))
    steps = [(None if hf is None else [hf], hb, None if wf is None else [wf],
              wb) for _, _, hf, hb, wf, wb in _steps(nv12.shape[0], g)]
    return _aligned_walk(nv12, geo, 8, 32, steps)


def test_tables_walk_equals_nv12_resize_plain(monkeypatch):
    """A numpy walk of the skewed tables through both passes, frame b's H
    pass one step before its W pass in buffers that alternate, is within 1
    LSB of nv12_resize_plain on fewer than 1e-3 of the samples, and its
    products issue the FLOPs skewed_work counts."""
    geo = GEOMETRIES[1]
    sw, sh, dw, dh = geo
    x = np.random.default_rng(7).integers(0, 256, (2, sh * 3 // 2, sw),
                                          dtype=np.uint8)
    got, flops = skewed_walk(x, geo, None, monkeypatch)
    want = nv12_resize_plain(torch.from_numpy(x), src_w=sw, src_h=sh,
                             dst_w=dw, dst_h=dh).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    assert rd.skewed_work(2, *geo)[1] == 2 * flops


def _steps(batch, g):
    """Each block's steps as nv12_skewed.cu takes them: per grid z and step
    s the frame whose H pass the producer runs into buffer s % 2 and the
    frame whose W pass the consumer runs from buffer (s - 1) % 2."""
    for z, (f0, nf) in enumerate(rd.skewed_groups(batch, g or batch)):
        for s in range(nf + 1):
            yield (z, s, f0 + s if s < nf else None, s % 2,
                   f0 + s - 1 if s > 0 else None, (s - 1) % 2)


@pytest.mark.parametrize("batch", [1, 2, 3, 5, 7, 15, 16, 17, 33])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, None])
def test_grid_visits_every_frame_once_and_hands_off_the_buffers(batch, g):
    """The groups cover the batch in order, G frames each (the last fewer;
    None: the batch, one group); in every block each frame's H pass comes
    one step before its W pass, into the buffer the W pass reads, and no
    step writes the buffer it reads; so over the grid of (range, strip,
    plane) every frame's H and W passes run once per block."""
    g = batch if g is None else g
    groups = rd.skewed_groups(batch, g)
    assert len(groups) == -(-batch // g)
    assert [f for f0, n in groups for f in range(f0, f0 + n)] == \
        list(range(batch))
    assert all(1 <= n <= g for _, n in groups)
    h_at, w_at = {}, {}
    for z, s, hf, hb, wf, wb in _steps(batch, g):
        if hf is not None:
            assert hf not in h_at
            h_at[hf] = (z, s, hb)
        if wf is not None:
            assert wf not in w_at
            w_at[wf] = (z, s, wb)
        if hf is not None and wf is not None:
            assert hb != wb
    assert sorted(h_at) == sorted(w_at) == list(range(batch))
    for f in range(batch):
        (hz, hs, hb), (wz, ws, wb) = h_at[f], w_at[f]
        assert hz == wz and ws == hs + 1 and wb == hb
    visits = {}
    for plane, (ch, t) in enumerate(_planes(GEOMETRIES[1])):
        for r in range(len(t.ranges)):
            for strip in range(t.weights.shape[0]):
                for f0, n in groups:
                    for f in range(f0, f0 + n):
                        key = (plane, r, strip, f)
                        visits[key] = visits.get(key, 0) + 1
    assert set(visits.values()) == {1}
    assert len(visits) == batch * sum(
        len(t.ranges) * t.weights.shape[0] for _, t in
        _planes(GEOMETRIES[1]))


@pytest.mark.parametrize("h_align,w_align", [(4, 32), (8, 16), (32, 128),
                                             (8, 64)])
def test_other_alignments_are_refused(h_align, w_align):
    """skewed runs aligned's windows at 8x32 only: any other alignment is
    refused before any launch, on the CPU as on the card."""
    geo = dict(src_w=512, src_h=288, dst_w=256, dst_h=144)
    assert "8, 32 only" in rd.skewed_refusal(**geo, h_align=h_align,
                                             w_align=w_align)
    x = torch.zeros((2, 432, 512), dtype=torch.uint8)
    with pytest.raises(ValueError, match="8, 32 only"):
        rd.skewed_resize(x, **geo, h_align=h_align, w_align=w_align)
    assert rd.skewed_refusal(**geo, h_align=8, w_align=32) == ""


@pytest.mark.parametrize("geo,why", [
    ((3840, 2160, 64, 16), "windows of .* rows exceed"),
    ((8192, 64, 64, 32), "shared memory"),
])
def test_geometries_that_do_not_fit_are_refused(geo, why):
    sw, sh, dw, dh = geo
    assert re.search(why, rd.skewed_refusal(*geo, 8, 32))
    x = torch.zeros((1, sh * 3 // 2, sw), dtype=torch.uint8)
    with pytest.raises(ValueError, match=why):
        rd.skewed_resize(x, src_w=sw, src_h=sh, dst_w=dw, dst_h=dh)


def test_source_instances_and_roles():
    """nv12_skewed.cu compiles one kernel per K / 16 (1 to 16) and plane;
    the producer's ring waits on a named barrier of its 128 threads, and
    the hand-off is one block barrier a step."""
    src = open(os.path.join(_cuda_build._PKG_DIR, "csrc",
                            "nv12_skewed.cu")).read()
    assert re.findall(r"NV12_SKEWED_NK\((\d+)\)", src) == [
        str(n) for n in range(1, 17)]
    kernel = src[src.index("skewed_kernel(Plane p"):
                 src.index("template <int NK, int CH>\ncudaError_t")]
    assert "issue_stage<kRole>" in kernel
    assert "named_sync(kRingBarrier, kRole)" in kernel
    assert kernel.count("__syncthreads()") == 1
