"""The host tables of the resize lab's ``aligned`` kernel
(``csrc/nv12_aligned.cu``, built by ``vali_tpu_torch.lab.resize_diag``) on
the CPU, at the lab's 4K -> 1080p and at the card tests' shapes: every
window inside its plane, the H-pass B and the W-pass A fragments the bf16
bands widened only with zeros, read back in the order the kernel's wgmma
descriptors and register fragments take them; a numpy walk of the tables
through both passes within the uint8 envelope of ``nv12_resize_plain``;
the FLOPs the tables issue; and the refusal."""

import os
import re

import numpy as np
import pytest
import torch

from vali_tpu_torch.lab import resize_diag as rd
from vali_tpu_torch.ops.banded import band_table, core_matrix_order
from vali_tpu_torch.ops.nv12_resize import nv12_resize_plain
from vali_tpu_torch.ops.resize import LANCZOS_AA, resize_weights

R = rd.ALIGNED_ROWS
#: (src_w, src_h, dst_w, dst_h): the lab's, the card tests' and the
#: padded-view test's geometries
GEOMETRIES = [(3840, 2160, 1920, 1080), (512, 288, 256, 144),
              (322, 150, 202, 70), (256, 96, 120, 40)]
#: (h_align, w_align) of the lab's names and the card tests'
ALIGNS = [(8, 32), (32, 128), (4, 16), (4, 8)]


def _planes(geo, h_align, w_align):
    """(n_in, n_out, px, ow, channels, tables) of luma and chroma."""
    sw, sh, dw, dh = geo
    y, c = rd._aligned_planes(sw, sh, dw, dh, h_align, w_align)
    return [(sh, dh, sw, dw, 1, y), (sh // 2, dh // 2, sw // 2, dw // 2, 2,
                                     c)]


def _b_as_read(t):
    """[strips, R, k_pad] of B as the kernel's descriptors read it from the
    core-matrix order the wrapper uploads: element (n, k) of a strip at
    (k // 16) R 16 + (n // 8) 128 + (k mod 16 // 8) 64 + (n mod 8) 8 +
    k mod 8 (k-steps R * 32 bytes apart, 8-row groups 256 bytes, k halves
    128 bytes)."""
    flat = core_matrix_order(t.weights)
    n = np.arange(R)[:, None]
    k = np.arange(t.k_pad)[None, :]
    idx = ((k // 16) * R * 16 + (n // 8) * 128 + (k % 16 // 8) * 64
           + (n % 8) * 8 + k % 8)
    return flat[:, idx]


def _a_as_read(frags, nk):
    """[64, 16 nk] of a tile's A from its fragments as wgmma reads A from
    registers: thread t (warp w, lane l) holds rows 16 w + l // 4 (+8) at
    k 2 (l mod 4) (+1, +8, +9) of each k-step, in the order a0..a7."""
    t = np.arange(128)
    m0 = 16 * (t // 32) + t % 32 // 4
    k0 = 2 * (t % 4)
    rows = m0[:, None] + np.array([0, 0, 8, 8, 0, 0, 8, 8])[None, :]
    cols = k0[:, None] + np.array([0, 1, 0, 1, 8, 9, 8, 9])[None, :]
    a = np.zeros((64, 16 * nk), np.float32)
    for ks in range(nk):
        a[rows, 16 * ks + cols] = frags[ks]
    return a


@pytest.mark.parametrize("h_align,w_align", ALIGNS)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_windows_and_bands_lie_inside_their_planes(geo, h_align, w_align):
    """Each window's rows lie in its plane (a plane shorter than k_pad is
    read whole, the rows past it weigh 0), each tile's band starts on 8
    pixels inside the plane's width rounded up to 16, and the ranges run
    over the tiles in order, each covering its tiles' bands from a first
    byte on 16."""
    for n_in, n_out, px, ow, ch, t in _planes(geo, h_align, w_align):
        assert t.k_pad % 16 == 0 and t.k_pad <= rd.ALIGNED_MAX_K
        strips = -(-n_out // R)
        assert t.weights.shape == (strips, R, t.k_pad)
        assert (t.starts >= 0).all()
        assert ((t.starts + t.k_pad <= n_in) | (t.starts == 0)).all()
        past = t.starts[:, None] + np.arange(t.k_pad)[None, :] >= n_in
        assert not t.weights.transpose(0, 2, 1)[past].any()
        tiles = -(-ow // rd.ALIGNED_W_TILE)
        assert t.heads.shape == (tiles, 3)
        first, c0, nk = t.heads.T
        assert (first == np.concatenate([[0], np.cumsum(nk)[:-1]])).all()
        assert t.frags.shape == (nk.sum(), 128, 8)
        assert (c0 % 8 == 0).all() and (c0 >= 0).all()
        assert (c0 + 16 * nk <= -(-px // 16) * 16).all()
        t0, n, x0, hw = t.ranges.T
        assert t0[0] == 0 and (t0[1:] == (t0 + n)[:-1]).all()
        assert (t0 + n)[-1] == tiles and (n >= 1).all()
        assert ((x0 * ch) % 16 == 0).all() and (hw % 16 == 0).all()
        assert t.hcols == hw.max()
        for r in range(len(t.ranges)):
            tile = slice(t0[r], t0[r] + n[r])
            assert (c0[tile] >= x0[r]).all()
            assert (c0[tile] + 16 * nk[tile] <= x0[r] + hw[r]).all()


@pytest.mark.parametrize("h_align,w_align", ALIGNS)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_weights_are_the_bf16_bands_widened_with_zeros(geo, h_align,
                                                       w_align):
    """B read through the descriptors' layout and A through wgmma's
    fragments hold each output row's and column's bf16 band at its source
    indices and zeros elsewhere; the nonzero weights of a strip lie in its
    window aligned to h_align rows (or the plane's end), those of a column
    in its tap range aligned to w_align // channels pixels."""
    for n_in, n_out, px, ow, ch, t in _planes(geo, h_align, w_align):
        assert np.array_equal(_b_as_read(t), t.weights)
        start, count, w = band_table(resize_weights(n_in, n_out, LANCZOS_AA),
                                     torch.bfloat16)
        for o in range(n_out):
            s, row = divmod(o, R)
            want = np.zeros(n_in + t.k_pad, np.float32)
            want[start[o]:start[o] + count[o]] = w[o, :count[o]]
            got = np.zeros_like(want)
            got[t.starts[s]:t.starts[s] + t.k_pad] = t.weights[s, row]
            assert np.array_equal(got, want), o
        for s in range(t.weights.shape[0]):
            nz = np.flatnonzero(t.weights[s].any(axis=0)) + t.starts[s]
            lo = start[R * s:R * (s + 1)].min() // h_align * h_align
            hi = -(-(start + count)[R * s:R * (s + 1)].max() // h_align) \
                * h_align
            assert lo <= nz.min() and nz.max() < min(hi, n_in)
        cs, cc, cw = band_table(resize_weights(px, ow, LANCZOS_AA),
                                torch.bfloat16)
        walign = max(1, w_align // ch)
        for tile, (first, c0, nk) in enumerate(t.heads):
            a = _a_as_read(t.frags[first:first + nk], nk)
            for m in range(64):
                o = rd.ALIGNED_W_TILE * tile + m
                want = np.zeros(16 * nk, np.float32)
                if o < ow:
                    want[cs[o] - c0:cs[o] - c0 + cc[o]] = cw[o, :cc[o]]
                    lo = cs[o] // walign * walign
                    hi = min(-(-(cs[o] + cc[o]) // walign) * walign, px)
                    assert c0 <= lo and hi <= c0 + 16 * nk
                assert np.array_equal(a[m], want), (tile, m)


def _walk(nv12, geo, h_align, w_align, steps=None):
    """Both passes of the aligned kernel in numpy from its tables, block
    by block as the kernel runs them (fp32 sums, H rows rounded to bf16,
    round half to even and clip), and the FLOPs its products issue a
    frame. ``steps`` is each block's walk over the frames: a list of
    (frames of the H pass or None, the H buffer it writes, frames of the W
    pass or None, the H buffer it reads); by default one H buffer, every
    frame's H pass, then its W pass."""
    sw, sh, dw, dh = geo
    b = nv12.shape[0]
    every = np.arange(b)
    steps = steps or [(every, 0, every, 0)]
    out = np.zeros((b, dh * 3 // 2, dw), np.uint8)
    flops = 0
    for (n_in, n_out, px, ow, ch, t), (row0, orow0) in zip(
            _planes(geo, h_align, w_align), ((0, 0), (sh, dh))):
        plane = nv12[:, row0:row0 + n_in].astype(np.float32)
        bmat = _b_as_read(t)
        amat = [_a_as_read(t.frags[first:first + nk], nk)
                for first, _, nk in t.heads]
        for s in range(bmat.shape[0]):
            rows = np.minimum(t.starts[s] + np.arange(t.k_pad), n_in - 1)
            win = plane[:, rows]                  # [b, k_pad, sw bytes]
            for t0, n, x0, hw in t.ranges.tolist():
                cols = x0 * ch + np.arange(hw * ch)
                hbufs = {}
                for hf, hb, wf, wb in steps:
                    if hf is not None:
                        x = np.zeros((len(hf), t.k_pad, hw * ch), np.float32)
                        x[..., cols < sw] = win[hf][..., cols[cols < sw]]
                        h = torch.from_numpy(bmat[s] @ x).to(
                            torch.bfloat16).float()
                        flops += 2 * R * t.k_pad * hw * ch * len(hf)
                        # chroma's H rows: R U rows, then R V rows
                        hbufs[hb] = torch.cat(
                            [h[..., c::ch] for c in range(ch)], dim=1)
                    if wf is None:
                        continue
                    h = hbufs[wb]
                    assert h.shape[0] == len(wf)
                    for tile in range(t0, t0 + n):
                        _, c0, nk = t.heads[tile].tolist()
                        a = amat[tile]
                        hk = h[..., c0 - x0:c0 - x0 + 16 * nk].numpy()
                        d = np.einsum("mk,bnk->bmn", a, hk)  # [b, 64, ch R]
                        flops += 2 * 64 * 16 * nk * R * ch * len(wf)
                        q = np.clip(np.rint(d), 0, 255).astype(np.uint8)
                        p = rd.ALIGNED_W_TILE * tile + np.arange(64)
                        keep = p < ow
                        for c in range(ch):
                            vals = q[:, keep, c * R:(c + 1) * R]
                            o = R * s + np.arange(R)
                            ok = o < n_out
                            out[np.asarray(wf)[:, None, None],
                                orow0 + o[ok][None, :, None],
                                ch * p[keep][None, None] + c] = \
                                vals[..., ok].transpose(0, 2, 1)
    return out, flops // b


@pytest.mark.parametrize("h_align,w_align", ALIGNS)
@pytest.mark.parametrize("geo,batch", [(GEOMETRIES[0], 1),
                                       (GEOMETRIES[1], 3),
                                       (GEOMETRIES[2], 2),
                                       (GEOMETRIES[3], 3)])
def test_tables_walk_equals_nv12_resize_plain(geo, batch, h_align, w_align):
    """A numpy walk of the tables through both passes is within 1 LSB of
    nv12_resize_plain on fewer than 1e-3 of the samples (fp32 sums in
    another order), and its products issue the FLOPs aligned_work counts."""
    sw, sh, dw, dh = geo
    x = np.random.default_rng(sw + sh + h_align).integers(
        0, 256, (batch, sh * 3 // 2, sw), dtype=np.uint8)
    got, flops = _walk(x, geo, h_align, w_align)
    want = nv12_resize_plain(torch.from_numpy(x), src_w=sw, src_h=sh,
                             dst_w=dw, dst_h=dh).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    nbytes, ops = rd.aligned_work(batch, sw, sh, dw, dh, h_align, w_align)
    assert ops == batch * flops
    assert nbytes == batch * (sh * 3 // 2 * sw + dh * 3 // 2 * dw)


@pytest.mark.parametrize("h_align,w_align", ALIGNS)
@pytest.mark.parametrize("geo", GEOMETRIES + [(256, 96, 64, 48)])
def test_refusal_admits_the_lab_and_test_alignments(geo, h_align, w_align):
    """Every alignment of the lab and the card tests launches at their
    shapes, two blocks an SM."""
    assert rd.aligned_refusal(*geo, h_align, w_align) == ""
    for ch, t in zip((1, 2), rd._aligned_planes(*geo, h_align, w_align)):
        assert rd.aligned_smem_bytes(ch, t.hcols, t.k_pad) \
            <= rd.ALIGNED_TWO_BLOCKS


@pytest.mark.parametrize("geo,why", [
    ((3840, 2160, 64, 16), "windows of .* rows exceed"),
    ((8192, 64, 64, 32), "shared memory"),
])
def test_refusal_refuses_what_does_not_fit(geo, why):
    """Windows over ALIGNED_MAX_K rows, or a block of one tile whose band's
    H rows pass a block's shared memory, are refused before any launch, on
    the CPU too."""
    assert re.search(why, rd.aligned_refusal(*geo, 8, 32))
    sw, sh, dw, dh = geo
    x = torch.zeros((1, sh * 3 // 2, sw), dtype=torch.uint8)
    with pytest.raises(ValueError, match=why):
        rd.aligned_resize(x, src_w=sw, src_h=sh, dst_w=dw, dst_h=dh)


def test_ab_builds_key_on_every_file_the_source_includes(tmp_path,
                                                         monkeypatch):
    """The labs' A/B builds (``_cuda_build.build_source``) name their
    library after the tools, the flags and every file the source includes
    at any depth, beside it first, and build under ``locked_build``'s lock:
    an edited header builds anew, an unchanged tree reuses its library."""
    import shutil
    import types

    from vali_tpu_torch.ops import _cuda_build as cb

    csrc = os.path.join(cb._PKG_DIR, "csrc")
    assert [os.path.basename(f) for f in cb.included_files(
        os.path.join(csrc, "nv12_aligned.cu"))] == [
        "nv12_aligned.cu", "aligned_block.cuh", "aligned_passes.cuh",
        "banded_common.cuh", "wgmma_common.cuh"]
    for name in ("nv12_grouped.cu", "banded_preprocess.cuh",
                 "banded_common.cuh", "wgmma_common.cuh"):
        shutil.copy(os.path.join(csrc, name), tmp_path / name)
    src = str(tmp_path / "nv12_grouped.cu")
    assert sorted(os.path.basename(f) for f in cb.included_files(src)) == [
        "banded_common.cuh", "banded_preprocess.cuh", "nv12_grouped.cu",
        "wgmma_common.cuh"]
    built = []
    monkeypatch.setattr(cb, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cb, "locked_build",
                        lambda path, *a: built.append(path) or path)
    monkeypatch.setattr(cb.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        nv12_grouped_launch=types.SimpleNamespace()))
    sig = {"nv12_grouped_launch":
           cb._LAB_SIGNATURES["nv12_grouped_launch"]}

    def build(*flags):
        cb.build_source(src, "ab", "g", sig, flags, [str(tmp_path)])
        return built[-1]

    first = build()
    assert build() == first
    assert build("-DNV12_GROUPED_KNOCKOUT=1") != first
    with open(tmp_path / "banded_common.cuh", "a") as f:
        f.write("// edited\n")
    assert build() not in (first, built[-2])
