"""vali_tpu_torch's 4K NV12 resize lab against the TPU notebook
``resize_diag.py`` on the CPU: the same numpy-seeded NV12 buffer, with 64
pad rows for the notebook's unclamped row windows, goes through each
notebook kernel in interpret mode (unwritten scratch reads as zero) and
through the port's wrapper on a CPU tensor (its plain version). uint8
outputs agree within 1 LSB on fewer than 1e-3 of the samples (the kernels'
envelope); ``dma_only`` exactly. Also the aligned band tables, the
wrappers' argument checks and the lab's CPU entry point.

The notebook fixes its geometry in module globals (``H, W, DH, DW, DC``)
and caches its jitted functions by input shape, so this module sets them
once, to one geometry, and restores them afterwards."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import resize_diag as nb  # noqa: E402
from vali_tpu_torch.lab import resize_diag as rd  # noqa: E402
from vali_tpu_torch.ops.banded import band_table  # noqa: E402
from vali_tpu_torch.ops.nv12_resize import nv12_resize_plain  # noqa: E402
from vali_tpu_torch.ops.resize import LANCZOS_AA, resize_weights  # noqa: E402

from tests.test_torch_port_skewed_tables import skewed_walk  # noqa: E402

# DW a multiple of LANE_TILE, so the notebook's padded width equals DW
B, H, W, DH, DW = 3, 288, 512, 144, 256
PAD = 64
GEO = dict(src_w=W, src_h=H, dst_w=DW, dst_h=DH)


@pytest.fixture(scope="module", autouse=True)
def notebook_geometry():
    saved = (nb.H, nb.W, nb.DH, nb.DW, nb.DC)
    nb.H, nb.W, nb.DH, nb.DW, nb.DC = H, W, DH, DW, DH // 2
    with pltpu.force_tpu_interpret_mode(
            pltpu.InterpretParams(uninitialized_memory="zero")):
        yield
    nb.H, nb.W, nb.DH, nb.DW, nb.DC = saved


@pytest.fixture(scope="module")
def nv12():
    """[B, H*3/2 + PAD, W] uint8 random samples."""
    return np.random.default_rng(0).integers(
        0, 256, (B, H * 3 // 2 + PAD, W), dtype=np.uint8)


@pytest.fixture(scope="module")
def edges(nv12):
    """Bars of 0 and 255 (period 24 rows): the H pass rings below 0 and
    above 255 there, which pins h_only's truncation and low byte."""
    x = nv12.copy()
    x[:, :H] = np.where((np.arange(H) // 12) % 2, 255, 0).astype(
        np.uint8)[None, :, None]
    return x


def _assert_u8_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1
    assert (d > 0).mean() < 1e-3


@pytest.mark.parametrize("mode", ["dma_only", "h_only", "w_only", "both"])
@pytest.mark.parametrize("frames", ["nv12", "edges"])
def test_knockouts_match_the_notebook(request, mode, frames):
    x = request.getfixturevalue(frames)
    j = np.asarray(nb.variant(jnp.asarray(x), mode=mode))
    t = rd.resize_phases(torch.from_numpy(x), **GEO, mode=mode).numpy()
    if mode == "dma_only":
        assert np.array_equal(j, t)
    else:
        _assert_u8_close(j, t)


def test_h_only_truncates_then_keeps_the_low_byte(edges):
    """Where the H pass rings past 0 and 255 the output is the truncated
    value's low byte: -3.4 -> 253, 257.9 -> 1."""
    x = torch.from_numpy(edges)
    out = rd.resize_phases(x, **GEO, mode="h_only")
    wh = torch.from_numpy(resize_weights(H, DH, LANCZOS_AA)).to(
        torch.bfloat16).float()
    yh = (wh @ x[:, :H, :rd.LANE_TILE].float()).to(torch.bfloat16).float()
    assert yh.min() < -1 and yh.max() > 256
    want = np.trunc(yh.numpy()).astype(np.int64) % 256
    assert np.abs(out[..., :rd.LANE_TILE].numpy().astype(int) - want).max() \
        <= 1
    assert not out[..., rd.LANE_TILE:].any()


@pytest.mark.parametrize("h_align,w_align", [(8, 32), (4, 32), (8, 16)])
def test_aligned_matches_the_notebook(nv12, h_align, w_align):
    j = nb.aligned(jnp.asarray(nv12), h_align=h_align, w_align=w_align)
    t = rd.aligned_resize(torch.from_numpy(nv12), **GEO, h_align=h_align,
                          w_align=w_align)
    _assert_u8_close(j, t.numpy())


def test_skewed_matches_the_notebook(nv12):
    j = nb.skewed(jnp.asarray(nv12))
    _assert_u8_close(j, rd.skewed_resize(torch.from_numpy(nv12),
                                         **GEO).numpy())


@pytest.mark.parametrize("frames_per_block", [2, 16])
def test_skewed_frames_per_block_matches_the_notebook(nv12, frames_per_block,
                                                      monkeypatch):
    """The notebook's skew at its (8, 32) windows against the wrapper's
    CPU route (nv12_resize_plain, whatever G) and against a numpy replay of
    the skewed kernel's walk at G frames a block (2: groups of 2 and 1 of
    the 3 frames; 16: one group of all of them), each block's H pass of a
    frame one step before its W pass, over two H buffers."""
    j = nb.skewed(jnp.asarray(nv12), h_align=8, w_align=32)
    t = rd.skewed_resize(torch.from_numpy(nv12), **GEO, h_align=8,
                         w_align=32, frames_per_block=frames_per_block)
    _assert_u8_close(j, t.numpy())
    assert torch.equal(t, nv12_resize_plain(torch.from_numpy(nv12), **GEO))
    walk, _ = skewed_walk(nv12[:, :H * 3 // 2], (W, H, DW, DH),
                          frames_per_block, monkeypatch)
    _assert_u8_close(j, walk)


@pytest.mark.parametrize("kw,match", [
    (dict(h_align=4), "8, 32 only"), (dict(w_align=16), "8, 32 only"),
    (dict(h_align=32, w_align=128), "8, 32 only"),
    (dict(frames_per_block=0), "frames_per_block"),
    (dict(frames_per_block=-2), "frames_per_block"),
    (dict(frames_per_block=2.0), "frames_per_block")])
def test_skewed_rejects_bad_keywords(nv12, kw, match):
    """An alignment but the notebook's (8, 32), or a G under 1 or not an
    int, is refused on the CPU before any plain run or launch."""
    x = torch.from_numpy(nv12)
    before = [w.launches for w in rd.WRAPPERS]
    with pytest.raises(ValueError, match=match):
        rd.skewed_resize(x, **GEO, **kw)
    with pytest.raises(ValueError, match=match):
        rd.skewed_resize(x.to("meta"), **GEO, **kw)
    assert [w.launches for w in rd.WRAPPERS] == before


@pytest.mark.parametrize("band", [32, 128])
def test_streamed_matches_the_notebook(nv12, band):
    j = nb.streamed(jnp.asarray(nv12), band=band)
    t = rd.streamed_resize(torch.from_numpy(nv12), **GEO, band=band)
    _assert_u8_close(j, t.numpy())


@pytest.mark.parametrize("nslabs", [2, 4])
def test_slabs_matches_the_notebook(nv12, nslabs):
    """Split-K H-pass sums: within the envelope of the notebook and of the
    unsplit product route (only the fp32 summation order differs)."""
    j = nb.slabs(jnp.asarray(nv12), nslabs=nslabs)
    x = torch.from_numpy(nv12)
    t = rd.slabs_resize(x, **GEO, nslabs=nslabs)
    _assert_u8_close(j, t.numpy())
    _assert_u8_close(nv12_resize_plain(x, **GEO).numpy(), t.numpy())


@pytest.mark.parametrize("store", ["dyn", "relay", "unroll"])
@pytest.mark.parametrize("nw", [2, 4])
def test_striped_matches_the_notebook(nv12, nw, store):
    """Stripes never mix columns: equal to nv12_resize_plain bit for bit,
    and within the envelope of the notebook."""
    j = nb.striped(jnp.asarray(nv12), nw=nw, store=store)
    x = torch.from_numpy(nv12)
    t = rd.striped_resize(x, **GEO, nw=nw, store=store)
    _assert_u8_close(j, t.numpy())
    assert torch.equal(t, nv12_resize_plain(x, **GEO))


@pytest.mark.parametrize("src_h,nslabs,want", [
    (288, 2, 224), (288, 4, 128), (2160, 4, 832), (2160, 6, 544),
    (2160, 1, 3264)])
def test_slab_rows_round_up_to_32(src_h, nslabs, want):
    assert rd.slab_rows(src_h, nslabs) == want


@pytest.mark.parametrize("src_w,nw,edges", [
    (512, 2, [0, 256, 512]), (512, 3, [0, 168, 336, 512]),
    (3840, 3, [0, 1280, 2560, 3840]), (3840, 5, [0, 768, 1536, 2304, 3072,
                                                 3840]), (66, 1, [0, 66])])
def test_stripe_edges_are_multiples_of_4(src_w, nw, edges):
    assert rd.stripe_edges(src_w, nw) == edges


def test_full_function_variants_equal_the_product_route(nv12):
    """On the CPU every full-function variant is nv12_resize_plain bit for
    bit, and ``both`` is its luma rows."""
    x = torch.from_numpy(nv12)
    ref = nv12_resize_plain(x, **GEO)
    for name in rd.DEFAULT_NAMES:
        c = rd.case(name, B, **GEO)
        if name == "both":
            assert torch.equal(c.call(x), ref[:, :DH])
        elif c.exact:
            assert torch.equal(c.call(x), ref), name


@pytest.mark.parametrize("h_align,w_align,channels", [
    (8, 32, 1), (32, 128, 1), (4, 16, 2), (3, 5, 1)])
def test_aligned_tables_keep_the_bands(h_align, w_align, channels):
    """Each strip's row window starts at a multiple of h_align (ends at
    one or at the plane), each column's range at a multiple of w_align
    lanes; the product band's weights sit at their source indices and
    every added tap weighs 0."""
    h, w, dh, dw = H // channels, W // channels, DH // channels, \
        DW // channels
    tabs = rd.aligned_tables(h, dh, w, dw, channels=channels,
                             device=torch.device("cpu"), h_align=h_align,
                             w_align=w_align)
    idx = tabs.index.numpy()
    wts = tabs.weights.numpy()
    hk, wk = tabs.taps
    for n_in, n_out, off, k, mat, a, strip in (
            (h, dh, 0, hk, wts[:dh * hk].reshape(dh, hk), h_align, 8),
            (w, dw, 2 * dh, wk, wts[dh * hk:].reshape(wk, dw).T,
             max(1, w_align // channels), 1)):
        start, count = idx[off:off + n_out], idx[off + n_out:off + 2 * n_out]
        assert (start % a == 0).all()
        end = start + count
        assert ((end % a == 0) | (end == n_in)).all()
        for s in range(0, n_out, strip):
            assert len(set(start[s:s + strip])) == 1
        dense = np.zeros((n_out, n_in), np.float32)
        for o in range(n_out):
            dense[o, start[o]:end[o]] = mat[o, :count[o]]
        ps, pc, pw = band_table(resize_weights(n_in, n_out, LANCZOS_AA),
                                torch.bfloat16)
        want = np.zeros_like(dense)
        for o in range(n_out):
            want[o, ps[o]:ps[o] + pc[o]] = pw[o, :pc[o]]
        assert np.array_equal(dense, want)


def test_wrappers_reject_bad_arguments(nv12):
    x = torch.from_numpy(nv12)
    before = [w.launches for w in rd.WRAPPERS]
    with pytest.raises(ValueError, match="mode"):
        rd.resize_phases(x, **GEO, mode="hw_only")
    with pytest.raises(ValueError, match="mode"):
        rd.resize_phases_plain(x, **GEO, mode="full")
    with pytest.raises(ValueError, match="align"):
        rd.aligned_resize(x, **GEO, h_align=0)
    with pytest.raises(ValueError, match="align"):
        rd.aligned_resize(x, **GEO, w_align=0)
    with pytest.raises(ValueError, match="band"):
        rd.streamed_resize(x, **GEO, band=0)
    with pytest.raises(ValueError, match="source rows of a strip"):
        rd.streamed_resize(x, **GEO, band=8)
    with pytest.raises(ValueError, match="uint8"):
        rd.skewed_resize(x.to(torch.int16), **GEO)
    with pytest.raises(ValueError, match="uint8"):
        rd.resize_phases(x.float(), **GEO, mode="both")
    with pytest.raises(ValueError, match="does not match"):  # rows < H*3/2
        rd.streamed_resize(x[:, :H * 3 // 2 - 1], **GEO)
    with pytest.raises(ValueError, match="does not match"):  # width
        rd.aligned_resize(x[:, :, :W - 16], **GEO)
    with pytest.raises(ValueError, match="even"):
        rd.skewed_resize(x, src_w=W, src_h=H, dst_w=DW, dst_h=DH - 1)
    with pytest.raises(ValueError, match="nslabs"):
        rd.slabs_resize(x, **GEO, nslabs=0)
    with pytest.raises(ValueError, match="align"):
        rd.slabs_resize(x, **GEO, h_align=0)
    with pytest.raises(ValueError, match="store"):
        rd.striped_resize(x, **GEO, store="lanes")
    with pytest.raises(ValueError, match="nw"):
        rd.striped_resize(x, **GEO, nw=0)
    with pytest.raises(ValueError, match="narrower"):
        rd.striped_resize(x, **GEO, nw=200)
    with pytest.raises(ValueError, match="unroll"):
        rd.striped_resize(x, **GEO, nw=9, store="unroll")
    for wrapper in rd.WRAPPERS:
        kw = dict(mode="both") if wrapper is rd.resize_phases else {}
        with pytest.raises(ValueError, match="CUDA or CPU"):
            wrapper(x.to("meta"), **GEO, **kw)
    rd.resize_phases(x, **GEO, mode="h_only")  # a plain version: no launch
    assert [w.launches for w in rd.WRAPPERS] == before
    with pytest.raises(ValueError, match="unknown lab name"):
        rd.case("aligned8", B, **GEO)
    with pytest.raises(ValueError, match="unknown lab name"):
        rd.case("striped3", B, **GEO)


def test_lab_entry_point_on_the_cpu(capsys):
    """The lab's CPU route runs every default name on the plain versions
    and reports maxdiff 0 against the references, timing nothing."""
    assert rd.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    per_name = [ln for ln in lines if "maxdiff=" in ln]
    assert [ln.split(":")[0] for ln in per_name] == list(rd.DEFAULT_NAMES)
    assert all("maxdiff=0 " in ln for ln in per_name)


def test_work_counts_the_frame_and_the_output():
    """Every name reads the NV12 frame once; the full-function variants
    write the NV12 output, the knock-outs its luma rows; the bound of a
    full-function variant is the product's. The aligned kernel's
    operations are the FLOPs its tensor-core tables issue, zeros included:
    more than the product's FMAs, and more at the coarser alignment; the
    streamed kernel issues aligned's at 8x32, the slabs kernel those and a
    chain more for each piece past a window's first, the striped kernel
    aligned's W products and each row's H columns once, the skewed kernel
    aligned's on its own column ranges at every G, and the knock-outs
    aligned's at 8x32 but the chroma W products."""
    from vali_tpu_torch.lab.timing import HBM_BYTES_PER_S, bound_ms

    frame = B * H * 3 // 2 * W
    full = rd.case("prod", B, **GEO).work
    assert full[0] == frame + B * DH * 3 // 2 * DW
    skewed = rd.case("skewed", B, **GEO).work
    assert skewed == rd.skewed_work(B, **GEO)
    assert all(rd.case(f"skewed{g}", B, **GEO).work == skewed
               for g in (2, 4, 8))
    assert skewed[0] == full[0] and full[1] < skewed[1]
    fine, coarse = (rd.case(n, B, **GEO).work
                    for n in ("aligned8x32", "aligned32x128"))
    assert fine == rd.aligned_work(B, **GEO, h_align=8, w_align=32)
    for name in ("striped3dyn", "striped5dyn", "striped3relay",
                 "striped3unroll"):
        striped = rd.case(name, B, **GEO).work
        assert striped == rd.striped_work(B, **GEO)
        assert striped[0] == full[0] and full[1] < striped[1] <= fine[1]
    assert rd.case("streamed64", B, **GEO).work == fine
    slabs = rd.case("slabs4", B, **GEO).work
    assert slabs == rd.slabs_work(B, **GEO, nslabs=4)
    assert slabs[0] == full[0] and fine[1] < slabs[1]
    assert fine[0] == coarse[0] == full[0]
    assert full[1] < fine[1] < coarse[1]
    for mode in rd.MODES:
        assert rd.case(mode, B, **GEO).work[0] == frame + B * DH * DW
    assert rd.case("dma_only", B, **GEO).work[1] == 0
    ops = {m: rd.case(m, B, **GEO).work[1] for m in rd.MODES}
    assert ops["both"] == ops["h_only"] + ops["w_only"] < fine[1]
    assert ops == {m: rd.phases_work(B, **GEO, mode=m)[1] for m in rd.MODES}
    ms, by = bound_ms(*full)
    assert by == "bytes" and ms == pytest.approx(
        full[0] / HBM_BYTES_PER_S * 1e3)
