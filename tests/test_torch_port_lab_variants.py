"""vali_tpu_torch's NV12 kernel-variant lab against the TPU notebook
``bench_kernel_variants.py`` on the CPU: the same numpy-seeded NV12 buffer,
padded with ``required_pad_rows`` as the notebook pads it, goes through
each notebook kernel in interpret mode and through the port's wrapper on a
CPU tensor (its plain version). uint8 outputs agree within 1 LSB on fewer
than 1e-3 of the samples (the kernels' envelope); the floor exactly.
Also the wrappers' argument checks and the lab's CPU entry point."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench_kernel_variants as bkv  # noqa: E402
from vali_tpu.ops.pallas_fused import (pallas_nv12_preprocess,  # noqa: E402
                                       required_pad_rows)
from vali_tpu_torch.lab import kernel_variants as kv  # noqa: E402
from vali_tpu_torch.ops.nv12_preprocess import (  # noqa: E402
    nv12_preprocess, nv12_preprocess_plain)

B, H, W, DH, DW = 4, 144, 256, 64, 96
GEO = dict(src_w=W, src_h=H, dst_w=DW, dst_h=DH)


@pytest.fixture(scope="module")
def nv12():
    """[B, H*3/2 + pad, W] uint8, the notebook's padded input."""
    rows = H * 3 // 2 + required_pad_rows(W, H, DH)
    return np.random.default_rng(0).integers(0, 256, (B, rows, W),
                                             dtype=np.uint8)


def _assert_u8_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1
    assert (d > 0).mean() < 1e-3


@pytest.mark.parametrize("variant", ["B", "C", "D"])
def test_variant_kernel_matches_the_notebook(nv12, variant):
    j = bkv.variant_kernel(jnp.asarray(nv12), **GEO, variant=variant,
                           interpret=True)
    t = kv.variant_kernel(torch.from_numpy(nv12), **GEO, variant=variant)
    _assert_u8_close(j, t.numpy())


@pytest.mark.parametrize("tile", [32, 16, 8, 4])
@pytest.mark.parametrize("mode", ["full", "hpass", "wpass"])
def test_prod_like_matches_the_notebook(nv12, mode, tile):
    """The TPU's H-pass tile is the port's strip height; each knock-out
    gives its own output, the same in both packages: through the wrapper
    where the port's kernel runs the mode at that strip height, else
    through the plain version (hpass and wpass at 4 and 8 rows). The
    notebook pads a buffer shorter than its tile's windows need, and wpass
    reads the buffer's last rows, so at 4 and 8 rows both get 64 more
    random rows: one buffer, as given to each."""
    from vali_tpu_torch.lab.prodlike import PRODLIKE_STRIPS

    if tile < 16:
        more = np.random.default_rng(tile).integers(
            0, 256, (B, 64, W), dtype=np.uint8)
        nv12 = np.concatenate([nv12, more], axis=1)
    j = bkv.prod_like(jnp.asarray(nv12), **GEO, mode=mode, tile=tile,
                      interpret=True)
    fn = kv.prod_like if tile in PRODLIKE_STRIPS[mode] else kv.prod_like_plain
    t = fn(torch.from_numpy(nv12), **GEO, mode=mode, rows_per_block=tile)
    _assert_u8_close(j, t.numpy())


@pytest.mark.parametrize("gframes", [2, 4])
def test_multiframe_matches_the_notebook(nv12, gframes):
    j = bkv.multiframe_kernel(jnp.asarray(nv12), **GEO, gframes=gframes,
                              interpret=True)
    t = kv.multiframe(torch.from_numpy(nv12), **GEO, gframes=gframes)
    _assert_u8_close(j, t.numpy())


def test_multiframe_at_8_frames_matches_the_notebook(nv12):
    """M8 (the combo's block walking 8 frames in two rounds of 4) on a
    batch of 8: the notebook's multiframe_kernel at gframes=8 (its 32-row
    tile, align 8) against the port's CPU route, within the envelope."""
    x8 = np.concatenate([nv12, nv12[::-1] ^ 0x5A])
    j = bkv.multiframe_kernel(jnp.asarray(x8), **GEO, gframes=8,
                              interpret=True)
    t = kv.multiframe(torch.from_numpy(x8), **GEO, gframes=8)
    _assert_u8_close(j, t.numpy())


@pytest.mark.parametrize("shortchain", [True, False])
def test_static_kernel_matches_the_notebook(nv12, shortchain):
    j = bkv.static_kernel(jnp.asarray(nv12), **GEO, shortchain=shortchain,
                          interpret=True)
    t = kv.static_kernel(torch.from_numpy(nv12), **GEO,
                         shortchain=shortchain)
    _assert_u8_close(j, t.numpy())


S2_SWEEP = [(32, 8), (16, 8), (24, 8), (48, 8), (32, 32)]


@pytest.mark.parametrize("tile,align", S2_SWEEP)
def test_static_kernel2_matches_the_notebook(nv12, tile, align):
    j = bkv.static_kernel2(jnp.asarray(nv12), **GEO, tile=tile, align=align,
                           interpret=True)
    t = kv.static_kernel2(torch.from_numpy(nv12), **GEO, tile=tile,
                          align=align)
    _assert_u8_close(j, t.numpy())


COMBO = [(2, 32), (4, 32), (2, 64), (1, 64), (2, 16), (4, 16)]


@pytest.mark.parametrize("gframes,tile", COMBO)
def test_combo_kernel_matches_the_notebook(nv12, gframes, tile):
    j = bkv.combo_kernel(jnp.asarray(nv12), **GEO, gframes=gframes,
                         tile=tile, interpret=True)
    t = kv.combo_kernel(torch.from_numpy(nv12), **GEO, gframes=gframes,
                        tile=tile)
    _assert_u8_close(j, t.numpy())


def test_grouped_kernel_matches_the_notebook(nv12):
    j = bkv.grouped_kernel(jnp.asarray(nv12), **GEO, interpret=True)
    t = kv.grouped_kernel(torch.from_numpy(nv12), **GEO)
    _assert_u8_close(j, t.numpy())


def test_transposed_chroma_matches_the_pallas_product(nv12):
    """The notebook's T does not run in interpret mode on the CPU (its
    bf16 x bf16 = f32 transposed products are unimplemented there); it
    asserts its output equal to pallas_nv12_preprocess, so the port's T is
    held to that."""
    j = pallas_nv12_preprocess(jnp.asarray(nv12), **GEO, interpret=True)
    t = kv.transposed_chroma(torch.from_numpy(nv12), **GEO)
    _assert_u8_close(j, t.numpy())


@pytest.mark.parametrize("name", ["S2t%da%d" % p for p in S2_SWEEP] + ["G"]
                         + ["combo%dx%d" % p for p in COMBO]
                         + ["full", "full4", "full8", "full48", "M2", "M8"]
                         + ["S", "Slong", "T", "S16", "Slong16", "T16"])
def test_table_plain_versions_equal_the_product_plain(nv12, name):
    """S2's, the combo's, full's, M*'s, S's, Slong's and T's (S2's at their
    strip height) and G's plain versions compute from their own host
    tables (strip windows with zero taps; block-diagonal matrices over
    stacked windows); each gives the product's plain output bit for bit,
    which checks the tables the kernels read."""
    x = torch.from_numpy(nv12)
    c = kv.case(name, B, nv12.shape[1], **GEO)
    assert c.plain is not None
    assert torch.equal(c.plain(x), nv12_preprocess_plain(x, **GEO))


def test_column_ranges_cover_the_w_bands():
    """At 1080p -> 224, strips of 32 and 48 rows run in 2 output-column
    ranges, 8, 16 and 24 rows at full width; each range's source columns
    hold every W band of its output columns, start on 16-column boundaries
    and fit a block (the earlier CUDA-core designs' ranges, which their
    A/Bs build)."""
    from vali_tpu_torch.ops import banded
    from vali_tpu_torch.ops.resize import LANCZOS_AA

    cpu = torch.device("cpu")
    geo = (1920, 1080, 224, 224, LANCZOS_AA)
    _, _, (ys, yc, _), (cs, cc, _) = banded._nv12_bands(*geo)
    for rows, n in ((8, 1), (16, 1), (24, 1), (32, 2), (48, 2)):
        r = banded.column_ranges(*geo, rows, cpu)
        assert r.n == n, rows
        ext = r.ext.numpy()
        assert (ext % 16 == 0).all()
        assert 2 * rows * (r.y_pitch + r.c_pitch) <= banded.SMEM_LIMIT
        for z in range(n):
            p = np.arange(z * 224 // n, (z + 1) * 224 // n)
            assert ext[z, 0] <= ys[p].min() and (ys + yc)[p].max() <= ext[z, 1]
            assert ext[z, 2] <= 2 * cs[p].min()
            assert 2 * (cs + cc)[p].max() <= ext[z, 3]
    gt = banded.grouped_tables(*geo)
    assert gt.weights.shape == (28, 16, 96)   # a block a strip, K 95 -> 96
    assert (gt.luma_rows, gt.chroma_rows) == (63, 32)


def test_stream_floor_matches_the_notebook(nv12):
    rows = nv12.shape[1]
    j = bkv.dma_floor(jnp.asarray(nv12), rows=rows, W=W, DH=DH, DW=DW,
                      interpret=True)
    t = kv.stream_floor(torch.from_numpy(nv12), rows=rows, W=W, DH=DH,
                        DW=DW)
    assert np.array_equal(np.asarray(j), t.numpy())


def test_full_function_variants_equal_the_product_route(nv12):
    """B, C, D, full and M* compute the product kernel's function: on the
    CPU each is the product plain version, bit for bit, and within the
    envelope of the Pallas product kernel."""
    x = torch.from_numpy(nv12)
    ref = nv12_preprocess(x, **GEO)
    outs = [kv.variant_kernel(x, **GEO, variant=v) for v in kv.VARIANTS]
    outs += [kv.prod_like(x, **GEO, rows_per_block=r) for r in (4, 8, 24)]
    outs += [kv.multiframe(x, **GEO, gframes=g) for g in (1, 2, 4)]
    for out in outs:
        assert torch.equal(out, ref)
    _assert_u8_close(pallas_nv12_preprocess(jnp.asarray(nv12), **GEO,
                                            interpret=True), ref.numpy())


def test_knockouts_read_the_buffer_as_given(nv12):
    """wpass and the floor read the buffer's last DH rows, so extra rows
    change them; the full function ignores rows past H*3/2."""
    x = torch.from_numpy(nv12)
    short = x[:, :H * 3 // 2].contiguous()
    assert torch.equal(kv.prod_like(short, **GEO), kv.prod_like(x, **GEO))
    assert not torch.equal(kv.prod_like(short, **GEO, mode="wpass"),
                           kv.prod_like(x, **GEO, mode="wpass"))
    r = H * 3 // 2
    assert not torch.equal(
        kv.stream_floor(short, rows=r, W=W, DH=DH, DW=DW),
        kv.stream_floor(x, rows=x.shape[1], W=W, DH=DH, DW=DW))


def test_wrappers_reject_bad_arguments(nv12):
    x = torch.from_numpy(nv12)
    before = [w.launches for w in kv.WRAPPERS]
    with pytest.raises(ValueError, match="multiple"):  # B % G
        kv.multiframe(x, **GEO, gframes=3)
    with pytest.raises(ValueError, match="multiple"):
        kv.multiframe(x, **GEO, gframes=0)
    with pytest.raises(ValueError, match="does not match"):  # rows < H*3/2
        kv.variant_kernel(x[:, :H * 3 // 2 - 1], **GEO)
    with pytest.raises(ValueError, match="does not match"):
        kv.prod_like(x[:, :H], **GEO, mode="wpass")
    with pytest.raises(ValueError, match="does not match"):  # width
        kv.multiframe(x[:, :, :W - 16], **GEO, gframes=2)
    with pytest.raises(ValueError, match="uint8"):  # non-uint8 input
        kv.prod_like(x.to(torch.int16), **GEO)
    with pytest.raises(ValueError, match="uint8"):
        kv.variant_kernel(x.float(), **GEO, variant="C")
    with pytest.raises(ValueError, match="uint8"):
        kv.stream_floor(x.to(torch.int32), rows=x.shape[1], W=W, DH=DH,
                        DW=DW)
    with pytest.raises(ValueError, match="variant"):
        kv.variant_kernel(x, **GEO, variant="A")
    with pytest.raises(ValueError, match="mode"):
        kv.prod_like(x, **GEO, mode="dpass")
    with pytest.raises(ValueError, match="rows_per_block"):
        kv.prod_like(x, **GEO, rows_per_block=0)
    with pytest.raises(ValueError, match="dst_w"):  # hpass keeps DW cols
        kv.prod_like(x, src_w=W, src_h=H, dst_w=W + 16, dst_h=DH,
                     mode="hpass")
    with pytest.raises(ValueError, match=r"\[B, "):  # floor rows as given
        kv.stream_floor(x, rows=H * 3 // 2, W=W, DH=DH, DW=DW)
    with pytest.raises(ValueError, match="fit"):
        kv.stream_floor(x, rows=x.shape[1], W=W, DH=DH, DW=W + 1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kv.prod_like(x.to("meta"), **GEO)
    for tile, align in ((0, 8), (32, 0), (-1, 1)):
        with pytest.raises(ValueError, match="tile and align"):
            kv.static_kernel2(x, **GEO, tile=tile, align=align)
    with pytest.raises(ValueError, match="tile"):
        kv.combo_kernel(x, **GEO, gframes=2, tile=0)
    for g in (3, 0, 8):  # B = 4
        with pytest.raises(ValueError, match="multiple"):
            kv.combo_kernel(x, **GEO, gframes=g)
    with pytest.raises(ValueError, match="uint8"):
        kv.grouped_kernel(x.float(), **GEO)
    with pytest.raises(ValueError, match="does not match"):
        kv.transposed_chroma(x[:, :H], **GEO)
    # S, Slong and T on S2's block: at 3840x2160 -> 224 S2's ring, weights
    # and H rows at 32-row strips pass a block's shared memory
    from vali_tpu_torch.ops import banded
    from vali_tpu_torch.ops.resize import LANCZOS_AA

    big = torch.zeros((2, 3240, 3840), dtype=torch.uint8)
    geo4k = dict(src_w=3840, src_h=2160, dst_w=224, dst_h=224)
    t4k = banded.static2_tables(*geo4k.values(), LANCZOS_AA, 32, 8)
    need = banded.static2_smem_bytes(32, t4k.k_luma, t4k.k_chroma)
    assert need > banded.SMEM_LIMIT
    for call in (lambda: kv.static_kernel(big, **geo4k),
                 lambda: kv.static_kernel(big, **geo4k, shortchain=False),
                 lambda: kv.transposed_chroma(big, **geo4k)):
        with pytest.raises(ValueError, match=f"{need} B of shared memory"):
            call()
    # the combo's tensor-core kernel: 32-row strips' ring, weights and H
    # rows at 4K -> 224 need 267,648 B of shared memory; (1, 32) is no
    # instance of it
    with pytest.raises(ValueError, match="267648 B of shared memory"):
        kv.combo_kernel(big, **geo4k, gframes=2, tile=32)
    with pytest.raises(ValueError, match=r"runs \(gframes, tile\)"):
        kv.combo_kernel(big, **geo4k, gframes=1, tile=32)
    kv.prod_like(x, **GEO, mode="hpass")  # a plain version: no launch
    kv.grouped_kernel(x, **GEO)
    kv.static_kernel2(x, **GEO, tile=16, align=8)
    # no launch was counted for plain versions or refusals
    assert [w.launches for w in kv.WRAPPERS] == before


def test_lab_entry_point_on_the_cpu(capsys):
    """The lab's CPU route runs every default name on the plain versions
    and reports maxdiff 0 against the references, timing nothing."""
    assert kv.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    per_name = [ln for ln in lines if ":" in ln and "maxdiff=" in ln]
    assert [ln.split(":")[0] for ln in per_name] == list(kv.DEFAULT_NAMES)
    assert all("maxdiff=0 " in ln for ln in per_name)
    with pytest.raises(ValueError, match="unknown lab name"):
        kv.case("E", *kv.CPU_SIZE[:1], H * 3 // 2, **GEO)


def test_bounds_count_the_bytes_the_function_moves():
    """The bound of a full-function variant is the NV12 input plus the
    planar output over the card's memory rate; wpass reads two DH-row
    slabs; the floor reads every row of the buffer."""
    from vali_tpu_torch.lab.timing import HBM_BYTES_PER_S, bound_ms

    rows = H * 3 // 2
    out = B * 3 * DH * DW
    full = kv.case("A", B, rows, **GEO).work
    assert full[0] == B * rows * W + out
    assert kv.case("wpass", B, rows, **GEO).work[0] == B * 2 * DH * W + out
    assert kv.case("floor", B, rows + 8, **GEO).work[0] == \
        B * (rows + 8) * W + out
    ms, by = bound_ms(*full)
    assert by == "bytes" and ms == pytest.approx(
        full[0] / HBM_BYTES_PER_S * 1e3)
    assert bound_ms(1, 1e15)[1] == "operations"
    # S2, the combo, S, Slong, T, G and the staged B, C, D move the
    # product's bytes and count the FMAs they run, zero taps included:
    # more operations than the product's bands (the combo, S, Slong and T
    # S2's at their strip height, whatever its frames a block or chain)
    for name in ("S", "Slong", "T", "S16", "Slong16", "T16"):
        t = 16 if name.endswith("16") else 32
        assert kv.case(name, B, rows, **GEO).work == kv.static2_work(
            B, **GEO, tile=t, align=8)
    for g, t in COMBO:
        work = kv.case(f"combo{g}x{t}", B, rows, **GEO).work
        assert work == kv.static2_work(B, **GEO, tile=t, align=8)
        assert work[0] == full[0] and work[1] > full[1]
    for name in ("S2t32a8", "S2t16a8", "G", "B", "C", "D"):
        work = kv.case(name, B, rows, **GEO).work
        assert work[0] == full[0] and work[1] > full[1]
    from vali_tpu_torch.lab.timing import preprocess_work
    from vali_tpu_torch.ops.banded import grouped_tables
    from vali_tpu_torch.ops.resize import LANCZOS_AA

    no_h = preprocess_work(B, W, H, DW, DH, h_fmas=0)[1]
    gt = grouped_tables(W, H, DW, DH, LANCZOS_AA)
    g_h = 2 * B * gt.weights.shape[0] * 16 * gt.k_pad * W
    if kv.GROUPED_WPASS == "banded":
        assert kv.case("G", B, rows, **GEO).work[1] == no_h + g_h
    no_hw = preprocess_work(B, W, H, DW, DH, h_fmas=0, w_fmas=0)[1]
    assert kv.grouped_work(B, **GEO, wpass="banded")[1] == no_h + g_h
    assert kv.grouped_work(B, **GEO, wpass="mma")[1] > no_h + g_h
    assert kv.grouped_work(B, **GEO, wpass="mma")[1] > no_hw + g_h


# --- G's tables (csrc/nv12_grouped.cu) --------------------------------------

G_GEOS = [(1920, 1080, 224, 224), (322, 150, 202, 70)]


def _bands(geo):
    from vali_tpu_torch.ops import banded
    from vali_tpu_torch.ops.resize import LANCZOS_AA

    return banded._nv12_bands(*geo, LANCZOS_AA)[:2]


def _g_tables(geo):
    from vali_tpu_torch.ops import banded
    from vali_tpu_torch.ops.resize import LANCZOS_AA

    return (banded.grouped_tables(*geo, LANCZOS_AA),
            banded.grouped_w_tables(*geo, LANCZOS_AA))


@pytest.mark.parametrize("geo", G_GEOS)
def test_grouped_windows_lie_inside_their_planes(geo):
    """Each strip's luma window of luma_rows rows lies inside the Y plane,
    its chroma window inside the src_h / 2 chroma rows, and each covers the
    bands of the strip's rows; K holds both windows, padded to 16."""
    src_w, src_h, dst_w, dst_h = geo
    gt, _ = _g_tables(geo)
    ly, lc = gt.luma_rows, gt.chroma_rows
    assert gt.k_pad % 16 == 0 and ly + lc <= gt.k_pad < ly + lc + 16
    assert gt.weights.shape[:2] == (-(-dst_h // 8), 16)
    for p, (length, n_in) in enumerate(((ly, src_h), (lc, src_h // 2))):
        ws = gt.starts[:, p]
        assert (ws >= 0).all() and (ws + length <= n_in).all()
        start, count, _ = _bands(geo)[p]
        o = np.arange(dst_h)
        assert (ws[o // 8] <= start).all()
        assert (start + count <= ws[o // 8] + length).all()


@pytest.mark.parametrize("geo", G_GEOS)
def test_grouped_weights_are_the_bf16_bands(geo):
    """Every nonzero weight of G's B is the bf16 band's weight at its tap,
    every tap of every band is there once, and each output row's weights
    sum as its band's do; the rows past dst_h and the padding weigh 0."""
    src_w, src_h, dst_w, dst_h = geo
    gt, _ = _g_tables(geo)
    ly = gt.luma_rows
    for p in range(2):
        start, count, w = _bands(geo)[p]
        for o in range(gt.weights.shape[0] * 8):
            row = gt.weights[o // 8, 8 * p + o % 8]
            if o >= dst_h:
                assert not row.any()
                continue
            off = ly * p + start[o] - gt.starts[o // 8, p]
            want = np.zeros_like(row)
            want[off:off + count[o]] = w[o, :count[o]]
            np.testing.assert_array_equal(row, want)
            # correctly rounded sums: independent of the order
            assert math.fsum(row) == math.fsum(w[o])
    assert not gt.weights[:, :8, ly:].any()
    assert not gt.weights[:, 8:, :ly].any()
    assert not gt.weights[:, :, ly + gt.chroma_rows:].any()


@pytest.mark.parametrize("geo", G_GEOS)
def test_grouped_b_order_is_the_descriptor_layout(geo):
    """B uploaded in core-matrix order reads back, through the addresses
    the kernel's descriptor gives (k-steps 512 B apart, the K halves at
    LBO 128 B, the 8-row groups at SBO 256 B, rows 16 B), as the [16, K]
    weights."""
    from vali_tpu_torch.ops.banded import core_matrix_order

    gt, _ = _g_tables(geo)
    flat = core_matrix_order(gt.weights)
    k = np.arange(gt.k_pad)[None, :]
    n = np.arange(16)[:, None]
    byte = (k // 16 * 512 + n // 8 * 256 + k % 16 // 8 * 128 + n % 8 * 16
            + k % 8 * 2)
    for j in range(gt.weights.shape[0]):
        np.testing.assert_array_equal(flat[j][byte // 2], gt.weights[j])


#: wgmma's register fragment of A: 32-bit register i // 2 of thread
#: (warp w, lane 4 g + t) holds rows 16 w + g + dm, k 2 t + dk of a k-step
_A_FRAG = [(0, 0), (0, 1), (8, 0), (8, 1), (0, 8), (0, 9), (8, 8), (8, 9)]


def _d_frag(d, w, g, t, i):
    """Accumulator i of thread (warp w, lane 4 g + t) in wgmma's fp32 D
    layout: row 16 w + g (+8 for i mod 4 >= 2), column 8 (i / 4) + 2 t +
    i mod 2."""
    return d[16 * w + g + 8 * (i % 4 // 2), 8 * (i // 4) + 2 * t + i % 2]


@pytest.mark.parametrize("geo", G_GEOS)
def test_grouped_w_tables_walk_to_the_dense_w_pass(geo):
    """The mma W pass as the kernel reads its tables: each thread's word of
    each k-step placed into A by wgmma's fragment layout, D = A x the H
    rows from the product's first column (8 luma rows; 8 U then 8 V rows),
    then each thread's four pixels from its accumulators as the kernel
    takes them (column 16 w + g (+8), row 2 t (+1): Y dy[e], U dc[e], V
    dc[4 + e]). On random H rows (zeros past the width) this gives the
    dense bf16 W pass of luma and both chroma channels."""
    from vali_tpu_torch.ops import banded
    from vali_tpu_torch.ops.resize import LANCZOS_AA, round_to

    src_w, src_h, dst_w, dst_h = geo
    _, wt = _g_tables(geo)
    rng = np.random.default_rng(1)
    widths = (src_w, src_w // 2, src_w // 2)
    yh, uh, vh = (np.pad(rng.normal(size=(8, n)),
                         ((0, 0), (0, -(-n // 16) * 16 - n)))
                  for n in widths)
    tid = np.arange(128)
    w, g, t = tid // 32, tid % 32 // 4, tid % 4
    got = np.full((3, 8, dst_w), np.nan)
    for tile in range(wt.heads.shape[0]):
        d = []
        for prod, h in enumerate((yh, np.concatenate([uh, vh]))):
            step, c0, nk = wt.heads[tile, prod]
            assert c0 % 8 == 0 and 0 <= c0 and c0 + 16 * nk <= h.shape[1]
            a = np.zeros((64, 16 * nk))
            for ks in range(nk):
                for i, (dm, dk) in enumerate(_A_FRAG):
                    a[16 * w + g + dm, 16 * ks + 2 * t + dk] = \
                        wt.frags[step + ks][:, i]
            d.append(a @ h[:, c0:c0 + 16 * nk].T)
        for e in range(4):
            p = 64 * tile + 16 * w + g + 8 * (e >> 1)
            r = 2 * t + (e & 1)
            ok = p < dst_w
            for ch, (dd, i) in enumerate(((d[0], e), (d[1], e),
                                          (d[1], 4 + e))):
                got[ch, r[ok], p[ok]] = _d_frag(dd, w, g, t, i)[ok]
    dw = banded.dense_weights(*geo, LANCZOS_AA, "420")
    wy, wc = (round_to(m, torch.bfloat16).double().numpy()
              for m in (dw.luma_w, dw.chroma_w))
    want = np.stack([yh[:, :src_w] @ wy.T, uh[:, :src_w // 2] @ wc.T,
                     vh[:, :src_w // 2] @ wc.T])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_grouped_work_is_the_flops_of_its_tables():
    """The work the lab's G case reports is the product's bytes and the
    FLOPs G's tables make its default build issue: [16, K] times every
    column of each strip, and with the mma W pass [64, 16] times 8 rows a
    k-step of each strip, zero weights included; the tail as the
    product's."""
    from vali_tpu_torch.lab.timing import CSC_OPS, preprocess_work

    b, (src_w, src_h, dst_w, dst_h) = 64, G_GEOS[0]
    gt, wt = _g_tables(G_GEOS[0])
    full = preprocess_work(b, src_w, src_h, dst_w, dst_h)
    strips = gt.weights.shape[0]
    h = 2 * strips * 16 * gt.k_pad * src_w
    nk = wt.heads[:, :, 2].sum(axis=0)   # luma (N = 8), U|V (N = 16)
    w = 2 * strips * 64 * 16 * (8 * int(nk[0]) + 16 * int(nk[1]))
    c = kv.case("G", b, src_h * 3 // 2, src_w=src_w, src_h=src_h,
                dst_w=dst_w, dst_h=dst_h)
    tail = CSC_OPS * dst_h * dst_w
    banded_w = full[1] // b - tail - preprocess_work(
        b, src_w, src_h, dst_w, dst_h, w_pass=False)[1] // b + 2 * dst_h * dst_w
    assert c.work[0] == full[0]
    want = h + (w if kv.GROUPED_WPASS == "mma" else banded_w) + tail
    assert c.work[1] == b * want
    assert wt.k_steps == int(wt.heads[:, :, 2].sum())


def test_grouped_wpass_default_matches_the_build():
    """GROUPED_WPASS names the W pass csrc/nv12_grouped.cu builds without
    a -D knob, so the lab's operation count is the default build's."""
    import re

    from vali_tpu_torch.ops import _cuda_build

    src = open(os.path.join(_cuda_build._PKG_DIR, "csrc",
                            "nv12_grouped.cu")).read()
    m = re.search(r"#ifndef NV12_GROUPED_WPASS\n#define NV12_GROUPED_WPASS "
                  r"(\w+)", src)
    assert m and m.group(1) == kv.GROUPED_WPASS


def test_grouped_refuses_what_does_not_fit():
    """Windows over 256 rows (4K -> 32 rows) and H rows too wide for a
    block's shared memory (an 8K frame) are refused before any launch, on
    either device; 1080p and 4K to 224 fit."""
    from vali_tpu_torch.ops import banded
    from vali_tpu_torch.ops.resize import LANCZOS_AA

    def refusal(*geo):
        return banded.grouped_refusal(*geo, LANCZOS_AA)

    assert refusal(1920, 1080, 224, 224) == ""
    assert refusal(3840, 2160, 224, 224) == ""
    assert "exceed" in refusal(3840, 2160, 32, 32)
    assert "shared memory" in refusal(7680, 96, 224, 32)
    assert banded.grouped_smem_bytes(1920, 96) == 109056
    before = kv.grouped_kernel.launches
    x = torch.zeros((1, 144, 7680), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shared memory"):
        kv.grouped_kernel(x, src_w=7680, src_h=96, dst_w=224, dst_h=32)
    assert kv.grouped_kernel.launches == before
