"""vali_tpu_torch's NV12 kernel-variant lab against the TPU notebook
``bench_kernel_variants.py`` on the CPU: the same numpy-seeded NV12 buffer,
padded with ``required_pad_rows`` as the notebook pads it, goes through
each notebook kernel in interpret mode and through the port's wrapper on a
CPU tensor (its plain version). uint8 outputs agree within 1 LSB on fewer
than 1e-3 of the samples (the kernels' envelope); the floor exactly.
Also the wrappers' argument checks and the lab's CPU entry point."""

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
from vali_tpu_torch.ops.nv12_preprocess import nv12_preprocess  # noqa: E402

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


@pytest.mark.parametrize("tile", [32, 16])
@pytest.mark.parametrize("mode", ["full", "hpass", "wpass"])
def test_prod_like_matches_the_notebook(nv12, mode, tile):
    """The TPU's H-pass tile is the port's strip height; each knock-out
    gives its own output, the same in both packages."""
    j = bkv.prod_like(jnp.asarray(nv12), **GEO, mode=mode, tile=tile,
                      interpret=True)
    t = kv.prod_like(torch.from_numpy(nv12), **GEO, mode=mode,
                     rows_per_block=tile)
    _assert_u8_close(j, t.numpy())


@pytest.mark.parametrize("gframes", [2, 4])
def test_multiframe_matches_the_notebook(nv12, gframes):
    j = bkv.multiframe_kernel(jnp.asarray(nv12), **GEO, gframes=gframes,
                              interpret=True)
    t = kv.multiframe(torch.from_numpy(nv12), **GEO, gframes=gframes)
    _assert_u8_close(j, t.numpy())


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
    kv.prod_like(x, **GEO, mode="hpass")  # a plain version: no launch
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
    full = kv.case("B", B, rows, **GEO).work
    assert full[0] == B * rows * W + out
    assert kv.case("wpass", B, rows, **GEO).work[0] == B * 2 * DH * W + out
    assert kv.case("floor", B, rows + 8, **GEO).work[0] == \
        B * (rows + 8) * W + out
    ms, by = bound_ms(*full)
    assert by == "bytes" and ms == pytest.approx(
        full[0] / HBM_BYTES_PER_S * 1e3)
    assert bound_ms(1, 1e15)[1] == "operations"
