"""vali_tpu_torch's 4:2:2 / 4:4:4 preprocess against vali_tpu on the CPU:
the plain versions of the two banded kernels against the Pallas kernels in
interpret mode, padded and strided views, the band tables of each chroma
layout, and decode -> MultiStreamPipeline on C422 / C444 y4m files on the
dense route and on the kernel route. Inputs are numpy-seeded and fed to
both packages.

Tolerances, and why: uint8 within 1 LSB on < 1e-3 of pixels (the same
cast points, summed in another order, can land on the other side of a
rounding tie); float within 1e-4 (float32 summation order).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vali_tpu.core.enums import ColorRange, ColorSpace, PixelFormat
from vali_tpu.ops import pallas_fused as jpallas
from vali_tpu.pipeline import multistream as jms
from vali_tpu_torch.core.enums import PixelFormat as TF
from vali_tpu_torch.engine.decoder import PyDecoder
from vali_tpu_torch.ops import banded
from vali_tpu_torch.ops.yuv422_preprocess import (yuv422_preprocess,
                                                  yuv422_preprocess_plain)
from vali_tpu_torch.ops.yuv444_preprocess import yuv444_preprocess
from vali_tpu_torch.pipeline import multistream as tms

NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
FMTS = {"422": (PixelFormat.YUV422, jpallas.pallas_yuv422_preprocess,
                yuv422_preprocess, 2),
        "444": (PixelFormat.YUV444, jpallas.pallas_yuv444_preprocess,
                yuv444_preprocess, 1)}


def _planes(rng, layout, b, w, h):
    """numpy uint8 y, u, v planes of a ``layout`` frame batch."""
    cw = w // FMTS[layout][3]
    return [rng.integers(0, 256, (b, h, ww)).astype(np.uint8)
            for ww in (w, cw, cw)]


def _assert_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == np.uint8:
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1
        assert (d > 0).mean() < 1e-3
    else:
        assert np.abs(a.astype(np.float64) - b.astype(np.float64)).max() \
            <= 1e-4


def _pair(layout, planes, w, h, dw, dh, **kw):
    """(Pallas interpret-mode output, port plain-version output)."""
    _, jfn, tfn, _ = FMTS[layout]
    jkw, tkw = dict(kw), dict(kw)
    if jkw.pop("f32_compute", False):
        del tkw["f32_compute"]
        jkw["compute_dtype"] = jnp.float32
        tkw["compute_dtype"] = torch.float32
    if "out_dtype" in kw:
        jkw["out_dtype"] = {"f32": jnp.float32,
                            "bf16": jnp.bfloat16}[kw["out_dtype"]]
        tkw["out_dtype"] = {"f32": torch.float32,
                            "bf16": torch.bfloat16}[kw["out_dtype"]]
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    j = jfn(*(jnp.asarray(p) for p in planes), interpret=True, **geo, **jkw)
    t = tfn(*(torch.from_numpy(p) for p in planes), **geo, **tkw)
    if t.dtype == torch.bfloat16:
        return np.asarray(j.astype(jnp.float32)), t.float().numpy()
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("kw", [
    {},
    {"f32_compute": True},
    {"out_dtype": "f32", "normalize": NORM},
    {"space": ColorSpace.BT_601, "crange": ColorRange.JPEG},
], ids=["u8_bf16", "u8_f32", "f32_norm", "bt601_jpeg"])
@pytest.mark.parametrize("layout", ["422", "444"])
def test_kernel_plain_matches_pallas(layout, kw):
    """Same cast points as the Pallas kernels; only the summation order
    differs."""
    b, h, w, dh, dw = 2, 96, 256, 32, 64
    planes = _planes(np.random.default_rng(5), layout, b, w, h)
    j, t = _pair(layout, planes, w, h, dw, dh, **kw)
    assert t.shape == (b, 3, dh, dw)
    _assert_close(t, j)


def test_bf16_normalized_output_matches_pallas():
    """bfloat16 output: the same float32 value rounded once to bfloat16."""
    b, h, w, dh, dw = 1, 64, 128, 32, 32
    planes = _planes(np.random.default_rng(8), "444", b, w, h)
    j, t = _pair("444", planes, w, h, dw, dh, out_dtype="bf16",
                 normalize=NORM)
    assert np.abs(j - t).max() <= 2.0 ** -7 * np.abs(j).max()


@pytest.mark.parametrize("compute", ["bf16", "f32"])
@pytest.mark.parametrize("geom", [
    (62, 130, 30, 34),     # odd-ish dims, upscale H
    (240, 320, 224, 224),  # upscale W, downscale H
    (64, 64, 64, 64),      # identity
    (36, 100, 100, 36),    # upscale one axis, downscale the other
])
@pytest.mark.parametrize("layout", ["422", "444"])
def test_kernel_plain_geometry_sweep(layout, geom, compute):
    h, w, dh, dw = geom
    planes = _planes(np.random.default_rng(h + w), layout, 1, w, h)
    kw = {"f32_compute": True} if compute == "f32" else {}
    j, t = _pair(layout, planes, w, h, dw, dh, **kw)
    _assert_close(t, j)


@pytest.mark.parametrize("layout", ["422", "444"])
def test_padded_strided_views_match_contiguous(layout):
    b, h, w, dh, dw = 3, 48, 64, 20, 24
    planes = [torch.from_numpy(p) for p in
              _planes(np.random.default_rng(9), layout, b, w, h)]
    fn = FMTS[layout][2]
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    views = []
    for p in planes:
        big = torch.zeros((b, p.shape[1] + 5, p.shape[2] + 16),
                          dtype=p.dtype)
        big[:, :p.shape[1], :p.shape[2]] = p
        views.append(big[:, :, :p.shape[2]])
    assert torch.equal(fn(*views, **geo), fn(*planes, **geo))


def test_wrappers_reject_bad_arguments():
    geo = dict(src_w=64, src_h=32, dst_w=16, dst_h=16)
    y = torch.zeros((1, 32, 64), dtype=torch.uint8)
    half = torch.zeros((1, 32, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):  # 4:2:0-height chroma
        yuv422_preprocess(y, half[:, :16], half[:, :16], **geo)
    with pytest.raises(ValueError):  # half-width chroma for 4:4:4
        yuv444_preprocess(y, half, half, **geo)
    with pytest.raises(ValueError):  # 8-bit only
        yuv444_preprocess(y.to(torch.int32).to(torch.uint16), y, y, **geo)
    with pytest.raises(ValueError):  # bfloat16 or float32 compute only
        yuv422_preprocess(y, half, half, compute_dtype=torch.float16, **geo)
    with pytest.raises(ValueError):  # normalize needs a float output
        yuv444_preprocess(y, y, y, normalize=NORM, **geo)
    with pytest.raises(ValueError):  # odd 4:2:2 width
        yuv422_preprocess_plain(y[:, :, :63], half, half, src_w=63,
                                src_h=32, dst_w=16, dst_h=16)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        yuv444_preprocess(y.to("meta"), y.to("meta"), y.to("meta"), **geo)


# --- band tables of each chroma layout -------------------------------------


@pytest.mark.parametrize("layout", banded.LAYOUTS)
def test_dense_weights_follow_the_layout(layout):
    """4:2:2 chroma rows take the luma row matrix, 4:4:4 chroma both luma
    matrices; the columns of 4:2:2 are the Pallas kernel's half-width
    chroma matrix."""
    w, h, dw, dh = 256, 96, 64, 32
    d = banded.dense_weights(w, h, dw, dh, "lanczos_aa", layout)
    assert d.luma_h.shape == (dh, h) and d.luma_w.shape == (dw, w)
    assert d.chroma_h.shape == (dh, h if layout != "420" else h // 2)
    assert d.chroma_w.shape == (dw, w if layout == "444" else w // 2)
    if layout != "420":
        assert np.array_equal(d.chroma_h, d.luma_h)
    if layout == "444":
        assert np.array_equal(d.chroma_w, d.luma_w)
    else:
        assert np.array_equal(
            d.chroma_w.T, jpallas._plain_w_weights_half(w, dw, "lanczos_aa"))


def test_device_tables_are_cached_per_layout():
    """The layout is part of the table cache's key: the same geometry in
    4:2:0 and 4:4:4 gets different chroma tables."""
    args = (256, 96, 64, 32, "lanczos_aa")
    cpu = torch.device("cpu")
    t420 = banded.device_tables(*args, "420", torch.bfloat16, cpu)
    t444 = banded.device_tables(*args, "444", torch.bfloat16, cpu)
    assert t420 is banded.device_tables(*args, "420", torch.bfloat16, cpu)
    assert not torch.equal(t420.weights, t444.weights)
    assert t444.taps[0] == t444.taps[1] and t444.taps[2] == t444.taps[3]
    with pytest.raises(ValueError):
        banded.dense_weights(*args, "411")


def test_kernel_preprocess_dispatches_the_new_layouts():
    geo = dict(src_w=64, src_h=32, dst_w=16, dst_h=16)
    rng = np.random.default_rng(3)
    for layout, (fmt, _, fn, _) in FMTS.items():
        planes = [torch.from_numpy(p) for p in _planes(rng, layout, 1, 64,
                                                       32)]
        out = banded.kernel_preprocess(
            planes, TF(int(fmt)), space=ColorSpace.BT_709,
            crange=ColorRange.MPEG, out_dtype=torch.uint8,
            method="lanczos_aa", normalize=None, **geo)
        assert torch.equal(out, fn(*planes, **geo))


# --- decode -> MultiStreamPipeline on y4m files ----------------------------


def _y4m(path, layout, w, h, n, seed):
    """A C422 / C444 y4m file of ``n`` random frames, written as the JAX
    package's own pipeline tests write them."""
    rng = np.random.default_rng(seed)
    cw = w // FMTS[layout][3]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{layout}\n".encode())
        for _ in range(n):
            f.write(b"FRAME\n")
            f.write(rng.integers(0, 255, (h, w), np.uint8).tobytes())
            for _ in range(2):
                f.write(rng.integers(0, 255, (h, cw), np.uint8).tobytes())
    return str(path)


def _collect(pipe):
    return [(np.asarray(batch.float() if isinstance(batch, torch.Tensor)
                        else batch.astype(jnp.float32)), list(ids))
            for batch, ids in pipe]


@pytest.mark.parametrize("mode", ["u8", "f32_norm"])
@pytest.mark.parametrize("route", ["dense", "kernel"])
@pytest.mark.parametrize("layout", ["422", "444"])
def test_pipeline_matches_jax(tmp_path, monkeypatch, layout, route, mode):
    """Port decode -> MultiStreamPipeline against vali_tpu's pipeline on
    the same file. On the kernel route both pipelines run their banded
    kernels: the port its plain versions, vali_tpu its Pallas kernels in
    interpret mode."""
    w, h, n = 64, 48, 4
    path = _y4m(tmp_path / f"c{layout}.y4m", layout, w, h, n,
                int(layout) + len(route))
    fmt = FMTS[layout][0]
    dec = PyDecoder(path, {}, gpu_id=-1)
    assert int(dec.Format) == int(fmt) and (dec.Width, dec.Height) == (w, h)
    del dec
    if route == "kernel":
        monkeypatch.setattr(tms, "_kernel_usable", lambda *a: True)
        monkeypatch.setattr(jms, "_pallas_usable", lambda *a: True)
        name = f"pallas_yuv{layout}_preprocess"
        monkeypatch.setattr(jpallas, name, functools.partial(
            getattr(jpallas, name), interpret=True))
        calls = []
        real = getattr(banded, "kernel_preprocess")
        monkeypatch.setattr(tms, "kernel_preprocess",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    jkw, tkw = {}, {}
    if mode == "f32_norm":
        jkw = dict(out_dtype=jnp.float32, normalize=NORM)
        tkw = dict(out_dtype=torch.float32, normalize=NORM)
    ours = _collect(tms.MultiStreamPipeline(
        [path] * 2, 32, 24, gpu_id=-1, sync_streams=True, **tkw))
    ref = _collect(jms.MultiStreamPipeline(
        [path] * 2, 32, 24, gpu_id=0, sync_streams=True, **jkw))
    assert len(ours) == len(ref) == n
    if route == "kernel":
        assert len(calls) == n  # every batch went through the kernel route
    for (a, ida), (b, idb) in zip(ours, ref):
        assert ida == idb == [0, 1]
        assert a.shape == b.shape == (2, 24, 32, 3)
        if mode == "u8":
            _assert_close(a.astype(np.uint8), b.astype(np.uint8))
        else:
            assert np.abs(a - b).max() <= 1e-4
        assert a.std() > 1.0
