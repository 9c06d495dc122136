"""vali_tpu_torch preprocess against vali_tpu on the CPU: the dense fused
route against the XLA fused op, the banded kernels' plain versions against
the Pallas kernels in interpret mode, letterboxing, and the wrappers'
argument checks. Inputs are numpy-seeded and fed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vali_tpu.core.enums import ColorRange, ColorSpace, PixelFormat
from vali_tpu.core.formats import format_info
from vali_tpu.ops import fused as jfused
from vali_tpu.ops.pallas_fused import (pallas_nv12_preprocess,
                                       pallas_yuv420_preprocess)
from vali_tpu_torch.ops import fused as tfused
from vali_tpu_torch.ops.banded import kernel_preprocess
from vali_tpu_torch.ops.nv12_preprocess import nv12_preprocess
from vali_tpu_torch.ops.yuv420_preprocess import yuv420_preprocess

NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
BT709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)


def _planes(rng, fmt, b, w, h):
    """numpy storage-layout planes of ``fmt`` with in-range samples."""
    info = format_info(fmt)
    out = []
    for ph, pw in info.plane_dims(w, h):
        if fmt in (PixelFormat.P10, PixelFormat.P12):
            x = rng.integers(0, 1 << info.bit_depth, (b, ph, pw)) << (
                16 - info.bit_depth)
        else:
            hi = 1 << info.bit_depth if info.dtype == np.uint16 else 256
            x = rng.integers(0, hi, (b, ph, pw))
        out.append(x.astype(info.dtype))
    return out


def _assert_u8_close(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert d.max() <= 1
    assert (d > 0).mean() < 1e-3


FUSED_FORMATS = [PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12,
                 PixelFormat.YUV420, PixelFormat.YUV420_10bit,
                 PixelFormat.YUV422, PixelFormat.YUV444]


@pytest.mark.parametrize("mode", ["u8", "f32_norm", "planar"])
@pytest.mark.parametrize("fmt", FUSED_FORMATS)
def test_fused_preprocess_matches_jax(fmt, mode):
    b, w, h, dw, dh = 2, 64, 48, 40, 24
    planes = _planes(np.random.default_rng(int(fmt)), fmt, b, w, h)
    kw = dict(planar=mode == "planar")
    if mode == "f32_norm":
        kw.update(normalize=NORM)
    j = np.asarray(jfused.fused_preprocess(
        tuple(jnp.asarray(p) for p in planes), fmt, w, h, dw, dh,
        out_dtype=jnp.float32 if mode == "f32_norm" else jnp.uint8,
        **BT709, **kw))
    t = tfused.fused_preprocess(
        tuple(torch.from_numpy(p) for p in planes), fmt, w, h, dw, dh,
        out_dtype=torch.float32 if mode == "f32_norm" else torch.uint8,
        **BT709, **kw).numpy()
    assert j.shape == t.shape
    if mode == "f32_norm":
        assert np.abs(j - t).max() <= 1e-5
    else:
        _assert_u8_close(j, t)


def _kernel_pair(fmt, planes, w, h, dw, dh, **kw):
    """(Pallas interpret-mode output, port plain-version output)."""
    jkw = dict(kw)
    tkw = dict(kw)
    if "compute_dtype" in kw:
        jkw["compute_dtype"] = jnp.float32
        tkw["compute_dtype"] = torch.float32
    if "out_dtype" in kw:
        jkw["out_dtype"] = jnp.float32
        tkw["out_dtype"] = torch.float32
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    if fmt in (PixelFormat.NV12, PixelFormat.P10):
        j = pallas_nv12_preprocess(jnp.asarray(planes[0]), interpret=True,
                                   **geo, **jkw)
        t = nv12_preprocess(torch.from_numpy(planes[0]), **geo, **tkw)
    else:
        j = pallas_yuv420_preprocess(*(jnp.asarray(p) for p in planes),
                                     interpret=True, **geo, **jkw)
        t = yuv420_preprocess(*(torch.from_numpy(p) for p in planes),
                              **geo, **tkw)
    return np.asarray(j), t.numpy()


KERNEL_CASES = [
    (PixelFormat.NV12, {}),
    (PixelFormat.NV12, {"compute_dtype": "f32"}),
    (PixelFormat.NV12, {"out_dtype": "f32", "normalize": NORM}),
    (PixelFormat.P10, {"out_dtype": "f32"}),
    (PixelFormat.YUV420, {}),
    (PixelFormat.YUV420, {"compute_dtype": "f32"}),
    (PixelFormat.YUV420, {"out_dtype": "f32", "normalize": NORM}),
    (PixelFormat.YUV420_10bit, {"out_dtype": "f32", "bit_depth": 10}),
]


@pytest.mark.parametrize("fmt,kw", KERNEL_CASES)
def test_kernel_plain_matches_pallas(fmt, kw):
    """Same cast points as the Pallas kernels; only the summation order
    differs."""
    b, h, w, dh, dw = 2, 96, 256, 32, 64
    planes = _planes(np.random.default_rng(5), fmt, b, w, h)
    j, t = _kernel_pair(fmt, planes, w, h, dw, dh, **kw)
    assert j.shape == t.shape == (b, 3, dh, dw)
    if t.dtype == np.uint8:
        _assert_u8_close(j, t)
    else:
        assert np.abs(j - t).max() <= 1e-4


@pytest.mark.parametrize("compute", ["bf16", "f32"])
@pytest.mark.parametrize("geom", [
    (62, 130, 30, 34),     # odd-ish dims, upscale H
    (480, 640, 224, 224),  # 480p -> 224
    (64, 64, 64, 64),      # identity
    (720, 1280, 90, 160),  # 8x downscale
    (36, 100, 100, 36),    # upscale one axis, downscale other
])
def test_kernel_plain_geometry_sweep(geom, compute):
    h, w, dh, dw = geom
    planes = _planes(np.random.default_rng(h + w), PixelFormat.NV12, 1, w, h)
    kw = {"compute_dtype": "f32"} if compute == "f32" else {}
    j, t = _kernel_pair(PixelFormat.NV12, planes, w, h, dw, dh, **kw)
    _assert_u8_close(j, t)


@pytest.mark.parametrize("fmt", [PixelFormat.NV12, PixelFormat.YUV420])
def test_padded_strided_views_match_contiguous(fmt):
    b, h, w, dh, dw = 3, 48, 64, 20, 24
    planes = [torch.from_numpy(p) for p in
              _planes(np.random.default_rng(9), fmt, b, w, h)]
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    views = []
    for p in planes:
        big = torch.zeros((b, p.shape[1] + 5, p.shape[2] + 16), dtype=p.dtype)
        big[:, :p.shape[1], :p.shape[2]] = p
        views.append(big[:, :, :p.shape[2]])
    if fmt == PixelFormat.NV12:
        ref = nv12_preprocess(planes[0], **geo)
        out = nv12_preprocess(views[0], **geo)
    else:
        ref = yuv420_preprocess(*planes, **geo)
        out = yuv420_preprocess(*views, **geo)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("mode", ["u8", "f32_norm"])
def test_letterbox_matches_jax(mode):
    b, w, h, dw, dh = 2, 96, 48, 64, 64
    fmt = PixelFormat.YUV420
    planes = _planes(np.random.default_rng(2), fmt, b, w, h)
    kw = dict(normalize=NORM) if mode == "f32_norm" else {}
    assert jfused.letterbox_params(w, h, dw, dh) == \
        tfused.letterbox_params(w, h, dw, dh)
    j = np.asarray(jfused.letterbox_preprocess(
        tuple(jnp.asarray(p) for p in planes), fmt, w, h, dw, dh,
        out_dtype=jnp.float32 if kw else jnp.uint8, planar=True,
        pad_value=100, **BT709, **kw))
    t = tfused.letterbox_preprocess(
        tuple(torch.from_numpy(p) for p in planes), fmt, w, h, dw, dh,
        out_dtype=torch.float32 if kw else torch.uint8, planar=True,
        pad_value=100, **BT709, **kw).numpy()
    assert j.shape == t.shape == (b, 3, dh, dw)
    if kw:
        assert np.abs(j - t).max() <= 1e-5
    else:
        _assert_u8_close(j, t)


def test_wrappers_reject_bad_arguments():
    geo = dict(src_w=64, src_h=32, dst_w=16, dst_h=16)
    nv = torch.zeros((1, 48, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):  # float input
        nv12_preprocess(nv.float(), **geo)
    with pytest.raises(ValueError):  # too few rows
        nv12_preprocess(nv[:, :40], **geo)
    with pytest.raises(ValueError):  # wrong width
        nv12_preprocess(nv[:, :, :32], **geo)
    with pytest.raises(ValueError):  # unsupported (space, range) pair
        nv12_preprocess(nv, space=ColorSpace.UNSPEC, **geo)
    with pytest.raises(ValueError):  # uint16 input with bf16 compute
        nv12_preprocess(nv.to(torch.int32).to(torch.uint16),
                        compute_dtype=torch.bfloat16, **geo)
    with pytest.raises(ValueError):  # normalize needs a float output
        nv12_preprocess(nv, normalize=NORM, **geo)
    y = torch.zeros((1, 32, 64), dtype=torch.uint8)
    c = torch.zeros((1, 16, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):  # chroma planes of different shapes
        yuv420_preprocess(y, c, c[:, :, :16], **geo)
    with pytest.raises(ValueError):  # mixed sample types
        yuv420_preprocess(y, c.to(torch.int32).to(torch.uint16), c, **geo)
    with pytest.raises(ValueError):  # no kernel for this format
        kernel_preprocess((y, y, y), PixelFormat.YUV444_10bit,
                          out_dtype=torch.uint8, method="lanczos_aa",
                          normalize=None, **BT709, **geo)
