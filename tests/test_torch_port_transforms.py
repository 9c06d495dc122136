"""vali_tpu_torch conversions, resizes and Surface transforms against
vali_tpu on the CPU: the 23 conversion pairs and their error cases, the
dense resize for every resizer format, the four kernels' plain versions
against the Pallas kernels in interpret mode, and PySurfaceConverter /
PySurfaceResizer on CPU Surfaces against vali_tpu.transforms. Inputs are
numpy-seeded and fed to both packages.

Tolerances, and why:
  - layout-only conversions: equal (no arithmetic);
  - arithmetic on uint8 (conversions, dense resizes, the resize kernels'
    plain versions): within 1 LSB on < 1e-3 of samples — the same fp32
    arithmetic, summed in another order, can land on the other side of a
    rounding tie;
  - uint16 resizes: within 1 LSB on < 1e-2 of samples — at 16-bit
    magnitudes a float32 ulp is ~1/256 LSB, so order-dependent ties are
    more frequent;
  - float32 results: within 1e-5 relative (float32 summation order);
  - nv12_to_rgb with bfloat16 coefficients: bit-identical (every product
    of a uint8 sample and a bfloat16 coefficient is exact in fp32, and the
    two sums have one rounding each); with float32 coefficients within 1
    LSB on < 1e-3 (the products round).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vali_tpu as jvali
import vali_tpu_torch as tvali
from vali_tpu.core.formats import format_info
from vali_tpu.ops import csc as jcsc
from vali_tpu.ops import resize as jresize
from vali_tpu.ops.pallas_fused import (pallas_nv12_resize, pallas_nv12_to_rgb,
                                       pallas_packed_resize,
                                       pallas_plane_resize)
from vali_tpu_torch.ops import csc as tcsc
from vali_tpu_torch.ops import resize as tresize
from vali_tpu_torch.ops.nv12_resize import nv12_resize
from vali_tpu_torch.ops.nv12_to_rgb import nv12_to_rgb
from vali_tpu_torch.ops.packed_resize import packed_resize
from vali_tpu_torch.ops.plane_resize import plane_resize

TF = tvali.PixelFormat
JF = jvali.PixelFormat
CPU = -1
LAYOUT_PAIRS = {
    (JF.NV12, JF.YUV420), (JF.YUV420, JF.NV12), (JF.P10, JF.NV12),
    (JF.P12, JF.NV12), (JF.RGB, JF.RGB_PLANAR), (JF.RGB_PLANAR, JF.RGB),
    (JF.Y, JF.YUV444), (JF.RGB, JF.BGR), (JF.BGR, JF.RGB), (JF.NV12, JF.Y),
    (JF.RGB_32F, JF.RGB_32F_PLANAR)}
CC = [None] + [(s, r) for s in (jvali.ColorSpace.BT_601,
                                jvali.ColorSpace.BT_709)
               for r in (jvali.ColorRange.JPEG, jvali.ColorRange.MPEG)]


def _samples(rng, fmt, shape):
    """Random samples in ``fmt``'s value range (P10/P12 MSB-aligned)."""
    info = format_info(fmt)
    if info.dtype == np.float32:
        return rng.random(shape, dtype=np.float32)
    if info.dtype == np.uint16:
        x = rng.integers(0, 1 << info.bit_depth, shape)
        if fmt in (JF.P10, JF.P12):
            x <<= 16 - info.bit_depth
        return x.astype(np.uint16)
    return rng.integers(0, 256, shape).astype(np.uint8)


def _planes(rng, fmt, b, w, h):
    return [_samples(rng, fmt, (b, ph, pw))
            for ph, pw in format_info(fmt).plane_dims(w, h)]


def _assert_close(a, b, exact=False):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if exact:
        assert np.array_equal(a, b)
    elif a.dtype == np.float32:
        bound = 1e-5 * np.maximum(np.abs(b), 1.0)
        assert (np.abs(a - b) <= bound).all()
    else:
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert d.max() <= 1
        assert (d > 0).mean() < (1e-3 if a.dtype == np.uint8 else 1e-2)


def _cc_ctx(mod, cc):
    if cc is None:
        return None
    return mod.ColorspaceConversionContext(mod.ColorSpace(int(cc[0])),
                                           mod.ColorRange(int(cc[1])))


@pytest.mark.parametrize("pair", jcsc.supported_conversions(),
                         ids=lambda p: f"{p[0].name}-{p[1].name}")
def test_convert_batch_matches_jax(pair):
    src, dst = pair
    w, h = 32, 16
    planes = _planes(np.random.default_rng(int(src) * 31 + int(dst)), src,
                     2, w, h)
    for cc in CC:
        try:
            j = jcsc.convert_batch(tuple(jnp.asarray(p) for p in planes),
                                   src, dst, w, h, _cc_ctx(jvali, cc),
                                   use_pallas=False)
        except jcsc.UnsupportedConversionParams:
            with pytest.raises(tcsc.UnsupportedConversionParams):
                tcsc.convert_batch(
                    tuple(torch.from_numpy(p) for p in planes),
                    TF(int(src)), TF(int(dst)), w, h, _cc_ctx(tvali, cc),
                    use_kernel=False)
            continue
        t = tcsc.convert_batch(tuple(torch.from_numpy(p) for p in planes),
                               TF(int(src)), TF(int(dst)), w, h,
                               _cc_ctx(tvali, cc), use_kernel=False)
        assert len(j) == len(t)
        for jp, tp in zip(j, t):
            _assert_close(tp.numpy(), jp, exact=pair in LAYOUT_PAIRS)


def test_conversion_registry_and_errors_match_jax():
    assert [(int(a), int(b)) for a, b in tcsc.supported_conversions()] == [
        (int(a), int(b)) for a, b in jcsc.supported_conversions()]
    assert len(tcsc.supported_conversions()) == 23
    nv = np.zeros((1, 24, 16), np.uint8)
    with pytest.raises(KeyError):
        jcsc.convert_batch((jnp.asarray(nv),), JF.NV12, JF.RGB_32F, 16, 16)
    with pytest.raises(KeyError):
        tcsc.convert_batch((torch.from_numpy(nv),), TF.NV12, TF.RGB_32F, 16,
                           16)


@pytest.mark.parametrize("fmt", jresize.SUPPORTED_FORMATS,
                         ids=lambda f: f.name)
def test_dense_resize_batch_matches_jax(fmt):
    assert [int(f) for f in tresize.SUPPORTED_FORMATS] == [
        int(f) for f in jresize.SUPPORTED_FORMATS]
    w, h, dw, dh = 64, 48, 40, 24
    planes = _planes(np.random.default_rng(int(fmt)), fmt, 2, w, h)
    j = jresize.resize_batch(tuple(jnp.asarray(p) for p in planes), fmt, w,
                             h, dw, dh, use_pallas=False)
    t = tresize.resize_batch(tuple(torch.from_numpy(p) for p in planes),
                             TF(int(fmt)), w, h, dw, dh, use_kernel=False)
    for jp, tp in zip(j, t):
        _assert_close(tp.numpy(), jp)


# --- the kernels' plain versions against Pallas in interpret mode --------


@pytest.mark.parametrize("cc,swap", [
    ((jvali.ColorSpace.BT_709, jvali.ColorRange.JPEG), False),
    ((jvali.ColorSpace.BT_709, jvali.ColorRange.MPEG), False),
    ((jvali.ColorSpace.BT_601, jvali.ColorRange.JPEG), True)])
@pytest.mark.parametrize("compute", ["bf16", "f32"])
@pytest.mark.parametrize("geom", [(2, 96, 256), (1, 62, 130)])
def test_nv12_to_rgb_plain_matches_pallas(cc, swap, compute, geom):
    b, h, w = geom
    x = _samples(np.random.default_rng(w + h), JF.NV12, (b, h * 3 // 2, w))
    f32 = compute == "f32"
    j = pallas_nv12_to_rgb(jnp.asarray(x), src_w=w, src_h=h, space=cc[0],
                           crange=cc[1], swap=swap, interpret=True,
                           compute_dtype=jnp.float32 if f32 else None)
    t = nv12_to_rgb(torch.from_numpy(x), src_w=w, src_h=h,
                    space=tvali.ColorSpace(int(cc[0])),
                    crange=tvali.ColorRange(int(cc[1])), swap=swap,
                    compute_dtype=torch.float32 if f32 else None)
    assert t.shape == (b, h, 3 * w)
    _assert_close(t.numpy(), j, exact=not f32)


def _resize_pair(kind, x, w, h, dw, dh, **kw):
    """(Pallas interpret-mode output, port plain-version output)."""
    jkw = {k: (jnp.float32 if v is torch.float32 else v)
           for k, v in kw.items()}
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if kind == "plane":
        return (pallas_plane_resize(xj, src_h=h, dst_h=dh, dst_w=dw,
                                    interpret=True, **jkw),
                plane_resize(xt, src_h=h, dst_h=dh, dst_w=dw, **kw))
    if kind == "packed":
        return (pallas_packed_resize(xj, src_w=w, src_h=h, dst_w=dw,
                                     dst_h=dh, interpret=True, **jkw),
                packed_resize(xt, src_w=w, src_h=h, dst_w=dw, dst_h=dh,
                              **kw))
    return (pallas_nv12_resize(xj, src_w=w, src_h=h, dst_w=dw, dst_h=dh,
                               interpret=True, **jkw),
            nv12_resize(xt, src_w=w, src_h=h, dst_w=dw, dst_h=dh, **kw))


def _resize_input(kind, fmt, b, w, h, seed):
    rng = np.random.default_rng(seed)
    if kind == "plane":
        return _samples(rng, fmt, (b, h, w))
    if kind == "packed":
        return _samples(rng, fmt, (b, h, 3 * w))
    return _samples(rng, fmt, (b, h * 3 // 2, w))


@pytest.mark.parametrize("kind,fmt,kw", [
    ("plane", JF.Y, {}),
    ("plane", JF.Y, {"compute_dtype": torch.float32}),
    ("plane", JF.GRAY12, {}),
    ("plane", JF.RGB_32F_PLANAR, {}),
    ("packed", JF.RGB, {}),
    ("packed", JF.RGB, {"compute_dtype": torch.float32}),
    ("packed", JF.RGB_32F, {}),
    ("nv12", JF.NV12, {}),
    ("nv12", JF.NV12, {"compute_dtype": torch.float32}),
    ("nv12", JF.P10, {}),
], ids=lambda v: getattr(v, "name", str(v)))
def test_resize_kernels_plain_match_pallas(kind, fmt, kw):
    b, h, w, dh, dw = 2, 96, 256, 40, 120
    x = _resize_input(kind, fmt, b, w, h, int(fmt))
    j, t = _resize_pair(kind, x, w, h, dw, dh, **kw)
    rows = dh * 3 // 2 if kind == "nv12" else dh
    assert t.shape == (b, rows, dw * (3 if kind == "packed" else 1))
    _assert_close(t.numpy(), j)


@pytest.mark.parametrize("kind", ["plane", "packed", "nv12"])
@pytest.mark.parametrize("geom", [
    (464, 848, 232, 424, "lanczos_aa"),  # the repo's clip geometry
    (62, 130, 96, 200, "lanczos"),       # upscale, width not x128
    (64, 64, 64, 64, "lanczos"),         # identity
    (96, 200, 40, 70, "bilinear"),       # odd scale factors
    (48, 96, 30, 34, "nearest"),
    (40, 60, 96, 36, "bilinear_aa"),     # upscale one axis, down the other
])
def test_resize_kernels_plain_geometry_sweep(kind, geom):
    h, w, dh, dw, method = geom
    x = _resize_input(kind, JF.NV12 if kind == "nv12" else JF.Y, 1, w, h,
                      h + w)
    j, t = _resize_pair(kind, x, w, h, dw, dh, method=method)
    _assert_close(t.numpy(), j)


def test_kernel_wrappers_reject_bad_arguments():
    u8 = torch.zeros((1, 48, 64), dtype=torch.uint8)
    u16 = torch.zeros((1, 48, 64), dtype=torch.int32).to(torch.uint16)
    for fn in (lambda x, **k: plane_resize(x, src_h=32, dst_h=16, dst_w=16,
                                           **k),
               lambda x, **k: nv12_resize(x, src_w=64, src_h=32, dst_w=16,
                                          dst_h=16, **k)):
        with pytest.raises(ValueError, match="float32"):
            fn(u16, compute_dtype=torch.bfloat16)
        with pytest.raises(ValueError):  # unsupported sample type
            fn(u8.to(torch.int32))
        with pytest.raises(ValueError):  # a 2-D tensor
            fn(u8[0])
        with pytest.raises(ValueError):  # neither CPU nor CUDA
            fn(u8.to("meta"))
    with pytest.raises(ValueError, match="float32"):
        pallas_plane_resize(jnp.zeros((1, 32, 64), jnp.uint16), src_h=32,
                            dst_h=16, dst_w=16, interpret=True,
                            compute_dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        plane_resize(u8.float(), src_h=32, dst_h=16, dst_w=16,
                     compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # wrong packed width
        packed_resize(u8, src_w=64, src_h=32, dst_w=16, dst_h=16)
    with pytest.raises(ValueError):  # odd destination
        nv12_resize(u8, src_w=64, src_h=32, dst_w=15, dst_h=16)
    with pytest.raises(ValueError):  # 8-bit only
        nv12_to_rgb(u16, src_w=64, src_h=32)
    with pytest.raises(ValueError):  # too few rows
        nv12_to_rgb(u8[:, :40], src_w=64, src_h=32)
    with pytest.raises(ValueError):  # unsupported (space, range) pair
        nv12_to_rgb(u8, src_w=64, src_h=32, space=tvali.ColorSpace.UNSPEC)
    with pytest.raises(ValueError):
        nv12_to_rgb(u8.to("meta"), src_w=64, src_h=32)


# --- PySurfaceConverter / PySurfaceResizer on CPU Surfaces ----------------


def _surfaces(fmt, w, h, seed):
    """The same host frame uploaded to a vali_tpu and a vali_tpu_torch
    Surface."""
    from vali_tpu.memory.host import planes_to_host_frame

    frame = planes_to_host_frame(
        [p[0] for p in _planes(np.random.default_rng(seed), fmt, 1, w, h)])
    j = jvali.Surface.Make(fmt, w, h)
    assert jvali.PyFrameUploader(gpu_id=0).Run(frame, j)[0]
    t = tvali.Surface.Make(TF(int(fmt)), w, h, gpu_id=CPU)
    assert tvali.PyFrameUploader(gpu_id=CPU).Run(frame, t)[0]
    return j, t


def _planes_of(surf):
    if isinstance(surf, tvali.Surface):
        return [p.numpy() for p in surf.plane_tensors()]
    return [np.asarray(p) for p in surf.plane_arrays()]


def test_converter_matches_jax_and_kernel_route():
    w, h = 128, 64
    js, ts = _surfaces(JF.NV12, w, h, 11)
    cc = (jvali.ColorSpace.BT_709, jvali.ColorRange.MPEG)
    jd = jvali.Surface.Make(JF.RGB, w, h)
    td = tvali.Surface.Make(TF.RGB, w, h, gpu_id=CPU)
    assert jvali.PySurfaceConverter(gpu_id=0).Run(js, jd,
                                                  _cc_ctx(jvali, cc))[0]
    assert tvali.PySurfaceConverter(gpu_id=CPU).Run(
        ts, td, _cc_ctx(tvali, cc)) == (True, tvali.TaskExecInfo.SUCCESS)
    _assert_close(_planes_of(td)[0], _planes_of(jd)[0])
    # the kernel route (its plain version here) against Pallas
    kd = tvali.Surface.Make(TF.BGR, w, h, gpu_id=CPU)
    conv = tvali.PySurfaceConverter(gpu_id=CPU, use_kernel=True)
    assert conv.RunAsync(ts, kd, _cc_ctx(tvali, cc)) == (
        True, tvali.TaskExecInfo.SUCCESS)
    ev = tvali.CudaStreamEvent(conv.Stream, CPU)
    ev.Record()
    ev.Wait()
    want = pallas_nv12_to_rgb(js.plane_arrays()[0][None], src_w=w, src_h=h,
                              space=cc[0], crange=cc[1], swap=True,
                              interpret=True)
    _assert_close(_planes_of(kd)[0], np.asarray(want)[0], exact=True)


def test_transform_error_codes_match_jax():
    w, h = 64, 48
    js, ts = _surfaces(JF.NV12, w, h, 12)
    for mod, src, kw in ((jvali, js, {"gpu_id": 0}),
                         (tvali, ts, {"gpu_id": CPU})):
        conv = mod.PySurfaceConverter(**kw)
        mk = {} if mod is jvali else {"gpu_id": CPU}
        rgb = mod.Surface.Make(mod.PixelFormat.RGB, w, h, **mk)
        cc = mod.ColorspaceConversionContext(mod.ColorSpace.BT_601,
                                             mod.ColorRange.MPEG)
        assert conv.Run(src, rgb, cc) == (
            False, mod.TaskExecInfo.UNSUPPORTED_FMT_CONV_PARAMS)
        small = mod.Surface.Make(mod.PixelFormat.RGB, 32, 32, **mk)
        assert conv.Run(src, small) == (False,
                                        mod.TaskExecInfo.INVALID_INPUT)
        with pytest.raises(ValueError):
            conv.Run(src, mod.Surface.Make(mod.PixelFormat.RGB_32F, w, h,
                                           **mk))
        assert conv.Run(mod.Surface(), mod.Surface()) == (
            False, mod.TaskExecInfo.INVALID_INPUT)
        res = mod.PySurfaceResizer(mod.PixelFormat.RGB, **kw)
        assert res.Run(src, rgb) == (False,
                                     mod.TaskExecInfo.SRC_DST_FMT_MISMATCH)
        assert res.Format == mod.PixelFormat.RGB
        with pytest.raises(RuntimeError):
            mod.PySurfaceResizer(mod.PixelFormat.YUV444_10bit, **kw)


@pytest.mark.parametrize("fmt,turbo", [
    (JF.RGB, False), (JF.NV12, False), (JF.RGB_32F, False),
    (JF.NV12, True), (JF.P10, True), (JF.YUV420, True), (JF.YUV444, True),
    (JF.RGB_PLANAR, True), (JF.RGB_32F_PLANAR, True), (JF.Y, True),
    (JF.GRAY12, True)], ids=lambda v: getattr(v, "name", str(v)))
def test_resizer_matches_jax(fmt, turbo):
    w, h, dw, dh = 128, 96, 64, 48
    js, ts = _surfaces(fmt, w, h, int(fmt) + 100)
    jd = jvali.Surface.Make(fmt, dw, dh)
    td = tvali.Surface.Make(TF(int(fmt)), dw, dh, gpu_id=CPU)
    assert jvali.PySurfaceResizer(fmt, gpu_id=0, method="lanczos_aa",
                                  turbo=turbo).Run(js, jd)[0]
    assert tvali.PySurfaceResizer(
        TF(int(fmt)), gpu_id=CPU, method="lanczos_aa",
        turbo=turbo).Run(ts, td) == (True, tvali.TaskExecInfo.SUCCESS)
    for tp, jp in zip(_planes_of(td), _planes_of(jd)):
        _assert_close(tp, jp)
