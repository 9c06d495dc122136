"""vali_tpu_torch's rotator, UD op and host frame converter against
vali_tpu on the CPU: ``rotate_batch`` and ``PySurfaceRotator`` for every
supported format at the right angles (the YUV422 chroma case included) and
at arbitrary angles, ``ud_batch`` and ``PySurfaceUD`` for every supported
conversion, and ``PyFrameConverter`` over the shared native engine. Inputs
are numpy-seeded and fed to both packages.

Tolerances, and why:
  - right angles: equal (pure data movement), except the YUV422 chroma at
    90/270, a 2-tap mean rounded the same way: equal too;
  - arbitrary angles: uint8 / uint16 within 1 LSB on < 1e-3 of samples,
    float32 within 1e-5 relative — the same fp32 bilinear arithmetic, with
    sin/cos and the sums possibly one float32 ulp apart;
  - UD: uint8 within 1 LSB on < 1e-3 of samples (fp32 products summed in
    another order before the floor), uint16 within 1 LSB on < 1e-2 (at
    16-bit magnitudes a float32 ulp is ~1/256 LSB, so order-dependent
    ties are more frequent), float32 within 1e-5;
  - the frame converter: byte for byte (the same native code).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vali_tpu as jvali
import vali_tpu_torch as tvali
from vali_tpu.core.formats import format_info
from vali_tpu.memory.host import planes_to_host_frame
from vali_tpu.ops import rotate as jrotate
from vali_tpu.ops import ud as jud
from vali_tpu_torch.ops import rotate as trotate
from vali_tpu_torch.ops import ud as tud

JF = jvali.PixelFormat
TF = tvali.PixelFormat
CPU = -1
OK = (True, tvali.TaskExecInfo.SUCCESS)


def _samples(rng, fmt, shape):
    """Random samples in ``fmt``'s value range (P10 MSB-aligned)."""
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


def _assert_close(a, b, exact=False, u16_frac=1e-3):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if exact:
        assert np.array_equal(a, b)
    elif a.dtype == np.float32:
        assert (np.abs(a - b) <= 1e-5 * np.maximum(np.abs(b), 1.0)).all()
    else:
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert d.max() <= 1
        assert (d > 0).mean() < (1e-3 if a.dtype == np.uint8 else u16_frac)


def _both(fn_j, fn_t, planes, *args):
    """The same numpy planes through a vali_tpu and a vali_tpu_torch batched
    op; (jax outputs, torch outputs) as numpy arrays."""
    j = fn_j(tuple(jnp.asarray(p) for p in planes), *args)
    t = fn_t(tuple(torch.from_numpy(p) for p in planes), *args)
    assert len(j) == len(t)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


W, H = 32, 24
ROT_FORMATS = [JF(int(f)) for f in trotate.SUPPORTED_FORMATS]


def test_supported_formats_match():
    assert [int(f) for f in trotate.SUPPORTED_FORMATS] == [
        int(f) for f in jrotate.SUPPORTED_FORMATS]
    assert [(int(a), int(b)) for a, b in tud.SUPPORTED_CONVERSIONS] == [
        (int(a), int(b)) for a, b in jud.SUPPORTED_CONVERSIONS]
    for args in ((90.0, 0.0, 0.0, W, H), (-90.0, 0.0, 0.0, W, H),
                 (540.0, 0.0, 0.0, W, H), (90.0, 3.0, 1.0, W, H),
                 (33.5, 0.0, 0.0, W, H)):
        assert trotate.normalize_right_angle(*args) == \
            jrotate.normalize_right_angle(*args)


@pytest.mark.parametrize("angle", [0.0, 90.0, 180.0, 270.0])
@pytest.mark.parametrize("fmt", ROT_FORMATS, ids=lambda f: f.name)
def test_rotate_batch_right_angles_match_jax(fmt, angle):
    """Bit-equal, YUV422 chroma at 90/270 included (rotated at full
    resolution, then a 2-tap mean)."""
    planes = _planes(np.random.default_rng(int(fmt) + int(angle)), fmt, 2,
                     W, H)
    dw, dh = (H, W) if angle in (90.0, 270.0) else (W, H)
    j, t = _both(lambda p, *a: jrotate.rotate_batch(p, fmt, *a),
                 lambda p, *a: trotate.rotate_batch(p, TF(int(fmt)), *a),
                 planes, W, H, dw, dh, angle)
    for jp, tp in zip(j, t):
        _assert_close(tp, jp, exact=True)
    if fmt != JF.YUV422 or angle in (0.0, 180.0):
        # plain rot90 of every plane
        k = int(angle) // 90
        if fmt in (JF.Y, JF.GRAY12, JF.YUV420, JF.YUV444, JF.YUV444_10bit,
                   JF.YUV420_10bit, JF.YUV422):
            for p, tp in zip(planes, t):
                assert np.array_equal(tp, np.rot90(p, k, axes=(1, 2)))


@pytest.mark.parametrize("fmt", ROT_FORMATS, ids=lambda f: f.name)
def test_rotate_batch_arbitrary_angles_match_jax(fmt):
    planes = _planes(np.random.default_rng(int(fmt) + 7), fmt, 2, W, H)
    for angle, sx, sy in ((33.5, 0.0, 0.0), (-17.25, 5.0, 3.0),
                          (90.0, 3.5, 1.0), (200.5, W / 2, H / 2)):
        j, t = _both(lambda p, *a: jrotate.rotate_batch(p, fmt, *a),
                     lambda p, *a: trotate.rotate_batch(p, TF(int(fmt)),
                                                        *a),
                     planes, W, H, W, H, angle, sx, sy)
        for jp, tp in zip(j, t):
            _assert_close(tp, jp)
            assert np.asarray(tp).std() > 0


def test_rotate_mismatched_canvas_falls_back_to_the_sampler():
    """A right angle into a canvas of another extent fills exactly that
    canvas, out-of-frame pixels zero, as the JAX package does."""
    planes = _planes(np.random.default_rng(3), JF.Y, 1, W, H)
    j, t = _both(lambda p, *a: jrotate.rotate_batch(p, JF.Y, *a),
                 lambda p, *a: trotate.rotate_batch(p, TF.Y, *a),
                 planes, W, H, W, H, 90.0)
    _assert_close(t[0], j[0], exact=True)
    assert (t[0] == 0).any()


# --- Surface ops --------------------------------------------------------


def _surfaces(fmt, w, h, seed):
    """The same host frame uploaded to a vali_tpu and a vali_tpu_torch
    Surface."""
    frame = planes_to_host_frame(
        [p[0] for p in _planes(np.random.default_rng(seed), fmt, 1, w, h)])
    j = jvali.Surface.Make(fmt, w, h)
    assert jvali.PyFrameUploader(gpu_id=0).Run(frame, j)[0]
    t = tvali.Surface.Make(TF(int(fmt)), w, h, gpu_id=CPU)
    assert tvali.PyFrameUploader(gpu_id=CPU).Run(frame, t) == OK
    return j, t


def _planes_of(surf):
    if isinstance(surf, tvali.Surface):
        return [p.numpy() for p in surf.plane_tensors()]
    return [np.asarray(p) for p in surf.plane_arrays()]


@pytest.mark.parametrize("fmt", ROT_FORMATS, ids=lambda f: f.name)
def test_rotator_matches_jax(fmt):
    """Run and RunAsync into Surfaces, at a right angle (equal) and at an
    arbitrary angle with a shift (the JAX package's traced path)."""
    w, h = 96, 64
    js, ts = _surfaces(fmt, w, h, int(fmt) + 40)
    jrot = jvali.PySurfaceRotator(gpu_id=0)
    trot = tvali.PySurfaceRotator(gpu_id=CPU)
    assert [int(f) for f in trot.SupportedFormats] == [
        int(f) for f in jrot.SupportedFormats]
    for angle, sx, sy, (dw, dh), exact in (
            (270.0, 0.0, 0.0, (h, w), True),
            (33.5, w / 4, 2.0, (w, h), False)):
        jd = jvali.Surface.Make(fmt, dw, dh)
        td = tvali.Surface.Make(TF(int(fmt)), dw, dh, gpu_id=CPU)
        assert jrot.Run(js, jd, angle, sx, sy)[0]
        assert trot.RunAsync(ts, td, angle, sx, sy) == OK
        ev = tvali.CudaStreamEvent(trot.Stream, CPU)
        ev.Record()
        ev.Wait()
        for tp, jp in zip(_planes_of(td), _planes_of(jd)):
            _assert_close(tp, jp, exact=exact)


def test_rotator_error_codes_match_jax():
    for mod, kw in ((jvali, {}), (tvali, {"gpu_id": CPU})):
        F = mod.PixelFormat
        rot = mod.PySurfaceRotator(**({"gpu_id": 0} if mod is jvali
                                      else kw))
        y = mod.Surface.Make(F.Y, W, H, **kw)
        assert rot.Run(y, mod.Surface.Make(F.RGB, H, W, **kw), 90.0) == (
            False, mod.TaskExecInfo.SRC_DST_FMT_MISMATCH)
        nv = mod.Surface.Make(F.NV12, W, H, **kw)
        assert rot.Run(nv, mod.Surface.Make(F.NV12, H, W, **kw), 90.0) == (
            False, mod.TaskExecInfo.NOT_SUPPORTED)
        assert F.NV12 not in rot.SupportedFormats
        assert not rot.Run(y, mod.Surface(), 90.0)[0]


UD_PAIRS = [(JF(int(a)), JF(int(b))) for a, b in tud.SUPPORTED_CONVERSIONS]


@pytest.mark.parametrize("geom", [(64, 48, 40, 24), (32, 24, 48, 40)],
                         ids=["down", "up"])
@pytest.mark.parametrize("pair", UD_PAIRS,
                         ids=lambda p: f"{p[0].name}-{p[1].name}")
def test_ud_batch_matches_jax(pair, geom):
    src, dst = pair
    w, h, dw, dh = geom
    planes = _planes(np.random.default_rng(int(src) * 17 + int(dst)), src,
                     2, w, h)
    j, t = _both(lambda p, *a: jud.ud_batch(p, src, dst, *a),
                 lambda p, *a: tud.ud_batch(p, TF(int(src)), TF(int(dst)),
                                            *a),
                 planes, w, h, dw, dh)
    for jp, tp in zip(j, t):
        _assert_close(tp, jp, u16_frac=1e-2)


@pytest.mark.parametrize("pair", UD_PAIRS,
                         ids=lambda p: f"{p[0].name}-{p[1].name}")
def test_ud_surface_matches_jax(pair):
    src, dst = pair
    w, h, dw, dh = 64, 48, 48, 32
    js, ts = _surfaces(src, w, h, int(src) + int(dst))
    jd = jvali.Surface.Make(dst, dw, dh)
    td = tvali.Surface.Make(TF(int(dst)), dw, dh, gpu_id=CPU)
    assert jvali.PySurfaceUD(gpu_id=0).Run(js, jd)[0]
    assert tvali.PySurfaceUD(gpu_id=CPU).Run(ts, td) == OK
    for tp, jp in zip(_planes_of(td), _planes_of(jd)):
        _assert_close(tp, jp, u16_frac=1e-2)


def test_ud_error_codes_match_jax():
    assert len(tvali.PySurfaceUD.SupportedFormats()) == 10
    for mod, kw in ((jvali, {}), (tvali, {"gpu_id": CPU})):
        F = mod.PixelFormat
        op = mod.PySurfaceUD(**({"gpu_id": 0} if mod is jvali else kw))
        rgb = mod.Surface.Make(F.RGB, W, H, **kw)
        assert op.Run(rgb, mod.Surface.Make(F.YUV444, W, H, **kw)) == (
            False, mod.TaskExecInfo.NOT_SUPPORTED)
    with pytest.raises(KeyError):
        tud.ud_batch((torch.zeros(1, 36, 32, dtype=torch.uint8),), TF.NV12,
                     TF.BGR, 32, 24, 16, 16)


# --- PyFrameConverter -----------------------------------------------------


@pytest.mark.parametrize("src,dst,cc", [
    (JF.RGB, JF.YUV444, (jvali.ColorSpace.BT_601, jvali.ColorRange.MPEG)),
    (JF.NV12, JF.RGB, (jvali.ColorSpace.BT_709, jvali.ColorRange.MPEG)),
    (JF.YUV420, JF.RGB, None),
    (JF.RGB, JF.YUV420, (jvali.ColorSpace.BT_709, jvali.ColorRange.JPEG)),
    (JF.RGB_PLANAR, JF.RGB, None),
], ids=lambda v: getattr(v, "name", str(v)))
def test_frame_converter_matches_jax(src, dst, cc):
    w, h = 64, 48
    frame = planes_to_host_frame(
        [p[0] for p in _planes(np.random.default_rng(int(src)), src, 1, w,
                               h)])
    outs = []
    for mod in (jvali, tvali):
        conv = mod.PyFrameConverter(w, h, mod.PixelFormat(int(src)),
                                    mod.PixelFormat(int(dst)))
        assert int(conv.Format) == int(dst)
        ctx = None if cc is None else mod.ColorspaceConversionContext(
            mod.ColorSpace(int(cc[0])), mod.ColorRange(int(cc[1])))
        out = np.zeros(1, np.uint8)  # resized to the frame by Run
        ok, info = conv.Run(frame, out, ctx)
        assert ok and int(info) == int(mod.TaskExecInfo.SUCCESS)
        outs.append(out)
    assert outs[0].nbytes == format_info(dst).host_size(w, h)
    assert np.array_equal(outs[0], outs[1])


def test_frame_converter_size_checks_match_jax():
    w, h = 32, 24
    for mod in (jvali, tvali):
        conv = mod.PyFrameConverter(w, h, mod.PixelFormat.NV12,
                                    mod.PixelFormat.RGB)
        assert conv.Run(np.zeros(10, np.uint8), np.zeros(1, np.uint8)) == (
            False, mod.TaskExecInfo.SRC_DST_SIZE_MISMATCH)
        src = np.zeros(w * h * 3 // 2, np.uint8)
        # a view cannot be resized
        assert conv.Run(src, np.zeros(8, np.uint8)[2:]) == (
            False, mod.TaskExecInfo.INVALID_INPUT)
        # ceil-divide: a float32 dst of w*h*3 bytes holds them all
        dst = np.zeros(3, np.float32)
        assert conv.Run(src, dst)[0]
        assert dst.nbytes == w * h * 3
