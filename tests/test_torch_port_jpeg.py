"""vali_tpu_torch's JPEG encode against vali_tpu's: the tables, the device
stage (``jpeg_transform_batch``) on the same numpy-seeded batches in
every input format, odd sizes and the subsample override, the same
errors, and the JPEG bytes of ``jpeg_encode_device`` and
``PyNvJpegEncoder.Run`` (both packages share the native libjpeg coder).

Envelope of the coefficients: equal, or +-1 on rounding ties only,
where the exact quotient (float64 DCT) is within 1e-3 of k + 0.5: the
DCT sums in another order in the two libraries, and a quotient within
float32 noise of a tie can land on either side. Such ties are not rare
on 8-bit input: a DC coefficient is a multiple of 1/8 up to float32
error, so one block in 8q (q its quantiser) has its DC quotient on a tie
(one in 40 luma blocks at quality 85, ~4e-4 of the coefficients). The
JPEG bytes of smooth frames (the JAX package's own test image) are
equal.
"""

import numpy as np
import pytest
import torch

import vali_tpu as ref
import vali_tpu_torch as port
from vali_tpu.engine.jpeg import jpeg_encode_device as ref_encode
from vali_tpu.ops import jpeg as ref_jpeg
from vali_tpu_torch.engine.jpeg import jpeg_encode_device as port_encode
from vali_tpu_torch.ops import jpeg as port_jpeg

F = port.PixelFormat


def _smooth(h, w, c=3, phase=0.0):
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [128 + 90 * np.sin(yy / 19.0 + phase) * np.cos(xx / 13.0),
             128 + 90 * np.cos(yy / 17.0 - phase),
             128 + 90 * np.sin(xx / 23.0 + 2 * phase)]
    return np.stack(chans[:c], -1).astype(np.uint8)


def _planes(fmt, n, w, h, rng):
    """Storage-layout batched uint8 planes of ``fmt``: smooth content
    with noise, so that blocks have many nonzero coefficients."""
    noisy = [np.clip(_smooth(h, w, phase=i).astype(int)
                     + rng.integers(-20, 21, (h, w, 3)), 0, 255)
             .astype(np.uint8) for i in range(n)]
    x = np.stack(noisy)
    if fmt in (F.RGB, F.BGR):
        return (x.reshape(n, h, 3 * w),)
    if fmt == F.RGB_PLANAR:
        return (np.ascontiguousarray(x.transpose(0, 3, 1, 2)).reshape(
            n, 3 * h, w),)
    if fmt == F.Y:
        return (x[..., 0].copy(),)
    if fmt == F.YUV444:
        return tuple(x[..., c].copy() for c in range(3))
    return (x[..., 0].copy(), x[:, :h // 2, :w // 2, 1].copy(),
            x[:, :h // 2, :w // 2, 2].copy())   # YUV420


def _exact_quotients(planes, kw, monkeypatch):
    """The port's coefficients before rounding, with the DCT and the
    division in float64 (the colour conversion as the port does it)."""
    def exact(plane, qtable, center=128.0):
        d = torch.from_numpy(port_jpeg.dct_matrix()).double()
        blocks = port_jpeg._blockify(plane.double() - center)
        return (torch.matmul(torch.matmul(d, blocks), d.T)
                / torch.from_numpy(qtable).double())

    with monkeypatch.context() as m:
        m.setattr(port_jpeg, "_dct_quant", exact)
        return port_jpeg.jpeg_transform_batch(planes, **kw)


def _close(got, want, exact):
    """Equal, or +-1 where the exact quotient is within 1e-3 of
    k + 0.5."""
    assert got.dtype == torch.int16 and got.shape == want.shape
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    frac = np.abs(exact - np.floor(exact) - 0.5)[d != 0]
    assert d.max() <= 1 and (frac < 1e-3).all(), (d.max(), frac.max())


@pytest.mark.parametrize("quality", [1, 10, 50, 85, 90, 100])
def test_tables_are_equal(quality):
    for a, b in zip(port_jpeg.quant_tables(quality),
                    ref_jpeg.quant_tables(quality)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_jpeg.dct_matrix(),
                                  ref_jpeg.dct_matrix())


@pytest.mark.parametrize("fmt,w,h,sub", [
    (F.RGB, 64, 48, True), (F.RGB, 101, 91, True), (F.RGB, 40, 24, False),
    (F.RGB, 128, 96, True), (F.Y, 256, 128, True),
    (F.BGR, 56, 40, True), (F.RGB_PLANAR, 45, 37, True),
    (F.Y, 83, 61, True), (F.YUV444, 48, 32, False),
    (F.YUV444, 49, 35, True), (F.YUV420, 64, 48, True),
    (F.YUV420, 70, 42, True)])
def test_coefficients_match(fmt, w, h, sub, monkeypatch):
    rng = np.random.default_rng(w * h)
    planes = _planes(fmt, 2, w, h, rng)
    kw = dict(src_fmt=int(fmt), width=w, height=h, quality=85,
              subsample420=sub)
    want = ref_jpeg.jpeg_transform_batch(planes, **kw)
    tp = tuple(torch.from_numpy(p) for p in planes)
    got = port_jpeg.jpeg_transform_batch(tp, **kw)
    exact = _exact_quotients(tp, kw, monkeypatch)
    for g, r, e in zip(got, want, exact):
        if r is None:
            assert g is None and e is None
        else:
            _close(g, np.asarray(r), e.numpy())


def test_errors_are_the_references():
    cases = [
        ((np.zeros((1, 16, 48), np.uint8),),
         dict(src_fmt=int(F.RGB), width=32, height=16, quality=85)),
        ((np.zeros((1, 32, 32), np.uint8), np.zeros((1, 16, 16), np.uint8),
          np.zeros((1, 16, 16), np.uint8)),
         dict(src_fmt=int(F.YUV420), width=32, height=32, quality=85,
              subsample420=False)),
        ((np.zeros((1, 8, 8), np.uint8),),
         dict(src_fmt=int(F.NV12), width=8, height=8, quality=85)),
    ]
    for planes, kw in cases:
        with pytest.raises(ValueError) as want:
            ref_jpeg.jpeg_transform_batch(planes, **kw)
        with pytest.raises(ValueError) as got:
            port_jpeg.jpeg_transform_batch(
                tuple(torch.from_numpy(p) for p in planes), **kw)
        assert str(got.value) == str(want.value)


def _surfaces(pkg, frames, fmt, w, h):
    if pkg is ref:
        return [ref.Surface.from_numpy(f, fmt, width=w, height=h)
                for f in frames]
    return [port.Surface.from_numpy(f, fmt, gpu_id=-1, width=w, height=h)
            for f in frames]


def _smooth_frames(fmt, n, w, h):
    """Per-frame planes of ``fmt`` with the smooth test image."""
    out = []
    for i in range(n):
        x = _smooth(h, w, phase=i)
        if fmt in (F.RGB, F.BGR):
            out.append([x.reshape(h, 3 * w)])
        elif fmt == F.Y:
            out.append([x[..., 0].copy()])
        elif fmt == F.YUV444:
            out.append([x[..., c].copy() for c in range(3)])
        else:
            out.append([x[..., 0].copy(), x[:h // 2, :w // 2, 1].copy(),
                        x[:h // 2, :w // 2, 2].copy()])
    return out


@pytest.mark.parametrize("fmt,w,h,sub", [
    (F.RGB, 96, 64, None), (F.RGB, 101, 91, None), (F.Y, 64, 48, None),
    (F.YUV420, 64, 48, None), (F.YUV444, 64, 48, None),
    (F.YUV444, 64, 48, True), (F.BGR, 48, 32, False)])
def test_jpeg_bytes_match(fmt, w, h, sub):
    frames = _smooth_frames(fmt, 2, w, h)
    want = ref_encode(_surfaces(ref, frames, fmt, w, h), quality=85,
                      subsample420=sub)
    got = port_encode(_surfaces(port, frames, fmt, w, h), quality=85,
                      subsample420=sub)
    assert len(got) == len(want) == 2
    for g, r in zip(got, want):
        assert g.dtype == np.uint8 and g.tobytes() == r.tobytes()
        assert g.tobytes()[:3] == b"\xff\xd8\xff"


def test_host_encoder_bytes_match():
    """PyNvJpegEncoder.Run (the host libjpeg encoder), and its
    failures."""
    frames = _smooth_frames(F.RGB, 3, 64, 48)
    r_enc, p_enc = ref.PyNvJpegEncoder(gpu_id=0), port.PyNvJpegEncoder(-1)
    want, r_info = r_enc.Run(r_enc.Context(75, F.RGB),
                             _surfaces(ref, frames, F.RGB, 64, 48))
    ctx = p_enc.Context(75, F.RGB)
    assert (ctx.Compression(), ctx.Format()) == (75, F.RGB)
    got, p_info = p_enc.Run(ctx, _surfaces(port, frames, F.RGB, 64, 48))
    assert p_info == port.TaskExecInfo.SUCCESS and len(got) == 3
    assert int(p_info) == int(r_info)
    assert [g.tobytes() for g in got] == [r.tobytes() for r in want]
    gray = _surfaces(port, [[_smooth(48, 64)[..., 0]]], F.Y, 64, 48)
    assert p_enc.Run(ctx, gray) == (
        [], port.TaskExecInfo.SRC_DST_FMT_MISMATCH)


def test_encode_device_guards():
    yuv420 = port.Surface.from_numpy(
        [np.zeros((32, 32), np.uint8), np.zeros((16, 16), np.uint8),
         np.zeros((16, 16), np.uint8)], F.YUV420, gpu_id=-1)
    with pytest.raises(ValueError, match="already 4:2:0"):
        port_encode([yuv420], subsample420=False)
    rgb = port.Surface.from_numpy(_smooth(16, 16), F.RGB, gpu_id=-1)
    with pytest.raises(ValueError, match="share format"):
        port_encode([rgb, yuv420])
    assert port_encode([]) == []


def test_encoder_needs_the_card_by_default():
    """No fallback: gpu_id=0 needs a card; -1 asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.PyNvJpegEncoder()
    port.PyNvJpegEncoder(-1)
