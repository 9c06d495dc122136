"""CUDA-only tests of vali_tpu_torch: the Hopper kernels against their
plain PyTorch versions on the card, the launch counters, and the
pipeline's pinned staging. They skip where torch has no CUDA device.

This file imports no JAX, so on a machine with a card it runs alone:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from vali_tpu_torch.core.enums import PixelFormat
from vali_tpu_torch.core.formats import format_info
from vali_tpu_torch.ops.nv12_preprocess import (nv12_preprocess,
                                                nv12_preprocess_plain)
from vali_tpu_torch.ops.yuv420_preprocess import (yuv420_preprocess,
                                                  yuv420_preprocess_plain)
from vali_tpu_torch.pipeline.multistream import BatchStager, \
    preprocess_batch

NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frames(rng, fmt, b, w, h):
    """[b, host_frame_bytes] uint8 frames of ``fmt``: random samples in
    the format's value range, plus a smooth gradient frame."""
    info = format_info(fmt)
    n = info.host_size(w, h) // info.elem_size
    if fmt in (PixelFormat.P10, PixelFormat.P12):
        x = rng.integers(0, 1 << info.bit_depth, (b, n)) << (
            16 - info.bit_depth)
    elif info.dtype == np.uint16:
        x = rng.integers(0, 1 << info.bit_depth, (b, n))
    else:
        x = rng.integers(0, 256, (b, n))
    x[0] = np.linspace(0, x.max(), n)
    return np.ascontiguousarray(x.astype(info.dtype)).view(np.uint8)


def _planes(batch, fmt, w, h):
    return BatchStager(fmt, w, h, batch.device).split(batch)


def _run(planes, fmt, w, h, dw, dh, plain, **kw):
    """Kernel (plain=False) or plain version on the same device planes."""
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    if fmt in (PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12):
        fn = nv12_preprocess_plain if plain else nv12_preprocess
        return fn(planes[0], **geo, **kw)
    fn = yuv420_preprocess_plain if plain else yuv420_preprocess
    return fn(*planes, **geo, **kw)


CASES = [
    (PixelFormat.NV12, {}),
    (PixelFormat.NV12, {"compute_dtype": torch.float32}),
    (PixelFormat.P10, {"out_dtype": torch.float32, "normalize": NORM}),
    (PixelFormat.YUV420, {}),
    (PixelFormat.YUV420, {"out_dtype": torch.bfloat16, "normalize": NORM}),
    (PixelFormat.YUV420_10bit, {"out_dtype": torch.float32}),
]


def _assert_close(out, ref, what):
    if out.dtype == torch.uint8:
        d = (out.int() - ref.int()).abs()
        assert d.max().item() <= 1, what
        assert (d > 0).float().mean().item() < 1e-3, what
    else:
        # float: same cast points, only the summation order differs; a
        # bfloat16 output may round one ulp apart
        tol = 1e-3 if out.dtype == torch.float32 else 2.0 ** -7
        d = (out.float() - ref.float()).abs()
        bound = tol * torch.clamp(ref.float().abs(), min=1.0)
        assert (d <= bound).all().item(), (what, d.max().item())


@pytest.mark.parametrize("geom", [
    (2, 96, 256, 32, 64),     # 16-byte vector loads
    (1, 62, 130, 30, 34),     # widths that are not whole vectors
    (2, 1080, 1920, 224, 224),
])
@pytest.mark.parametrize("fmt,kw", CASES)
def test_kernel_matches_plain(dev, geom, fmt, kw):
    b, h, w, dh, dw = geom
    rng = np.random.default_rng(7)
    batch = torch.from_numpy(_frames(rng, fmt, b, w, h)).to(dev)
    planes = _planes(batch, fmt, w, h)
    out = _run(planes, fmt, w, h, dw, dh, False, **kw)
    ref = _run(planes, fmt, w, h, dw, dh, True, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (b, 3, dh, dw)
    _assert_close(out, ref, (fmt, geom, kw))


@pytest.mark.parametrize("fmt", [PixelFormat.NV12, PixelFormat.YUV420])
def test_kernel_padded_strided_views(dev, fmt):
    """Extra rows and a batch stride larger than the plane give the same
    output as contiguous planes."""
    b, h, w, dh, dw = 3, 96, 256, 40, 48
    rng = np.random.default_rng(3)
    batch = torch.from_numpy(_frames(rng, fmt, b, w, h)).to(dev)
    planes = _planes(batch, fmt, w, h)
    ref = _run(tuple(p.contiguous() for p in planes), fmt, w, h, dw, dh,
               False)
    padded = []
    for p in planes:
        big = torch.zeros((b, p.shape[1] + 5, p.shape[2] + 16),
                          dtype=p.dtype, device=dev)
        big[:, :p.shape[1], :p.shape[2]] = p
        padded.append(big[:, :, :p.shape[2]])
    out = _run(tuple(padded), fmt, w, h, dw, dh, False)
    assert torch.equal(out, ref)


def test_launch_counters(dev):
    h, w = 64, 128
    rng = np.random.default_rng(1)
    nv = _planes(torch.from_numpy(
        _frames(rng, PixelFormat.NV12, 2, w, h)).to(dev),
        PixelFormat.NV12, w, h)
    i4 = _planes(torch.from_numpy(
        _frames(rng, PixelFormat.YUV420, 2, w, h)).to(dev),
        PixelFormat.YUV420, w, h)
    n0, y0 = nv12_preprocess.launches, yuv420_preprocess.launches
    preprocess_batch(nv, PixelFormat.NV12, w, h, 32, 32)
    preprocess_batch(i4, PixelFormat.YUV420, w, h, 32, 32, letterbox=True)
    preprocess_batch(i4, PixelFormat.YUV420, w, h, 32, 32, use_kernel=False)
    assert nv12_preprocess.launches == n0 + 1
    assert yuv420_preprocess.launches == y0 + 1
    # the plain version on CPU tensors is not a launch
    nv12_preprocess(nv[0].cpu(), src_w=w, src_h=h, dst_w=16, dst_h=16)
    assert nv12_preprocess.launches == n0 + 1


def test_staging_reuses_pinned_buffers_only_after_the_copy(dev):
    """Batches staged while the device is still busy must not overwrite a
    pinned buffer whose H2D copy has not run yet."""
    fmt, h, w = PixelFormat.YUV420, 64, 128
    stager = BatchStager(fmt, w, h, dev, keep=2)
    size = format_info(fmt).host_size(w, h)
    outs, want = [], []
    torch.cuda._sleep(200_000_000)  # keep the stream busy
    for i in range(6):
        frames = [np.full(size, 10 * i + j, np.uint8) for j in range(2)]
        want.append(np.stack(frames))
        outs.append(stager.run(frames, lambda planes: torch.cat(
            [p.flatten(1) for p in planes], dim=1).clone()))
    torch.cuda.synchronize()
    for got, exp in zip(outs, want):
        assert np.array_equal(got.cpu().numpy(), exp)
