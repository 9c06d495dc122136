"""CUDA-only tests of vali_tpu_torch: the Hopper kernels against their
plain PyTorch versions on the card, the launch counters, the pipeline's
pinned staging, the Surface ops' streams, the rotator and UD op on the
card against the same ops on the CPU, the NV12 kernel-variant lab's
kernels against their plain versions, the 4K NV12 resize lab's kernels
against their plain versions and nv12_resize, the NV12 -> RGB convert
lab's kernels against their plain versions and nv12_to_rgb, and the
multi-device slice on one card (per-position streams over reused pinned
buffers, record_stream, the sharded kernels and pipeline against one
launch). They skip where torch has no CUDA device.

This file imports no JAX, so on a machine with a card it runs alone:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
from vali_tpu_torch.core.formats import format_info
from vali_tpu_torch.lab import convert_lab as cl
from vali_tpu_torch.lab import kernel_variants as kv
from vali_tpu_torch.lab import resize_diag as rd
from vali_tpu_torch.lab.ab_common import padded_view
from vali_tpu_torch.ops.nv12_resize import nv12_resize, nv12_resize_plain
from vali_tpu_torch.ops.nv12_to_rgb import nv12_to_rgb, nv12_to_rgb_plain
from vali_tpu_torch.ops.packed_resize import (packed_resize,
                                              packed_resize_plain)
from vali_tpu_torch.ops.plane_resize import (plane_resize,
                                             plane_resize_plain)
from vali_tpu_torch.ops.resize import LANCZOS
from vali_tpu_torch.ops.nv12_preprocess import (nv12_preprocess,
                                                nv12_preprocess_plain)
from vali_tpu_torch.ops.yuv420_preprocess import (yuv420_preprocess,
                                                  yuv420_preprocess_plain)
from vali_tpu_torch.ops.yuv422_preprocess import (yuv422_preprocess,
                                                  yuv422_preprocess_plain)
from vali_tpu_torch.ops.yuv444_preprocess import (yuv444_preprocess,
                                                  yuv444_preprocess_plain)
from vali_tpu_torch.pipeline.multistream import BatchStager, \
    preprocess_batch
from vali_tpu_torch.utils import tracing

NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def launches(wrapper):
    """Kernel launches ``wrapper`` made so far (``launches.<wrapper>``)."""
    return tracing.counters().get("launches." + wrapper.__name__, 0)


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


PLANAR = {
    PixelFormat.YUV420: (yuv420_preprocess, yuv420_preprocess_plain),
    PixelFormat.YUV420_10bit: (yuv420_preprocess, yuv420_preprocess_plain),
    PixelFormat.YUV422: (yuv422_preprocess, yuv422_preprocess_plain),
    PixelFormat.YUV444: (yuv444_preprocess, yuv444_preprocess_plain),
}


def _run(planes, fmt, w, h, dw, dh, plain, **kw):
    """Kernel (plain=False) or plain version on the same device planes."""
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    if fmt in (PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12):
        fn = nv12_preprocess_plain if plain else nv12_preprocess
        return fn(planes[0], **geo, **kw)
    return PLANAR[fmt][int(plain)](*planes, **geo, **kw)


CASES = [
    (PixelFormat.NV12, {}),
    (PixelFormat.NV12, {"compute_dtype": torch.float32}),
    (PixelFormat.P10, {"out_dtype": torch.float32, "normalize": NORM}),
    (PixelFormat.YUV420, {}),
    (PixelFormat.YUV420, {"out_dtype": torch.bfloat16, "normalize": NORM}),
    (PixelFormat.YUV420_10bit, {"out_dtype": torch.float32}),
    (PixelFormat.YUV422, {"space": ColorSpace.BT_601,
                          "crange": ColorRange.JPEG}),
    (PixelFormat.YUV422, {"compute_dtype": torch.float32}),
    (PixelFormat.YUV444, {}),
    (PixelFormat.YUV444, {"out_dtype": torch.float32, "normalize": NORM}),
    (PixelFormat.YUV444, {"out_dtype": torch.bfloat16, "normalize": NORM}),
]


def _assert_close(out, ref, what, tol=1):
    """uint8: within ``tol`` (1 LSB, or a per-sample bound such as the lab
    hpass's) on fewer than 1e-3 of the samples."""
    if out.dtype == torch.uint8:
        d = (out.int() - ref.int()).abs()
        assert (d <= tol).all().item(), (what, d.max().item())
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
    # dst_h not a multiple of the stage or strip height, dst_w not a
    # multiple of the tile, an odd batch
    (3, 150, 322, 70, 202),
    (5, 96, 256, 37, 61),
    (1, 1080, 1920, 360, 640),  # the letterbox launch's shape, one frame
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


@pytest.mark.parametrize("fmt", [PixelFormat.NV12, PixelFormat.YUV420,
                                 PixelFormat.YUV422, PixelFormat.YUV444])
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


def test_preprocess_geometry_that_does_not_fit_raises_before_launch(dev):
    """Rings of tens of thousands of rows do not fit a block: the wrapper
    raises before any launch."""
    x = torch.zeros((1, 150000, 64), dtype=torch.uint8, device=dev)
    before = launches(nv12_preprocess)
    with pytest.raises(ValueError, match="shared memory"):
        nv12_preprocess(x, src_w=64, src_h=100000, dst_w=32, dst_h=8)
    assert launches(nv12_preprocess) == before


def test_launch_counters(dev):
    h, w = 64, 128
    rng = np.random.default_rng(1)
    nv = _planes(torch.from_numpy(
        _frames(rng, PixelFormat.NV12, 2, w, h)).to(dev),
        PixelFormat.NV12, w, h)
    i4 = _planes(torch.from_numpy(
        _frames(rng, PixelFormat.YUV420, 2, w, h)).to(dev),
        PixelFormat.YUV420, w, h)
    n0, y0 = launches(nv12_preprocess), launches(yuv420_preprocess)
    preprocess_batch(nv, PixelFormat.NV12, w, h, 32, 32)
    preprocess_batch(i4, PixelFormat.YUV420, w, h, 32, 32, letterbox=True)
    preprocess_batch(i4, PixelFormat.YUV420, w, h, 32, 32, use_kernel=False)
    assert launches(nv12_preprocess) == n0 + 1
    assert launches(yuv420_preprocess) == y0 + 1
    # the plain version on CPU tensors is not a launch
    nv12_preprocess(nv[0].cpu(), src_w=w, src_h=h, dst_w=16, dst_h=16)
    assert launches(nv12_preprocess) == n0 + 1


def test_planar_kernels_launch_counters(dev):
    """The 4:2:2 and 4:4:4 kernels count their launches, inside
    preprocess_batch too; the dense route and CPU calls are not launches."""
    h, w = 64, 128
    rng = np.random.default_rng(2)
    for fmt in (PixelFormat.YUV422, PixelFormat.YUV444):
        fn = PLANAR[fmt][0]
        planes = _planes(torch.from_numpy(_frames(rng, fmt, 2, w, h)).to(
            dev), fmt, w, h)
        n0 = launches(fn)
        out = preprocess_batch(planes, fmt, w, h, 32, 32, planar=True)
        assert launches(fn) == n0 + 1
        assert torch.equal(out, fn(*planes, src_w=w, src_h=h, dst_w=32,
                                   dst_h=32))
        preprocess_batch(planes, fmt, w, h, 32, 32, use_kernel=False)
        fn(*(p.cpu() for p in planes), src_w=w, src_h=h, dst_w=16,
           dst_h=16)
        assert launches(fn) == n0 + 2
        with pytest.raises(ValueError):  # rows not contiguous
            fn(planes[0].transpose(1, 2), *planes[1:], src_w=h, src_h=w,
               dst_w=16, dst_h=16)
        assert launches(fn) == n0 + 2


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


# --- the Surface path's kernels -------------------------------------------


def _rand(dev, shape, dtype, seed):
    """Random samples: uint8 full range, uint16 10-bit MSB-aligned,
    float32 in [0, 1)."""
    rng = np.random.default_rng(seed)
    if dtype == torch.float32:
        x = rng.random(shape, dtype=np.float32)
    elif dtype == torch.uint16:
        x = (rng.integers(0, 1024, shape) << 6).astype(np.uint16)
    else:
        x = rng.integers(0, 256, shape).astype(np.uint8)
    return torch.from_numpy(x).to(dev)


def _close_any(out, ref, what):
    """_assert_close, with uint16 within 1 LSB on < 1e-2 of samples (a
    float32 ulp of a 16-bit sum is ~1/256 LSB, so summation-order ties
    are more frequent than for uint8)."""
    if out.dtype == torch.uint16:
        d = (out.to(torch.int32) - ref.to(torch.int32)).abs()
        assert d.max().item() <= 1, what
        assert (d > 0).float().mean().item() < 1e-2, what
    else:
        _assert_close(out, ref, what)


def _resize_call(kind, x, geo, plain=False, **kw):
    h, w, dh, dw = geo
    if kind == "plane":
        fn = plane_resize_plain if plain else plane_resize
        return fn(x, src_h=h, dst_h=dh, dst_w=dw, **kw)
    if kind == "packed":
        fn = packed_resize_plain if plain else packed_resize
        return fn(x, src_w=w, src_h=h, dst_w=dw, dst_h=dh, **kw)
    fn = nv12_resize_plain if plain else nv12_resize
    return fn(x, src_w=w, src_h=h, dst_w=dw, dst_h=dh, **kw)


def _resize_shape(kind, b, h, w):
    return {"plane": (b, h, w), "packed": (b, h, 3 * w),
            "nv12": (b, h * 3 // 2, w)}[kind]


@pytest.mark.parametrize("geo", [
    (96, 256, 40, 120),       # downscale
    (62, 130, 96, 200),       # upscale, widths not x4
    (64, 64, 64, 64),         # identity
    (2160, 3840, 1080, 1920),  # 4K -> 1080p
    (1080, 1920, 224, 224),
    # (h, w, dh, dw, batch): dst_h not a multiple of the stage or strip
    # height, dst_w not a multiple of the tile; one frame, an odd batch
    (150, 322, 70, 202, 1),
    (150, 322, 70, 202, 3),
    (1080, 1920, 360, 640, 1),  # the Surface path's shapes
    (1080, 1920, 540, 960, 1),
    (540, 960, 270, 480, 2),
])
@pytest.mark.parametrize("kind,dtype,kw", [
    ("plane", torch.uint8, {}),
    ("plane", torch.uint8, {"compute_dtype": torch.float32}),
    ("plane", torch.uint16, {}),
    ("plane", torch.float32, {}),
    ("packed", torch.uint8, {}),
    ("packed", torch.float32, {}),
    ("nv12", torch.uint8, {}),
    ("nv12", torch.uint16, {}),
    ("plane", torch.uint8, {"method": LANCZOS}),
    ("packed", torch.uint8, {"method": LANCZOS}),
    ("nv12", torch.uint8, {"method": LANCZOS}),
])
def test_resize_kernels_match_plain(dev, geo, kind, dtype, kw):
    h, w, dh, dw = geo[:4]
    b = geo[4] if len(geo) > 4 else 1 if h > 1000 else 2
    x = _rand(dev, _resize_shape(kind, b, h, w), dtype, h + w)
    out = _resize_call(kind, x, geo[:4], **kw)
    ref = _resize_call(kind, x, geo[:4], plain=True, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    _close_any(out, ref, (kind, geo, dtype, kw))


@pytest.mark.parametrize("kind", ["plane", "packed", "nv12"])
def test_resize_kernels_padded_strided_views(dev, kind):
    """Extra rows, a padded row pitch, a misaligned start and a batch
    stride larger than the image give the same output as contiguous
    input."""
    geo = (48, 64, 20, 36)
    x = _rand(dev, _resize_shape(kind, 3, 48, 64), torch.uint8, 5)
    ref = _resize_call(kind, x.contiguous(), geo)
    for pad_rows, pad_cols, off in ((5, 16, 0), (0, 3, 1)):
        big = torch.zeros((3, x.shape[1] + pad_rows,
                           x.shape[2] + pad_cols + off),
                          dtype=x.dtype, device=dev)
        big[:, :x.shape[1], off:off + x.shape[2]] = x
        out = _resize_call(kind, big[:, :, off:off + x.shape[2]], geo)
        assert torch.equal(out, ref), (pad_rows, pad_cols, off)


@pytest.mark.parametrize("geom", [(2, 96, 256), (1, 62, 130),
                                  (2, 1080, 1920), (1, 1080, 1920),
                                  (3, 1080, 144), (2, 96, 144)])
@pytest.mark.parametrize("kw", [
    {}, {"compute_dtype": torch.float32},
    {"space": ColorSpace.BT_601, "crange": ColorRange.JPEG, "swap": True},
    {"space": ColorSpace.BT_601, "crange": ColorRange.JPEG, "swap": True,
     "compute_dtype": torch.float32},
    {"space": ColorSpace.BT_709, "crange": ColorRange.MPEG}])
def test_nv12_to_rgb_matches_plain(dev, geom, kw):
    """Same arithmetic in the same order: bit-identical (N = 1 at 1080p,
    widths of 144 and 130, a height of 1080, both compute dtypes)."""
    b, h, w = geom
    x = _rand(dev, (b, h * 3 // 2, w), torch.uint8, w)
    out = nv12_to_rgb(x, src_w=w, src_h=h, **kw)
    ref = nv12_to_rgb_plain(x, src_w=w, src_h=h, **kw)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("compute_dtype", [None, torch.float32])
def test_nv12_to_rgb_replays_give_one_reference(dev, compute_dtype):
    """The staged block's TMA ring and output tiles at 1080p, BGR: each of
    20 launches gives the plain version's bits (no race checker runs on
    this card; csrc/convert_staged.cuh names the waits that guard each
    reuse)."""
    b, w, h = 8, 1920, 1080
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=27)
    kw = dict(src_w=w, src_h=h, space=ColorSpace.BT_601,
              crange=ColorRange.JPEG, swap=True, compute_dtype=compute_dtype)
    want = nv12_to_rgb_plain(x, **kw)
    for i in range(20):
        assert torch.equal(nv12_to_rgb(x, **kw), want), i


def test_nv12_to_rgb_geometry_picks_the_route(dev):
    """The launcher's rule (nv12_to_rgb_tma_route) is the wrapper's
    staged_route: a width of 40 and an odd pitch take the per-pixel
    kernel, bit-equal to the plain version at both compute dtypes; 1080p
    packed, padded to a pitch of 1984 or with a larger batch stride take
    the staged block."""
    from vali_tpu_torch.ops import _cuda_build
    from vali_tpu_torch.ops.nv12_to_rgb import staged_route

    lib = _cuda_build.load_kernels()
    h = 32
    narrow = _rand(dev, (2, h * 3 // 2, 40), torch.uint8, 40)
    big = torch.zeros((2, h * 3 // 2, 1921), dtype=torch.uint8, device=dev)
    big[:, :, :1920] = _rand(dev, (2, h * 3 // 2, 1920), torch.uint8, 3)
    odd = big[:, :, :1920]
    pitched = torch.zeros((2, 1620, 1984), dtype=torch.uint8,
                          device=dev)[:, :, :1920]
    flat = torch.zeros(2 * (1620 * 1920 + 4096), dtype=torch.uint8,
                       device=dev)
    strided = torch.as_strided(flat, (2, 1620, 1920),
                               (1620 * 1920 + 4096, 1920, 1))
    packed = torch.zeros((1, 1620, 1920), dtype=torch.uint8, device=dev)
    for x, w, staged in ((narrow, 40, False), (odd, 1920, False),
                         (pitched, 1920, True), (strided, 1920, True),
                         (packed, 1920, True)):
        out = torch.empty((x.shape[0], 8, 3 * w), dtype=torch.uint8,
                          device=dev)
        rule = lib.nv12_to_rgb_tma_route(x.data_ptr(), x.stride(0),
                                         x.stride(1), w, out.data_ptr())
        assert (rule == 1) == staged == staged_route(x, w), (w, staged)
    for x, w in ((narrow, 40), (odd, 1920)):
        for kw in ({}, {"compute_dtype": torch.float32, "swap": True}):
            got = nv12_to_rgb(x, src_w=w, src_h=h, **kw)
            assert torch.equal(got, nv12_to_rgb_plain(x, src_w=w, src_h=h,
                                                      **kw)), (w, kw)


@pytest.mark.parametrize("geom", [
    (3, 288, 512, 144, 256),     # the resize lab's CPU geometry
    (2, 150, 322, 70, 202),      # ragged strips and tiles
    (1, 2160, 3840, 1080, 1920),  # 4K -> 1080p, one frame
])
def test_nv12_resize_equals_the_lab_both_and_striped(dev, geom):
    """The lab's ``both`` (csrc/nv12_phases.cu) and ``striped``
    (csrc/nv12_striped.cu) run aligned's tensor-core passes at 8x32:
    aligned8x32's bits (``both`` its luma rows), within the uint8 envelope
    of nv12_resize."""
    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = rd.make_frames(b, h * 3 // 2, w, dev, seed=h)
    out = nv12_resize(x, **geo)
    aligned = rd.aligned_resize(x, **geo, h_align=8, w_align=32)
    both = rd.resize_phases(x, **geo, mode="both")
    assert torch.equal(both, aligned[:, :dh])
    _assert_close(both, out[:, :dh], geom)
    striped = rd.striped_resize(x, **geo, nw=3, store="dyn")
    assert torch.equal(striped, aligned)
    _assert_close(striped, out, geom)


def test_resize_geometry_that_does_not_fit_raises_before_launch(dev):
    """A ring of tens of thousands of rows does not fit a block: the
    wrapper raises before any launch."""
    x = torch.zeros((1, 100000, 64), dtype=torch.uint8, device=dev)
    before = launches(plane_resize)
    with pytest.raises(ValueError, match="shared memory"):
        plane_resize(x, src_h=100000, dst_h=8, dst_w=32)
    assert launches(plane_resize) == before


def test_nv12_to_rgb_padded_strided_views(dev):
    b, h, w = 2, 64, 128
    x = _rand(dev, (b, h * 3 // 2, w), torch.uint8, 9)
    ref = nv12_to_rgb(x, src_w=w, src_h=h)
    big = torch.zeros((b, h * 2, w + 32), dtype=torch.uint8, device=dev)
    big[:, :h * 3 // 2, 16:16 + w] = x
    assert torch.equal(nv12_to_rgb(big[:, :, 16:16 + w], src_w=w, src_h=h),
                       ref)                 # 16-byte aligned path
    big[:, :h * 3 // 2, 1:1 + w] = x
    assert torch.equal(nv12_to_rgb(big[:, :, 1:1 + w], src_w=w, src_h=h),
                       ref)                 # per-pixel path


def test_surface_kernels_count_launches_and_reject_bad_input(dev):
    x = _rand(dev, (1, 48, 64), torch.uint8, 1)
    counted = (nv12_to_rgb, plane_resize, packed_resize, nv12_resize)
    before = [launches(f) for f in counted]
    nv12_to_rgb(x, src_w=64, src_h=32)
    plane_resize(x, src_h=48, dst_h=16, dst_w=16)
    packed_resize(x[:, :, :63], src_w=21, src_h=48, dst_w=8, dst_h=8)
    nv12_resize(x, src_w=64, src_h=32, dst_w=16, dst_h=16)
    assert [launches(f) for f in counted] == [n + 1 for n in before]
    plane_resize(x.cpu(), src_h=48, dst_h=16, dst_w=16)  # not a launch
    assert launches(plane_resize) == before[1] + 1
    with pytest.raises(ValueError):  # rows not contiguous
        plane_resize(x.transpose(1, 2), src_h=64, dst_h=16, dst_w=16)
    with pytest.raises(ValueError):
        nv12_to_rgb(x.transpose(1, 2), src_w=48, src_h=32)
    with pytest.raises(ValueError):  # sample type
        nv12_resize(x.to(torch.int16), src_w=64, src_h=32, dst_w=16,
                    dst_h=16)
    with pytest.raises(ValueError):  # shape
        packed_resize(x, src_w=64, src_h=48, dst_w=8, dst_h=8)
    with pytest.raises(ValueError, match="float32"):
        plane_resize(x.float(), src_h=48, dst_h=16, dst_w=16,
                     compute_dtype=torch.bfloat16)
    assert [launches(f) for f in counted][1:] == [
        n + 1 for n in before][1:]


def test_run_async_event_then_read_on_another_stream(dev):
    """RunAsync on a side stream, an event on that stream, then a read on
    another stream gives the synchronous result."""
    import vali_tpu_torch as vali
    from vali_tpu_torch.utils.device import new_stream

    F = vali.PixelFormat
    w, h = 1920, 1080
    frame = np.random.default_rng(4).integers(
        0, 256, format_info(F.NV12).host_size(w, h), dtype=np.uint8)
    src = vali.Surface.Make(F.NV12, w, h, gpu_id=0)
    assert vali.PyFrameUploader(gpu_id=0).Run(frame, src)[0]
    sync_rgb = vali.Surface.Make(F.RGB, w, h, gpu_id=0)
    assert vali.PySurfaceConverter(gpu_id=0).Run(src, sync_rgb)[0]
    side = new_stream(0)
    rgb = vali.Surface.Make(F.RGB, w, h, gpu_id=0)
    small = vali.Surface.Make(F.RGB, 640, 360, gpu_id=0)
    view = torch.from_dlpack(small)  # taken before the ops run
    conv = vali.PySurfaceConverter(gpu_id=0, stream=side.handle)
    res = vali.PySurfaceResizer(F.RGB, gpu_id=0, stream=side.handle)
    torch.cuda._sleep(100_000_000)  # keep the side stream's input late
    assert conv.RunAsync(src, rgb) == (True, vali.TaskExecInfo.SUCCESS)
    assert res.RunAsync(rgb, small) == (True, vali.TaskExecInfo.SUCCESS)
    ev = vali.CudaStreamEvent(conv.Stream, 0)
    ev.Record()
    ev.Wait()
    other = torch.cuda.Stream(dev)
    with torch.cuda.stream(other):
        got_rgb = rgb.to_torch().clone()
        got_small = view.clone()
    other.synchronize()
    assert torch.equal(got_rgb, sync_rgb.to_torch())
    want = vali.Surface.Make(F.RGB, 640, 360, gpu_id=0)
    assert vali.PySurfaceResizer(F.RGB, gpu_id=0).Run(sync_rgb, want)[0]
    assert torch.equal(got_small, want.to_torch())
    cai = small.__cuda_array_interface__
    assert cai["shape"] == (360, 640, 3) and cai["data"][0] == view.data_ptr()


# --- the rotator and the UD op: the card against the CPU ------------------


def _surface_pair(vali, fmt, w, h, seed):
    """The same random host frame uploaded to a CUDA and a CPU Surface."""
    rng = np.random.default_rng(seed)
    info = format_info(fmt)
    n = info.host_size(w, h)
    if info.dtype == np.float32:
        frame = rng.random(n // 4, dtype=np.float32).view(np.uint8)
    else:
        frame = rng.integers(0, 256, n, dtype=np.uint8)
        if info.dtype == np.uint16:
            frame = (frame.view(np.uint16) & ((1 << info.bit_depth) - 1)
                     ).view(np.uint8)
    pair = []
    for gpu_id in (0, -1):
        s = vali.Surface.Make(fmt, w, h, gpu_id=gpu_id)
        assert vali.PyFrameUploader(gpu_id=gpu_id).Run(frame, s)[0]
        pair.append(s)
    return pair


def _planes_close(cuda_surf, cpu_surf, exact):
    for a, b in zip(cuda_surf.plane_tensors(), cpu_surf.plane_tensors()):
        a = a.cpu()
        if exact:
            assert torch.equal(a, b)
        elif a.dtype == torch.float32:
            assert ((a - b).abs() <= 1e-5 * b.abs().clamp(min=1.0)).all()
        else:
            # uint16 at 16-bit magnitudes: within 1 LSB on < 1e-2, as in
            # _close_any
            d = (a.to(torch.int64) - b.to(torch.int64)).abs()
            assert d.max().item() <= 1
            frac = 1e-3 if a.dtype == torch.uint8 else 1e-2
            assert (d > 0).double().mean().item() < frac


@pytest.mark.parametrize("fmt,angle", [
    (PixelFormat.YUV422, 90.0), (PixelFormat.YUV420, 180.0),
    (PixelFormat.GRAY12, 270.0), (PixelFormat.RGB, 33.5),
    (PixelFormat.RGB_32F_PLANAR, -17.25), (PixelFormat.YUV444, 200.5)])
def test_rotator_on_the_card_matches_the_cpu(dev, fmt, angle):
    """Right angles bit-equal; other angles within 1 LSB on < 1e-3."""
    import vali_tpu_torch as vali

    w, h = 256, 144
    src, src_cpu = _surface_pair(vali, fmt, w, h, int(abs(angle)))
    dw, dh = (h, w) if angle in (90.0, 270.0) else (w, h)
    outs = []
    for gpu_id, s in ((0, src), (-1, src_cpu)):
        d = vali.Surface.Make(fmt, dw, dh, gpu_id=gpu_id)
        assert vali.PySurfaceRotator(gpu_id=gpu_id).Run(s, d, angle) == (
            True, vali.TaskExecInfo.SUCCESS)
        outs.append(d)
    _planes_close(*outs, exact=float(angle) % 90 == 0)


@pytest.mark.parametrize("src_fmt,dst_fmt", [
    (PixelFormat.NV12, PixelFormat.YUV444),
    (PixelFormat.NV12, PixelFormat.RGB),
    (PixelFormat.NV12, PixelFormat.RGB_32F_PLANAR),
    (PixelFormat.YUV420, PixelFormat.YUV444),
    (PixelFormat.P10, PixelFormat.YUV444_10bit)])
def test_ud_on_the_card_matches_the_cpu(dev, src_fmt, dst_fmt):
    import vali_tpu_torch as vali

    src, src_cpu = _surface_pair(vali, src_fmt, 1920, 1080, 11)
    outs = []
    for gpu_id, s in ((0, src), (-1, src_cpu)):
        d = vali.Surface.Make(dst_fmt, 960, 540, gpu_id=gpu_id)
        assert vali.PySurfaceUD(gpu_id=gpu_id).Run(s, d) == (
            True, vali.TaskExecInfo.SUCCESS)
        outs.append(d)
    _planes_close(*outs, exact=False)


# --- the NV12 kernel-variant lab (csrc/nv12_variants.cu and the others) ----

LAB_NAMES = [n for n in kv.DEFAULT_NAMES if n != "A"]


@pytest.mark.parametrize("geom", [
    (8, 144, 256, 64, 96),      # 16-byte loads
    (8, 62, 130, 30, 34),       # widths that are not whole vectors
    (8, 1080, 1920, 224, 224),  # the lab's size
])
@pytest.mark.parametrize("name", LAB_NAMES)
def test_lab_kernels_match_plain(dev, geom, name):
    """Each lab kernel against its plain version on a padded buffer; the
    full-function variants (the staged B/C/D, G, S2*, combo*, every strip
    height, M*, S*, Slong*, T*: the tensor cores' sums) within 1 LSB of
    the product kernel."""
    b, h, w, dh, dw = geom
    rows = h * 3 // 2 + 8
    x = kv.make_frames(b, rows, w, dev, seed=h + w)
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    c = kv.case(name, b, rows, **geo)
    out, ref = c.call(x), c.plain(x)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (b, 3, dh, dw)
    if name == "floor":
        assert torch.equal(out, ref)
    else:
        _assert_close(out, ref, (name, geom), c.tolerance(x))
    if c.full_function and c.exact:
        assert torch.equal(out, nv12_preprocess(x, **geo)), (name, geom)
    elif c.full_function:   # the tensor cores' sums, within 1 LSB
        _assert_close(out, nv12_preprocess(x, **geo), (name, geom))


NEW_LAB_NAMES = ["S", "Slong", "S2t32a8", "S2t16a8", "S2t24a8", "S2t48a8",
                 "S2t32a32", "combo2x32", "combo4x32", "combo2x64",
                 "combo1x64", "combo2x16", "combo4x16", "T", "G", "S16",
                 "Slong16", "T16"]


@pytest.mark.parametrize("geom", [
    (4, 90, 162, 20, 50),    # a last strip of 4 rows, a group of one strip
    (4, 62, 130, 30, 34),    # a last group of 14 rows
])
@pytest.mark.parametrize("name", NEW_LAB_NAMES)
def test_static_grouped_transposed_ragged(dev, geom, name):
    """Partial last strips and groups, and widths that are not whole
    16-byte vectors (the scalar paths), against the product."""
    b, h, w, dh, dw = geom
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=dh + dw)
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    c = kv.case(name, b, h * 3 // 2, **geo)
    out, prod = c.call(x), nv12_preprocess(x, **geo)
    torch.cuda.synchronize()
    if c.exact:
        assert torch.equal(out, prod), (name, geom)
    else:
        _assert_close(out, prod, (name, geom))
    _assert_close(out, c.plain(x), (name, geom))


def test_static_bank_follows_alternating_geometries(dev):
    """S, Slong and T (S2's block; the earlier S's constant bank, which
    held one geometry, is gone) follow two alternating geometries in one
    process with S2's tables cached per geometry: S2's bits at their strip
    each time. The combo follows them too: S2's bits at 16-row strips
    each time."""
    geos = [dict(src_w=256, src_h=144, dst_w=96, dst_h=64),
            dict(src_w=320, src_h=180, dst_w=64, dst_h=48)]
    xs = [kv.make_frames(2, g["src_h"] * 3 // 2, g["src_w"], dev, seed=i)
          for i, g in enumerate(geos)]
    for i in (0, 1, 0, 1, 0):
        for tile in (32, 16):
            s2 = kv.static_kernel2(xs[i], **geos[i], tile=tile, align=8)
            for short in (True, False):
                out = kv.static_kernel(xs[i], **geos[i], shortchain=short,
                                       tile=tile)
                assert torch.equal(out, s2), (i, tile, short)
            assert torch.equal(kv.transposed_chroma(xs[i], **geos[i],
                                                    tile=tile), s2), (i, tile)
        out = kv.combo_kernel(xs[i], **geos[i], gframes=2, tile=16)
        assert torch.equal(out, kv.static_kernel2(xs[i], **geos[i], tile=16,
                                                  align=8)), i
        _assert_close(out, nv12_preprocess(xs[i], **geos[i]), i)


@pytest.mark.parametrize("geom", [
    (8, 1080, 1920, 224, 224),  # the lab's size
    (3, 150, 322, 70, 202),     # ragged stages and tiles, an odd batch
    (1, 62, 130, 30, 34),       # widths that are not whole vectors
])
def test_nv12_preprocess_equals_the_lab_full_and_slong(dev, geom):
    """The lab's ``S``, ``Slong`` and ``T`` (csrc/nv12_chains.cu: S2's
    block with the TPU's cast chains, or the chroma H rows kept
    interleaved) at 32 and 16 rows give S2's bits at their strip (every
    uint8 is exact in bf16 by each chain; T moves the chroma sums, not
    their sums), within the envelope of the streaming kernel. The lab's
    ``full`` runs S2's tensor-core kernel (csrc/nv12_static2.cu at 16-row
    strips), whose sums take the tensor cores' order: within the
    envelope."""
    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=h + dw)
    out = nv12_preprocess(x, **geo)
    for tile in (32, 16):
        s2 = kv.static_kernel2(x, **geo, tile=tile, align=8)
        for name in ("S", "Slong", "T"):
            name += "" if tile == 32 else "16"
            got = kv.case(name, b, h * 3 // 2, **geo).call(x)
            assert torch.equal(got, s2), (name, geom)
            _assert_close(got, out, (name, geom))
    _assert_close(kv.case("full", b, h * 3 // 2, **geo).call(x), out, geom)


@pytest.mark.parametrize("kind", ["nv12", "i420", "422", "444"])
def test_swept_tile19_geometry_is_bit_equal(dev, kind):
    """A sweep of 64 x 1080p -> 224 NV12 once gave other bits at the block
    of column tile 19, 4-row stages and one 224-row strip, in a build whose
    H items summed four rows. Forced through the launcher, that block gives
    the FMA kernel's own entry's bits (NV12's wrapper takes the
    tensor-core route at this shape: ``_nv12_preprocess_banded``) on each
    of 20 launches in every layout, and the entry agrees with the plain
    version."""
    from vali_tpu_torch.lab import preprocess_ab as ab
    from vali_tpu_torch.ops import _cuda_build, banded
    from vali_tpu_torch.ops.resize import LANCZOS_AA

    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    planes = ab.make_planes(kind, 64, 1920, 1080, dev, seed=19)
    cdt, _ = ab.checked(kind, planes, geo, {})
    layout = ab.KINDS[kind][2]
    bands = banded._layout_bands(1920, 1080, 224, 224, LANCZOS_AA,
                                 "420" if layout == "nv12" else layout, cdt)
    block = next(b for _, b in banded.preprocess_candidates(
        bands, layout, 1, 2, 64, banded.sm_count(dev))
        if b[0] == 19 and b[3] == 4 and b[4] == 224)
    if kind == "nv12":
        assert block[:7] == (19, 224, 224, 4, 224, 82, 41)
    want = ab.fma_call(kind, planes, geo, {})
    fn = ab.launcher(_cuda_build.load_kernels(), kind, planes, geo, {},
                     False, ab.tables_for(kind, planes, geo, cdt,
                                          block=block))
    for i in range(20):
        assert torch.equal(ab.bits(fn()), ab.bits(want)), (kind, i)
    plain = {"nv12": nv12_preprocess_plain, "i420": yuv420_preprocess_plain,
             "422": yuv422_preprocess_plain,
             "444": yuv444_preprocess_plain}[kind]
    _assert_close(want, plain(*planes, **geo), (kind, block))


# --- nv12_preprocess's tensor-core route (csrc/nv12_wgmma_preprocess.cu) --


def test_route_equals_the_lab_t16_with_both_libraries_loaded(dev):
    """At 64 x 1080p -> 224 the routed wrapper gives the lab's T16 bits
    (csrc/nv12_chains.cu at 16 rows: the same block and instance in the
    labs' library), whichever library launches first and on every turn:
    what static2_passes.cuh keeps per kernel has internal linkage in both
    libraries, so neither launches with the other's shared-memory
    allowance. Both lie within the envelope of the FMA kernel."""
    from vali_tpu_torch.ops import _cuda_build
    from vali_tpu_torch.ops.nv12_preprocess import (_nv12_preprocess_banded,
                                                    nv12_route)

    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(64, 1620, 1920, dev, seed=31)
    assert nv12_route(x, **geo) == "wgmma"
    _cuda_build.load_lab_kernels()
    _cuda_build.load_kernels()
    first = kv.transposed_chroma(x, **geo, tile=16)
    for turn in range(3):
        routed = nv12_preprocess(x, **geo)
        lab = kv.transposed_chroma(x, **geo, tile=16)
        torch.cuda.synchronize()
        assert torch.equal(routed, first), turn
        assert torch.equal(lab, first), turn
    _assert_close(first, _nv12_preprocess_banded(x, **geo), "T16 vs FMA")


def test_routed_call_is_one_kernel_the_roofline_metric_finds(dev):
    """A profiled routed call runs exactly one device kernel, and its name
    is what perfbench's nv12_preprocess_roofline finds (a
    ``preprocess_kernel<..., 0>`` with no cast in its arguments) and not
    what yuv420_preprocess_roofline finds."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.metrics import nv12_preprocess_roofline as nv12_metric
    from perfbench.metrics import yuv420_preprocess_roofline as i420_metric

    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(8, 1620, 1920, dev, seed=32)
    nv12_preprocess(x, **geo)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        nv12_preprocess(x, **geo)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_time_total and e.count]
    assert len(kernels) == 1, kernels
    assert sum(e.count for e in prof.key_averages()
               if e.key == kernels[0]) == nv12_metric.LAUNCHES_PER_CALL
    assert nv12_metric.KERNEL.search(kernels[0]), kernels
    assert not i420_metric.KERNEL.search(kernels[0]), kernels


def test_route_counters_count(dev):
    """``routes.nv12_preprocess.wgmma`` counts the routed calls,
    ``routes.nv12_preprocess.banded`` those on the FMA kernel (the float32
    compute knob, a float output, P010, the FMA kernel's own entry, a
    geometry the block refuses), and ``launches.nv12_preprocess`` both."""
    from vali_tpu_torch.ops.nv12_preprocess import _nv12_preprocess_banded

    def routes():
        c = tracing.counters()
        return tuple(c.get(f"routes.nv12_preprocess.{r}", 0)
                     for r in ("wgmma", "banded"))

    geo = dict(src_w=256, src_h=144, dst_w=96, dst_h=64)
    x = kv.make_frames(2, 216, 256, dev, seed=33)
    p10 = torch.zeros((2, 216, 256), dtype=torch.uint16, device=dev)
    (w0, b0), n0 = routes(), launches(nv12_preprocess)
    nv12_preprocess(x, **geo)
    nv12_preprocess(x, **geo)
    assert routes() == (w0 + 2, b0)
    nv12_preprocess(x, **geo, compute_dtype=torch.float32)
    nv12_preprocess(x, **geo, out_dtype=torch.float32)
    nv12_preprocess(p10, **geo)
    _nv12_preprocess_banded(x, **geo)
    big = kv.make_frames(1, 1620, 1920, dev, seed=34)
    nv12_preprocess(big, src_w=1920, src_h=1080, dst_w=32, dst_h=32)
    torch.cuda.synchronize()
    assert routes() == (w0 + 2, b0 + 5)
    assert launches(nv12_preprocess) == n0 + 7
    nv12_preprocess(x.cpu(), **geo)     # the plain version: not a launch
    assert routes() == (w0 + 2, b0 + 5)


@pytest.mark.parametrize("geom", [
    (2, 144, 256, 64, 96),     # down
    (2, 144, 256, 200, 320),   # up on both axes
    (3, 96, 322, 150, 70),     # up rows, down columns, ragged
])
@pytest.mark.parametrize("method", ["lanczos", "bilinear", "nearest",
                                    "lanczos_aa", "bilinear_aa"])
def test_route_matches_plain_and_fma_at_every_method(dev, geom, method):
    """Every resize method takes the route at these shapes, up and down,
    and lies within the kernels' envelope of the plain version and of the
    FMA kernel's own entry."""
    from vali_tpu_torch.ops.nv12_preprocess import (_nv12_preprocess_banded,
                                                    nv12_route)

    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh, method=method)
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=h + dw)
    assert nv12_route(x, **geo) == "wgmma"
    out = nv12_preprocess(x, **geo)
    _assert_close(out, nv12_preprocess_plain(x, **geo), (geom, method))
    _assert_close(out, _nv12_preprocess_banded(x, **geo), (geom, method))


@pytest.mark.parametrize("name", ["S2t32a8", "S2t48a8", "combo2x32",
                                  "combo1x64"])
def test_column_range_strips_equal_the_product(dev, name):
    """Tall strips at 1080p run one 64-column output tile a block (the lab
    line says so) and lie within the kernels' envelope of the product (the
    tensor cores' sums); combo2x32 gives S2 t32a8's bits (its warpgroups
    split the chunks as S2's do), combo1x64 (the strip's rows split) lies
    within the envelope of its plain version."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(4, 1620, 1920, dev, seed=11)
    c = kv.case(name, 4, 1620, **geo)
    assert "column ranges, one 64-column output tile each" in c.note
    assert not c.exact
    out = c.call(x)
    _assert_close(out, nv12_preprocess(x, **geo), name)
    _assert_close(out, c.plain(x), name)
    if name == "combo2x32":
        assert torch.equal(out, kv.static_kernel2(x, **geo, tile=32,
                                                  align=8))


def test_new_lab_wrappers_count_launches_and_reject_bad_input(dev):
    h, w = 96, 256
    x = kv.make_frames(4, h * 3 // 2, w, dev, seed=4)
    geo = dict(src_w=w, src_h=h, dst_w=32, dst_h=32)
    new = (kv.static_kernel, kv.static_kernel2, kv.combo_kernel,
           kv.transposed_chroma, kv.grouped_kernel)
    before = [f.launches for f in new]
    for f in new:
        f(x, **geo)
    after = [n + 1 for n in before]
    assert [f.launches for f in new] == after
    pitched = torch.zeros((4, h * 3 // 2, 2 * w), dtype=torch.uint8,
                          device=dev)[:, :, ::2]
    for f in new:
        with pytest.raises(ValueError, match="contiguous"):
            f(pitched, **geo)
    with pytest.raises(ValueError, match="multiple"):
        kv.combo_kernel(x, **geo, gframes=3)
    with pytest.raises(ValueError, match="tile and align"):
        kv.static_kernel2(x, **geo, tile=0)
    big = torch.zeros((1, 3240, 3840), dtype=torch.uint8, device=dev)
    for f in (kv.static_kernel, kv.transposed_chroma):
        with pytest.raises(ValueError, match="shared memory"):
            f(big, src_w=3840, src_h=2160, dst_w=224, dst_h=224)
        with pytest.raises(ValueError, match="strips of 16 and 32"):
            f(x, **geo, tile=24)
    assert [f.launches for f in new] == after


@pytest.mark.parametrize("name", ["B", "D", "M2", "M8", "hpass", "wpass",
                                  "floor", "S", "S2t32a8", "combo2x32", "T",
                                  "G", "Slong16", "T16"])
def test_lab_kernels_padded_strided_views(dev, name):
    """A padded row pitch and a larger batch stride give the output of the
    contiguous buffer."""
    b, h, w, dh, dw = 8 if name == "M8" else 4, 96, 256, 40, 48
    rows = h * 3 // 2
    x = kv.make_frames(b, rows, w, dev, seed=5)
    c = kv.case(name, b, rows, src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    big = torch.zeros((b, rows, w + 32), dtype=torch.uint8, device=dev)
    big[:, :, :w] = x
    assert torch.equal(c.call(big[:, :, :w]), c.call(x))


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("tile,align", [(16, 8), (24, 8), (32, 8), (48, 8),
                                        (32, 32)])
def test_static2_single_frame_and_odd_batch(dev, b, tile, align):
    """S2 at every sweep point on one 1080p frame and on an odd batch:
    within the envelope of nv12_preprocess and of its plain version."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(b, 1620, 1920, dev, seed=b + tile)
    out = kv.static_kernel2(x, **geo, tile=tile, align=align)
    torch.cuda.synchronize()
    assert out.shape == (b, 3, 224, 224)
    _assert_close(out, nv12_preprocess(x, **geo), (b, tile, align))
    _assert_close(out, kv.static_kernel2_plain(x, **geo, tile=tile,
                                               align=align), (b, tile, align))


def test_static2_refuses_what_does_not_fit_before_a_launch(dev):
    """A strip height that is not a multiple of 8 up to 48, and windows
    whose ring passes a block's shared memory, raise before any launch."""
    x = kv.make_frames(1, 216, 256, dev)
    before = kv.static_kernel2.launches
    for tile in (12, 56):
        with pytest.raises(ValueError, match="multiple of 8"):
            kv.static_kernel2(x, src_w=256, src_h=144, dst_w=96, dst_h=64,
                              tile=tile)
    with pytest.raises(ValueError, match="shared memory"):
        kv.static_kernel2(torch.zeros((1, 3240, 3840), dtype=torch.uint8,
                                      device=dev),
                          src_w=3840, src_h=2160, dst_w=224, dst_h=32)
    assert kv.static_kernel2.launches == before


COMBO = [(2, 16), (4, 16), (2, 32), (4, 32), (1, 64), (2, 64)]


@pytest.mark.parametrize("geom", [
    (4, 1080, 1920, 224, 224),  # the lab's size
    (8, 144, 256, 64, 96),      # 16-byte loads
    (4, 150, 322, 70, 202),     # ragged stages, tiles and strips
    (4, 62, 130, 30, 34),       # widths that are not whole vectors
])
@pytest.mark.parametrize("gframes,tile", COMBO)
def test_combo_within_the_envelope_and_equal_to_s2_replayed(dev, geom,
                                                            gframes, tile):
    """Each combo instance on 20 replays equals its first output, lies
    within the envelope of its plain version and of nv12_preprocess, and
    where its warpgroups split the chunks as S2's do equals S2 at the same
    strip height bit for bit (no race checker runs on the card: the
    replays stand in for one)."""
    from vali_tpu_torch.ops.banded import COMBO_SPLITS

    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=h + tile + gframes)
    first = kv.combo_kernel(x, **geo, gframes=gframes, tile=tile).clone()
    for i in range(20):
        assert torch.equal(kv.combo_kernel(x, **geo, gframes=gframes,
                                           tile=tile), first), i
    torch.cuda.synchronize()
    assert first.shape == (b, 3, dh, dw)
    _assert_close(first, kv.static_kernel2_plain(x, **geo, tile=tile,
                                                 align=8), geom)
    _assert_close(first, nv12_preprocess(x, **geo), geom)
    if COMBO_SPLITS[gframes, tile] == "chunks":
        assert torch.equal(first, kv.static_kernel2(x, **geo, tile=tile,
                                                    align=8))


@pytest.mark.parametrize("gframes,tile", COMBO)
def test_combo_padded_strided_and_misaligned_views(dev, gframes, tile):
    """A padded row pitch, a larger batch stride and rows that start off
    16-byte alignment (the element loads) give the contiguous buffer's
    output; each launch counts once."""
    b, h, w, dh, dw = 4, 96, 256, 40, 48
    rows = h * 3 // 2
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = kv.make_frames(b, rows, w, dev, seed=5)
    want = kv.combo_kernel(x, **geo, gframes=gframes, tile=tile)
    padded = torch.zeros((b, rows + 3, w + 32), dtype=torch.uint8,
                         device=dev)
    padded[:, :rows, :w] = x
    shifted = torch.zeros((b, rows, w + 17), dtype=torch.uint8, device=dev)
    shifted[:, :, 1:w + 1] = x
    before = kv.combo_kernel.launches
    for view in (padded[:, :rows, :w], shifted[:, :, 1:w + 1]):
        assert torch.equal(kv.combo_kernel(view, **geo, gframes=gframes,
                                           tile=tile), want)
    assert kv.combo_kernel.launches == before + 2


def test_combo_refuses_what_does_not_fit_before_a_launch(dev):
    """A (gframes, tile) that is no instance, a batch that is not a
    multiple of gframes, and windows whose ring passes a block's shared
    memory raise before any launch."""
    x = kv.make_frames(4, 216, 256, dev)
    geo = dict(src_w=256, src_h=144, dst_w=96, dst_h=64)
    before = kv.combo_kernel.launches
    for g, t in ((1, 16), (2, 24), (4, 64), (2, 48)):
        with pytest.raises(ValueError, match=r"runs \(gframes, tile\)"):
            kv.combo_kernel(x, **geo, gframes=g, tile=t)
    with pytest.raises(ValueError, match="multiple"):
        kv.combo_kernel(x[:3], **geo, gframes=2, tile=16)
    with pytest.raises(ValueError, match="shared memory"):
        kv.combo_kernel(torch.zeros((2, 3240, 3840), dtype=torch.uint8,
                                    device=dev),
                        src_w=3840, src_h=2160, dst_w=224, dst_h=224,
                        gframes=2, tile=32)
    assert kv.combo_kernel.launches == before


PRODLIKE_NAMES = ["full4", "full", "hpass", "hpass32", "wpass", "wpass32",
                  "M2", "M4", "M8"]


@pytest.mark.parametrize("geom", [
    (8, 1080, 1920, 224, 224),  # the lab's size
    (8, 144, 256, 64, 96),      # 16-byte loads
    (8, 150, 322, 70, 202),     # ragged stages, tiles and strips
    (8, 62, 130, 30, 34),       # widths that are not whole vectors
])
@pytest.mark.parametrize("name", PRODLIKE_NAMES)
def test_prodlike_and_multiframe_replayed_and_within_their_bounds(
        dev, geom, name):
    """prod_like's and multiframe's tensor-core instances (and full at 16,
    S2's kernel) on 20 replays equal their first output (no race checker
    runs on the card: the replays stand in for one) and lie within the
    envelope of their plain versions (hpass within hpass_tolerance); M2 /
    M4 / M8 equal the combo at (G, 32), bit for bit."""
    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    rows = h * 3 // 2 + 8
    x = kv.make_frames(b, rows, w, dev, seed=h + len(name))
    c = kv.case(name, b, rows, **geo)
    first = c.call(x).clone()
    for i in range(20):
        assert torch.equal(c.call(x), first), i
    torch.cuda.synchronize()
    assert first.shape == (b, 3, dh, dw)
    _assert_close(first, c.plain(x), (name, geom), c.tolerance(x))
    if name.startswith("M"):
        g = int(name[1:])
        assert torch.equal(first, kv.combo_kernel(x, **geo, gframes=g,
                                                  tile=32))


@pytest.mark.parametrize("layout", ["mn_major", "k_major"])
def test_staged_shared_memory_a_product_equals_matmul(dev, layout):
    """One m64n16k16 wgmma with A read from shared memory through a
    descriptor (csrc/nv12_staged.cu's form), MN-major as the staged kernel
    lays out its operand and K-major, against torch.matmul of the same
    bf16 values: small integers, so every sum is exact."""
    from vali_tpu_torch.lab import staged as st
    from vali_tpu_torch.ops import _cuda_build
    from vali_tpu_torch.ops.banded import core_matrix_order

    rng = np.random.default_rng(7)
    a = rng.integers(-8, 9, (64, 16)).astype(np.float32)
    bnk = rng.integers(-8, 9, (16, 16)).astype(np.float32)   # [N, K]
    mn = layout == "mn_major"
    lbo, sbo = (128, 2064) if mn else (1024, 128)
    img = st.operand_image(st.bf16_bits(a), lbo, sbo, mn)
    a_img = torch.from_numpy(img).to(dev)
    b_img = torch.from_numpy(core_matrix_order(bnk)).to(dev, torch.bfloat16)
    d = torch.empty((64, 16), dtype=torch.float32, device=dev)
    lib = _cuda_build.load_lab_kernels()
    rc = lib.nv12_staged_probe_launch(
        a_img.data_ptr(), img.size // 16, b_img.data_ptr(), int(mn), lbo,
        sbo, d.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _cuda_build.check(lib, rc, "staged probe")
    torch.cuda.synchronize()
    want = torch.from_numpy(a) @ torch.from_numpy(bnk).T
    assert torch.equal(d.cpu(), want)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("mn_major", [True, False])
def test_chains_probe_pins_the_mn_major_b_descriptor(dev, n, mn_major):
    """One m64nNk16 wgmma with A from registers and B through a descriptor
    (csrc/nv12_chains.cu's probe): at N = 32 and 64, T's chroma W products
    at 16- and 32-row strips, with T's offsets (leading byte offset
    kGroupC along K, stride 128 along N), MN-major as T lays out its
    operand and K-major as S2 does, against the matmul of the same small
    integers (every sum exact)."""
    from vali_tpu_torch.lab import chains_ab
    from vali_tpu_torch.ops import _cuda_build

    assert chains_ab.probe(_cuda_build.load_lab_kernels(), n, mn_major,
                           seed=n + mn_major)


@pytest.mark.parametrize("geom", [
    (1, 1080, 1920, 224, 224),  # one frame of the lab's size
    (5, 1080, 1920, 224, 224),  # an odd batch
    (3, 150, 322, 70, 202),     # ragged strips and tiles, element loads
    (2, 96, 256, 40, 48),       # TMA at a small shape
])
def test_staged_b_c_d_within_the_envelope_and_b_equal_c(dev, geom):
    """The staged B, C and D within the envelope of nv12_preprocess and of
    their plain version; B and C (equal operands by two cast chains)
    equal bit for bit; D within the envelope of S2 t16a8, whose products
    it issues."""
    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=b + w)
    prod, plain = nv12_preprocess(x, **geo), nv12_preprocess_plain(x, **geo)
    outs = {v: kv.variant_kernel(x, **geo, variant=v) for v in kv.VARIANTS}
    torch.cuda.synchronize()
    for v, out in outs.items():
        assert out.shape == (b, 3, dh, dw)
        _assert_close(out, prod, (v, geom))
        _assert_close(out, plain, (v, geom))
    assert torch.equal(outs["B"], outs["C"])
    _assert_close(outs["D"], kv.static_kernel2(x, **geo, tile=16, align=8),
                  geom)


@pytest.mark.parametrize("variant", ["B", "D"])
def test_staged_element_loads_equal_tma(dev, variant):
    """A view TMA cannot take (start not 16-byte aligned) fills the same
    landing ring with element loads: the contiguous buffer's bits."""
    from vali_tpu_torch.lab import staged as st

    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(3, 1620, 1920, dev, seed=9)
    big = torch.zeros((3, 1620, 1920 + 32), dtype=torch.uint8, device=dev)
    big[:, :, 1:1921] = x
    view = big[:, :, 1:1921]
    assert st.tma_ok(x, 1920, 1080) and not st.tma_ok(view, 1920, 1080)
    assert torch.equal(kv.variant_kernel(view, **geo, variant=variant),
                       kv.variant_kernel(x, **geo, variant=variant))


@pytest.mark.parametrize("b", [1, 5])
def test_staged_d_at_32_rows_within_the_envelope(dev, b):
    """D built for 32-row strips (the A/B's arm, one block an SM) within
    the envelope of nv12_preprocess and of the plain version."""
    from vali_tpu_torch.ops.banded import tail_params

    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(b, 1620, 1920, dev, seed=32 + b)
    tail = tail_params(ColorSpace.BT_709, ColorRange.MPEG, 1.0, torch.uint8,
                       None)
    out = kv.staged_launch(x, tail, **geo, variant="D", tile=32)
    torch.cuda.synchronize()
    _assert_close(out, nv12_preprocess(x, **geo), b)
    _assert_close(out, nv12_preprocess_plain(x, **geo), b)


def test_staged_refuses_what_does_not_fit_before_a_launch(dev):
    """Windows whose landing ring and operand buffers pass a block's
    shared memory (4K -> 32 rows) raise before any launch."""
    before = kv.variant_kernel.launches
    for v in kv.VARIANTS:
        with pytest.raises(ValueError, match="shared memory"):
            kv.variant_kernel(torch.zeros((1, 3240, 3840), dtype=torch.uint8,
                                          device=dev),
                              src_w=3840, src_h=2160, dst_w=224, dst_h=32,
                              variant=v)
    assert kv.variant_kernel.launches == before


@pytest.mark.parametrize("b", [1, 5])
def test_grouped_single_frame_and_odd_batch(dev, b):
    """G on one 1080p frame and on an odd batch: within the envelope of
    nv12_preprocess and of its plain version."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(b, 1620, 1920, dev, seed=b)
    out = kv.grouped_kernel(x, **geo)
    torch.cuda.synchronize()
    assert out.shape == (b, 3, 224, 224)
    _assert_close(out, nv12_preprocess(x, **geo), b)
    _assert_close(out, kv.grouped_kernel_plain(x, **geo), b)


def test_grouped_on_a_side_stream_read_after_an_event(dev):
    """G launched on a non-default stream and read on another after an
    event gives the default stream's output."""
    geo = dict(src_w=1920, src_h=1080, dst_w=224, dst_h=224)
    x = kv.make_frames(8, 1620, 1920, dev, seed=3)
    want = kv.grouped_kernel(x, **geo)
    side, reader = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    done = torch.cuda.Event()
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        out = kv.grouped_kernel(x, **geo)
        done.record(side)
    with torch.cuda.stream(reader):
        reader.wait_event(done)
        got = out.clone()
    reader.synchronize()
    assert torch.equal(got, want)


def test_grouped_refuses_what_does_not_fit_before_a_launch(dev):
    """Windows over 256 rows (4K -> 32 rows) and H rows too wide for a
    block's shared memory (an 8K frame) raise before any launch."""
    before = kv.grouped_kernel.launches
    with pytest.raises(ValueError, match="exceed"):
        kv.grouped_kernel(torch.zeros((1, 3240, 3840), dtype=torch.uint8,
                                      device=dev),
                          src_w=3840, src_h=2160, dst_w=32, dst_h=32)
    with pytest.raises(ValueError, match="shared memory"):
        kv.grouped_kernel(torch.zeros((1, 144, 7680), dtype=torch.uint8,
                                      device=dev),
                          src_w=7680, src_h=96, dst_w=224, dst_h=32)
    assert kv.grouped_kernel.launches == before


@pytest.mark.parametrize("geom", [
    (8, 1080, 1920, 224, 224),  # the lab's size
    (3, 150, 322, 70, 202),     # ragged strips and tiles, scalar loads
    (4, 90, 162, 20, 50),       # a last strip of 4 rows
])
def test_grouped_other_wpass_build_within_the_envelope(dev, geom):
    """csrc/nv12_grouped.cu built with the other W pass
    (-DNV12_GROUPED_WPASS) stays within the envelope of the default build,
    of nv12_preprocess and of the plain version."""
    from vali_tpu_torch.lab import grouped_ab

    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=h + dw)
    lib = grouped_ab.build_current(
        [f"-DNV12_GROUPED_WPASS={grouped_ab.OTHER_WPASS}"])
    out = grouped_ab.launcher(lib, x, geo, False)()
    torch.cuda.synchronize()
    _assert_close(out, kv.grouped_kernel(x, **geo), geom)
    _assert_close(out, nv12_preprocess(x, **geo), geom)
    _assert_close(out, kv.grouped_kernel_plain(x, **geo), geom)


def test_stream_floor_sink_reads_every_byte(dev):
    """On a zeroed sink the XOR of its words is the XOR of every 32-bit
    word of the frames, and one byte changed outside the two output
    corners changes the sink but not the output."""
    rows, w, dh, dw = 216, 256, 64, 96
    x = kv.make_frames(2, rows, w, dev, seed=3)
    fl = dict(rows=rows, W=w, DH=dh, DW=dw)

    def run(frames):
        sink = torch.zeros(kv.SINK_WORDS, dtype=torch.int32, device=dev)
        out = kv.stream_floor(frames, **fl, sink=sink)
        return out, sink.cpu().numpy().view(np.uint32)

    out, sink = run(x)
    words = x.cpu().numpy().view(np.uint32).ravel()
    assert np.bitwise_xor.reduce(sink) == np.bitwise_xor.reduce(words)
    y = x.clone()
    y[1, rows - dh - 2, 200] ^= 1
    out2, sink2 = run(y)
    assert torch.equal(out2, out)
    assert not np.array_equal(sink2, sink)


def test_lab_wrappers_count_launches_and_reject_bad_input(dev):
    h, w = 96, 256
    x = kv.make_frames(4, h * 3 // 2, w, dev, seed=2)
    geo = dict(src_w=w, src_h=h, dst_w=32, dst_h=32)
    before = [f.launches for f in kv.WRAPPERS]
    kv.stream_floor(x, rows=h * 3 // 2, W=w, DH=32, DW=32)
    kv.prod_like(x, **geo, mode="wpass")
    kv.variant_kernel(x, **geo, variant="D")
    kv.multiframe(x, **geo, gframes=2)
    # one launch each for these four wrappers, none for the others
    after = [n + (i < 4) for i, n in enumerate(before)]
    assert kv.WRAPPERS[:4] == (kv.stream_floor, kv.prod_like,
                               kv.variant_kernel, kv.multiframe)
    assert [f.launches for f in kv.WRAPPERS] == after
    kv.prod_like(x.cpu(), **geo)  # the plain version: not a launch
    pitched = torch.zeros((4, h * 3 // 2, 2 * w), dtype=torch.uint8,
                          device=dev)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        kv.variant_kernel(pitched, **geo)
    with pytest.raises(ValueError, match="contiguous"):
        kv.stream_floor(pitched, rows=h * 3 // 2, W=w, DH=32, DW=32)
    with pytest.raises(ValueError, match="multiple"):
        kv.multiframe(x, **geo, gframes=3)
    big = kv.make_frames(1, 1620, 1920, dev)
    # 64-row strips: S2's block needs 303,488 B of shared memory
    with pytest.raises(ValueError, match="shared memory"):
        kv.prod_like(big, src_w=1920, src_h=1080, dst_w=224, dst_h=224,
                     rows_per_block=64)
    assert [f.launches for f in kv.WRAPPERS] == after


# --- the NV12 resize lab (csrc/nv12_phases.cu, nv12_aligned.cu, ----------
# --- nv12_skewed.cu, nv12_streamed.cu, nv12_slabs.cu, nv12_striped.cu) ----

RESIZE_LAB_NAMES = [n for n in rd.DEFAULT_NAMES if n != "prod"]


@pytest.mark.parametrize("geom", [
    (3, 288, 512, 144, 256),    # the CPU tests' geometry
    (2, 150, 322, 70, 202),     # dst_h % 8 != 0, tiles that do not divide DW
])
@pytest.mark.parametrize("name", RESIZE_LAB_NAMES)
def test_resize_lab_kernels_match_plain(dev, geom, name):
    """Each resize-lab kernel against its plain version: ``dma_only``
    equal, ``h_only``'s low bytes within h_only_tolerance (mod 256), the
    others within the uint8 envelope (tensor-core sums); ``both`` equals
    aligned8x32's luma rows, the full-function variants keep within the
    envelope of nv12_resize."""
    b, h, w, dh, dw = geom
    x = rd.make_frames(b, h * 3 // 2, w, dev, seed=h + w)
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    c = rd.case(name, b, **geo)
    out, ref = c.call(x), c.plain(x)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    if name == "dma_only":
        assert torch.equal(out, ref)
    elif name == "h_only":
        assert c.within(out, x), (name, geom)
    else:
        _assert_close(out, ref, (name, geom))
    if c.exact:
        assert torch.equal(out, c.reference(x)), (name, geom)
    elif name != "h_only":
        _assert_close(out, c.reference(x), (name, geom))


@pytest.mark.parametrize("h_align,w_align", [(8, 32), (32, 128), (4, 16),
                                             (4, 8)])
def test_aligned_within_the_envelope_of_nv12_resize_at_4k(dev, h_align,
                                                          w_align):
    """The tensor-core aligned kernel at 4K -> 1080p (four frames): within
    1 LSB on fewer than 1e-3 of the samples of nv12_resize and of its plain
    version, and the wrapper's output is the launcher's every call."""
    geo = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(4, 3240, 3840, dev, seed=h_align + w_align)
    out = rd.aligned_resize(x, **geo, h_align=h_align, w_align=w_align)
    _assert_close(out, nv12_resize(x, **geo), (h_align, w_align))
    _assert_close(out, nv12_resize_plain(x, **geo), (h_align, w_align))
    assert torch.equal(out, rd.aligned_resize(x, **geo, h_align=h_align,
                                              w_align=w_align))


def test_aligned_refuses_before_any_launch(dev):
    """A window past the kernel's K or a block past its shared memory
    raises ValueError on the card too, and launches nothing."""
    before = rd.aligned_resize.launches
    x = rd.make_frames(1, 96, 8192, dev)
    with pytest.raises(ValueError, match="shared memory"):
        rd.aligned_resize(x, src_w=8192, src_h=64, dst_w=64, dst_h=32)
    y = rd.make_frames(1, 3240, 3840, dev)
    with pytest.raises(ValueError, match="exceed"):
        rd.aligned_resize(y, src_w=3840, src_h=2160, dst_w=64, dst_h=16)
    assert rd.aligned_resize.launches == before


@pytest.mark.parametrize("band", [64, 256])
@pytest.mark.parametrize("geom", [
    (4, 2160, 3840, 1080, 1920),
    (3, 288, 512, 144, 256),
    (2, 150, 322, 70, 202),
    (3, 96, 256, 40, 120),
])
def test_streamed_equals_aligned_8x32(dev, geom, band):
    """The TMA-fed streamed kernel runs aligned's products at 8x32 (the
    same A fragments, B, k-step order and W tables), so its output equals
    aligned_resize(h_align=8, w_align=32) bit for bit, at 4K and at the
    lab tests' shapes, whichever staging the view takes."""
    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = rd.make_frames(b, h * 3 // 2, w, dev, seed=h + w + band)
    out = rd.streamed_resize(x, **geo, band=band)
    assert torch.equal(out, rd.aligned_resize(x, **geo, h_align=8,
                                              w_align=32)), (geom, band)
    _assert_close(out, nv12_resize(x, **geo), (geom, band))


def test_streamed_stages_by_tma_where_the_view_allows(dev):
    """A contiguous 4K batch takes the TMA staging; a view whose start and
    pitch are not multiples of 16 bytes (the (0, 3, 1) padding) takes the
    same kernel's element loads, with the same output."""
    geo = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(2, 3240, 3840, dev, seed=11)
    launches = rd.streamed_resize.launches
    tma = rd.streamed_resize.tma_launches
    ref = rd.streamed_resize(x, **geo)
    assert rd.streamed_resize.tma_launches == tma + 1
    b, h, w, dh, dw = 3, 96, 256, 40, 120
    small = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    y = rd.make_frames(b, h * 3 // 2, w, dev, seed=5)
    big = torch.zeros((b, h * 3 // 2, w + 4), dtype=torch.uint8, device=dev)
    big[:, :, 1:1 + w] = y
    view = big[:, :, 1:1 + w]
    assert not rd.tma_stageable(view) and rd.tma_stageable(x)
    assert torch.equal(rd.streamed_resize(view, **small),
                       rd.streamed_resize(y, **small))
    assert rd.streamed_resize.launches == launches + 3
    assert rd.streamed_resize.tma_launches == tma + 2
    assert torch.equal(ref, rd.aligned_resize(x, **geo))


@pytest.mark.parametrize("name", ["dma_only", "h_only", "w_only", "both",
                                  "aligned8x32", "aligned4x8", "skewed",
                                  "streamed64", "slabs4", "striped3dyn",
                                  "striped3relay", "striped2unroll"])
def test_resize_lab_kernels_padded_strided_views(dev, name):
    """Extra rows, a padded row pitch (16-byte aligned, then not) and a
    larger batch stride give the output of the contiguous buffer."""
    b, h, w, dh, dw = 3, 96, 256, 40, 120
    rows = h * 3 // 2
    x = rd.make_frames(b, rows, w, dev, seed=5)
    c = rd.case(name, b, src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    ref = c.call(x)
    for pad_rows, pad_cols, off in ((6, 16, 0), (0, 3, 1)):
        big = torch.zeros((b, rows + pad_rows, w + pad_cols + off),
                          dtype=torch.uint8, device=dev)
        big[:, :rows, off:off + w] = x
        assert torch.equal(c.call(big[:, :, off:off + w]), ref), \
            (name, pad_rows, pad_cols, off)


@pytest.mark.parametrize("b", [1, 3])
def test_skewed_resize_single_and_odd_batches(dev, b):
    """The skew crosses frames: one frame (no overlap) and an odd count
    (the last W pass from the other buffer), G frames a block or the
    batch, equal aligned8x32, within the envelope of nv12_resize."""
    geo = dict(src_w=512, src_h=288, dst_w=256, dst_h=144)
    x = rd.make_frames(b, 432, 512, dev, seed=b)
    ref = rd.aligned_resize(x, **geo)
    for g in (1, 2, None):
        out = rd.skewed_resize(x, **geo, frames_per_block=g)
        assert torch.equal(out, ref), g
        _assert_close(out, nv12_resize(x, **geo), g)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("g", [2, 4, 8, None])
@pytest.mark.parametrize("geom", [(288, 512, 144, 256), (150, 322, 70, 202),
                                  (2160, 3840, 1080, 1920)])
def test_skewed_every_g_equals_aligned_8x32(dev, geom, g, b):
    """Every G of the lab (2, 4, 8, the batch) issues aligned's products
    per (strip, column) in aligned's order: aligned8x32's bits, for one
    frame, an odd batch and the lab's 16."""
    h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = rd.make_frames(b, h * 3 // 2, w, dev, seed=b + h)
    out = rd.skewed_resize(x, **geo, frames_per_block=g)
    assert torch.equal(out, rd.aligned_resize(x, **geo)), (geom, g, b)


@pytest.mark.parametrize("pad,off", [(64, 0), (16, 1)])
def test_skewed_padded_and_misaligned_views(dev, pad, off):
    """A padded pitch (cp.async) and a misaligned view (element loads)
    give the contiguous buffer's output, at every G."""
    geo = dict(src_w=322, src_h=150, dst_w=202, dst_h=70)
    x = rd.make_frames(5, 225, 322, dev, seed=9)
    view = padded_view(x, pad, off)
    for g in (2, 4, None):
        assert torch.equal(rd.skewed_resize(view, **geo, frames_per_block=g),
                           rd.aligned_resize(x, **geo)), (pad, off, g)


def test_skewed_refuses_other_alignments_and_keeps_two_blocks_an_sm(dev):
    """Another alignment is refused on the card before any launch; at 4K
    both planes' blocks are resident two to an SM."""
    geo = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(2, 3240, 3840, dev)
    before = rd.skewed_resize.launches
    with pytest.raises(ValueError, match="8, 32 only"):
        rd.skewed_resize(x, **geo, h_align=32, w_align=128)
    with pytest.raises(ValueError, match="frames_per_block"):
        rd.skewed_resize(x, **geo, frames_per_block=0)
    assert rd.skewed_resize.launches == before
    assert rd.resident_blocks(x, **geo, mode="skewed") == (2, 2)
    assert rd.resident_blocks(x, **geo, mode="both") == (2, 2)


@pytest.mark.parametrize("mode", ["dma_only", "h_only", "w_only", "both"])
@pytest.mark.parametrize("geom", [(3, 96, 256, 40, 120),
                                  (2, 144, 256, 72, 128),
                                  (2, 150, 322, 70, 202)])
@pytest.mark.parametrize("pad,off", [(0, 0), (64, 0), (16, 1)])
def test_phases_modes_match_plain_at_padded_and_misaligned_views(
        dev, mode, geom, pad, off):
    """Each knock-out on aligned's block against its plain version at the
    card tests' shapes, contiguous, at a padded pitch (cp.async) and a
    misaligned view (element loads): dma_only equal, h_only within
    h_only_tolerance, w_only within the envelope, both equal to
    aligned8x32's luma rows."""
    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = rd.make_frames(b, h * 3 // 2, w, dev, seed=h + pad + off)
    v = padded_view(x, pad, off) if pad else x
    c = rd.case(mode, b, **geo)
    out = rd.resize_phases(v, **geo, mode=mode)
    if mode in ("dma_only", "both"):
        assert torch.equal(out, c.reference(x)), (mode, geom)
    else:
        assert c.within(out, x), (mode, geom)


def test_phases_at_4k_within_their_tolerances(dev):
    """16 x 4K -> 1080p, as the lab runs it: both equals aligned8x32's luma
    rows, h_only lies within h_only_tolerance and w_only within the uint8
    envelope of their plain versions on fewer than 1e-3 of the samples,
    dma_only equals its plain version."""
    geo = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(16, 3240, 3840, dev)
    for mode in rd.MODES:
        c = rd.case(mode, 16, **geo)
        out = c.call(x)
        if mode in ("dma_only", "both"):
            assert torch.equal(out, c.reference(x)), mode
        else:
            assert c.within(out, x), mode


@pytest.mark.parametrize("mode", ["dma_only", "w_only"])
def test_resize_phases_sink_reads_every_byte(dev, mode):
    """On a zeroed sink the XOR of its words is the XOR of every 32-bit
    word of the frames (each byte folded by one block of aligned's grid,
    as lab/resize_diag.py sink_partition shares them), and one byte
    changed outside the output corner and the W pass's rows changes the
    sink but not the output."""
    h, w = 144, 256
    geo = dict(src_w=w, src_h=h, dst_w=128, dst_h=72)
    x = rd.make_frames(2, h * 3 // 2, w, dev, seed=3)

    def run(frames):
        sink = torch.zeros(rd.SINK_WORDS, dtype=torch.int32, device=dev)
        out = rd.resize_phases(frames, **geo, mode=mode, sink=sink)
        return out, sink.cpu().numpy().view(np.uint32)

    out, sink = run(x)
    words = x.cpu().numpy().view(np.uint32).ravel()
    assert np.bitwise_xor.reduce(sink) == np.bitwise_xor.reduce(words)
    y = x.clone()
    y[1, h + 10, 200] ^= 1
    out2, sink2 = run(y)
    assert torch.equal(out2, out)
    assert not np.array_equal(sink2, sink)


def test_resize_lab_wrappers_count_launches_and_reject_bad_input(dev):
    h, w = 96, 256
    geo = dict(src_w=w, src_h=h, dst_w=64, dst_h=48)
    x = rd.make_frames(2, h * 3 // 2, w, dev, seed=2)
    before = [f.launches for f in rd.WRAPPERS]
    rd.resize_phases(x, **geo, mode="h_only")
    rd.aligned_resize(x, **geo)
    rd.skewed_resize(x, **geo)
    rd.streamed_resize(x, **geo)
    rd.slabs_resize(x, **geo)
    rd.striped_resize(x, **geo, store="relay")
    after = [n + 1 for n in before]
    assert [f.launches for f in rd.WRAPPERS] == after
    rd.skewed_resize(x.cpu(), **geo)  # the plain version: not a launch
    pitched = torch.zeros((2, h * 3 // 2, 2 * w), dtype=torch.uint8,
                          device=dev)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        rd.streamed_resize(pitched, **geo)
    with pytest.raises(ValueError, match="contiguous"):
        rd.resize_phases(pitched, **geo, mode="dma_only")
    with pytest.raises(ValueError, match="sink"):
        rd.resize_phases(x, **geo, mode="both",
                         sink=torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="source rows of a strip"):
        rd.streamed_resize(x, **geo, band=4)
    with pytest.raises(ValueError, match="shared memory"):  # ring > smem
        rd.streamed_resize(x, **geo, band=4096)
    with pytest.raises(ValueError, match="unroll"):
        rd.striped_resize(x, **geo, nw=9, store="unroll")
    with pytest.raises(ValueError, match="nslabs"):
        rd.slabs_resize(x, **geo, nslabs=0)
    assert [f.launches for f in rd.WRAPPERS] == after


def _straddling_rows(src_h, dst_h, slab):
    """Output rows of the NV12 resize (luma, then chroma) whose row band
    crosses a slab edge of the buffer's rows."""
    from vali_tpu_torch.ops.banded import band_table
    from vali_tpu_torch.ops.resize import LANCZOS_AA, resize_weights

    out = []
    for row0, n, dn in ((0, src_h, dst_h), (src_h, src_h // 2, dst_h // 2)):
        start, count, _ = band_table(resize_weights(n, dn, LANCZOS_AA),
                                     torch.bfloat16)
        first = (row0 + start) // slab
        last = (row0 + start + count - 1) // slab
        out.append(first != last)
    return torch.from_numpy(np.concatenate(out))


@pytest.mark.parametrize("view", ["contiguous", "padded pitch",
                                  "misaligned view"])
@pytest.mark.parametrize("nslabs", [2, 4, 6, 16])
def test_slabs_equal_aligned_8x32_off_the_slab_edges(dev, nslabs, view):
    """Rows whose band lies inside one slab sum one piece, the other
    pieces adding exact zeros: aligned_resize(h_align=8, w_align=32)'s bits,
    whichever staging the view takes (TMA boxes for contiguous frames and a
    padded pitch, element loads for a view off 16 bytes). The rows whose
    band straddles an edge add two fp32 partials: every sample within the
    uint8 envelope of slabs_resize_plain and of nv12_resize."""
    h, w, dh, dw = 288, 512, 144, 256
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = rd.make_frames(3, h * 3 // 2, w, dev, seed=nslabs)
    if view != "contiguous":
        off = int(view == "misaligned view")
        big = torch.zeros((3, h * 3 // 2, w + 16 + off), dtype=torch.uint8,
                          device=dev)
        big[:, :, off:off + w] = x
        x = big[:, :, off:off + w]
    tma = rd.slabs_resize.tma_launches
    out = rd.slabs_resize(x, **geo, nslabs=nslabs)
    assert rd.slabs_resize.tma_launches == tma + (view != "misaligned view")
    ref = rd.aligned_resize(x, **geo, h_align=8, w_align=32)
    edge = _straddling_rows(h, dh, rd.slab_rows(h, nslabs)).to(dev)
    assert edge.any()
    assert torch.equal(out[:, ~edge], ref[:, ~edge])
    _assert_close(out, rd.slabs_resize_plain(x, **geo, nslabs=nslabs),
                  (nslabs, view))
    _assert_close(out, nv12_resize(x, **geo), (nslabs, view))


@pytest.mark.parametrize("nslabs", [2, 4, 6])
def test_slabs_at_4k_equal_aligned_8x32_off_the_slab_edges(dev, nslabs):
    """The lab's sweep points at 4K -> 1080p (four frames, staged by TMA):
    equal to aligned8x32 on every row whose band lies in one slab, within
    the uint8 envelope of slabs_resize_plain and nv12_resize, and the
    wrapper's output is the same every call."""
    geo = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(4, 3240, 3840, dev, seed=nslabs)
    out = rd.slabs_resize(x, **geo, nslabs=nslabs)
    edge = _straddling_rows(2160, 1080, rd.slab_rows(2160, nslabs)).to(dev)
    ref = rd.aligned_resize(x, **geo, h_align=8, w_align=32)
    assert torch.equal(out[:, ~edge], ref[:, ~edge])
    _assert_close(out, rd.slabs_resize_plain(x, **geo, nslabs=nslabs),
                  nslabs)
    _assert_close(out, nv12_resize(x, **geo), nslabs)
    assert torch.equal(out, rd.slabs_resize(x, **geo, nslabs=nslabs))


@pytest.mark.parametrize("nw,store", [(1, "dyn"), (8, "unroll"),
                                      (7, "relay"), (3, "unroll")])
def test_striped_stores_equal_nv12_resize(dev, nw, store):
    """One stripe, the most a cluster holds, and stripes that do not divide
    the row (stripes that own no tile, halos from several peers): each
    store gives aligned8x32's bits, within the uint8 envelope of
    nv12_resize."""
    geo = dict(src_w=322, src_h=150, dst_w=202, dst_h=70)
    x = rd.make_frames(2, 225, 322, dev, seed=nw)
    out = rd.striped_resize(x, **geo, nw=nw, store=store)
    assert torch.equal(out, rd.aligned_resize(x, **geo, h_align=8,
                                              w_align=32))
    _assert_close(out, nv12_resize(x, **geo), (nw, store))


STRIPED_4K = [(2, "dyn"), (3, "dyn"), (5, "dyn"), (6, "dyn"),
              (3, "relay"), (3, "unroll")]


@pytest.mark.parametrize("nw,store", STRIPED_4K)
def test_striped_at_4k_equals_aligned_8x32_on_20_replays(dev, nw, store):
    """The A/B's instances at 16 x 4K -> 1080p: 20 calls, each equal to
    aligned8x32 bit for bit (one reference: a race between the stripes'
    exchange and their W products would show as a call that differs), and
    within the uint8 envelope of nv12_resize and striped_resize_plain."""
    geo = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(16, 3240, 3840, dev, seed=nw)
    ref = rd.aligned_resize(x, **geo, h_align=8, w_align=32)
    for i in range(20):
        assert torch.equal(rd.striped_resize(x, **geo, nw=nw, store=store),
                           ref), (nw, store, i)
    _assert_close(ref, nv12_resize(x, **geo), (nw, store))
    _assert_close(ref, rd.striped_resize_plain(x, **geo, nw=nw), (nw, store))


@pytest.mark.parametrize("store", rd.STORES)
@pytest.mark.parametrize("geom", [(2, 150, 322, 70, 202),
                                  (3, 96, 256, 40, 120)])
def test_striped_ragged_strips_and_tiles_on_20_replays(dev, geom, store):
    """Ragged strips and tiles at every nw a store takes up to 8: 20 calls
    of each, every one aligned8x32's bits."""
    b, h, w, dh, dw = geom
    geo = dict(src_w=w, src_h=h, dst_w=dw, dst_h=dh)
    x = rd.make_frames(b, h * 3 // 2, w, dev, seed=w)
    ref = rd.aligned_resize(x, **geo, h_align=8, w_align=32)
    for nw in range(1, 9):
        for i in range(20):
            out = rd.striped_resize(x, **geo, nw=nw, store=store)
            assert torch.equal(out, ref), (nw, store, i)


@pytest.mark.parametrize("nw,store", STRIPED_4K)
def test_striped_clusters_are_resident_at_4k(dev, nw, store):
    """Each 4K instance's cluster of nw blocks fits the card (at least one
    resident a plane); relay runs no cluster."""
    geo = dict(src_w=3840, src_h=2160, dst_w=1920, dst_h=1080)
    x = rd.make_frames(1, 3240, 3840, dev)
    clusters = rd.striped_clusters(x, **geo, nw=nw, store=store)
    if store == "relay":
        assert clusters == (0, 0)
    else:
        assert min(clusters) > 0, clusters


def test_striped_refuses_before_any_launch(dev):
    """More stripes than a cluster holds, a stripe under 16 bytes and a
    window past the kernel's K raise on the card before any launch; the
    relay store, which runs no cluster, takes nine stripes."""
    geo = dict(src_w=322, src_h=150, dst_w=202, dst_h=70)
    x = rd.make_frames(1, 225, 322, dev, seed=9)
    before = rd.striped_resize.launches
    for nw, store, why in ((9, "dyn", "cluster"), (9, "unroll", "cluster"),
                           (21, "relay", "narrower"), (0, "dyn", "nw")):
        with pytest.raises(ValueError, match=why):
            rd.striped_resize(x, **geo, nw=nw, store=store)
    y = torch.zeros((1, 3240, 3840), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="exceed"):
        rd.striped_resize(y, src_w=3840, src_h=2160, dst_w=64, dst_h=16)
    assert rd.striped_resize.launches == before
    assert torch.equal(rd.striped_resize(x, **geo, nw=9, store="relay"),
                       rd.aligned_resize(x, **geo, h_align=8, w_align=32))
    assert rd.striped_resize.launches == before + 1


# --- the NV12 -> RGB convert lab (csrc/nv12_to_rgb_variants.cu) -------------

CONVERT_LAB_NAMES = [n for n in cl.DEFAULT_NAMES if n != "prod"]


@pytest.mark.parametrize("geom", [
    (3, 256, 144),     # the CPU lab's geometry
    (2, 336, 150),     # a partial 128-pixel group, H % 32 != 0
    (2, 1920, 1080),   # the card's geometry
])
@pytest.mark.parametrize("name", CONVERT_LAB_NAMES)
def test_convert_lab_kernels_match_plain(dev, geom, name):
    """Every convert-lab kernel equals its plain version bit for bit; V1
    and V2 also nv12_to_rgb."""
    b, w, h = geom
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=w + h)
    c = cl.case(name, b, h * 3 // 2, w, h)
    out, ref = c.call(x), c.plain(x)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), (name, geom)
    assert torch.equal(out, c.reference(x)), (name, geom)


@pytest.mark.parametrize("name", CONVERT_LAB_NAMES)
def test_convert_lab_kernels_padded_views(dev, name):
    """Extra rows, a padded 16-byte aligned row pitch and a larger batch
    stride: the plain version of the same view (inonly and noh read the
    rows past H*3/2 that the buffer has)."""
    b, w, h = 2, 256, 144
    rows = h * 3 // 2
    big = torch.zeros((b, rows + 40, w + 32), dtype=torch.uint8, device=dev)
    big[:, :, :w] = kv.make_frames(b, rows + 40, w, dev, seed=9)
    view = big[:, :, :w]
    c = cl.case(name, b, rows + 40, w, h)
    assert torch.equal(c.call(view), c.plain(view)), name


@pytest.mark.parametrize("variant", ["V1", "V2"])
def test_convert_staged_replays_give_one_reference(dev, variant):
    """The staged convert's TMA ring and output tiles at 1080p: each of 20
    launches gives the bits of nv12_to_rgb (no race checker runs on this
    card; csrc/nv12_convert_staged.cu names the waits that guard each
    reuse)."""
    b, w, h = 8, 1920, 1080
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=26)
    cc = dict(space=ColorSpace.BT_601, crange=ColorRange.JPEG)
    want = nv12_to_rgb(x, src_w=w, src_h=h, **cc)
    for i in range(20):
        got = cl.convert_variant(x, src_w=w, src_h=h, variant=variant, **cc)
        assert torch.equal(got, want), (variant, i)


@pytest.mark.parametrize("twice", [False, True])
@pytest.mark.parametrize("n", [24, 48])
def test_convert_staged_probe_pins_the_k_major_instances(dev, n, twice):
    """One m64nNk16 wgmma with A and B K-major in shared memory
    (csrc/nv12_convert_staged.cu's probe) at the staged convert's N = 24
    and 48 and its operand's offsets: scale-d 0 over NaN accumulators
    gives the matmul of the same small integers (every sum exact), and a
    second product with scale-d 1 twice that."""
    from vali_tpu_torch.lab import convert_ab
    from vali_tpu_torch.ops import _cuda_build

    assert convert_ab.probe(_cuda_build.load_lab_kernels(), n, twice)


@pytest.mark.parametrize("mode", ["dma", "inonly"])
def test_convert_probe_sink_reads_every_byte(dev, mode):
    """On a zeroed sink the XOR of its words is the XOR of every 32-bit
    word of the frames, and one byte changed in a row the output never
    reads changes the sink but not the output."""
    b, w, h = 2, 256, 144
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=4)

    def run(frames):
        sink = torch.zeros(cl.SINK_WORDS, dtype=torch.int32, device=dev)
        out = cl.convert_probe(frames, src_w=w, src_h=h, mode=mode,
                               sink=sink)
        return out, sink.cpu().numpy().view(np.uint32)

    out, sink = run(x)
    words = x.cpu().numpy().view(np.uint32).ravel()
    assert np.bitwise_xor.reduce(sink) == np.bitwise_xor.reduce(words)
    y = x.clone()
    y[1, h + 10, 200] ^= 1
    out2, sink2 = run(y)
    assert torch.equal(out2, out)
    assert not np.array_equal(sink2, sink)


def test_convert_lab_wrappers_count_launches_and_reject_bad_input(dev):
    b, w, h = 2, 256, 144
    geo = dict(src_w=w, src_h=h)
    x = kv.make_frames(b, h * 3 // 2, w, dev, seed=2)
    before = [f.launches for f in cl.WRAPPERS]
    cl.convert_variant(x, **geo, variant="V2")
    cl.convert_probe(x, **geo, mode="noh")
    after = [n + 1 for n in before]
    assert [f.launches for f in cl.WRAPPERS] == after
    cl.convert_variant(x.cpu(), **geo)  # the plain version: not a launch
    unaligned = torch.zeros((b, h * 3 // 2, w + 8), dtype=torch.uint8,
                            device=dev)[:, :, :w]
    with pytest.raises(ValueError, match="multiple of 16"):
        cl.convert_variant(unaligned, **geo)
    narrow = kv.make_frames(b, h * 3 // 2, 200, dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        cl.convert_probe(narrow, src_w=200, src_h=h, mode="dma")
    with pytest.raises(ValueError, match="sink"):
        cl.convert_probe(x, **geo, mode="dma",
                         sink=torch.zeros(4, dtype=torch.int64, device=dev))
    assert [f.launches for f in cl.WRAPPERS] == after


# ---- the inference and analysis slice: the card against the CPU ---------

def _golden_envelope(got, want):
    """tests/test_e2e_segmentation.py's envelope on [N, h, w, C] logits:
    max |difference| <= 0.02 x max |logit|, per-frame class histograms
    agreeing > 0.98."""
    got, want = got.float().cpu().numpy(), want.float().numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    assert np.abs(got - want).max() / scale <= 0.02
    for g, w in zip(got, want):
        c = w.shape[-1]
        hg = np.bincount(g.argmax(-1).reshape(-1), minlength=c)
        hw = np.bincount(w.argmax(-1).reshape(-1), minlength=c)
        assert np.minimum(hg, hw).sum() / hw.sum() > 0.98, (hg, hw)


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 65, 47, 3)])
def test_fcn_on_the_card_matches_the_cpu(dev, shape):
    """bf16 at the golden envelope; f32 (TF32 off) within rtol 1e-4, atol
    1e-5; uint8 input too; the default device is the card."""
    from vali_tpu_torch.models import fcn

    rng = np.random.default_rng(sum(shape))
    params = fcn.numpy_params(rng)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    u8 = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    cpu = torch.device("cpu")
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            card = fcn.params_from_numpy(params, dtype=dtype)
            assert card.conv0.weight.device == dev
            host = fcn.params_from_numpy(params, cpu, dtype=dtype)
            for inp in (x, u8):
                got = fcn.apply(card, inp.to(dev))
                want = fcn.apply(host, inp)
                assert got.dtype == dtype and got.device == dev
                if dtype == torch.bfloat16:
                    _golden_envelope(got, want)
                else:
                    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                               atol=1e-5)
        classes = fcn.predict_classes(card, x.to(dev))
        assert classes.shape == want.shape[:3] and classes.device == dev
    assert fcn.init_params().head.weight.device == dev


def test_metrics_and_analytics_on_the_card_match_the_cpu(dev):
    """Histograms and cuts equal; statistics, scores, PSNR and SSIM
    within rtol 1e-5 (float32 reductions in another order)."""
    from vali_tpu_torch.ops import analytics, metrics

    rng = np.random.default_rng(41)
    luma = rng.integers(0, 256, (8, 72, 128), dtype=np.uint8)
    luma[4:] = np.clip(luma[4:].astype(int) // 3 + 170, 0, 255)
    hdr = rng.integers(0, 1024, (3, 40, 64), dtype=np.uint16) << 6
    for frames in (luma, hdr):
        t = torch.from_numpy(frames)
        g = t.to(dev)
        assert torch.equal(analytics.histogram_batch(g).cpu(),
                           analytics.histogram_batch(t))
        assert torch.equal(analytics.histogram_batch(g, 37, (30.0, 900.0))
                           .cpu(), analytics.histogram_batch(t, 37,
                                                             (30.0, 900.0)))
        sg, sc = analytics.luma_stats_batch(g), analytics.luma_stats_batch(t)
        for k in sc:
            torch.testing.assert_close(sg[k].cpu(), sc[k], rtol=1e-5,
                                       atol=0)
        torch.testing.assert_close(analytics.scene_change_scores(g).cpu(),
                                   analytics.scene_change_scores(t),
                                   rtol=1e-5, atol=1e-7)
    cuts = analytics.detect_scene_changes(luma)   # numpy: to the card
    assert list(cuts) == list(analytics.detect_scene_changes(
        luma, device=torch.device("cpu"))) == [4]
    a = rng.integers(0, 256, (4, 64, 96, 3), dtype=np.uint8)
    b = np.clip(a + rng.integers(-9, 10, a.shape), 0, 255).astype(np.uint8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fn in (metrics.mse_batch, metrics.psnr_batch, metrics.ssim_batch):
        torch.testing.assert_close(fn(ta.to(dev), tb.to(dev)).cpu(),
                                   fn(ta, tb), rtol=1e-5, atol=0)


@pytest.mark.parametrize("transfer,method,out", [
    ("pq", "bt2390", torch.uint8), ("hlg", "hable", torch.uint16),
    ("pq", "reinhard", torch.float32)])
def test_tonemap_on_the_card_matches_the_cpu(dev, transfer, method, out):
    """Within 1 LSB of the output codes (float: of a 16-bit code), or, in
    the toe of the 1/2.4 display gamma, within 1e-4 of full scale in
    linear light: near black its slope is unbounded, and float32 noise of
    the two devices' power functions, amplified by the gamut matrix's
    cancellation at the clip boundary, moves dark codes by a few LSB."""
    from vali_tpu_torch.ops import tonemap

    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.integers(0, 1024, (2, 48, 64, 3),
                                      dtype=np.uint16) << 6)
    kw = dict(transfer=transfer, method=method, out_dtype=out)
    got = tonemap.tonemap_batch(x.to(dev), **kw).cpu()
    want = tonemap.tonemap_batch(x, **kw)
    assert got.dtype == out
    top = 1.0 if out == torch.float32 else float(torch.iinfo(out).max)
    g, w = got.to(torch.float64) / top, want.to(torch.float64) / top
    lsb = 1.0 / (65535.0 if out == torch.float32 else top)
    beyond = ((g - w).abs() > lsb) & ((g ** 2.4 - w ** 2.4).abs() > 1e-4)
    assert not beyond.any()


@pytest.mark.parametrize("fmt,w,h", [(PixelFormat.RGB, 96, 64),
                                     (PixelFormat.RGB, 101, 91),
                                     (PixelFormat.YUV420, 128, 96)])
def test_jpeg_transform_on_the_card_matches_the_cpu(dev, fmt, w, h,
                                                    monkeypatch):
    """Coefficients equal, or +-1 where the exact (float64) quotient is
    within 1e-3 of k + 0.5 (a rounding tie of another summation order)."""
    from vali_tpu_torch.ops import jpeg

    rng = np.random.default_rng(43)
    if fmt == PixelFormat.RGB:
        planes = (rng.integers(0, 256, (3, h, 3 * w), dtype=np.uint8),)
    else:
        planes = (rng.integers(0, 256, (3, h, w), dtype=np.uint8),
                  *(rng.integers(0, 256, (3, h // 2, w // 2), dtype=np.uint8)
                    for _ in range(2)))
    tp = tuple(torch.from_numpy(p) for p in planes)
    kw = dict(src_fmt=int(fmt), width=w, height=h, quality=85)
    got = jpeg.jpeg_transform_batch(tuple(p.to(dev) for p in tp), **kw)
    want = jpeg.jpeg_transform_batch(tp, **kw)

    def exact(plane, qtable, center=128.0):
        d = torch.from_numpy(jpeg.dct_matrix()).double()
        blocks = jpeg._blockify(plane.double() - center)
        return (torch.matmul(torch.matmul(d, blocks), d.T)
                / torch.from_numpy(qtable).double())

    monkeypatch.setattr(jpeg, "_dct_quant", exact)
    quotients = jpeg.jpeg_transform_batch(tp, **kw)
    for g, c, e in zip(got, want, quotients):
        assert g.device == dev and g.dtype == torch.int16
        d = (g.cpu().int() - c.int()).abs()
        e = e[d != 0]
        assert d.max().item() <= 1
        assert ((e - e.floor() - 0.5).abs() < 1e-3).all()


def _host_frames(rng, fmt, n, w, h):
    """n flat host frames of ``fmt`` in the decoder's layout."""
    return list(_frames(rng, fmt, n, w, h))


@pytest.mark.parametrize("fmt", [PixelFormat.YUV420, PixelFormat.NV12,
                                 PixelFormat.P10])
@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_upload_host_frame_over_a_wrapping_ring(dev, fmt, sync):
    """Frames staged through the decoder's pinned ring into 10 Surfaces:
    every Surface bit-equal to its host frame, checked as the ring first
    fills and again after it has wrapped. Without the ring's wait a later
    decode would overwrite a buffer that a queued copy still reads."""
    from vali_tpu_torch.engine.decoder import STAGING_SLOTS, StagingRing
    from vali_tpu_torch.memory.host import host_frame_to_planes
    from vali_tpu_torch.memory.surface import Surface

    w, h, n = 320, 180, 10
    frames = _host_frames(np.random.default_rng(int(fmt)), fmt, n, w, h)
    ring = StagingRing(dev)
    surfs = [Surface.Make(fmt, w, h, device=dev) for _ in range(n)]

    def check(i):
        want = host_frame_to_planes(frames[i], fmt, w, h)
        for plane, p in zip(surfs[i].plane_tensors(), want):
            assert np.array_equal(plane.cpu().numpy(), p), i

    for i, f in enumerate(frames):
        def fill(buf, f=f):
            buf[:] = f
            return buf.nbytes
        assert ring.upload(fill, fmt, w, h, surfs[i], sync) == f.nbytes
        event = ring._events[i % STAGING_SLOTS]
        assert isinstance(event, torch.cuda.Event)
        assert ring._bufs[i % STAGING_SLOTS].is_pinned()
        if sync:
            assert event.query()
        if i == STAGING_SLOTS - 1:
            torch.cuda.synchronize()
            for j in range(i + 1):
                check(j)
    torch.cuda.synchronize()
    for i in range(n):
        check(i)


@pytest.mark.parametrize("fmt", [PixelFormat.YUV420, PixelFormat.NV12,
                                 PixelFormat.P10, PixelFormat.RGB])
def test_download_host_frame_inverts_the_upload(dev, fmt):
    from vali_tpu_torch.memory.host import (download_host_frame,
                                            upload_host_frame)
    from vali_tpu_torch.memory.surface import Surface
    from vali_tpu_torch.utils.device import get_stream

    w, h = 256, 144
    frame = _host_frames(np.random.default_rng(9), fmt, 1, w, h)[0]
    surf = Surface.Make(fmt, w, h, device=dev)
    upload_host_frame(torch.from_numpy(frame), fmt, w, h, surf,
                      get_stream(None, 0))
    out = download_host_frame(surf)
    assert out.dtype == np.uint8 and np.array_equal(out, frame)


def _transcode_device_half(frames, device, w, h, dw, dh, async_):
    """transcode's device half (the CLI's loop without the codecs): each
    host YUV420 frame staged into a Surface on ``device`` as the decoder
    does it, through the CLI's resize and NV12 step, downloaded as the
    encoder reads it."""
    from vali_tpu_torch.__main__ import ToNV12
    from vali_tpu_torch.engine.decoder import StagingRing
    from vali_tpu_torch.memory.host import download_host_frame
    from vali_tpu_torch.memory.surface import Surface

    F = PixelFormat
    ring = StagingRing(device)
    src = Surface.Make(F.YUV420, w, h, device=device)
    step = ToNV12(F.YUV420, dw, dh, device)
    out = []
    for f in frames:
        def fill(buf, f=f):
            buf[:] = f
            return buf.nbytes
        ring.upload(fill, F.YUV420, w, h, src, sync=not async_)
        out.append(download_host_frame(step(src)).copy())
    return out


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_transcode_device_half_matches_the_cpu(dev, async_):
    """256x144 -> 128x72: two plane_resize launches a frame on the card,
    the NV12 frames within 1 LSB on < 1e-3 of the samples of the same
    loop on CPU Surfaces (the kernels' plain versions)."""
    w, h, dw, dh = 256, 144, 128, 72
    frames = _host_frames(np.random.default_rng(10), PixelFormat.YUV420, 6,
                          w, h)
    before = launches(plane_resize)
    card = _transcode_device_half(frames, dev, w, h, dw, dh, async_)
    assert launches(plane_resize) - before == 2 * len(frames)
    cpu = _transcode_device_half(frames, torch.device("cpu"), w, h, dw, dh,
                                 async_)
    for a, b in zip(card, cpu):
        assert a.shape == b.shape == (dw * dh * 3 // 2,)
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


# --- the multi-device slice on one card (parallel/mesh.py) ----------------


def _quad(dev, n=4):
    """A "data" mesh of ``n`` positions, all on ``dev``."""
    from vali_tpu_torch.parallel.mesh import Mesh

    grid = np.empty(n, dtype=object)
    grid[:] = [dev] * n
    return Mesh(grid, ("data",))


def test_mesh_staging_reuses_pinned_buffers_only_after_every_copy(dev):
    """[cuda:0]*4: while the caller's stream is busy, batches of 7 frames
    (padded to 8, cut back to 7) are staged through one pinned buffer
    each, every position's rows copied on its own stream; a buffer is
    reused only after all four copy events, so no batch is overwritten."""
    from vali_tpu_torch.parallel.mesh import ShardedTensor

    fmt, h, w = PixelFormat.YUV420, 64, 128
    stager = BatchStager(fmt, w, h, dev, keep=2)
    mesh = _quad(dev)
    size = format_info(fmt).host_size(w, h)
    streams = []

    def dispatch(planes):
        streams.append(torch.cuda.current_stream(dev).cuda_stream)
        return torch.cat([p.flatten(1) for p in planes], dim=1).clone()

    outs, want = [], []
    torch.cuda._sleep(200_000_000)  # keep the caller's stream busy
    for i in range(6):
        frames = [np.full(size, 10 * i + j, np.uint8) for j in range(7)]
        want.append(np.stack(frames))
        outs.append(stager.run_on_mesh(frames, mesh, dispatch))
    assert all(len(events) == 4 for _, events in stager._inflight)
    torch.cuda.synchronize()
    for got, exp in zip(outs, want):
        assert isinstance(got, ShardedTensor) and got.shape[0] == 7
        assert np.array_equal(got.numpy(), exp)
    default = torch.cuda.default_stream(dev).cuda_stream
    assert len(set(streams[:4])) == 4 and default not in streams
    # the next batch finds the six buffers free again
    stager.run_on_mesh(want[0], mesh, dispatch)
    assert len(stager._inflight) == 1


def test_position_streams_keep_freed_inputs_alive(dev):
    """record_stream: inputs the caller frees while each position's stream
    still reads them are not handed to another stream's allocations."""
    from vali_tpu_torch.parallel.mesh import on_position_streams

    n = 1 << 22
    xs = [torch.full((n,), float(k + 1), device=dev) for k in range(4)]

    def job(x):
        torch.cuda._sleep(100_000_000)  # still reading when freed below
        return x * 2

    outs, events = on_position_streams(
        [(dev, [x], (lambda x=x: job(x))) for x in xs])
    assert len(events) == 4
    del xs
    other = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(other):
        junk = [torch.zeros(n, device=dev) for _ in range(8)]
    torch.cuda.synchronize()
    for k, out in enumerate(outs):
        assert torch.equal(out, torch.full((n,), 2.0 * (k + 1),
                                           device=dev))
    del junk


def test_sharded_kernel_preprocess_equals_one_launch(dev):
    """Four positions of 4 frames each on one card: four launches, bit for
    bit the single 16-frame launch."""
    from vali_tpu_torch.parallel.mesh import sharded_kernel_preprocess

    frames = _frames(np.random.default_rng(51), PixelFormat.NV12, 16, 256,
                     144)
    nv12 = torch.from_numpy(frames).to(dev).view(16, 216, 256)
    single = nv12_preprocess(nv12, src_w=256, src_h=144, dst_w=96, dst_h=64)
    fn = sharded_kernel_preprocess(_quad(dev), 256, 144, 96, 64)
    n0 = launches(nv12_preprocess)
    out = fn(nv12)
    torch.cuda.synchronize()
    assert launches(nv12_preprocess) == n0 + 4
    assert torch.equal(out.gather(dev), single)
    assert [tuple(s.data.shape) for s in out.shards] == [(4, 3, 64, 96)] * 4


def test_mesh_pipeline_equals_the_pipeline_without_one(dev):
    """The pipeline on [cuda:0]*4 gives the mesh-less pipeline's batches
    bit for bit, with an EOS tail of 3 frames padded and cut back."""
    from vali_tpu_torch.pipeline.multistream import MultiStreamPipeline
    from vali_tpu_torch.utils.synth import HostFrameSource

    fmt, w, h = PixelFormat.NV12, 256, 144
    frames = list(_frames(np.random.default_rng(52), fmt, 7, w, h))

    def run(mesh):
        pipe = MultiStreamPipeline([HostFrameSource(frames, fmt, w, h)],
                                   96, 64, gpu_id=0, batch_size=4,
                                   mesh=mesh)
        return [(b.gather(dev) if mesh is not None else b, ids)
                for b, ids in pipe]

    whole, split = run(None), run(_quad(dev))
    assert [ids for _, ids in split] == [ids for _, ids in whole] == [
        [0] * 4, [0] * 3]
    for (a, _), (b, _) in zip(whole, split):
        assert torch.equal(a, b)


def test_sharded_preprocess_and_tensor_parallel_fcn_match_the_cpu(dev):
    """data 1 x spatial 2 x model 2 on one card: the row-split dense
    preprocess within the dense route's float32 envelope (1e-5) of the
    CPU's, the tensor-parallel FCN within the bf16 golden envelope of the
    CPU's."""
    from vali_tpu_torch.models import fcn
    from vali_tpu_torch.parallel import dryrun
    from vali_tpu_torch.parallel.mesh import shard_planes, sharded_preprocess

    cpu = torch.device("cpu")
    nv12 = dryrun.make_planes(2, 144, 256, seed=53)
    outs, logits = [], []
    for d in (dev, cpu):
        mesh = dryrun.mesh3([d] * 4)
        fn = sharded_preprocess(mesh, PixelFormat.NV12, 256, 144, 96, 64,
                                out_dtype=torch.float32)
        rgb = fn(shard_planes((nv12,), mesh)).gather(d)
        outs.append(rgb.cpu())
        model = fcn.params_from_numpy(fcn.numpy_params(
            np.random.default_rng(54), num_classes=16), d,
            dtype=torch.bfloat16)
        with torch.no_grad():
            logits.append(fcn.apply_sharded(
                fcn.shard_params(model, mesh), rgb))
        assert max(fn.received.values()) > 0
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-5
    _golden_envelope(logits[0], logits[1])
