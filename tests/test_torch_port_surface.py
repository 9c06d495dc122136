"""vali_tpu_torch Surface layer against vali_tpu on the CPU: Surface and
plane properties for every format, the constructors and exports, their
error cases, upload / download, streams and events, the allocation
registry. Inputs are numpy-seeded and fed to both packages."""

import gc

import numpy as np
import pytest
import torch

import vali_tpu as jvali
import vali_tpu_torch as tvali
from vali_tpu.core.formats import all_formats, format_info
from vali_tpu_torch.memory import registry
from vali_tpu_torch.memory.host import planes_to_host_frame
from vali_tpu_torch.utils import device as tdevice
from vali_tpu_torch.utils import tracing

F = tvali.PixelFormat
W, H = 64, 48
CPU = -1


def _frame(rng, fmt, w=W, h=H):
    """A flat host frame of ``fmt`` with in-range random samples."""
    info = format_info(fmt)
    planes = []
    for ph, pw in info.plane_dims(w, h):
        if info.dtype == np.float32:
            planes.append(rng.random((ph, pw), dtype=np.float32))
        elif info.dtype == np.uint16:
            planes.append(rng.integers(0, 1 << info.bit_depth, (ph, pw),
                                       dtype=np.uint16))
        else:
            planes.append(rng.integers(0, 256, (ph, pw), dtype=np.uint8))
    return planes_to_host_frame(planes)


@pytest.mark.parametrize("fmt", all_formats(), ids=lambda f: f.name)
def test_make_matches_jax(fmt):
    j = jvali.Surface.Make(fmt, W, H)
    t = tvali.Surface.Make(F(int(fmt)), W, H, gpu_id=CPU)
    for prop in ("Width", "Height", "NumPlanes", "NumComponents", "HostSize",
                 "Pitch", "Shape", "IsOwnMemory", "IsEmpty"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert int(t.Format) == int(j.Format)
    for tp, jp in zip(t.Planes, j.Planes):
        for prop in ("Width", "Height", "ElemSize", "Pitch",
                     "HostFrameSize"):
            assert getattr(tp, prop) == getattr(jp, prop), prop
    # Make zero-initialises
    assert all(not p.view(torch.uint8).any() for p in t.plane_tensors())
    assert t.device == torch.device("cpu")


@pytest.mark.parametrize("fmt", [F.NV12, F.RGB, F.RGB_PLANAR, F.YUV420,
                                 F.P10, F.RGB_32F], ids=lambda f: f.name)
def test_from_numpy_flat_and_download_match_jax(fmt):
    frame = _frame(np.random.default_rng(int(fmt)), fmt)
    j = jvali.Surface.from_numpy(frame, jvali.PixelFormat(int(fmt)),
                                 width=W, height=H)
    t = tvali.Surface.from_numpy(frame, fmt, gpu_id=CPU, width=W, height=H)
    assert t.Shape == j.Shape and t.IsOwnMemory == j.IsOwnMemory
    assert np.array_equal(t.to_numpy(), j.to_numpy())
    out_t = np.zeros(3, np.uint8)  # wrong size: auto-resized
    out_j = np.zeros(3, np.uint8)
    assert tvali.PySurfaceDownloader(gpu_id=CPU).Run(t, out_t) == (
        True, tvali.TaskExecInfo.SUCCESS)
    assert jvali.PySurfaceDownloader(gpu_id=0).Run(j, out_j)[0]
    assert np.array_equal(out_t, out_j) and np.array_equal(out_t, frame)


def test_export_shaped_and_plane_list_constructors():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    t = tvali.Surface.from_numpy(rgb, F.RGB, gpu_id=CPU)
    assert (t.Width, t.Height) == (W, H)
    assert np.array_equal(t.to_numpy(), rgb)
    planar = rng.integers(0, 256, (3, H, W), dtype=np.uint8)
    t = tvali.Surface.from_numpy(planar, F.RGB_PLANAR, gpu_id=CPU)
    assert np.array_equal(t.to_numpy(), planar)
    assert t.to_torch().shape == (3, H, W)
    nv12 = rng.integers(0, 256, (H * 3 // 2, W), dtype=np.uint8)
    t = tvali.Surface.from_torch(torch.from_numpy(nv12), F.NV12)
    assert (t.Width, t.Height) == (W, H) and not t.IsOwnMemory
    planes = [rng.integers(0, 256, (h, w), dtype=np.uint8)
              for h, w in format_info(F.YUV420).plane_dims(W, H)]
    t = tvali.Surface.from_numpy(planes, F.YUV420, gpu_id=CPU)
    j = jvali.Surface.from_numpy(planes, jvali.PixelFormat.YUV420)
    assert (t.Width, t.Height) == (j.Width, j.Height) == (W, H)
    assert np.array_equal(t.to_numpy(), j.to_numpy())


def test_constructor_errors_match_jax():
    import jax.numpy as jnp

    arr = np.zeros((96, 64), np.uint8)  # NV12 export: 64x64
    ok = tvali.Surface.from_torch(torch.from_numpy(arr), F.NV12, width=64,
                                  height=64)
    assert (ok.Width, ok.Height) == (64, 64)
    for mod, make in ((tvali, lambda a, **kw: tvali.Surface.from_torch(
            torch.from_numpy(a), F.NV12, **kw)),
            (jvali, lambda a, **kw: jvali.Surface.from_jax(
                jnp.asarray(a), jvali.PixelFormat.NV12, **kw))):
        with pytest.raises(ValueError, match="implies"):
            make(arr, width=32, height=48)
        with pytest.raises(ValueError):  # odd luma size
            make(np.zeros((6, 63), np.uint8))
    for mod in (tvali, jvali):
        kw = {"gpu_id": CPU} if mod is tvali else {}
        with pytest.raises(ValueError):
            mod.Surface.Make(mod.PixelFormat.NV12, 63, 48, **kw)
        with pytest.raises(ValueError):
            mod.Surface.Make(mod.PixelFormat.YUV422, 63, 48, **kw)
        mod.Surface.Make(mod.PixelFormat.YUV422, 64, 47, **kw)
        with pytest.raises(TypeError):
            mod.Surface(1)
        with pytest.raises(ValueError):  # wrong plane dtype
            mod.Surface.from_numpy(np.zeros((H, W * 3), np.float32),
                                   mod.PixelFormat.RGB, **kw)
        with pytest.raises(ValueError):  # flat frame without its size
            mod.Surface.from_numpy(np.zeros(10, np.uint8),
                                   mod.PixelFormat.NV12, **kw)
    with pytest.raises(RuntimeError):  # no such CUDA device
        tvali.Surface.Make(F.RGB, W, H, gpu_id=tdevice.num_devices())


def test_dlpack_roundtrip_and_borrowed_views():
    src = np.random.default_rng(2).integers(0, 256, (H, W, 3), np.uint8)
    surf = tvali.Surface.from_numpy(src, F.RGB, gpu_id=CPU)
    view = torch.from_dlpack(surf)
    assert view.shape == (H, W, 3) and np.array_equal(view.numpy(), src)
    assert surf.__dlpack_device__() == view.__dlpack_device__()
    back = tvali.Surface.from_dlpack(view, F.RGB)
    assert (back.Width, back.Height) == (W, H) and not back.IsOwnMemory
    # a borrowed surface aliases the producer's memory
    view[0, 0, 0] = 7
    assert int(back.to_torch()[0, 0, 0]) == 7
    plane = torch.from_dlpack(surf.Planes[0])
    assert plane.shape == (H, W * 3)
    assert surf.Planes[0].GpuMem == view.data_ptr()
    # no CUDA array interface for a host surface
    assert not hasattr(surf, "__cuda_array_interface__")


def test_multi_plane_export_raises_runtime_error():
    for mod in (tvali, jvali):
        kw = {"gpu_id": CPU} if mod is tvali else {}
        surf = mod.Surface.Make(mod.PixelFormat.YUV420, 32, 32, **kw)
        with pytest.raises(RuntimeError, match="multi-plane"):
            surf.__dlpack__()
        with pytest.raises(RuntimeError, match="multi-plane"):
            surf.__dlpack_device__()
    surf = tvali.Surface.Make(F.YUV420, 32, 32, gpu_id=CPU)
    with pytest.raises(RuntimeError, match="multi-plane"):
        surf.__cuda_array_interface__
    with pytest.raises(RuntimeError, match="multi-plane"):
        surf.to_torch()


def test_ops_write_in_place_for_views_and_plane_handles():
    """A DLPack view and a SurfacePlane handle taken before Run see the
    op's result: ops write into the destination's tensors."""
    rng = np.random.default_rng(3)
    src = tvali.Surface.from_numpy(_frame(rng, F.NV12), F.NV12, gpu_id=CPU,
                                   width=W, height=H)
    dst = tvali.Surface.Make(F.RGB, W, H, gpu_id=CPU)
    view = torch.from_dlpack(dst)
    handle = dst.Planes[0]
    ptr = handle.GpuMem
    assert tvali.PySurfaceConverter(gpu_id=CPU).Run(src, dst)[0]
    assert int(view.count_nonzero()) > 0
    assert torch.equal(view.reshape(H, W * 3), handle.to_torch())
    assert dst.Planes[0].GpuMem == ptr


def test_clone_is_deep():
    src = np.random.default_rng(4).integers(0, 256, (H, W, 3), np.uint8)
    surf = tvali.Surface.from_numpy(src, F.RGB, gpu_id=CPU)
    clone = surf.Clone()
    assert clone.IsOwnMemory and np.array_equal(clone.to_numpy(), src)
    surf.plane_tensors()[0].add_(1)
    assert np.array_equal(clone.to_numpy(), src)
    with pytest.raises(RuntimeError):
        tvali.Surface().Clone()


def test_from_cai_dict_honours_strides():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (H, W * 2, 3), dtype=np.uint8)
    sliced = base[:, ::2, :]  # not C-contiguous
    d = dict(sliced.__array_interface__)
    d["data"] = (sliced.ctypes.data, False)
    t = tvali.Surface.from_cai(d, F.RGB, gpu_id=CPU)
    j = jvali.Surface.from_cai(d, jvali.PixelFormat.RGB)
    assert np.array_equal(t.to_numpy(), sliced)
    assert np.array_equal(t.to_numpy(), j.to_numpy())
    d = {"shape": (H, W, 3), "typestr": "|u1", "version": 3,
         "data": (np.ascontiguousarray(sliced).ctypes.data, False)}
    keep = np.ascontiguousarray(sliced)
    d["data"] = (keep.ctypes.data, False)
    assert np.array_equal(
        tvali.Surface.from_cai(d, F.RGB, gpu_id=CPU).to_numpy(), keep)


def test_cuda_buffer():
    buf = tvali.CudaBuffer.Make(4, 128, gpu_id=CPU)
    assert (buf.ElemSize, buf.NumElems, buf.RawMemSize) == (4, 128, 512)
    buf.to_torch()[:] = 3
    clone = buf.Clone()
    other = tvali.CudaBuffer.Make(4, 128, gpu_id=CPU)
    other.CopyFrom(buf)
    assert np.all(other.to_numpy() == 3) and np.all(clone.to_numpy() == 3)
    buf.to_torch()[:] = 5
    assert np.all(clone.to_numpy() == 3)
    with pytest.raises(RuntimeError):
        tvali.CudaBuffer.Make(2, 128, gpu_id=CPU).CopyFrom(buf)


def test_upload_snapshots_host_bytes_and_checks_size():
    w, h = 128, 64
    frame = np.full(w * h * 3 // 2, 100, np.uint8)
    surf = tvali.Surface.Make(F.NV12, w, h, gpu_id=CPU)
    up = tvali.PyFrameUploader(gpu_id=CPU)
    assert up.Run(frame, surf) == (True, tvali.TaskExecInfo.SUCCESS)
    frame[:] = 7  # the caller reuses its buffer
    assert int(surf.plane_tensors()[0][0, 0]) == 100
    src = frame.copy()
    s2 = tvali.Surface.from_numpy(src, F.NV12, gpu_id=CPU, width=w,
                                  height=h)
    src[:] = 200
    assert int(s2.plane_tensors()[0][0, 0]) == 7
    assert up.Run(np.zeros(10, np.uint8), surf) == (
        False, tvali.TaskExecInfo.INVALID_INPUT)


def test_download_auto_resize_and_lossy_destinations():
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 255, (4, 12), np.uint8)
    t = tvali.Surface.from_numpy(rgb, F.RGB, gpu_id=CPU, width=4, height=4)
    dl = tvali.PySurfaceDownloader(gpu_id=CPU)
    out = np.zeros(1, np.uint8)
    assert dl.Run(t, out)[0] and np.array_equal(out.reshape(4, 12), rgb)
    dst_t = np.zeros((12, 4), np.uint8).T  # non-contiguous
    assert dl.Run(t, dst_t) == (False, tvali.TaskExecInfo.INVALID_INPUT)
    assert dst_t.sum() == 0
    y = tvali.Surface.from_numpy(rng.integers(0, 255, (3, 3), np.uint8),
                                 F.Y, gpu_id=CPU, width=3, height=3)
    assert dl.Run(y, np.zeros(4, np.float32)) == (
        False, tvali.TaskExecInfo.INVALID_INPUT)
    assert dl.Run(tvali.Surface(), out) == (
        False, tvali.TaskExecInfo.INVALID_INPUT)


def test_streams_and_events_on_the_cpu_are_ledgers():
    st = tdevice.get_stream(None, CPU)
    assert st.handle == 0 and st.torch_stream is None
    a, b = tdevice.new_stream(CPU), tdevice.new_stream(CPU)
    assert a.handle != b.handle and a.handle > 0
    with a.context():
        pass
    a.synchronize()
    ev = tvali.CudaStreamEvent(0, CPU)
    ev.Record()
    ev.Wait()
    conv = tvali.PySurfaceConverter(gpu_id=CPU, stream=a.handle)
    assert conv.Stream == a.handle
    with pytest.raises(RuntimeError):  # no such CUDA device
        tdevice.get_stream(None, tdevice.num_devices())


def test_allocation_registry_and_tracing_scope():
    registry.enable(True)
    try:
        before = len(registry.live_allocations())
        surf = tvali.Surface.Make(F.Y, W, H, gpu_id=CPU)
        assert len(registry.live_allocations()) == before + 1
        assert registry.live_bytes() >= W * H
        del surf
        gc.collect()
        assert len(registry.live_allocations()) == before
    finally:
        registry.enable(False)
    was = tracing.enable(True)
    try:
        for on in (True, False):
            tracing.enable(on)
            with tracing.span("ConvertSurface"):
                pass
    finally:
        tracing.enable(was)


def test_lazy_public_names():
    for name in ("Surface", "SurfacePlane", "CudaBuffer", "CudaStreamEvent",
                 "PySurfaceConverter", "PySurfaceResizer",
                 "PyFrameUploader", "PySurfaceDownloader"):
        assert name in dir(tvali)
        assert getattr(tvali, name).__name__ == name
