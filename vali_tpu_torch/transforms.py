"""Surface transform wrappers: converter, resizer, rotator, UD,
up/download.

Counterpart of ``vali_tpu/transforms.py`` (reference
src/python_vali/src/PySurfaceConverter.cpp, PySurfaceResizer.cpp,
PySurfaceRotator.cpp, PySurfaceUD.cpp, PyFrameUploader.cpp,
PySurfaceDownloader.cpp). Each wraps the batched ops
in ``vali_tpu_torch.ops`` with N=1 and writes the result into the
destination Surface's tensors in place.

Every op runs on its stream (``utils/device.Stream``): kernels launch
under ``torch.cuda.stream(op_stream)``, after the op stream has been
ordered behind the caller's current stream. ``Run`` synchronises the op's
stream before it returns; ``RunAsync`` returns once the work is queued, and
``CudaStreamEvent(op.Stream, gpu_id)`` then ``Record()``/``Wait()`` waits
for it. On a CPU Surface (``gpu_id=-1``) the work is done when the call
returns.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .core.enums import PixelFormat, TaskExecInfo
from .memory.host import download_host_frame, upload_host_frame
from .memory.surface import Surface
from .ops import csc, resize, rotate, ud
from .utils.device import get_stream
from .utils.tracing import span

_OK = (True, TaskExecInfo.SUCCESS)


def _fail(info: TaskExecInfo) -> Tuple[bool, TaskExecInfo]:
    return (False, info)


class _SurfaceOp:
    """Shared plumbing: device/stream selection and sync semantics."""

    def __init__(self, gpu_id: int = 0, stream: Optional[int] = None):
        self._stream = get_stream(stream, gpu_id)

    @property
    def Stream(self) -> int:
        """The op's stream handle (a raw cudaStream_t on CUDA)."""
        return self._stream.handle

    def _finish(self, src: Surface, dst: Surface, outs, sync: bool):
        """Write the batched (N=1) results into dst's planes, in place."""
        for plane, out in zip(dst.plane_tensors(), outs):
            plane.copy_(out[0])
        ts = self._stream.torch_stream
        if ts is not None:
            # the planes' memory must outlive the queued work even if the
            # caller drops the surfaces before the stream reaches it
            for p in src.plane_tensors() + dst.plane_tensors():
                p.record_stream(ts)
        if sync:
            self._stream.synchronize()
        return _OK


class PySurfaceConverter(_SurfaceOp):
    """Pixel format / color space converter (23 conversion pairs).

    On a CUDA device NV12 -> RGB/BGR (uint8) routes to the kernel of
    ``ops/nv12_to_rgb.py`` by default: within 2 LSB of the exact route
    (bfloat16 coefficients). Construct with ``use_kernel=False`` for the
    exact route, or ``use_kernel=True`` to force the kernel route (its
    plain version on a CPU Surface). On a CPU Surface the default is the
    exact route. Every other conversion pair takes the exact route.
    """

    def __init__(self, gpu_id: int = 0, stream: Optional[int] = None,
                 use_kernel: Optional[bool] = None):
        super().__init__(gpu_id, stream)
        self._use_kernel = use_kernel

    @staticmethod
    def Conversions():
        """Supported (src, dst) pixel-format pairs (parity:
        TaskConvertSurface.cpp:966-994)."""
        return csc.supported_conversions()

    def _run(self, src: Surface, dst: Surface, cc_ctx, sync: bool):
        if src.Width != dst.Width or src.Height != dst.Height:
            return _fail(TaskExecInfo.INVALID_INPUT)
        if src.IsEmpty or dst.IsEmpty:
            return _fail(TaskExecInfo.INVALID_INPUT)
        planes = tuple(p[None] for p in src.plane_tensors())
        with span("ConvertSurface"), self._stream.context():
            try:
                out = csc.convert_batch(planes, src.Format, dst.Format,
                                        src.Width, src.Height, cc_ctx,
                                        use_kernel=self._use_kernel)
            except csc.UnsupportedConversionParams:
                return _fail(TaskExecInfo.UNSUPPORTED_FMT_CONV_PARAMS)
            except KeyError:
                # parity: unsupported pair throws
                # (TaskConvertSurface.cpp:1080)
                raise ValueError(
                    f"Unsupported pixel format conversion: "
                    f"{src.Format.name} -> {dst.Format.name}") from None
            return self._finish(src, dst, out, sync)

    def Run(self, src, dst, cc_ctx=None):
        """Convert src into dst synchronously (parity:
        PySurfaceConverter.cpp:76-84)."""
        return self._run(src, dst, cc_ctx, sync=True)

    def RunAsync(self, src, dst, cc_ctx=None):
        """Convert src into dst without waiting for device completion."""
        return self._run(src, dst, cc_ctx, sync=False)


_SEMI_PLANAR = (PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12)
_PLANAR = (PixelFormat.Y, PixelFormat.GRAY12, PixelFormat.YUV420,
           PixelFormat.YUV444, PixelFormat.RGB_PLANAR,
           PixelFormat.RGB_32F_PLANAR)


class PySurfaceResizer(_SurfaceOp):
    """Lanczos resizer (parity: NPPI_INTER_LANCZOS, TaskResizeSurface.cpp)."""

    def __init__(self, format: PixelFormat, gpu_id: int = 0,
                 stream: Optional[int] = None, method: str = resize.LANCZOS,
                 turbo: bool = False, use_kernel: Optional[bool] = None):
        """``turbo=True`` routes NV12/P10/P12 and the planar formats
        (Y/GRAY12/YUV420/YUV444/RGB_PLANAR/RGB_32F_PLANAR) through the
        banded resize kernels (``ops/nv12_resize.py``,
        ``ops/plane_resize.py``): uint8 resizes in bfloat16 instead of
        float32, within 3 LSB of the exact route; uint16 and float planes
        stay float32. On a CPU Surface turbo takes the kernels' plain
        versions.

        The packed formats (RGB/BGR/RGB_32F) route to the banded packed
        resize kernel BY DEFAULT on a CUDA device (uint8 in bfloat16,
        within the reference's 4-LSB envelope of the exact route; float32
        stays float32). Pass ``use_kernel=False`` for the exact route on
        packed formats, ``use_kernel=True`` to force the kernel route.
        Planar and semi-planar formats outside turbo take the exact
        route."""
        super().__init__(gpu_id, stream)
        format = PixelFormat(format)
        if format not in resize.SUPPORTED_FORMATS:
            raise RuntimeError(f"pixel format not supported: {format.name}")
        self._format = format
        self._method = method
        self._turbo = turbo
        self._use_kernel = use_kernel

    @property
    def Format(self) -> PixelFormat:
        """Pixel format this resizer was constructed for."""
        return self._format

    def _turbo_resize(self, planes, src: Surface, dw: int, dh: int):
        """The banded-kernel route (JAX transforms.py:200-240)."""
        from .ops.nv12_resize import nv12_resize
        from .ops.plane_resize import plane_resize

        fmt, m = self._format, self._method
        if fmt in _SEMI_PLANAR:
            return (nv12_resize(planes[0], src_w=src.Width,
                                src_h=src.Height, dst_w=dw, dst_h=dh,
                                method=m),)
        if fmt == PixelFormat.YUV444:
            r = plane_resize(torch.cat(planes, dim=0), src_h=src.Height,
                             dst_h=dh, dst_w=dw, method=m)
            return tuple(r[i:i + 1] for i in range(3))
        if fmt in (PixelFormat.RGB_PLANAR, PixelFormat.RGB_32F_PLANAR):
            n, h3, w = planes[0].shape
            r = plane_resize(planes[0].reshape(3, h3 // 3, w),
                             src_h=src.Height, dst_h=dh, dst_w=dw, method=m)
            return (r.reshape(1, 3 * dh, dw),)
        if fmt == PixelFormat.YUV420:
            y = plane_resize(planes[0], src_h=src.Height, dst_h=dh,
                             dst_w=dw, method=m)
            c = plane_resize(torch.cat(planes[1:], dim=0),
                             src_h=src.Height // 2, dst_h=dh // 2,
                             dst_w=dw // 2, method=m)
            return (y, c[0:1], c[1:2])
        return (plane_resize(planes[0], src_h=src.Height, dst_h=dh,
                             dst_w=dw, method=m),)  # Y / GRAY12

    def _run(self, src: Surface, dst: Surface, sync: bool):
        if src.Format != self._format or dst.Format != self._format:
            return _fail(TaskExecInfo.SRC_DST_FMT_MISMATCH)
        if src.IsEmpty or dst.IsEmpty:
            return _fail(TaskExecInfo.INVALID_INPUT)
        planes = tuple(p[None] for p in src.plane_tensors())
        fmt = self._format
        with span("ResizeSurface"), self._stream.context():
            if self._turbo and (fmt in _SEMI_PLANAR or fmt in _PLANAR):
                out = self._turbo_resize(planes, src, dst.Width, dst.Height)
            else:
                out = resize.resize_batch(
                    planes, fmt, src.Width, src.Height, dst.Width,
                    dst.Height, self._method, use_kernel=self._use_kernel)
            return self._finish(src, dst, out, sync)

    def Run(self, src, dst):
        """Resize src into dst (Lanczos by default) synchronously."""
        return self._run(src, dst, sync=True)

    def RunAsync(self, src, dst):
        """Resize src into dst without waiting for device completion."""
        return self._run(src, dst, sync=False)


class PySurfaceRotator(_SurfaceOp):
    """Arbitrary-angle rotator (parity: nppiRotate, NPPI_INTER_LINEAR).

    Multiples of 90 degrees with no shift (or the canonical one) are pure
    data movement; every other angle and shift is a bilinear gather. One
    code path serves every angle: nothing is compiled per angle."""

    @property
    def SupportedFormats(self):
        """Pixel formats the rotator accepts."""
        return list(rotate.SUPPORTED_FORMATS)

    def _run(self, src: Surface, dst: Surface, angle, shift_x, shift_y,
             sync: bool):
        if src.Format != dst.Format:
            return _fail(TaskExecInfo.SRC_DST_FMT_MISMATCH)
        if src.Format not in rotate.SUPPORTED_FORMATS:
            return _fail(TaskExecInfo.NOT_SUPPORTED)
        if src.IsEmpty or dst.IsEmpty:
            return _fail(TaskExecInfo.INVALID_INPUT)
        planes = tuple(p[None] for p in src.plane_tensors())
        with span("RotateSurface"), self._stream.context():
            out = rotate.rotate_batch(
                planes, src.Format, src.Width, src.Height, dst.Width,
                dst.Height, float(angle), float(shift_x), float(shift_y))
            return self._finish(src, dst, out, sync)

    def Run(self, src, dst, angle, shift_x=0.0, shift_y=0.0):
        """Rotate src by ``angle`` degrees (with optional shift) into dst,
        synchronously (parity: RotateSurface.cpp)."""
        return self._run(src, dst, angle, shift_x, shift_y, sync=True)

    def RunAsync(self, src, dst, angle, shift_x=0.0, shift_y=0.0):
        """Rotate src into dst without waiting for device completion."""
        return self._run(src, dst, angle, shift_x, shift_y, sync=False)


class PySurfaceUD(_SurfaceOp):
    """Fused upsample-downscale-convert (parity: UDSurface)."""

    @staticmethod
    def SupportedFormats():
        """Supported (src, dst) pairs (parity: UDSurface.cpp:117-133)."""
        return list(ud.SUPPORTED_CONVERSIONS)

    def _run(self, src: Surface, dst: Surface, sync: bool):
        if (src.Format, dst.Format) not in ud.SUPPORTED_CONVERSIONS:
            return _fail(TaskExecInfo.NOT_SUPPORTED)
        if src.IsEmpty or dst.IsEmpty:
            return _fail(TaskExecInfo.INVALID_INPUT)
        planes = tuple(p[None] for p in src.plane_tensors())
        with span("UDSurface"), self._stream.context():
            out = ud.ud_batch(planes, src.Format, dst.Format, src.Width,
                              src.Height, dst.Width, dst.Height)
            return self._finish(src, dst, out, sync)

    def Run(self, src, dst):
        """Fused chroma-upsample + rescale + optional CSC, synchronously
        (parity: UDSurface.cpp:135-182)."""
        return self._run(src, dst, sync=True)

    def RunAsync(self, src, dst):
        """Fused upsample-downscale without waiting for device
        completion."""
        return self._run(src, dst, sync=False)


class PyFrameUploader:
    """Host frame -> device Surface (parity: CudaUploadFrame)."""

    def __init__(self, gpu_id: int = 0, stream: Optional[int] = None):
        self._stream = get_stream(stream, gpu_id)

    def Run(self, src: np.ndarray, dst: Surface):
        """Copy a host frame into the device surface, synchronously: the
        bytes as of the call (parity: PyFrameUploader.cpp — size
        mismatches fail with INVALID_INPUT; only the DOWNLOADER
        auto-resizes in the reference). The copy is
        :func:`~vali_tpu_torch.memory.host.upload_host_frame`, the one
        the decoder's Surface path makes."""
        try:
            flat = np.ascontiguousarray(src).reshape(-1).view(np.uint8)
            if flat.nbytes != dst.HostSize or dst.IsEmpty:
                return _fail(TaskExecInfo.INVALID_INPUT)
            with span("CudaUploadFrame"):
                # a pageable host source: the copy has read it when the
                # call returns, so the caller may reuse its buffer at once
                upload_host_frame(torch.from_numpy(flat), dst.Format,
                                  dst.Width, dst.Height, dst, self._stream,
                                  sync=True)
        except (ValueError, TypeError):
            return _fail(TaskExecInfo.INVALID_INPUT)
        return _OK


class PySurfaceDownloader:
    """Device Surface -> host numpy (parity: CudaDownloadSurface).

    Like the reference, the destination array is resized when its byte size
    does not match (PySurfaceDownloader.cpp numpy auto-resize)."""

    def __init__(self, gpu_id: int = 0, stream: Optional[int] = None):
        self._stream = get_stream(stream, gpu_id)

    def Run(self, src: Surface, dst: np.ndarray):
        """Copy a device surface into the host array (parity:
        PySurfaceDownloader.cpp). The copy is
        :func:`~vali_tpu_torch.memory.host.download_host_frame`, the one
        the encoder's Surface path makes."""
        if src.IsEmpty:
            return _fail(TaskExecInfo.INVALID_INPUT)
        try:
            with span("CudaDownloadSurface"):
                flat = download_host_frame(src, self._stream)
        except ValueError:
            return _fail(TaskExecInfo.INVALID_INPUT)
        if flat.nbytes % dst.dtype.itemsize:
            return _fail(TaskExecInfo.INVALID_INPUT)
        if dst.nbytes != flat.nbytes:
            try:
                dst.resize((flat.nbytes // dst.dtype.itemsize,),
                           refcheck=False)
            except ValueError:
                return _fail(TaskExecInfo.INVALID_INPUT)
        view = dst.reshape(-1)
        if not np.shares_memory(view, dst):
            # reshape had to copy (non-contiguous dst): writing into the
            # copy would silently lose the data
            return _fail(TaskExecInfo.INVALID_INPUT)
        view.view(np.uint8)[:] = flat
        return _OK
