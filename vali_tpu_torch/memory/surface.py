"""Device surfaces over ``torch.Tensor``.

Counterpart of ``vali_tpu/memory/surface.py`` (reference:
src/TC/inc/MemoryInterfaces.hpp:156-266, src/TC/inc/Surfaces.hpp,
src/TC/inc/SurfacePlane.hpp). One Surface class covers all formats via the
layout table in ``core/formats.py``; planes are 2-D tensors on one
``torch.device`` in the storage layout the table gives.

Design difference from the JAX package: **ops write into the destination
Surface's tensors in place.** JAX arrays are immutable, so there ops swap
new arrays into the surface. Writing in place keeps what that design gives
(existing :class:`SurfacePlane` handles see the new pixels) and what the
reference gives besides: a DLPack or ``__cuda_array_interface__`` view
taken before an op's ``Run`` sees its result too.

Interop: ``__dlpack__``/``__dlpack_device__`` and, on CUDA,
``__cuda_array_interface__`` export the surface's tensor zero-copy;
``to_torch``/``from_torch`` and ``from_dlpack`` are the torch-side doors.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.enums import PixelFormat
from ..core.formats import FormatInfo, format_info
from ..utils.device import get_device
from . import registry


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype of the format table."""
    return getattr(torch, np.dtype(dtype).name)


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor holding a COPY of host array ``a`` as of the call.

    Upload semantics are the bytes as of call time (the reference's CUDA
    upload always copies): ``torch.from_numpy`` aliases the caller's memory
    and a later ``.to(cpu)`` is a no-op, so the copy is taken here."""
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _multi_plane_error(fmt: PixelFormat) -> RuntimeError:
    return RuntimeError(
        f"{fmt.name} is multi-plane; DLPack export is unsupported "
        f"(parity: Surfaces.hpp:168-176)")


class SurfacePlane:
    """A single 2-D plane of a Surface.

    Holds its parent surface and plane index, so it always sees the
    surface's current tensor (the reference's shared_ptr plane semantics,
    SurfacePlane.hpp:52-285)."""

    __slots__ = ("_surface", "_index")

    def __init__(self, surface: "Surface", index: int):
        self._surface = surface
        self._index = index

    @property
    def _tensor(self) -> torch.Tensor:
        t = self._surface._planes[self._index]
        if t is None:
            raise RuntimeError("SurfacePlane is empty")
        return t

    @property
    def Width(self) -> int:
        """Plane width in elements."""
        return int(self._tensor.shape[1])

    @property
    def Height(self) -> int:
        """Plane height in rows."""
        return int(self._tensor.shape[0])

    @property
    def ElemSize(self) -> int:
        """Element size in bytes."""
        return int(self._tensor.element_size())

    @property
    def Pitch(self) -> int:
        """Row stride in bytes (width * elem size for a dense plane)."""
        return int(self._tensor.stride(0)) * self.ElemSize

    @property
    def HostFrameSize(self) -> int:
        """Plane size in bytes on the host."""
        return self.Width * self.Height * self.ElemSize

    @property
    def GpuMem(self) -> int:
        """Address of the plane's first element."""
        return int(self._tensor.data_ptr())

    def __dlpack__(self, stream=None, **kwargs):
        return self._tensor.__dlpack__(stream=stream, **kwargs)

    def __dlpack_device__(self):
        return self._tensor.__dlpack_device__()

    @property
    def __cuda_array_interface__(self):
        return self._tensor.__cuda_array_interface__

    def to_torch(self) -> torch.Tensor:
        """Zero-copy handle to the plane's tensor."""
        return self._tensor

    def __repr__(self) -> str:
        return (f"SurfacePlane({self.Width}x{self.Height}, "
                f"elem={self.ElemSize})")


class Surface:
    """A pixel-format-typed image of 1..3 planes on one device.

    Construct with :meth:`Make`, :meth:`from_torch`, :meth:`from_dlpack`,
    :meth:`from_cai` or :meth:`from_numpy`.
    """

    def __init__(self, *args, **kwargs):
        if args or kwargs:
            raise TypeError(
                "Use Surface.Make(format, width, height, gpu_id=...) or "
                "Surface.from_torch/from_dlpack/from_numpy")
        self._format = PixelFormat.UNDEFINED
        self._width = 0
        self._height = 0
        self._planes: List[Optional[torch.Tensor]] = []
        self._own_memory = True

    # --- construction -----------------------------------------------------

    @staticmethod
    def Make(format: PixelFormat, width: int, height: int,
             gpu_id: int = 0, context: Optional[int] = None,
             device: Optional[torch.device] = None) -> "Surface":
        """Allocate a zero-initialized surface on a device.

        Parity: reference Surface::Make (MemoryInterfaces.cpp:336-404). The
        ``context`` overload of the reference maps to passing an explicit
        ``device``."""
        info = format_info(format)
        info.validate(width, height)
        if gpu_id > 0xFFFF and context is None:
            # reference code may pass a CUcontext positionally in the
            # gpu_id slot (Surface.Make(fmt, w, h, context)): treat
            # pointer-sized values as a context on the default device
            context, gpu_id = gpu_id, 0
        if device is None:
            device = get_device(gpu_id)
        surf = Surface()
        surf._format = PixelFormat(format)
        surf._width = int(width)
        surf._height = int(height)
        dtype = torch_dtype(info.dtype)
        surf._planes = [torch.zeros((h, w), dtype=dtype, device=device)
                        for (h, w) in info.plane_dims(width, height)]
        registry.register(surf, f"Surface[{surf._format.name}]",
                          info.host_size(width, height))
        return surf

    @staticmethod
    def from_torch(tensors, format: PixelFormat, width: Optional[int] = None,
                   height: Optional[int] = None) -> "Surface":
        """Wrap existing tensor(s) as a Surface (borrowed, zero-copy).

        ``tensors`` is either a single tensor in the format's export shape
        (e.g. (H, W, 3) for RGB, (3, H, W) for RGB_PLANAR, (H*3/2, W) for
        NV12) or a sequence of per-plane 2-D tensors in storage layout.
        """
        info = format_info(format)
        if isinstance(tensors, (list, tuple)):
            planes = [torch.as_tensor(t) for t in tensors]
            if width is None or height is None:
                h0, w0 = planes[0].shape
                if format in (PixelFormat.NV12, PixelFormat.P10,
                              PixelFormat.P12):
                    height, width = h0 * 2 // 3, w0
                elif format in (PixelFormat.RGB, PixelFormat.BGR,
                                PixelFormat.RGB_32F):
                    height, width = h0, w0 // 3
                elif format in (PixelFormat.RGB_PLANAR,
                                PixelFormat.RGB_32F_PLANAR):
                    height, width = h0 // 3, w0
                else:
                    height, width = h0, w0
        else:
            t = torch.as_tensor(tensors)
            dw, dh, planes = _storage_from_export(t, info)
            # an explicit width/height must AGREE with the export shape
            if ((width is not None and int(width) != dw)
                    or (height is not None and int(height) != dh)):
                raise ValueError(
                    f"tensor of export shape {tuple(t.shape)} implies "
                    f"{dw}x{dh}, but width={width} height={height} was "
                    f"requested")
            width, height = dw, dh
        info.validate(width, height)
        expected = info.plane_dims(width, height)
        if len(planes) != len(expected):
            raise ValueError(
                f"{format.name} needs {len(expected)} planes, "
                f"got {len(planes)}")
        dtype = torch_dtype(info.dtype)
        for t, (h, w) in zip(planes, expected):
            if tuple(t.shape) != (h, w):
                raise ValueError(
                    f"Plane shape {tuple(t.shape)} != expected {(h, w)} "
                    f"for {format.name} {width}x{height}")
            if t.dtype != dtype:
                raise ValueError(
                    f"Plane dtype {t.dtype} != expected {dtype} "
                    f"for {format.name}")
        if len({t.device for t in planes}) != 1:
            raise ValueError("all planes of a Surface must be on one device")
        surf = Surface()
        surf._format = PixelFormat(format)
        surf._width = int(width)
        surf._height = int(height)
        surf._planes = list(planes)
        surf._own_memory = False
        registry.register(surf, f"Surface[{surf._format.name}](borrowed)", 0)
        return surf

    @staticmethod
    def from_dlpack(obj, format: PixelFormat = PixelFormat.RGB) -> "Surface":
        """Import a DLPack tensor (capsule-producer object or capsule)."""
        return Surface.from_torch(torch.from_dlpack(obj), format)

    @staticmethod
    def from_cai(d, format: PixelFormat = PixelFormat.RGB, *,
                 gpu_id: int = 0) -> "Surface":
        """Ingest an array-interface object (reference: PySurface.cpp:
        468-537).

        An object exposing ``__cuda_array_interface__`` is wrapped
        zero-copy on its CUDA device. A dict in that format pointing at
        HOST memory (strides honoured) or an object with
        ``__array_interface__`` is copied and uploaded to ``gpu_id``."""
        if hasattr(d, "__cuda_array_interface__"):
            return Surface.from_torch(torch.as_tensor(d, device="cuda"),
                                      format)
        if isinstance(d, dict):
            shape = tuple(d["shape"])
            dt = np.dtype(d["typestr"])
            data = d["data"]
            ptr = data[0] if isinstance(data, (tuple, list)) else int(data)
            strides = d.get("strides")
            if strides is None:  # C-contiguous per the CAI spec
                count = int(np.prod(shape))
                buf = (ctypes.c_char * (count * dt.itemsize))
                host = np.frombuffer(buf.from_address(ptr),
                                     dtype=dt).reshape(shape)
            else:
                # honor byte strides like the reference does
                # (PySurface.cpp:487-496)
                strides = tuple(int(s) for s in strides)
                if any(s < 0 for s in strides):
                    raise ValueError(
                        "negative strides are not supported by "
                        "Surface.from_cai")
                span = dt.itemsize + sum(
                    (n - 1) * s for n, s in zip(shape, strides) if n > 0)
                flat = np.frombuffer(
                    (ctypes.c_char * span).from_address(ptr),
                    dtype=np.uint8)
                host = np.lib.stride_tricks.as_strided(
                    flat[:dt.itemsize].view(dt), shape=shape,
                    strides=strides)
        else:
            host = np.asarray(d)
        return Surface.from_numpy(host, format, gpu_id=gpu_id)

    @staticmethod
    def from_numpy(array, format: PixelFormat, gpu_id: int = 0,
                   device: Optional[torch.device] = None,
                   width: Optional[int] = None,
                   height: Optional[int] = None) -> "Surface":
        """Upload a host frame to a device (a copy as of the call).

        ``array`` may be a list of per-plane arrays, an export-shaped array,
        or a flat 1-D host frame (requires ``width``/``height``).
        """
        if device is None:
            device = get_device(gpu_id)
        if isinstance(array, (list, tuple)):
            planes = [host_tensor(a).to(device) for a in array]
            return Surface.from_torch(planes, format, width, height)
        if np.ndim(array) == 1:
            from .host import host_frame_to_planes
            if width is None or height is None:
                raise ValueError(
                    "flat host frames require explicit width/height")
            host_planes = host_frame_to_planes(
                np.ascontiguousarray(array), format, width, height)
            planes = [host_tensor(p).to(device) for p in host_planes]
            return Surface.from_torch(planes, format, width, height)
        return Surface.from_torch(host_tensor(array).to(device), format,
                                  width, height)

    # --- properties ---------------------------------------------------------

    @property
    def _info(self) -> FormatInfo:
        return format_info(self._format)

    @property
    def Format(self) -> PixelFormat:
        """Pixel format of this surface."""
        return self._format

    @property
    def Width(self) -> int:
        """Width in pixels (luma plane)."""
        return self._width

    @property
    def Height(self) -> int:
        """Height in pixels (luma plane)."""
        return self._height

    @property
    def NumPlanes(self) -> int:
        """Number of storage planes."""
        return len(self._planes)

    @property
    def NumComponents(self) -> int:
        """Number of color components."""
        return self._info.num_components

    @property
    def IsEmpty(self) -> bool:
        """True when the surface has no allocated pixels."""
        return not self._planes or any(p is None for p in self._planes)

    @property
    def IsOwnMemory(self) -> bool:
        """True when the surface owns its memory (False for borrowed or
        imported views)."""
        return self._own_memory

    @property
    def HostSize(self) -> int:
        """Total size in bytes of the dense host representation."""
        return self._info.host_size(self._width, self._height)

    @property
    def Pitch(self) -> int:
        """Row pitch in bytes of the first plane."""
        return self.Planes[0].Pitch

    @property
    def Planes(self) -> Tuple[SurfacePlane, ...]:
        """Tuple of SurfacePlane views over the storage planes."""
        return tuple(SurfacePlane(self, i) for i in range(len(self._planes)))

    @property
    def Shape(self) -> List[int]:
        """Export shape, or flat element count for multi-plane formats
        (parity: MemoryInterfaces.cpp:461-478)."""
        info = self._info
        if info.export_shape is not None:
            return list(info.export_shape(self._width, self._height))
        return [self.HostSize // info.elem_size]

    @property
    def device(self) -> torch.device:
        """The torch device holding this surface's planes."""
        if self.IsEmpty:
            raise RuntimeError("Surface is empty")
        return self._planes[0].device

    # --- interop -------------------------------------------------------------

    def to_torch(self) -> torch.Tensor:
        """The surface as ONE tensor in export shape (a view of the
        storage plane)."""
        info = self._info
        if info.export_shape is None:
            raise RuntimeError(
                f"{self._format.name} is multi-plane; use .Planes / "
                f".plane_tensors()")
        t = self._planes[0]
        shape = info.export_shape(self._width, self._height)
        return t.view(shape) if tuple(t.shape) != tuple(shape) else t

    def plane_tensors(self) -> Tuple[torch.Tensor, ...]:
        """Per-plane tensors in storage layout (zero-copy)."""
        if self.IsEmpty:
            raise RuntimeError("Surface is empty")
        return tuple(self._planes)

    def to_numpy(self) -> np.ndarray:
        """Download to host in export shape (flat for multi-plane)."""
        info = self._info
        if info.export_shape is not None:
            return self.to_torch().cpu().numpy()
        return np.concatenate(
            [p.cpu().numpy().reshape(-1) for p in self.plane_tensors()])

    def __dlpack__(self, stream=None, **kwargs):
        if self._info.export_shape is None:
            raise _multi_plane_error(self._format)
        return self.to_torch().__dlpack__(stream=stream, **kwargs)

    def __dlpack_device__(self):
        if self._info.export_shape is None:
            raise _multi_plane_error(self._format)
        return self._planes[0].__dlpack_device__()

    @property
    def __cuda_array_interface__(self):
        if self._info.export_shape is None:
            raise _multi_plane_error(self._format)
        # torch raises AttributeError for a CPU tensor, so hasattr() is
        # False for a host surface, as consumers of the protocol expect
        return self.to_torch().__cuda_array_interface__

    def Clone(self) -> "Surface":
        """Deep copy (parity: MemoryInterfaces.cpp:406-433)."""
        if self.IsEmpty:
            raise RuntimeError("Cannot clone an empty surface")
        surf = Surface()
        surf._format = self._format
        surf._width = self._width
        surf._height = self._height
        surf._planes = [p.clone() for p in self._planes]
        surf._own_memory = True
        registry.register(surf, f"Surface[{surf._format.name}]",
                          self.HostSize)
        return surf

    def block_until_ready(self) -> "Surface":
        """Block until all queued device work has finished (the whole
        device: torch does not track which stream wrote a tensor); returns
        self."""
        if not self.IsEmpty and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def __repr__(self) -> str:
        if self.IsEmpty:
            return "Surface(<empty>)"
        return (f"Surface({self._format.name}, {self._width}x{self._height}, "
                f"planes={self.NumPlanes}, device={self.device})")


def _storage_from_export(t: torch.Tensor, info: FormatInfo):
    """Convert an export-shaped tensor into storage-layout planes (views
    where the strides allow, as ``reshape`` gives them)."""
    fmt = info.fmt
    if fmt in (PixelFormat.RGB, PixelFormat.BGR, PixelFormat.RGB_32F):
        if t.dim() == 3:
            h, w, c = t.shape
            if c != 3:
                raise ValueError(f"Expected (H, W, 3) for {fmt.name}")
            return int(w), int(h), [t.reshape(h, w * 3)]
        h, w3 = t.shape
        return int(w3 // 3), int(h), [t]
    if fmt in (PixelFormat.RGB_PLANAR, PixelFormat.RGB_32F_PLANAR):
        if t.dim() == 3:
            c, h, w = t.shape
            if c != 3:
                raise ValueError(f"Expected (3, H, W) for {fmt.name}")
            return int(w), int(h), [t.reshape(3 * h, w)]
        h3, w = t.shape
        return int(w), int(h3 // 3), [t]
    if t.dim() != 2:
        raise ValueError(
            f"Expected a 2-D array for {fmt.name}, got shape "
            f"{tuple(t.shape)}")
    h, w = t.shape
    if fmt in (PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12):
        return int(w), int(h * 2 // 3), [t]
    return int(w), int(h), [t]


class CudaBuffer:
    """1-D typed device buffer (API parity: reference CudaBuffer,
    MemoryInterfaces.hpp:119-151). Backed by a flat uint8 tensor."""

    def __init__(self, *args, **kwargs):
        if args or kwargs:
            raise TypeError(
                "Use CudaBuffer.Make(elem_size, num_elems, gpu_id)")
        self._tensor: Optional[torch.Tensor] = None
        self._elem_size = 0
        self._num_elems = 0

    @staticmethod
    def Make(elem_size: int, num_elems: int, gpu_id: int = 0
             ) -> "CudaBuffer":
        """Allocate a zeroed typed 1-D device buffer (parity:
        MemoryInterfaces.cpp:300-321)."""
        buf = CudaBuffer()
        buf._elem_size = int(elem_size)
        buf._num_elems = int(num_elems)
        buf._tensor = torch.zeros(elem_size * num_elems, dtype=torch.uint8,
                                  device=get_device(gpu_id))
        registry.register(buf, "CudaBuffer", elem_size * num_elems)
        return buf

    @property
    def ElemSize(self) -> int:
        """Element size in bytes."""
        return self._elem_size

    @property
    def NumElems(self) -> int:
        """Number of elements."""
        return self._num_elems

    @property
    def RawMemSize(self) -> int:
        """Total size in bytes."""
        return self._elem_size * self._num_elems

    @property
    def GpuMem(self) -> int:
        """Address of the buffer's first byte."""
        return int(self._tensor.data_ptr())

    def CopyFrom(self, other: "CudaBuffer", stream: int = 0,
                 gpu_id: Optional[int] = None) -> None:
        """Copy another buffer's contents into this one, in place."""
        if other.RawMemSize != self.RawMemSize:
            raise RuntimeError("CudaBuffer size mismatch in CopyFrom")
        self._tensor.copy_(other._tensor)

    def Clone(self) -> "CudaBuffer":
        """Deep-copy this buffer on its device."""
        buf = CudaBuffer()
        buf._elem_size = self._elem_size
        buf._num_elems = self._num_elems
        buf._tensor = self._tensor.clone()
        registry.register(buf, "CudaBuffer", buf.RawMemSize)
        return buf

    def to_torch(self) -> torch.Tensor:
        """The underlying uint8 tensor."""
        return self._tensor

    def to_numpy(self) -> np.ndarray:
        """Copy the buffer to a host numpy array."""
        return self._tensor.cpu().numpy()
