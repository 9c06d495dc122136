"""Host-frame layout helpers and the copies between host frames and
Surfaces.

A "host frame" is the flat byte layout the reference's CPU decode path and
up/downloaders use: all planes concatenated in order (reference
TaskDecodeFrame.cpp:628-643 via av_image_copy_to_buffer, and the per-plane
cuMemcpy2D loops in TaskCudaUploadFrame.cpp:54-72).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional

import numpy as np
import torch

from ..core.enums import PixelFormat
from ..core.formats import format_info
from ..utils.device import Stream, device_gpu_id, get_stream

if TYPE_CHECKING:
    from .surface import Surface


def host_frame_views(buf, fmt: PixelFormat, width: int, height: int):
    """Split a flat uint8 host frame into its storage-layout planes: views
    that share ``buf``'s memory, of the format's sample type.

    ``buf`` is a numpy array (the planes are numpy arrays) or a torch
    tensor (the planes are tensors, so copies to and from a pinned
    buffer's planes are asynchronous and PyTorch's pinned-memory allocator
    tracks them as uses of ``buf``)."""
    info = format_info(fmt)
    if isinstance(buf, np.ndarray):
        dtype = info.dtype
        flat_bytes = buf.dtype == np.uint8 and buf.ndim == 1
    else:
        dtype = getattr(torch, np.dtype(info.dtype).name)
        flat_bytes = buf.dtype == torch.uint8 and buf.dim() == 1
    if not flat_bytes:
        raise ValueError("host frame buffers are flat uint8 arrays")
    need = info.host_size(width, height)
    if buf.shape[0] != need:
        raise ValueError(
            f"Host frame has {buf.shape[0]} bytes, {fmt.name} "
            f"{width}x{height} needs {need}")
    views = []
    offset = 0
    for (h, w) in info.plane_dims(width, height):
        n = h * w * info.elem_size
        views.append(buf[offset:offset + n].view(dtype).reshape(h, w))
        offset += n
    return views


def host_frame_to_planes(array: np.ndarray, fmt: PixelFormat,
                         width: int, height: int) -> List[np.ndarray]:
    """Split a flat host frame of any dtype into storage-layout planes
    (zero-copy views of a contiguous ``array``)."""
    flat = np.ascontiguousarray(array).reshape(-1).view(np.uint8)
    return host_frame_views(flat, fmt, width, height)


def planes_to_host_frame(planes) -> np.ndarray:
    """Concatenate storage-layout planes into a flat host frame (bytes)."""
    return np.concatenate(
        [np.ascontiguousarray(np.asarray(p)).reshape(-1).view(np.uint8)
         for p in planes])


def upload_host_frame(stage: torch.Tensor, fmt: PixelFormat, width: int,
                      height: int, surf: "Surface", stream: Stream,
                      sync: bool = True) -> Optional[torch.cuda.Event]:
    """Copy a flat host frame (``fmt``, ``width`` x ``height``, the
    layout ``PyDecoder.DecodeSingleFrame`` produces) into ``surf``'s
    planes, in place, on ``stream``.

    ``stage`` is a flat uint8 tensor: pinned for an asynchronous copy to
    the card (a ``StagingRing`` buffer), or pageable, which the copy has
    read when the call returns. Unlike the JAX package, which swaps new
    arrays into the Surface because JAX arrays are immutable, the planes
    are written in place (VALI's own semantics): a DLPack or torch view of
    a plane taken before the call sees the new frame. On a CUDA Surface
    the copies are queued on ``stream`` after it has been ordered behind
    the caller's current stream. With ``sync`` the stream is synchronised
    before the call returns. Returns the event recorded after the copies
    on CUDA (a pinned ``stage`` may be reused once it has completed), None
    on the CPU, where the copy is done when the call returns. Raises
    ValueError when the frame does not fit the Surface or the Surface lies
    on another device than ``stream``."""
    fmt = PixelFormat(fmt)
    if (surf.Format, surf.Width, surf.Height) != (fmt, width, height):
        raise ValueError(
            f"frame {fmt.name} {width}x{height} does not fit the Surface "
            f"{surf.Format.name} {surf.Width}x{surf.Height}")
    if surf.device != stream.device:
        raise ValueError(f"Surface on {surf.device}, stream on "
                         f"{stream.device}")
    views = host_frame_views(stage, fmt, width, height)
    planes = surf.plane_tensors()
    ts = stream.torch_stream
    if ts is None:
        for plane, view in zip(planes, views):
            plane.copy_(view)
        return None
    with stream.context():
        for plane, view in zip(planes, views):
            plane.copy_(view, non_blocking=True)
            # the planes' memory must outlive the queued copies even if
            # the caller drops the Surface before the stream reaches them
            plane.record_stream(ts)
        event = torch.cuda.Event()
        event.record(ts)
    if sync:
        stream.synchronize()
    return event


def download_host_frame(surface: "Surface",
                        stream: Optional[Stream] = None) -> np.ndarray:
    """The Surface's planes as one flat uint8 host frame (the layout of
    :func:`planes_to_host_frame`), read once the work queued before the
    call has written them.

    On a CUDA Surface the planes are copied on ``stream`` (default: the
    default stream of the Surface's card), ordered behind the caller's
    current stream, into pinned host memory; the stream is synchronised
    before the frame is returned, so the caller may hand it to the native
    encoder at once. The returned array holds the pinned buffer. Raises
    ValueError for an empty Surface or a ``stream`` on another device."""
    if surface.IsEmpty:
        raise ValueError("cannot download an empty Surface")
    device = surface.device
    if stream is None:
        stream = get_stream(None, device_gpu_id(device))
    if stream.device != device:
        raise ValueError(f"Surface on {device}, stream on {stream.device}")
    on_card = stream.torch_stream is not None
    host = torch.empty(surface.HostSize, dtype=torch.uint8,
                       pin_memory=on_card)
    with stream.context():
        for view, plane in zip(host_frame_views(
                host, surface.Format, surface.Width, surface.Height),
                surface.plane_tensors()):
            view.copy_(plane, non_blocking=on_card)
    stream.synchronize()
    return host.numpy()
