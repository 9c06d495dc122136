"""Host-frame layout helpers.

A "host frame" is the flat byte layout the reference's CPU decode path and
up/downloaders use: all planes concatenated in order (reference
TaskDecodeFrame.cpp:628-643 via av_image_copy_to_buffer, and the per-plane
cuMemcpy2D loops in TaskCudaUploadFrame.cpp:54-72).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.enums import PixelFormat
from ..core.formats import format_info


def host_frame_to_planes(array: np.ndarray, fmt: PixelFormat,
                         width: int, height: int) -> List[np.ndarray]:
    """Split a flat host frame into storage-layout planes (zero-copy views)."""
    info = format_info(fmt)
    flat = np.ascontiguousarray(array).reshape(-1).view(info.dtype)
    expected = info.host_size(width, height) // info.elem_size
    if flat.size != expected:
        raise ValueError(
            f"Host frame has {flat.size} elements, {fmt.name} "
            f"{width}x{height} needs {expected}")
    planes = []
    offset = 0
    for (h, w) in info.plane_dims(width, height):
        planes.append(flat[offset:offset + h * w].reshape(h, w))
        offset += h * w
    return planes


def planes_to_host_frame(planes) -> np.ndarray:
    """Concatenate storage-layout planes into a flat host frame (bytes)."""
    return np.concatenate(
        [np.ascontiguousarray(np.asarray(p)).reshape(-1).view(np.uint8)
         for p in planes])
