"""Pixel-format layout table.

Where the reference encodes per-format layout in 13 C++ Surface subclasses
(reference: src/TC/inc/Surfaces.hpp:19-453, factory
src/TC/src/MemoryInterfaces.cpp:336-404), the TPU build keeps one declarative
table: every format is a list of dense 2-D planes (no pitch — TPU HBM arrays
are dense, XLA handles tiling). ``Surface`` and all ops consume this table.

Layout parity with the reference:
  - NV12/P10/P12 are a SINGLE plane of height ``H*3/2`` (Y stacked on
    interleaved UV), 2 components (Surfaces.hpp:72-73).
  - RGB/BGR/RGB_32F are a single packed plane of width-in-elements ``W*3``
    exported with shape (H, W, 3) (Surfaces.hpp:329-330).
  - RGB_PLANAR/RGB_32F_PLANAR are a single plane of height ``H*3`` exported
    with shape (3, H, W) (Surfaces.cpp:631-675).
  - YUV420/422/444 families are 3 separate planes; like the reference they
    refuse single-tensor DLPack export (Surfaces.hpp:168-176).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .enums import PixelFormat


@dataclasses.dataclass(frozen=True)
class FormatInfo:
    fmt: PixelFormat
    dtype: np.dtype
    num_components: int
    #: (height, width) of each stored plane as a function of (W, H).
    plane_dims: Callable[[int, int], Tuple[Tuple[int, int], ...]]
    #: Exported tensor shape for DLPack/array-interface, or None if the
    #: format is multi-plane and cannot be exported as one tensor.
    export_shape: Optional[Callable[[int, int], Tuple[int, ...]]]
    #: chroma subsampling (x, y) e.g. (2, 2) for 4:2:0; (1, 1) if none.
    subsampling: Tuple[int, int] = (1, 1)
    #: for 10/12-bit formats stored in uint16: number of significant bits.
    bit_depth: int = 8

    @property
    def elem_size(self) -> int:
        return int(np.dtype(self.dtype).itemsize)

    @property
    def num_planes(self) -> int:
        return len(self.plane_dims(16, 16))

    def host_size(self, width: int, height: int) -> int:
        return sum(
            h * w * self.elem_size for (h, w) in self.plane_dims(width, height)
        )

    def validate(self, width: int, height: int) -> None:
        sx, sy = self.subsampling
        if width <= 0 or height <= 0:
            raise ValueError(f"Invalid surface size {width}x{height}")
        if width % sx or height % sy:
            raise ValueError(
                f"{self.fmt.name} requires width % {sx} == 0 and "
                f"height % {sy} == 0, got {width}x{height}"
            )


def _single(hw: Callable[[int, int], Tuple[int, int]]):
    return lambda w, h: (hw(w, h),)


_TABLE = {
    PixelFormat.Y: FormatInfo(
        PixelFormat.Y, np.dtype(np.uint8), 1,
        _single(lambda w, h: (h, w)), lambda w, h: (h, w)),
    PixelFormat.GRAY12: FormatInfo(
        PixelFormat.GRAY12, np.dtype(np.uint16), 1,
        _single(lambda w, h: (h, w)), lambda w, h: (h, w), bit_depth=12),
    PixelFormat.NV12: FormatInfo(
        PixelFormat.NV12, np.dtype(np.uint8), 2,
        _single(lambda w, h: (h * 3 // 2, w)),
        lambda w, h: (h * 3 // 2, w), subsampling=(2, 2)),
    PixelFormat.P10: FormatInfo(
        PixelFormat.P10, np.dtype(np.uint16), 2,
        _single(lambda w, h: (h * 3 // 2, w)),
        lambda w, h: (h * 3 // 2, w), subsampling=(2, 2), bit_depth=10),
    PixelFormat.P12: FormatInfo(
        PixelFormat.P12, np.dtype(np.uint16), 2,
        _single(lambda w, h: (h * 3 // 2, w)),
        lambda w, h: (h * 3 // 2, w), subsampling=(2, 2), bit_depth=12),
    PixelFormat.YUV420: FormatInfo(
        PixelFormat.YUV420, np.dtype(np.uint8), 3,
        lambda w, h: ((h, w), (h // 2, w // 2), (h // 2, w // 2)),
        None, subsampling=(2, 2)),
    PixelFormat.YUV420_10bit: FormatInfo(
        PixelFormat.YUV420_10bit, np.dtype(np.uint16), 3,
        lambda w, h: ((h, w), (h // 2, w // 2), (h // 2, w // 2)),
        None, subsampling=(2, 2), bit_depth=10),
    PixelFormat.YUV422: FormatInfo(
        PixelFormat.YUV422, np.dtype(np.uint8), 3,
        lambda w, h: ((h, w), (h, w // 2), (h, w // 2)),
        None, subsampling=(2, 1)),
    PixelFormat.YUV444: FormatInfo(
        PixelFormat.YUV444, np.dtype(np.uint8), 3,
        lambda w, h: ((h, w), (h, w), (h, w)), None),
    PixelFormat.YUV444_10bit: FormatInfo(
        PixelFormat.YUV444_10bit, np.dtype(np.uint16), 3,
        lambda w, h: ((h, w), (h, w), (h, w)), None, bit_depth=10),
    PixelFormat.RGB: FormatInfo(
        PixelFormat.RGB, np.dtype(np.uint8), 3,
        _single(lambda w, h: (h, w * 3)), lambda w, h: (h, w, 3)),
    PixelFormat.BGR: FormatInfo(
        PixelFormat.BGR, np.dtype(np.uint8), 3,
        _single(lambda w, h: (h, w * 3)), lambda w, h: (h, w, 3)),
    PixelFormat.RGB_32F: FormatInfo(
        PixelFormat.RGB_32F, np.dtype(np.float32), 3,
        _single(lambda w, h: (h, w * 3)), lambda w, h: (h, w, 3)),
    PixelFormat.RGB_PLANAR: FormatInfo(
        PixelFormat.RGB_PLANAR, np.dtype(np.uint8), 3,
        _single(lambda w, h: (h * 3, w)), lambda w, h: (3, h, w)),
    PixelFormat.RGB_32F_PLANAR: FormatInfo(
        PixelFormat.RGB_32F_PLANAR, np.dtype(np.float32), 3,
        _single(lambda w, h: (h * 3, w)), lambda w, h: (3, h, w)),
}


def format_info(fmt: PixelFormat) -> FormatInfo:
    try:
        return _TABLE[PixelFormat(fmt)]
    except KeyError:
        raise ValueError(f"Unsupported pixel format: {fmt!r}") from None


def all_formats() -> Sequence[PixelFormat]:
    return tuple(_TABLE.keys())
