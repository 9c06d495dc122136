"""PyFrameConverter: host color conversion via libswscale.

Counterpart of ``vali_tpu/engine/frame_converter.py`` (reference
src/python_vali/src/PyFrameConverter.cpp over TaskConvertFrame.cpp: sws_scale
and its colorspace details), over the shared native engine.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.details import ColorspaceConversionContext
from ..core.enums import PixelFormat, TaskExecInfo
from ._loader import load_native


class PyFrameConverter:
    def __init__(self, width: int, height: int, src_format: PixelFormat,
                 dst_format: PixelFormat):
        native = load_native()
        self._width = int(width)
        self._height = int(height)
        self._src_format = PixelFormat(src_format)
        self._dst_format = PixelFormat(dst_format)
        self._conv = native.FrameConverter(
            self._width, self._height, int(self._src_format),
            int(self._dst_format))

    @property
    def Format(self) -> PixelFormat:
        """Destination pixel format."""
        return self._dst_format

    def Run(self, src: np.ndarray, dst: np.ndarray,
            cc_ctx: ColorspaceConversionContext = None,
            ) -> Tuple[bool, TaskExecInfo]:
        """Convert a host frame between pixel formats via libswscale
        (parity: PyFrameConverter.cpp). A ``dst`` of another byte size is
        resized to hold the result, as PyDecoder.DecodeSingleFrame does."""
        src_size, dst_size = self._conv.sizes()
        if src.nbytes != src_size:
            return (False, TaskExecInfo.SRC_DST_SIZE_MISMATCH)
        if dst.nbytes != dst_size:
            try:
                # ceil-divide, so that an itemsize that does not divide
                # dst_size never truncates the buffer below it
                n_items = -(-dst_size // dst.dtype.itemsize)
                dst.resize((n_items,), refcheck=False)
            except ValueError:  # dst does not own its data
                return (False, TaskExecInfo.INVALID_INPUT)
        cs = int(cc_ctx.color_space) if cc_ctx is not None else 2
        cr = int(cc_ctx.color_range) if cc_ctx is not None else 2
        src_flat = np.ascontiguousarray(src).reshape(-1).view(np.uint8)
        info, _ = self._conv.run(src_flat, dst, cs, cr)
        info = TaskExecInfo(info)
        return (info == TaskExecInfo.SUCCESS, info)
