"""Color-space conversion matrices as data.

The reference dispatches to per-(colorspace x range) NPP entry points
(reference src/TC/src/TaskConvertSurface.cpp:62-520); here the same variants
are 3x3 matrices + offsets consumed by one fused kernel. Coefficients mirror
the NPP functions the reference calls:

  - (BT_709, JPEG)  -> nppiNV12ToRGB_709HDTV:  full-range 709
  - (BT_709, MPEG)  -> nppiNV12ToRGB_709CSC:   studio-range 709 (1.164 luma)
  - (BT_601, JPEG)  -> nppiYUV*ToRGB:          NPP analog-YUV coefficients
                       (1.140 / 0.394 / 0.581 / 2.032)
  - (BT_601, MPEG)  -> nppiYCbCr*ToRGB:        studio-range 601
                       (1.164 / 1.596 / 0.392 / 0.813 / 2.017)

RGB -> YUV likewise follows nppiRGBToYUV (JPEG, analog) and nppiRGBToYCbCr
(MPEG, studio). Each conversion pair supports exactly the (space, range)
combinations the reference's NPP dispatch supports; everything else raises
UNSUPPORTED_FMT_CONV_PARAMS like the reference does
(tests/test_PySurfaceConverter.py test_unsupported_params).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.enums import ColorRange, ColorSpace

# ---------------------------------------------------------------------------
# YUV -> RGB: rgb = M @ [Y - y_off, U - c_off, V - c_off]
# Matrices are for 8-bit data; for 10/12-bit scale offsets by 2^(d-8).
# ---------------------------------------------------------------------------

_YUV2RGB: Dict[Tuple[ColorSpace, ColorRange], Tuple[np.ndarray, float]] = {
    # (space, range): (3x3 matrix, y_offset)
    (ColorSpace.BT_709, ColorRange.JPEG): (
        np.array([[1.0, 0.0, 1.5748],
                  [1.0, -0.1873, -0.4681],
                  [1.0, 1.8556, 0.0]], dtype=np.float64),
        0.0,
    ),
    (ColorSpace.BT_709, ColorRange.MPEG): (
        np.array([[1.164, 0.0, 1.793],
                  [1.164, -0.213, -0.533],
                  [1.164, 2.112, 0.0]], dtype=np.float64),
        16.0,
    ),
    (ColorSpace.BT_601, ColorRange.JPEG): (
        np.array([[1.0, 0.0, 1.140],
                  [1.0, -0.394, -0.581],
                  [1.0, 2.032, 0.0]], dtype=np.float64),
        0.0,
    ),
    (ColorSpace.BT_601, ColorRange.MPEG): (
        np.array([[1.164, 0.0, 1.596],
                  [1.164, -0.392, -0.813],
                  [1.164, 2.017, 0.0]], dtype=np.float64),
        16.0,
    ),
}

# ---------------------------------------------------------------------------
# RGB -> YUV: yuv = M @ rgb + [y_off, c_off, c_off]
# ---------------------------------------------------------------------------

_RGB2YUV: Dict[Tuple[ColorSpace, ColorRange], Tuple[np.ndarray, float]] = {
    # NPP nppiRGBToYUV (analog YUV, full range)
    (ColorSpace.BT_601, ColorRange.JPEG): (
        np.array([[0.299, 0.587, 0.114],
                  [-0.147, -0.289, 0.436],
                  [0.615, -0.515, -0.100]], dtype=np.float64),
        0.0,
    ),
    # NPP nppiRGBToYCbCr (studio range)
    (ColorSpace.BT_601, ColorRange.MPEG): (
        np.array([[0.257, 0.504, 0.098],
                  [-0.148, -0.291, 0.439],
                  [0.439, -0.368, -0.071]], dtype=np.float64),
        16.0,
    ),
    # BT.709 full range (used by the CPU FrameConverter / encoder paths;
    # not reachable through PySurfaceConverter, same as the reference).
    (ColorSpace.BT_709, ColorRange.JPEG): (
        np.array([[0.2126, 0.7152, 0.0722],
                  [-0.1146, -0.3854, 0.5000],
                  [0.5000, -0.4542, -0.0458]], dtype=np.float64),
        0.0,
    ),
    (ColorSpace.BT_709, ColorRange.MPEG): (
        np.array([[0.1826, 0.6142, 0.0620],
                  [-0.1006, -0.3386, 0.4392],
                  [0.4392, -0.3989, -0.0403]], dtype=np.float64),
        16.0,
    ),
}

#: Grayscale weights (NPP nppiRGBToGray, ITU-R 601).
GRAY_WEIGHTS = np.array([0.299, 0.587, 0.114], dtype=np.float64)

#: Coefficients of the reference UD fused kernel (ResizeUtils.cu:75-77):
#: full-range analog YUV with NO luma offset, scaled by 256/255 via the
#: normalize/denormalize pair (value/256 texture read, *256 write).
UD_YUV2RGB = np.array([[1.0, 0.0, 1.140],
                       [1.0, -0.394, -0.581],
                       [1.0, 2.032, 0.0]], dtype=np.float64)


def resolve_cc(
    cc, default_space: ColorSpace, default_range: ColorRange
) -> Tuple[ColorSpace, ColorRange]:
    """Apply the reference's per-conversion defaulting rule
    (e.g. TaskConvertSurface.cpp:70-71: NV12->RGB defaults to 709+JPEG)."""
    if cc is None:
        return default_space, default_range
    space = ColorSpace(cc.color_space)
    crange = ColorRange(cc.color_range)
    if space == ColorSpace.UNSPEC:
        space = default_space
    if crange == ColorRange.UDEF:
        crange = default_range
    return space, crange


def yuv2rgb_matrix(
    space: ColorSpace, crange: ColorRange
) -> Optional[Tuple[np.ndarray, float]]:
    """(matrix, y_offset) or None when the combo is unsupported."""
    return _YUV2RGB.get((space, crange))


def rgb2yuv_matrix(
    space: ColorSpace, crange: ColorRange
) -> Optional[Tuple[np.ndarray, float]]:
    return _RGB2YUV.get((space, crange))
