"""Core enums of the vali-tpu framework.

API-parity notes: names and members mirror the reference VALI pybind11 enums
(reference: src/TC/inc/MemoryInterfaces.hpp:29-58 for PixelFormat/ColorSpace/
ColorRange, src/TC/TC_CORE/inc/TC_CORE.hpp:38-52 for TaskExecStatus/Info,
src/python_vali/src/VALI.cpp:130-214 for the python-visible enum surface).
Values are IntEnum so they are hashable, comparable and ``int(x)`` works the
same way pybind11 enums do.
"""

from __future__ import annotations

import enum


class _ReprEnum(enum.IntEnum):
    """IntEnum printing as ``ClassName.MEMBER`` (parity with pybind11 enums;
    python >= 3.11 IntEnum would otherwise print the bare integer, which
    breaks e.g. golden filenames built from ``str(fmt)``)."""

    def __str__(self) -> str:
        return f"{type(self).__name__}.{self.name}"

    __repr__ = __str__


class PixelFormat(_ReprEnum):
    """Surface pixel formats (reference MemoryInterfaces.hpp:29-46)."""

    UNDEFINED = 0
    Y = 1
    RGB = 2
    NV12 = 3
    YUV420 = 4
    RGB_PLANAR = 5
    BGR = 6
    YUV444 = 7
    RGB_32F = 8
    RGB_32F_PLANAR = 9
    YUV422 = 10
    P10 = 11
    P12 = 12
    YUV444_10bit = 13
    YUV420_10bit = 14
    GRAY12 = 15


class ColorSpace(_ReprEnum):
    """YUV<->RGB conversion standard (reference MemoryInterfaces.hpp:48-52)."""

    BT_601 = 0
    BT_709 = 1
    UNSPEC = 2


class ColorRange(_ReprEnum):
    """Narrow (MPEG) vs full (JPEG) range (MemoryInterfaces.hpp:54-58)."""

    MPEG = 0
    JPEG = 1
    UDEF = 2


class TaskExecStatus(_ReprEnum):
    TASK_EXEC_SUCCESS = 0
    TASK_EXEC_FAIL = 1


class TaskExecInfo(_ReprEnum):
    """Detailed op outcome taxonomy (reference TC_CORE.hpp:40-52)."""

    SUCCESS = 0
    FAIL = 1
    END_OF_STREAM = 2
    MORE_DATA_NEEDED = 3
    BIT_DEPTH_NOT_SUPPORTED = 4
    INVALID_INPUT = 5
    UNSUPPORTED_FMT_CONV_PARAMS = 6
    NOT_SUPPORTED = 7
    RES_CHANGE = 8
    SRC_DST_SIZE_MISMATCH = 9
    SRC_DST_FMT_MISMATCH = 10


class DecodeMode(_ReprEnum):
    """Decoder frame-delivery mode (reference Tasks.hpp / PyDecoder)."""

    ALL_FRAMES = 0
    KEY_FRAMES = 1


class SeekMode(_ReprEnum):
    """Seek criterion used internally by SeekContext."""

    BY_FRAME = 0
    BY_TIMESTAMP = 1


class FfmpegLogLevel(_ReprEnum):
    """Maps to FFmpeg AV_LOG_* levels (reference VALI.cpp:196-214)."""

    PANIC = 0
    FATAL = 8
    ERROR = 16
    WARNING = 24
    INFO = 32
    VERBOSE = 40
    DEBUG = 48


class DLDeviceType(_ReprEnum):
    """DLPack device types relevant to interop (dlpack/dlpack.h)."""

    kDLCPU = 1
    kDLCUDA = 2
    kDLCUDAHost = 3
    kDLCUDAManaged = 13


class NV_ENC_CAPS(_ReprEnum):
    """Encoder capability keys (parity with reference VALI.cpp NV_ENC_CAPS).

    The TPU build encodes on the host via libavcodec/x264/x265; capability
    values are synthesized from the selected software codec so that
    ``PyNvEncoder.Capabilities`` keeps its shape.
    """

    NUM_MAX_BFRAMES = 0
    SUPPORTED_RATECONTROL_MODES = 1
    SUPPORT_FIELD_ENCODING = 2
    SUPPORT_MONOCHROME = 3
    SUPPORT_FMO = 4
    SUPPORT_QPELMV = 5
    SUPPORT_BDIRECT_MODE = 6
    SUPPORT_CABAC = 7
    SUPPORT_ADAPTIVE_TRANSFORM = 8
    SUPPORT_STEREO_MVC = 9
    NUM_MAX_TEMPORAL_LAYERS = 10
    SUPPORT_HIERARCHICAL_PFRAMES = 11
    SUPPORT_HIERARCHICAL_BFRAMES = 12
    LEVEL_MAX = 13
    LEVEL_MIN = 14
    SEPARATE_COLOUR_PLANE = 15
    WIDTH_MAX = 16
    HEIGHT_MAX = 17
    SUPPORT_TEMPORAL_SVC = 18
    SUPPORT_DYN_RES_CHANGE = 19
    SUPPORT_DYN_BITRATE_CHANGE = 20
    SUPPORT_DYN_FORCE_CONSTQP = 21
    SUPPORT_DYN_RCMODE_CHANGE = 22
    SUPPORT_SUBFRAME_READBACK = 23
    SUPPORT_CONSTRAINED_ENCODING = 24
    SUPPORT_INTRA_REFRESH = 25
    SUPPORT_CUSTOM_VBV_BUF_SIZE = 26
    SUPPORT_DYNAMIC_SLICE_MODE = 27
    SUPPORT_REF_PIC_INVALIDATION = 28
    PREPROC_SUPPORT = 29
    ASYNC_ENCODE_SUPPORT = 30
    MB_NUM_MAX = 31
    MB_PER_SEC_MAX = 32
    SUPPORT_YUV444_ENCODE = 33
    SUPPORT_LOSSLESS_ENCODE = 34
    SUPPORT_SAO = 35
    SUPPORT_MEONLY_MODE = 36
    SUPPORT_LOOKAHEAD = 37
    SUPPORT_TEMPORAL_AQ = 38
    SUPPORT_10BIT_ENCODE = 39
    NUM_MAX_LTR_FRAMES = 40
    SUPPORT_WEIGHTED_PREDICTION = 41
    DYNAMIC_QUERY_ENCODER_CAPACITY = 42
    SUPPORT_BFRAME_REF_MODE = 43
    SUPPORT_EMPHASIS_LEVEL_MAP = 44
    WIDTH_MIN = 45
    HEIGHT_MIN = 46
    SUPPORT_MULTIPLE_REF_FRAMES = 47
    SUPPORT_ALPHA_LAYER_ENCODING = 48
    EXPOSED_COUNT = 49


#: Sentinel PTS for frames without a timestamp (AV_NOPTS_VALUE).
NO_PTS = -(2**63)
