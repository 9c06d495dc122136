"""Plain-data types of the public API.

Parity: reference src/python_vali/src/VALI.cpp:216-496 (SeekContext,
PacketData, MotionVector, TaskExecDetails, ColorspaceConversionContext,
StreamParams, CudaStreamEvent). These are pure-Python dataclasses here; the
semantics (field names, defaults, constructor overloads) match the reference
bindings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as _np

from .enums import (
    ColorRange,
    ColorSpace,
    SeekMode,
    TaskExecInfo,
    TaskExecStatus,
)


@dataclasses.dataclass
class TaskExecDetails:
    status: TaskExecStatus = TaskExecStatus.TASK_EXEC_SUCCESS
    info: TaskExecInfo = TaskExecInfo.SUCCESS
    message: str = ""

    @property
    def ok(self) -> bool:
        return self.status == TaskExecStatus.TASK_EXEC_SUCCESS

    @classmethod
    def success(cls) -> "TaskExecDetails":
        return cls()

    @classmethod
    def fail(cls, info: TaskExecInfo, message: str = "") -> "TaskExecDetails":
        return cls(TaskExecStatus.TASK_EXEC_FAIL, info, message)


class ColorspaceConversionContext:
    """Conversion color-space + range pair (reference VALI.cpp:318-330)."""

    def __init__(
        self,
        color_space: ColorSpace = ColorSpace.UNSPEC,
        color_range: ColorRange = ColorRange.UDEF,
    ):
        self.color_space = ColorSpace(color_space)
        self.color_range = ColorRange(color_range)

    def __repr__(self) -> str:
        return (
            f"ColorspaceConversionContext({self.color_space.name}, "
            f"{self.color_range.name})"
        )

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, ColorspaceConversionContext)
            and self.color_space == other.color_space
            and self.color_range == other.color_range
        )


class SeekContext:
    """Seek request: by frame number or by timestamp in seconds.

    Mirrors the reference's two constructor overloads
    (VALI.cpp SeekContext bindings): ``SeekContext(seek_frame=N)`` or
    ``SeekContext(seek_ts=T)``.
    """

    def __init__(
        self,
        seek_frame: Optional[int] = None,
        seek_ts: Optional[float] = None,
        **kwargs,
    ):
        if "seek_tssec" in kwargs and seek_ts is None:
            seek_ts = kwargs.pop("seek_tssec")
        if kwargs:
            raise TypeError(f"Unexpected arguments: {sorted(kwargs)}")
        if (seek_frame is None) == (seek_ts is None):
            raise ValueError(
                "SeekContext requires exactly one of seek_frame / seek_ts")
        if seek_frame is not None:
            if seek_frame < 0:
                raise ValueError("seek_frame must be >= 0")
            self.mode = SeekMode.BY_FRAME
            self.seek_frame = int(seek_frame)
            self.seek_tssec = 0.0
        else:
            if seek_ts < 0:
                raise ValueError("seek_ts must be >= 0")
            self.mode = SeekMode.BY_TIMESTAMP
            self.seek_frame = 0
            self.seek_tssec = float(seek_ts)

    def __repr__(self) -> str:
        if self.mode == SeekMode.BY_FRAME:
            return f"SeekContext(seek_frame={self.seek_frame})"
        return f"SeekContext(seek_ts={self.seek_tssec})"


@dataclasses.dataclass
class PacketData:
    """Per-frame packet metadata (reference VALI.cpp:246-279).

    ``bsl`` = bitstream length consumed; ``key`` = 1 for key frames.
    """

    pts: int = 0
    dts: int = 0
    pos: int = 0
    bsl: int = 0
    duration: int = 0
    key: int = 0


@dataclasses.dataclass
class MotionVector:
    """H.264/HEVC decoded motion vector (reference VALI.cpp:96-128)."""

    source: int = 0
    w: int = 0
    h: int = 0
    src_x: int = 0
    src_y: int = 0
    dst_x: int = 0
    dst_y: int = 0
    motion_x: int = 0
    motion_y: int = 0
    motion_scale: int = 0


# Registered numpy dtype for vectorized motion-vector access (parity:
# PYBIND11_NUMPY_DTYPE_EX on the all-int MotionVector struct, reference
# VALI.cpp:125-128 + VALI.hpp:46-56). PyDecoder.MotionVectors returns a
# structured array with this dtype.
MOTION_VECTOR_DTYPE = _np.dtype(
    [
        ("source", "=i4"),
        ("w", "=i4"),
        ("h", "=i4"),
        ("src_x", "=i4"),
        ("src_y", "=i4"),
        ("dst_x", "=i4"),
        ("dst_y", "=i4"),
        ("motion_x", "=i4"),
        ("motion_y", "=i4"),
        ("motion_scale", "=i4"),
    ]
)


@dataclasses.dataclass
class StreamParams:
    """Per-stream probe result (reference VALI.cpp StreamParams binding)."""

    width: int = 0
    height: int = 0
    fourcc: int = 0
    codec_id: int = 0
    fps: float = 0.0
    avg_fps: float = 0.0
    time_base: float = 0.0
    start_time: int = 0
    start_time_sec: float = 0.0
    duration_sec: float = 0.0
    bit_rate: int = 0
    num_frames: int = 0
    profile: int = 0
    level: int = 0
    color_space: ColorSpace = ColorSpace.UNSPEC
    color_range: ColorRange = ColorRange.UDEF
