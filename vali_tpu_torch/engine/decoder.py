"""PyDecoder: FFmpeg demux+decode into host frames.

Counterpart of the host-frame path of ``vali_tpu/engine/decoder.py`` (API
parity: reference PyDecoder). ``gpu_id=-1`` gives the host path:
``DecodeSingleFrame`` into a numpy array in the flat host-frame layout.
Decode always runs on host CPU with the GIL released inside the native
engine, so N decoder instances scale across threads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.details import PacketData, SeekContext
from ..core.enums import ColorRange, ColorSpace, PixelFormat, SeekMode, \
    TaskExecInfo
from ..utils.device import get_device
from ._loader import load_native
from ._opts import opt_str


def _copy_frame_error(written: int) -> TaskExecInfo:
    """Map a native CopyFrame error code to the TaskExecInfo taxonomy."""
    if written == load_native().ERR_UNREPRESENTABLE_LAYOUT:
        return TaskExecInfo.UNSUPPORTED_FMT_CONV_PARAMS
    return TaskExecInfo.FAIL


class PyDecoder:
    """Video decoder (parity: reference PyDecoder), host-frame path."""

    def __init__(self, input, opts: Optional[dict] = None, gpu_id: int = 0):
        if opts is None:
            opts = {}
        opts = {opt_str(k): opt_str(v) for k, v in opts.items()}
        native = load_native()
        self._gpu_id = gpu_id
        if gpu_id >= 0:
            get_device(gpu_id)  # raises when there is no such CUDA device
        if isinstance(input, (str, bytes)):
            url = input if isinstance(input, str) else input.decode()
            self._dec = native.Decoder(url, opts, None, False)
        else:
            if not hasattr(input, "read"):
                raise TypeError(
                    "input must be a URL string or an object with .read")
            self._dec = native.Decoder(None, opts, input, False)

    def _do_decode(self, seek_ctx: Optional[SeekContext]):
        if seek_ctx is not None:
            by_number = seek_ctx.mode == SeekMode.BY_FRAME
            return self._dec.seek(
                seek_ctx.seek_frame, seek_ctx.seek_tssec, int(by_number))
        return self._dec.decode()

    def DecodeSingleFrame(
        self, frame: np.ndarray, pkt_data: Optional[PacketData] = None,
        seek_ctx: Optional[SeekContext] = None,
    ) -> Tuple[bool, TaskExecInfo]:
        """Decode into a host numpy array (gpu_id == -1 path only)."""
        if isinstance(pkt_data, SeekContext) and seek_ctx is None:
            pkt_data, seek_ctx = None, pkt_data
        if self._gpu_id >= 0:
            # parity: the reference returns (False, FAIL) on the
            # accelerated-path mismatch, it does not raise
            return (False, TaskExecInfo.FAIL)
        info = TaskExecInfo(self._do_decode(seek_ctx)[0])
        if info == TaskExecInfo.RES_CHANGE:
            # No pixels delivered with the event; the caller re-allocates
            # and the next call returns the stashed frame.
            return (True, info)
        if info != TaskExecInfo.SUCCESS:
            return (False, info)
        size = self.HostFrameSize
        if frame.nbytes != size:
            try:
                # ceil, not floor: a frame size not divisible by the
                # caller's dtype itemsize must never truncate the buffer
                elems = -(-size // frame.dtype.itemsize)
                frame.resize((elems,), refcheck=False)
            except ValueError:  # array does not own its data
                return (False, TaskExecInfo.INVALID_INPUT)
        written = self._dec.copy_frame(frame)
        if written < 0:
            return (False, _copy_frame_error(written))
        if pkt_data is not None:
            d = self._dec.packet_data()
            for key in ("pts", "dts", "pos", "bsl", "duration", "key"):
                setattr(pkt_data, key, d[key])
        return (True, info)

    def _props(self):
        return self._dec.props()

    @property
    def Width(self) -> int:
        """Coded frame width in pixels."""
        return self._props()["width"]

    @property
    def Height(self) -> int:
        """Coded frame height in pixels."""
        return self._props()["height"]

    @property
    def Format(self) -> PixelFormat:
        """Pixel format of the decoded frames."""
        return PixelFormat(self._props()["format"])

    @property
    def ColorSpace(self) -> ColorSpace:
        """Color space of the decoded frames (BT_601/BT_709/UNSPEC)."""
        return ColorSpace(self._props()["color_space"])

    @property
    def ColorRange(self) -> ColorRange:
        """Color range of the decoded frames (MPEG/JPEG/UDEF)."""
        return ColorRange(self._props()["color_range"])

    @property
    def HostFrameSize(self) -> int:
        """Size in bytes of one decoded host frame."""
        return self._props()["host_frame_size"]

    @property
    def NumFrames(self) -> int:
        """Number of frames in the stream (0 when the container does not say)."""
        return self._props()["num_frames"]

    @property
    def Framerate(self) -> float:
        """Declared frame rate (r_frame_rate)."""
        return self._props()["framerate"]
