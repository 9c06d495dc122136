"""PyDecoder: FFmpeg demux+decode feeding host frames or device Surfaces.

Counterpart of ``vali_tpu/engine/decoder.py`` (API parity: reference
PyDecoder). Construction with ``gpu_id=-1`` gives the host path
(``DecodeSingleFrame`` into numpy); ``gpu_id>=0`` gives the Surface path
(``DecodeSingleSurface`` into a Surface whose planes live on the card, or
on the device named by ``device=``). Decode itself always runs on host CPU
with the GIL released inside the native engine, so N decoder instances
scale across threads (the reference's multi-instance pattern); the Surface
path then copies the decoded host frame into the Surface's planes
(:meth:`StagingRing.upload`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.details import (
    MOTION_VECTOR_DTYPE,
    PacketData,
    SeekContext,
    StreamParams,
)
from ..core.enums import (
    ColorRange,
    ColorSpace,
    DecodeMode,
    FfmpegLogLevel,
    PixelFormat,
    SeekMode,
    TaskExecInfo,
)
from ..core.formats import format_info
from ..memory.host import upload_host_frame
from ..memory.surface import Surface
from ..utils.device import get_device, get_stream
from ._loader import load_native
from ._opts import opt_str

#: pinned host buffers a decoder cycles through on the card: a decode may
#: run ahead of the copies still reading earlier frames by this many
STAGING_SLOTS = 4


def SetFFMpegLogLevel(level: FfmpegLogLevel) -> None:
    """Parity: reference VALI.cpp:512-521."""
    load_native().set_ffmpeg_log_level(int(level))


def _copy_frame_error(written: int) -> TaskExecInfo:
    """Map a native CopyFrame error code to the TaskExecInfo taxonomy.

    ERR_UNREPRESENTABLE_LAYOUT means the frame layout cannot be expressed
    in the advertised PixFmt, e.g. odd-dimension yuv420p12 vs semi-planar
    P012."""
    if written == load_native().ERR_UNREPRESENTABLE_LAYOUT:
        return TaskExecInfo.UNSUPPORTED_FMT_CONV_PARAMS
    return TaskExecInfo.FAIL


class BufferedReader:
    """Thin adapter marking an object as a custom-IO source.

    Any object with ``.read(n)`` (and optionally ``.seek``) can be passed to
    PyDecoder directly; this class exists for API discoverability.
    """

    def __init__(self, obj):
        if not hasattr(obj, "read"):
            raise TypeError("BufferedReader requires an object with .read")
        self.obj = obj


class StagingRing:
    """Host buffers that decoded frames are staged in before the copy to
    the device.

    On a CUDA device the buffers are pinned and the copies out of them are
    asynchronous: a copy may still read a buffer after the call that queued
    it returned, so each buffer carries the event recorded after its copy,
    and :meth:`take` waits on that event before handing the buffer out
    again. A decode can thus run ``STAGING_SLOTS`` frames ahead of the
    copies. On the CPU a copy is done when it returns; the buffers are
    plain memory. The copies run on ``stream``, the default stream of the
    device (the reference decoder's stream).
    """

    def __init__(self, device: torch.device):
        device = torch.device(device)
        self._pinned = device.type == "cuda"
        self.stream = get_stream(
            None, (device.index or 0) if self._pinned else -1)
        self._bufs: List[Optional[torch.Tensor]] = [None] * STAGING_SLOTS
        self._events: List[Optional[torch.cuda.Event]] = [None] * len(
            self._bufs)
        self._next = 0
        self._taken = 0

    def take(self, nbytes: int) -> torch.Tensor:
        """The next flat uint8 buffer of ``nbytes``, once no queued copy
        reads it any more."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        event, self._events[i] = self._events[i], None
        if event is not None:
            event.synchronize()
        buf = self._bufs[i]
        if buf is None or buf.numel() != nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              pin_memory=self._pinned)
            self._bufs[i] = buf
        self._taken = i
        return buf

    def guard(self, event: Optional[torch.cuda.Event]) -> None:
        """The copy out of the buffer :meth:`take` last handed out ends at
        ``event`` (None: it has ended)."""
        self._events[self._taken] = event

    def upload(self, fill, fmt: PixelFormat, width: int, height: int,
               surf: Surface, sync: bool = True) -> int:
        """Stage one host frame and copy it into ``surf``'s planes, in
        place: ``fill`` writes the flat frame into the next buffer's numpy
        view and returns the bytes it wrote, or a negative error code, in
        which case nothing is copied. The copy is
        :func:`upload_host_frame` on :attr:`stream`; the buffer is handed
        out again once it has completed. Returns what ``fill`` returned."""
        stage = self.take(format_info(fmt).host_size(width, height))
        written = fill(stage.numpy())
        if written >= 0:
            self.guard(upload_host_frame(stage, fmt, width, height, surf,
                                         self.stream, sync))
        return written


class PyDecoder:
    """Video decoder (parity: reference PyDecoder)."""

    def __init__(self, input, opts: Optional[dict] = None, gpu_id: int = 0,
                 *, device: Optional[torch.device] = None, **kwargs):
        """``gpu_id >= 0`` is the Surface path, on card ``gpu_id`` (which
        must exist: there is no fallback) or on ``device`` when given,
        e.g. ``device=torch.device("cpu")`` for Surfaces on the CPU.
        ``gpu_id=-1`` is the host-frame path; it takes no ``device``."""
        if opts is None:
            opts = {}
        opts = {opt_str(k): opt_str(v) for k, v in opts.items()}
        if gpu_id < 0:
            if device is not None:
                raise ValueError("device= names where the Surface path "
                                 "decodes to; gpu_id=-1 is the host-frame "
                                 "path")
            self._device = None
        else:
            self._device = (torch.device(device) if device is not None
                            else get_device(gpu_id))
            if self._device.type == "cuda" and self._device.index is None:
                self._device = get_device(torch.cuda.current_device())
        native = load_native()
        self._gpu_id = gpu_id
        self._ring = (StagingRing(self._device)
                      if self._device is not None else None)
        self._stream = (self._ring.stream if self._ring is not None
                        else get_stream(None, -1))
        if isinstance(input, BufferedReader):
            input = input.obj
        if isinstance(input, (str, bytes)):
            url = input if isinstance(input, str) else input.decode()
            self._dec = native.Decoder(url, opts, None, False)
        else:
            if not hasattr(input, "read"):
                raise TypeError(
                    "input must be a URL string or an object with .read")
            self._dec = native.Decoder(None, opts, input, False)

    # --- decode ------------------------------------------------------------

    def _do_decode(self, seek_ctx: Optional[SeekContext]):
        if seek_ctx is not None:
            by_number = seek_ctx.mode == SeekMode.BY_FRAME
            return self._dec.seek(
                seek_ctx.seek_frame, seek_ctx.seek_tssec, int(by_number))
        return self._dec.decode()

    def _fill_pkt_data(self, pkt_data: Optional[PacketData]):
        if pkt_data is None:
            return
        d = self._dec.packet_data()
        for key in ("pts", "dts", "pos", "bsl", "duration", "key"):
            setattr(pkt_data, key, d[key])

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
        self._fill_pkt_data(pkt_data)
        return (True, info)

    def _decode_surface(self, surf: Surface, pkt_data, seek_ctx, sync):
        if self._gpu_id < 0:
            # parity: (False, FAIL), not an exception
            return (False, TaskExecInfo.FAIL)
        if surf is None or surf.IsEmpty or surf.device != self._device:
            # the planes are written in place, so they must lie on the
            # decoder's device
            return (False, TaskExecInfo.INVALID_INPUT)
        # Validate the destination BEFORE decoding: rejecting after
        # _do_decode would consume and irreversibly drop a decoded frame
        # per failed call.
        p = self._props()
        fmt = PixelFormat(p["format"])
        if (surf.Width != p["width"] or surf.Height != p["height"]
                or surf.Format != fmt):
            return (False, TaskExecInfo.SRC_DST_FMT_MISMATCH
                    if surf.Format != fmt
                    else TaskExecInfo.SRC_DST_SIZE_MISMATCH)
        info = TaskExecInfo(self._do_decode(seek_ctx)[0])
        if info == TaskExecInfo.RES_CHANGE:
            # Stash protocol: caller re-allocates, next call delivers.
            return (True, info)
        if info != TaskExecInfo.SUCCESS:
            return (False, info)
        # a RES_CHANGE may have updated the props since the pre-check
        p = self._props()
        written = self._ring.upload(self._dec.copy_frame,
                                    PixelFormat(p["format"]), p["width"],
                                    p["height"], surf, sync)
        if written < 0:
            return (False, _copy_frame_error(written))
        self._fill_pkt_data(pkt_data)
        return (True, info)

    def DecodeSingleSurface(self, surf, pkt_data=None, seek_ctx=None):
        """Decode the next frame into ``surf``'s planes, in place, and
        wait until the copy has finished (parity: PyDecoder.cpp:97-123)."""
        if isinstance(pkt_data, SeekContext) and seek_ctx is None:
            pkt_data, seek_ctx = None, pkt_data
        return self._decode_surface(surf, pkt_data, seek_ctx, sync=True)

    def DecodeSingleSurfaceAsync(self, surf, pkt_data=None, seek_ctx=None):
        """Decode the next frame into ``surf`` without waiting for the copy
        to the device: later Surface ops are ordered behind it through the
        decoder's stream (``Stream``)."""
        if isinstance(pkt_data, SeekContext) and seek_ctx is None:
            pkt_data, seek_ctx = None, pkt_data
        return self._decode_surface(surf, pkt_data, seek_ctx, sync=False)

    # --- probe -------------------------------------------------------------

    @staticmethod
    def Probe(input: str) -> List[StreamParams]:
        """Parameters of every stream of ``input`` (parity: reference
        PyDecoder.cpp:684-698)."""
        native = load_native()
        dec = native.Decoder(input, {}, None, True)
        out = []
        for i in range(dec.props()["num_streams"]):
            p = dec.stream_params(i)
            if p is None:
                continue
            out.append(StreamParams(
                width=p["width"], height=p["height"], fourcc=p["fourcc"],
                codec_id=p["codec_id"], fps=p["fps"], avg_fps=p["avg_fps"],
                time_base=p["time_base"], start_time=p["start_time"],
                start_time_sec=p["start_time_sec"],
                duration_sec=p["duration_sec"], bit_rate=p["bit_rate"],
                num_frames=p["num_frames"], profile=p["profile"],
                level=p["level"],
                color_space=ColorSpace(p["color_space"]),
                color_range=ColorRange(p["color_range"])))
        return out

    # --- properties --------------------------------------------------------

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
    def Level(self) -> int:
        """Codec level of the input stream."""
        return self._props()["level"]

    @property
    def Profile(self) -> int:
        """Codec profile of the input stream."""
        return self._props()["profile"]

    @property
    def Delay(self) -> int:
        """Decoder reordering delay in frames."""
        return self._props()["delay"]

    @property
    def GopSize(self) -> int:
        """GOP size from the codec context (like the reference: the
        libavcodec decode-side default when the stream does not say)."""
        return self._props()["gop_size"]

    @property
    def Bitrate(self) -> int:
        """Stream bitrate in bits per second."""
        return self._props()["bitrate"]

    @property
    def NumFrames(self) -> int:
        """Number of frames in the stream (0 when the container does not say)."""
        return self._props()["num_frames"]

    @property
    def NumStreams(self) -> int:
        """Number of streams in the container."""
        return self._props()["num_streams"]

    @property
    def StreamIndex(self) -> int:
        """Index of the selected video stream."""
        return self._props()["stream_index"]

    @property
    def HostFrameSize(self) -> int:
        """Size in bytes of one decoded host frame."""
        return self._props()["host_frame_size"]

    @property
    def Framerate(self) -> float:
        """Declared frame rate (r_frame_rate)."""
        return self._props()["framerate"]

    @property
    def AvgFramerate(self) -> float:
        """Average frame rate (avg_frame_rate)."""
        return self._props()["avg_framerate"]

    @property
    def Timebase(self) -> float:
        """Stream time base in seconds per tick."""
        return self._props()["timebase"]

    @property
    def StartTime(self) -> float:
        """Stream start time in seconds."""
        return self._props()["start_time"]

    @property
    def Duration(self) -> float:
        """Stream duration in TRUE seconds.

        Intentional deviation kept from the JAX package: the reference
        divides stream-timebase units by AV_TIME_BASE, which only equals
        seconds when the timebase happens to be 1/1000000; the native
        engine multiplies by the actual timebase."""
        return self._props()["duration"]

    @property
    def ColorSpace(self) -> ColorSpace:
        """Color space of the decoded frames (BT_601/BT_709/UNSPEC)."""
        return ColorSpace(self._props()["color_space"])

    @property
    def ColorRange(self) -> ColorRange:
        """Color range of the decoded frames (MPEG/JPEG/UDEF)."""
        return ColorRange(self._props()["color_range"])

    @property
    def Format(self) -> PixelFormat:
        """Pixel format of the decoded frames."""
        return PixelFormat(self._props()["format"])

    @property
    def IsVFR(self) -> bool:
        """True when the stream is variable frame rate (r_frame_rate != avg_frame_rate)."""
        return self._props()["is_vfr"]

    @property
    def IsAccelerated(self) -> bool:
        """Always False: decode runs on host CPU; the device's work is the
        copy into the Surface and the Surface ops after it."""
        return False

    @property
    def Stream(self) -> int:
        """Handle of the stream the Surface path copies on (a raw
        cudaStream_t on the card, 0 for the default stream)."""
        return self._stream.handle

    @property
    def Mode(self) -> DecodeMode:
        """Current decode mode (ALL_FRAMES or KEY_FRAMES)."""
        return DecodeMode(self._props()["mode"])

    def SetMode(self, mode: DecodeMode) -> None:
        """Switch between ALL_FRAMES and KEY_FRAMES decode modes."""
        self._dec.set_mode(int(mode))

    @property
    def Metadata(self) -> dict:
        """Container and stream metadata as nested dicts."""
        return self._dec.metadata()

    @property
    def MotionVectors(self) -> "np.ndarray":
        """Motion vectors of the last decoded frame (requires
        flags2=+export_mvs) as a structured numpy array with dtype
        ``MOTION_VECTOR_DTYPE``; fields are readable by name
        (``mvs["motion_x"]``). The array is writable, as the reference's
        is: the native bytes are copied into a bytearray it owns."""
        buf = self._dec.motion_vectors_packed()
        return np.frombuffer(bytearray(buf), dtype=MOTION_VECTOR_DTYPE)

    @property
    def DisplayRotation(self) -> float:
        """Display rotation angle in degrees from the stream/frame display matrix."""
        return self._dec.display_rotation()

    @property
    def Stats(self) -> dict:
        """Internal pipeline counters (parity: the reference's debug
        counters m_num_pkt_read/sent/frm_recv)."""
        p = self._props()
        return {k: p[k] for k in ("num_pkt_read", "num_pkt_sent",
                                  "num_frm_recv")}
