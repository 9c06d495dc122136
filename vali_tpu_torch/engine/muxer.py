"""PyMuxer: wrap encoded elementary-stream packets into a container.

The reference emits raw elementary streams only (encoded packets are
written to disk verbatim in its samples); a muxer completes the
transcode story — `PyNvEncoder` packets plus caller-chosen timestamps
become a seekable .mp4/.mkv/.ts. It is also how the test suite
synthesizes true variable-frame-rate fixtures (the reference ships none:
its test_PyDecoder.py leaves the VFR-true assertion commented out).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.enums import TaskExecInfo
from ._loader import load_native
from ._opts import opt_str


class PyMuxer:
    """Write encoded H.264/HEVC access units into MP4/MKV/MPEG-TS.

    Timestamps are float seconds; they are quantized to ``timebase_den``
    ticks per second (default 90 kHz, the MPEG transport timebase).
    """

    def __init__(self, path: str, width: int, height: int,
                 codec: str = "h264", timebase_den: int = 90000,
                 format: Optional[str] = None,
                 fps=None,
                 opts: Optional[dict] = None):
        """``opts``: muxer AVOptions passed to the container writer,
        e.g. ``{"movflags": "faststart"}`` for web-streamable MP4."""
        native = load_native()
        fps_num, fps_den = 0, 1
        if fps:
            if isinstance(fps, (tuple, list)):
                fps_num, fps_den = int(fps[0]), int(fps[1])
                if fps_num <= 0 or fps_den <= 0:
                    # The native layer only guards fps_num; a zero/neg
                    # denominator would install AVRational{n, 0} as
                    # avg_frame_rate and poison duration math downstream.
                    raise ValueError(
                        f"fps rational must be positive, got "
                        f"{fps_num}/{fps_den}")
            else:
                # av_d2q-style rational approximation, NOT millihertz
                # quantization: fps=30000/1001 must be stored as exactly
                # 30000/1001, or the declared rate (2997/100) disagrees
                # with the timestamp-derived r_frame_rate and CFR NTSC
                # content decodes as IsVFR=True.
                from fractions import Fraction
                frac = Fraction(float(fps)).limit_denominator(1 << 16)
                fps_num, fps_den = frac.numerator, frac.denominator
        norm_opts = {opt_str(k): opt_str(v)
                     for k, v in (opts or {}).items()}
        self._mux = native.Muxer(path, int(width), int(height), str(codec),
                                 int(timebase_den), format or "",
                                 fps_num, fps_den, norm_opts)
        self._tb_den = int(timebase_den)
        self._closed = False

    def Mux(self, packet, pts: float, dts: Optional[float] = None,
            key: bool = False) -> Tuple[bool, TaskExecInfo]:
        """Write one access unit. ``packet`` is bytes or a uint8 array.

        ``dts`` defaults to ``pts``, which is only correct for streams
        without frame reordering: encode with ``{'bf': '0'}`` (as the
        samples and ``utils.synth`` do), or pass the real decode
        timestamps explicitly for B-frame streams — with reordering,
        pts-as-dts makes the container writer reject non-monotonic
        timestamps mid-stream or produce jerky playback."""
        if isinstance(packet, np.ndarray):
            packet = np.ascontiguousarray(packet).tobytes()
        pts_t = int(round(pts * self._tb_den))
        dts_t = pts_t if dts is None else int(round(dts * self._tb_den))
        info, msg = self._mux.write(packet, pts_t, dts_t, bool(key))
        info = TaskExecInfo(info)
        return info == TaskExecInfo.SUCCESS, info

    def Close(self) -> Tuple[bool, TaskExecInfo]:
        """Write the container trailer and close the file (idempotent)."""
        if self._closed:
            return True, TaskExecInfo.SUCCESS
        self._closed = True
        info, msg = self._mux.close()
        info = TaskExecInfo(info)
        return info == TaskExecInfo.SUCCESS, info

    def __enter__(self) -> "PyMuxer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        ok, info = self.Close()
        # a failed trailer write means the file is unplayable; swallowing
        # it would let a with-block exit green on a corrupt container.
        # Don't mask an exception already unwinding, though.
        if not ok and exc_type is None:
            raise RuntimeError(
                f"PyMuxer.Close failed writing the container trailer "
                f"({info.name}); the output file is likely corrupt")
