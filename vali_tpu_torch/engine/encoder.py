"""PyNvEncoder: VALI-compatible encoder over libx264/libx265.

Counterpart of ``vali_tpu/engine/encoder.py`` (API parity: reference
PyNvEncoder): the option dict (validated, discoverable via
``GetNvencParams``), ``EncodeSingleSurface`` / ``EncodeSurface`` with
SEI, sync and append, ``Flush`` / ``FlushSinglePacket``, ``Reconfigure``
and ``Capabilities``. The NVENC ASIC becomes host x264/x265: a Surface's
planes are read to the host (:func:`download_host_frame`) and fed to the
codec with the GIL released. ``EncodeSingleFrame`` takes a host frame
directly, so the tests and the chip smoke run synthesise clips with no
device at all.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.enums import NV_ENC_CAPS, PixelFormat, TaskExecInfo
from ..memory.host import download_host_frame
from ..utils.device import get_stream
from ._loader import load_native
from ._opts import opt_str


def GetNvencParams() -> Dict[str, str]:
    """Documented encoder option keys (parity: VALI.cpp:505-510)."""
    return dict(load_native().encoder_option_docs())


def _append_packet(packet: np.ndarray, data: bytes, append: bool) -> None:
    """Write encoded bytes into the caller's numpy array, optionally
    appending."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if append and packet.size:
        n = packet.size
        packet.resize((n + arr.size,), refcheck=False)
        packet[n:] = arr
    else:
        packet.resize((arr.size,), refcheck=False)
        packet[:] = arr


class PyNvEncoder:
    """Video encoder with the reference's option-dict interface."""

    def __init__(self, settings: Dict[str, str], gpu_id: int = 0,
                 stream: Optional[int] = None,
                 format: PixelFormat = PixelFormat.NV12,
                 verbose: bool = False):
        """``gpu_id`` and ``stream`` keep the reference's places. Encoding
        runs on the host; a Surface's own device decides where
        :meth:`EncodeSingleSurface` reads it, on the stream of handle
        ``stream`` of that card (its default stream when None)."""
        settings = {opt_str(k): opt_str(v) for k, v in settings.items()}
        self._format = PixelFormat(format)
        self._stream_handle = stream
        self._enc = load_native().Encoder(settings, int(self._format),
                                          bool(verbose))

    @property
    def Width(self) -> int:
        """Encoded frame width in pixels."""
        return self._enc.props()["width"]

    @property
    def Height(self) -> int:
        """Encoded frame height in pixels."""
        return self._enc.props()["height"]

    @property
    def Format(self) -> PixelFormat:
        """Input pixel format the encoder expects."""
        return PixelFormat(self._enc.props()["format"])

    @property
    def FrameSizeInBytes(self) -> int:
        """Size in bytes of one input frame."""
        return self._enc.props()["frame_size"]

    def GetFrameSizeInBytes(self) -> int:
        """Size in bytes of one input frame in the encoder's pixel format."""
        return self.FrameSizeInBytes

    @property
    def Capabilities(self) -> Dict[NV_ENC_CAPS, int]:
        """Synthesized capability table for the active software codec."""
        hevc = self._enc.props()["is_hevc"]
        caps = {c: 0 for c in NV_ENC_CAPS}
        caps.update({
            NV_ENC_CAPS.NUM_MAX_BFRAMES: 16,
            NV_ENC_CAPS.SUPPORTED_RATECONTROL_MODES: 0x3F,
            NV_ENC_CAPS.SUPPORT_QPELMV: 1,
            NV_ENC_CAPS.SUPPORT_BDIRECT_MODE: 1,
            NV_ENC_CAPS.SUPPORT_CABAC: 1,
            NV_ENC_CAPS.SUPPORT_ADAPTIVE_TRANSFORM: 1,
            NV_ENC_CAPS.WIDTH_MAX: 8192,
            NV_ENC_CAPS.HEIGHT_MAX: 8192,
            NV_ENC_CAPS.WIDTH_MIN: 32,
            NV_ENC_CAPS.HEIGHT_MIN: 32,
            NV_ENC_CAPS.SUPPORT_DYN_BITRATE_CHANGE: 1,
            NV_ENC_CAPS.SUPPORT_DYN_RES_CHANGE: 1,
            NV_ENC_CAPS.SUPPORT_CUSTOM_VBV_BUF_SIZE: 1,
            NV_ENC_CAPS.SUPPORT_INTRA_REFRESH: 1,
            NV_ENC_CAPS.SUPPORT_LOOKAHEAD: 1,
            NV_ENC_CAPS.SUPPORT_TEMPORAL_AQ: 1,
            NV_ENC_CAPS.SUPPORT_LOSSLESS_ENCODE: 1,
            NV_ENC_CAPS.SUPPORT_10BIT_ENCODE: 1,
            NV_ENC_CAPS.SUPPORT_YUV444_ENCODE: 0 if hevc else 1,
            NV_ENC_CAPS.SUPPORT_SAO: 1 if hevc else 0,
            NV_ENC_CAPS.SUPPORT_MULTIPLE_REF_FRAMES: 1,
            NV_ENC_CAPS.MB_NUM_MAX: 65536,
            NV_ENC_CAPS.MB_PER_SEC_MAX: 983040,
        })
        return caps

    # --- encode ------------------------------------------------------------

    def _encode_host_frame(self, frame: np.ndarray, packet: np.ndarray,
                           sei: Optional[np.ndarray],
                           append: bool) -> bool:
        sei_buf = None
        if sei is not None and getattr(sei, "size", 0):
            sei_buf = np.ascontiguousarray(sei).reshape(-1).view(np.uint8)
        info, _ = self._enc.encode(frame, False, sei_buf)
        if TaskExecInfo(info) != TaskExecInfo.SUCCESS:
            return False
        data = self._enc.pop_packet()
        if data is None:
            # No packet yet: the codec is still filling its lookahead /
            # B-frame queue; the reference returns False here and the
            # bytes arrive on a later call. sync=True is best-effort, as
            # in the JAX package: libavcodec cannot drain one frame
            # mid-stream without ending it.
            if not append:
                _append_packet(packet, b"", False)
            return False
        _append_packet(packet, data, append)
        return True

    def EncodeSingleSurface(self, surface, packet: np.ndarray,
                            sei: Optional[np.ndarray] = None,
                            sync: bool = False,
                            append: bool = False) -> bool:
        """Encode one Surface; returns True iff an encoded packet was
        written into ``packet`` (False while the codec's frame-delay queue
        fills). A None or empty Surface drains one packet, like
        :meth:`FlushSinglePacket`; a Surface of another size or format
        raises RuntimeError (parity: PyNvEncoder.cpp:177-261)."""
        if surface is None or surface.IsEmpty:
            return self.FlushSinglePacket(packet)
        if (surface.Width != self.Width or surface.Height != self.Height
                or surface.Format != self._format):
            raise RuntimeError(
                "Surface does not match encoder size/format")
        stream = None
        if surface.device.type == "cuda":
            stream = get_stream(self._stream_handle, surface.device.index)
        frame = download_host_frame(surface, stream)
        return self._encode_host_frame(frame, packet, sei, append)

    # The reference exposes the same entry point under both names.
    EncodeSurface = EncodeSingleSurface

    def EncodeSingleFrame(self, frame: np.ndarray, packet: np.ndarray,
                          sei: Optional[np.ndarray] = None,
                          append: bool = False) -> bool:
        """Encode one flat host frame in the encoder's pixel format (the
        layout ``PyDecoder.DecodeSingleFrame`` produces; beyond the
        reference). Same packet contract as :meth:`EncodeSingleSurface`."""
        flat = np.ascontiguousarray(frame).reshape(-1).view(np.uint8)
        if flat.nbytes != self.FrameSizeInBytes:
            raise RuntimeError(
                f"Frame has {flat.nbytes} bytes, encoder expects "
                f"{self.FrameSizeInBytes}")
        return self._encode_host_frame(flat, packet, sei, append)

    def FlushSinglePacket(self, packet: np.ndarray) -> bool:
        """Retrieve one buffered packet after EOS; False when drained."""
        info, _ = self._enc.flush()
        if TaskExecInfo(info) != TaskExecInfo.SUCCESS:
            return False
        data = self._enc.pop_packet()
        if data is None:
            _append_packet(packet, b"", False)
            return False
        _append_packet(packet, data, False)
        return True

    def Flush(self, packets: np.ndarray) -> bool:
        """Drain all remaining packets into ``packets``, concatenated
        (parity: PyNvEncoder.cpp:263-281)."""
        info, _ = self._enc.flush()
        if TaskExecInfo(info) != TaskExecInfo.SUCCESS:
            return False
        chunks = []
        while True:
            data = self._enc.pop_packet()
            if data is None:
                break
            chunks.append(data)
        _append_packet(packets, b"".join(chunks), False)
        return bool(chunks)

    def Reconfigure(self, settings: Dict[str, str], force_idr: bool = False,
                    reset_encoder: bool = False,
                    verbose: bool = False) -> bool:
        """Merge new options and re-tune the encoder; resolution changes
        require reset_encoder=True (parity: PyNvEncoder.cpp:88-103)."""
        info, _ = self._enc.reconfigure(
            {opt_str(k): opt_str(v) for k, v in settings.items()},
            bool(force_idr), bool(reset_encoder))
        return TaskExecInfo(info) == TaskExecInfo.SUCCESS
