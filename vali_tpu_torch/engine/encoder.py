"""PyNvEncoder: VALI-compatible encoder over libx264/libx265, host frames.

Counterpart of the host-frame path of ``vali_tpu/engine/encoder.py`` (API
parity: reference PyNvEncoder's option dict and packet contract). It lets
the tests and the chip smoke run synthesise clips without JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.enums import PixelFormat, TaskExecInfo
from ._loader import load_native
from ._opts import opt_str


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
        """``gpu_id`` and ``stream`` are accepted for API parity (the
        reference's order) and unused; encoding runs on the host."""
        settings = {opt_str(k): opt_str(v) for k, v in settings.items()}
        self._enc = load_native().Encoder(settings, int(PixelFormat(format)),
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
    def FrameSizeInBytes(self) -> int:
        """Size in bytes of one input frame."""
        return self._enc.props()["frame_size"]

    def EncodeSingleFrame(self, frame: np.ndarray, packet: np.ndarray,
                          sei: Optional[np.ndarray] = None,
                          append: bool = False) -> bool:
        """Encode one flat host frame in the encoder's pixel format (the
        layout ``PyDecoder.DecodeSingleFrame`` produces). Returns True iff
        an encoded packet was written into ``packet`` (False while the
        codec's frame-delay queue fills)."""
        flat = np.ascontiguousarray(frame).reshape(-1).view(np.uint8)
        if flat.nbytes != self.FrameSizeInBytes:
            raise RuntimeError(
                f"Frame has {flat.nbytes} bytes, encoder expects "
                f"{self.FrameSizeInBytes}")
        sei_buf = None
        if sei is not None and getattr(sei, "size", 0):
            sei_buf = np.ascontiguousarray(sei).reshape(-1).view(np.uint8)
        info, _ = self._enc.encode(flat, False, sei_buf)
        if TaskExecInfo(info) != TaskExecInfo.SUCCESS:
            return False
        data = self._enc.pop_packet()
        if data is None:
            if not append:
                _append_packet(packet, b"", False)
            return False
        _append_packet(packet, data, append)
        return True

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
