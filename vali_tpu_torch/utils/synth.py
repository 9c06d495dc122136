"""Self-contained test-clip synthesis (encode + mux with the native engine).

Counterpart of ``vali_tpu/utils/synth.py``: clips are synthesised on demand
with the package's own encoder + muxer, so tests and smoke runs need no
media checkout and no JAX. :class:`HostFrameSource` feeds frames that do
not come from a file (and needs no native engine).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.enums import PixelFormat, TaskExecInfo
from ..core.formats import format_info


class HostFrameSource:
    """Replays flat host frames through PyDecoder's host-frame interface,
    so that a MultiStreamPipeline stream can carry frames made in memory.

    ``frames`` are flat uint8 arrays in ``fmt``'s host-frame layout
    (``core/formats.py``), all of ``HostFrameSize`` bytes; they are
    returned in order, then the source reports END_OF_STREAM."""

    def __init__(self, frames: Sequence[np.ndarray], fmt, width: int,
                 height: int):
        self.Format = PixelFormat(fmt)
        self.Width, self.Height = width, height
        self.HostFrameSize = format_info(self.Format).host_size(width,
                                                                 height)
        self._frames = list(frames)
        for f in self._frames:
            if f.nbytes != self.HostFrameSize:
                raise ValueError(f"frame of {f.nbytes} bytes, expected "
                                 f"{self.HostFrameSize}")
        self._next = 0

    def DecodeSingleFrame(self, frame: np.ndarray):
        """Copy the next frame into ``frame`` (flat uint8, HostFrameSize
        bytes)."""
        if self._next == len(self._frames):
            return (False, TaskExecInfo.END_OF_STREAM)
        np.copyto(frame, self._frames[self._next])
        self._next += 1
        return (True, TaskExecInfo.SUCCESS)


def synthesize_clip(path: str, w: int = 848, h: int = 464, n: int = 96,
                    fps: float = 30.0, chroma: str = "flat") -> str:
    """Encode ``n`` moving-gradient NV12 frames with PyNvEncoder and mux
    them into ``path`` (container inferred from the extension). Returns
    ``path``.

    chroma="flat" (default): U=V=128, a grayscale ramp. chroma="sweep": U
    ramps vertically and V horizontally (16..240), so decoded R!=G!=B
    almost everywhere and an RGB<->BGR channel swap cannot pass unnoticed.
    """
    from ..engine.encoder import PyNvEncoder
    from ..engine.muxer import PyMuxer

    enc = PyNvEncoder({"s": f"{w}x{h}", "bf": "0", "lookahead": "0",
                       "gop": "30", "fps": str(int(fps))},
                      gpu_id=0, format=PixelFormat.NV12)
    pkts = []
    pkt = np.zeros(0, np.uint8)
    grad = np.linspace(16, 235, w, dtype=np.float64)
    if chroma == "sweep":
        u_col = np.linspace(16, 240, h // 2, dtype=np.float64)
        v_row = np.linspace(16, 240, w // 2, dtype=np.float64)
        uv_sweep = np.empty((h // 2, w), np.uint8)
        uv_sweep[:, 0::2] = u_col[:, None].astype(np.uint8)
        uv_sweep[:, 1::2] = v_row[None, :].astype(np.uint8)
    elif chroma != "flat":
        raise ValueError(f"chroma must be 'flat' or 'sweep', got {chroma!r}")
    for i in range(n):
        y = np.clip(grad[None, :] + i, 16, 235).astype(np.uint8)
        y = np.broadcast_to(y, (h, w))
        uv = (uv_sweep if chroma == "sweep"
              else np.full((h // 2, w), 128, np.uint8))
        frame = np.concatenate([y.reshape(-1), uv.reshape(-1)])
        if enc.EncodeSingleFrame(frame, pkt):
            pkts.append(pkt.tobytes())
    while True:
        f = np.zeros(0, np.uint8)
        if not enc.FlushSinglePacket(f) or not f.size:
            break
        pkts.append(f.tobytes())
    if len(pkts) != n:
        raise RuntimeError(f"encoder produced {len(pkts)} packets for {n} "
                           f"frames")

    with PyMuxer(path, w, h, fps=fps) as mux:
        for i, d in enumerate(pkts):
            ok, info = mux.Mux(d, pts=i / fps)
            if not ok:
                raise RuntimeError(f"muxing packet {i} failed: {info.name}")
    return path
