"""PyNvJpegEncoder: batch JPEG encode through the host libjpeg, and the
device-assisted ``jpeg_encode_device``.

Counterpart of ``vali_tpu/engine/jpeg.py`` (API parity: reference
PyNvJpegEncoder.cpp): a per-call NvJpegEncodeContext (quality and input
format) and a batched ``Run`` over a list of Surfaces returning JPEG byte
arrays, through the native engine's libjpeg encoder (loaded by file path,
``engine/_loader.py``). ``jpeg_encode_device`` runs the pixel work of the
whole batch on the Surfaces' device (``ops/jpeg.py``) and hands only the
int16 coefficients to the host's entropy coder.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import torch

from ..core.enums import PixelFormat, TaskExecInfo
from ..memory.host import planes_to_host_frame
from ..memory.surface import Surface
from ..utils.device import get_device
from ._loader import load_native


class NvJpegEncodeContext:
    """Per-call compression settings (parity: NvJpegEncodeContext)."""

    def __init__(self, compression: int, pixel_format: PixelFormat,
                 gpu_id: int = 0):
        self._compression = int(compression)
        self._format = PixelFormat(pixel_format)
        self._native = load_native().JpegEncoder(self._compression,
                                                 int(self._format))

    def Compression(self) -> int:
        """Compression quality, 1-100."""
        return self._compression

    def Format(self) -> PixelFormat:
        """Pixel format of the Surfaces this context encodes."""
        return self._format


class PyNvJpegEncoder:
    """Batch JPEG encoder. ``gpu_id`` names the card the Surfaces live on
    (raises where there is no such card); ``-1`` takes Surfaces on the
    CPU. Thread-safe like the reference (an internal lock)."""

    def __init__(self, gpu_id: int = 0):
        if gpu_id >= 0:
            get_device(gpu_id)  # raises when there is no such CUDA device
        self._gpu_id = gpu_id
        self._lock = threading.Lock()
        load_native()

    def Context(self, compression: int,
                pixel_format: PixelFormat) -> NvJpegEncodeContext:
        """An encode context carrying the compression quality and input
        format (parity: PyNvJpegEncoder.cpp Context)."""
        return NvJpegEncodeContext(compression, pixel_format, self._gpu_id)

    def Run(self, context: NvJpegEncodeContext,
            surfaces: List[Surface]) -> Tuple[List[np.ndarray], TaskExecInfo]:
        """Encode a batch of Surfaces to JPEG bytes: ([arrays],
        TaskExecInfo) (parity: PyNvJpegEncoder.cpp:135-160)."""
        out: List[np.ndarray] = []
        with self._lock:
            for surf in surfaces:
                if surf.IsEmpty or surf.Format != context.Format():
                    return ([], TaskExecInfo.SRC_DST_FMT_MISMATCH
                            if not surf.IsEmpty else TaskExecInfo.FAIL)
                frame = planes_to_host_frame(
                    [p.cpu().numpy() for p in surf.plane_tensors()])
                info, payload = context._native.encode(
                    frame, surf.Width, surf.Height)
                if TaskExecInfo(info) != TaskExecInfo.SUCCESS:
                    return ([], TaskExecInfo(info))
                out.append(np.frombuffer(bytearray(payload), dtype=np.uint8))
        return (out, TaskExecInfo.SUCCESS)


def jpeg_encode_device(surfaces, quality: int = 85,
                       subsample420=None):
    """Device-assisted batch JPEG encode.

    Colour conversion, chroma subsampling, 8x8 DCT and quantisation run
    for the whole batch on the Surfaces' device (``ops/jpeg.py``); the
    host entropy-codes the quantised coefficients with libjpeg's
    jpeg_write_coefficients. Accepts RGB/BGR/RGB_PLANAR/Y/YUV444/YUV420
    Surfaces of one format and geometry; returns a list of numpy JPEG
    byte arrays. ``subsample420=None`` picks the format's natural
    subsampling (4:2:0 except for YUV444); an explicit bool overrides it
    where possible: YUV420 input is already subsampled, so
    ``subsample420=False`` with it raises, and grayscale ignores it."""
    from ..ops.jpeg import jpeg_transform_batch

    if not surfaces:
        return []
    native = load_native()
    fmt = surfaces[0].Format
    w, h = surfaces[0].Width, surfaces[0].Height
    for s in surfaces:
        if s.Format != fmt or s.Width != w or s.Height != h:
            raise ValueError("All surfaces must share format and geometry")

    n_planes = len(surfaces[0].plane_tensors())
    batched = tuple(
        torch.stack([s.plane_tensors()[j] for s in surfaces])
        for j in range(n_planes))
    if subsample420 is None:
        is420 = fmt != PixelFormat.YUV444
    else:
        if not subsample420 and fmt == PixelFormat.YUV420:
            raise ValueError(
                "subsample420=False is impossible for YUV420 input: the "
                "chroma is already 4:2:0-subsampled")
        is420 = bool(subsample420) or fmt == PixelFormat.YUV420
    y_c, cb_c, cr_c = jpeg_transform_batch(
        batched, src_fmt=int(fmt), width=w, height=h, quality=quality,
        subsample420=is420)

    y_np = y_c.cpu().numpy()
    cb_np = cb_c.cpu().numpy() if cb_c is not None else None
    cr_np = cr_c.cpu().numpy() if cr_c is not None else None

    out = []
    for i in range(y_np.shape[0]):
        kwargs = dict(width=w, height=h, subsample420=is420,
                      quality=quality, y_bh=y_np.shape[1],
                      y_bw=y_np.shape[2])
        if cb_np is not None:
            kwargs.update(c_bh=cb_np.shape[1], c_bw=cb_np.shape[2])
            info, payload = native.encode_jpeg_coefficients(
                np.ascontiguousarray(y_np[i]),
                np.ascontiguousarray(cb_np[i]),
                np.ascontiguousarray(cr_np[i]), **kwargs)
        else:
            info, payload = native.encode_jpeg_coefficients(
                np.ascontiguousarray(y_np[i]), None, None, **kwargs)
        if TaskExecInfo(info) != TaskExecInfo.SUCCESS:
            raise RuntimeError(f"JPEG entropy coding failed: {payload}")
        out.append(np.frombuffer(bytearray(payload), dtype=np.uint8))
    return out
