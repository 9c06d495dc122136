"""Device stage of JPEG encode: colour convert + subsample + 8x8 DCT +
quantisation, batched over frames.

Counterpart of ``vali_tpu/ops/jpeg.py``: everything up to entropy coding
runs on the frames' device as plain PyTorch ops — the 8x8 type-II DCT is
``D @ block @ D^T``, two small matrix products in IEEE float32 over all
blocks of all frames at once — and the host finishes with libjpeg's
``jpeg_write_coefficients`` (``engine/jpeg.py``). The quantisation tables
replicate libjpeg's IJG quality scaling, so that the host-written headers
match the device-quantised coefficients.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.enums import PixelFormat
from .csc import subsample420
from .fused import exact_f32_matmul

# Annex K / IJG base tables (luminance, chrominance), natural order.
_BASE_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int32).reshape(8, 8)

_BASE_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], dtype=np.int32).reshape(8, 8)


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) int32 [8, 8] tables by IJG quality scaling (libjpeg
    jpeg_set_quality / jpeg_quality_scaling), bit-exact with the host
    writer."""
    quality = max(1, min(100, int(quality)))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    tables = []
    for base in (_BASE_LUMA, _BASE_CHROMA):
        t = (base * scale + 50) // 100
        tables.append(np.clip(t, 1, 255).astype(np.int32))
    return tables[0], tables[1]


@functools.lru_cache(maxsize=1)
def dct_matrix() -> np.ndarray:
    """8x8 type-II DCT matrix D with JPEG normalisation:
    F = D @ f @ D^T."""
    d = np.zeros((8, 8), dtype=np.float64)
    for u in range(8):
        cu = np.sqrt(1.0 / 8.0) if u == 0 else np.sqrt(2.0 / 8.0)
        for x in range(8):
            d[u, x] = cu * np.cos((2 * x + 1) * u * np.pi / 16.0)
    return d.astype(np.float32)


def _blockify(plane: torch.Tensor) -> torch.Tensor:
    """[N, H, W] -> [N, H/8, W/8, 8, 8]"""
    n, h, w = plane.shape
    return plane.reshape(n, h // 8, 8, w // 8, 8).transpose(2, 3)


def _dct_quant(plane: torch.Tensor, qtable: np.ndarray,
               center: float = 128.0) -> torch.Tensor:
    """[N, H, W] float32 -> quantised coefficients [N, H/8, W/8, 8, 8]
    int16, rounded half to even and clipped into int16."""
    blocks = _blockify(plane - center)
    d = torch.from_numpy(dct_matrix()).to(plane.device)
    with exact_f32_matmul():
        coef = torch.matmul(torch.matmul(d, blocks), d.T)
    q = torch.from_numpy(qtable.astype(np.float32)).to(plane.device)
    return torch.clamp(torch.round(coef / q), -32768, 32767).to(torch.int16)


def _pad_edges(plane: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replicate the last row ``ph`` and the last column ``pw`` times."""
    if not (ph or pw):
        return plane
    return F.pad(plane, (0, pw, 0, ph), mode="replicate")


def _subsample2(c: torch.Tensor) -> torch.Tensor:
    """h2v2 box downsample (libjpeg's default): odd sizes edge-replicated
    to even first, as libjpeg's h2v2_downsample does, then the 2x2 mean
    of the CSC module."""
    _, h, w = c.shape
    return subsample420(_pad_edges(c, h % 2, w % 2))


def _pad_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """Edge-replicate to multiples of 8 (libjpeg does the same)."""
    _, h, w = plane.shape
    return _pad_edges(plane, (-h) % 8, (-w) % 8)


def jpeg_transform_batch(planes, *, src_fmt: int, width: int, height: int,
                         quality: int, subsample420: bool = True):
    """Batched device stage of JPEG encode.

    planes: storage-layout batched planes on one device (RGB/BGR packed
    [N, H, 3W], RGB_PLANAR [N, 3H, W], Y [N, H, W], YUV444/YUV420
    3-plane). Returns (y, cb, cr) quantised coefficients
    [N, bh, bw, 8, 8] int16 (cb/cr None for grayscale)."""
    fmt = PixelFormat(src_fmt)
    # width/height are the logical size the host writer will declare: a
    # mismatch errors here instead of in the writer's edge clamping
    _, ph, pw = planes[0].shape
    expect = {
        PixelFormat.Y: (height, width),
        PixelFormat.RGB: (height, width * 3),
        PixelFormat.BGR: (height, width * 3),
        PixelFormat.RGB_PLANAR: (height * 3, width),
        PixelFormat.YUV444: (height, width),
        PixelFormat.YUV420: (height, width),
    }.get(fmt)
    if expect is not None and (ph, pw) != expect:
        raise ValueError(
            f"jpeg_transform_batch: plane shape {(ph, pw)} does not match "
            f"the declared {width}x{height} for {fmt.name} "
            f"(expected {expect})")
    ql, qc = quant_tables(quality)

    if fmt == PixelFormat.Y:
        y = planes[0].to(torch.float32)
        return (_dct_quant(_pad_to_blocks(y), ql), None, None)

    if fmt in (PixelFormat.RGB, PixelFormat.BGR, PixelFormat.RGB_PLANAR):
        if fmt == PixelFormat.RGB_PLANAR:
            n, h3, w = planes[0].shape
            rgb = planes[0].reshape(n, 3, h3 // 3, w).movedim(1, -1)
        else:
            n, h, w3 = planes[0].shape
            rgb = planes[0].reshape(n, h, w3 // 3, 3)
        if fmt == PixelFormat.BGR:
            rgb = rgb.flip(-1)
        rgb = rgb.to(torch.float32)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        # JFIF full-range BT.601 (libjpeg rgb_ycc exact coefficients)
        y = 0.29900 * r + 0.58700 * g + 0.11400 * b
        cb = -0.16874 * r - 0.33126 * g + 0.50000 * b + 128.0
        cr = 0.50000 * r - 0.41869 * g - 0.08131 * b + 128.0
    elif fmt == PixelFormat.YUV444:
        y, cb, cr = (p.to(torch.float32) for p in planes[:3])
    elif fmt == PixelFormat.YUV420:
        if not subsample420:
            # the chroma planes are half-size already: a 4:4:4 layout
            # would make the writer read them as full-size
            raise ValueError(
                "jpeg_transform_batch: subsample420=False is impossible "
                "for YUV420 input — the chroma planes are already "
                "subsampled")
        y, cb, cr = (p.to(torch.float32) for p in planes[:3])
        return (
            _dct_quant(_pad_to_blocks(y), ql),
            _dct_quant(_pad_to_blocks(cb), qc),
            _dct_quant(_pad_to_blocks(cr), qc),
        )
    else:
        raise ValueError(f"jpeg_transform_batch: unsupported {fmt.name}")

    if subsample420:
        cb = _subsample2(cb)
        cr = _subsample2(cr)
    return (
        _dct_quant(_pad_to_blocks(y), ql),
        _dct_quant(_pad_to_blocks(cb), qc),
        _dct_quant(_pad_to_blocks(cr), qc),
    )
