"""Reference of the fused preprocess: 4:2:0 frames -> RGB at the
destination size, HWC.

Each plane is resampled straight onto the destination grid (luma on its
own grid; chroma from its half-resolution axes, sited as the
configuration's ``chroma_site`` says), then the colour matrix turns the
resampled Y, U, V into RGB.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import lanczos, matrix, resize_2d, rounder, split_420, yuv_to_rgb


def compute(planes: Tuple[torch.Tensor, ...], fmt: str, config: dict,
            precision: str = "float64") -> Tuple[torch.Tensor]:
    """(rgb [b, dst_height, dst_width, 3] float64,) of the frames of
    ``planes``."""
    q = rounder(precision)
    h, w = config["height"], config["width"]
    dh, dw = config["dst_height"], config["dst_width"]
    rs, (sx, sy) = config["resample"], config["chroma_site"]
    dev = planes[0].device
    wyh = matrix(lanczos.plane_weights(h, dh, rs), dev, q)
    wyw = matrix(lanczos.plane_weights(w, dw, rs), dev, q)
    wch = matrix(lanczos.chroma_weights(h // 2, dh, h, sy, rs), dev, q)
    wcw = matrix(lanczos.chroma_weights(w // 2, dw, w, sx, rs), dev, q)
    y, u, v = split_420(planes, fmt, h)
    return (yuv_to_rgb(resize_2d(y[:, :h], wyh, wyw, q),
                       resize_2d(u[:, :h // 2], wch, wcw, q),
                       resize_2d(v[:, :h // 2], wch, wcw, q), config, q),)
