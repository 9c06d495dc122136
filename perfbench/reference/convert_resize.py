"""Reference of the two-stage route: NV12 -> packed RGB at full size (a
uint8 surface), then that surface resized to the destination size.

The convert takes each pixel's chroma from the 2 x 2 block it lies in
(``convert_upsample``: nearest) and applies the colour matrix; the RGB
surface holds those values rounded half to even. The resize resamples
each channel of the surface on its own grid, rows then columns.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import lanczos, matrix, resize_2d, rounder, split_420, yuv_to_rgb


def compute(planes: Tuple[torch.Tensor, ...], fmt: str, config: dict,
            precision: str = "float64") -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb [b, height, 3 width], small [b, dst_height, 3 dst_width]),
    float64, of the frames of ``planes``."""
    if config["convert_upsample"] != "nearest":
        raise ValueError(
            f"unsupported upsample {config['convert_upsample']!r}")
    q = rounder(precision)
    h, w = config["height"], config["width"]
    dh, dw = config["dst_height"], config["dst_width"]
    y, u, v = split_420(planes, fmt, h)
    u, v = (c[:, :h // 2].repeat_interleave(2, 1).repeat_interleave(2, 2)
            for c in (u, v))
    rgb = yuv_to_rgb(y[:, :h], u, v, config, q)          # [b, h, w, 3]
    surface = torch.round(rgb)
    dev = rgb.device
    wh = matrix(lanczos.plane_weights(h, dh, config["resample"]), dev, q)
    ww = matrix(lanczos.plane_weights(w, dw, config["resample"]), dev, q)
    small = torch.stack([resize_2d(surface[..., c], wh, ww, q)
                         for c in range(3)], dim=-1).clamp(0.0, 255.0)
    b = rgb.shape[0]
    return rgb.reshape(b, h, 3 * w), small.reshape(b, dh, 3 * dw)
