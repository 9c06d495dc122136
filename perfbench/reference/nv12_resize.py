"""Reference of the NV12 resize: NV12 frames -> NV12 frames at the
destination size.

Luma resizes as one image; the interleaved chroma rows resize as their
own half-size image, U and V apart (``chroma_resample``: half_image).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import lanczos, matrix, resize_2d, rounder, split_420


def compute(planes: Tuple[torch.Tensor, ...], fmt: str, config: dict,
            precision: str = "float64") -> Tuple[torch.Tensor]:
    """(nv12 [b, dst_height * 3 / 2, dst_width] float64,) of the frames of
    ``planes``."""
    if fmt != "NV12" or config["chroma_resample"] != "half_image":
        raise ValueError("the NV12 resize reference takes NV12 frames "
                         "whose chroma resizes as a half-size image")
    q = rounder(precision)
    h, w = config["height"], config["width"]
    dh, dw = config["dst_height"], config["dst_width"]
    rs = config["resample"]
    dev = planes[0].device
    y, u, v = split_420(planes, fmt, h)
    luma = resize_2d(y, matrix(lanczos.plane_weights(h, dh, rs), dev, q),
                     matrix(lanczos.plane_weights(w, dw, rs), dev, q), q)
    ch = matrix(lanczos.plane_weights(h // 2, dh // 2, rs), dev, q)
    cw = matrix(lanczos.plane_weights(w // 2, dw // 2, rs), dev, q)
    chroma = torch.stack([resize_2d(c, ch, cw, q) for c in (u, v)],
                         dim=-1).flatten(2)          # U, V interleaved
    return (torch.cat([luma, chroma], dim=1).clamp(0.0, 255.0),)
