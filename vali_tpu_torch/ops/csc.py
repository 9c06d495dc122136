"""Layout helpers for batched semi-planar planes.

Counterpart of the layout half of ``vali_tpu/ops/csc.py``; the
conversion registry waits for the Surface port.
"""

from __future__ import annotations

from typing import Tuple

import torch


def nv12_split(plane: torch.Tensor, height: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, >= H*3/2, W] -> (y [N,H,W], u [N,H/2,W/2], v [N,H/2,W/2]).

    All three are strided views of ``plane``; rows past H*3/2 are
    ignored."""
    y = plane[:, :height, :]
    uv = plane[:, height:height * 3 // 2, :]
    n, hc, w = uv.shape
    uv = uv.unflatten(2, (w // 2, 2))
    return y, uv[..., 0], uv[..., 1]
