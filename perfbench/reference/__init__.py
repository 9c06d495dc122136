"""Plain PyTorch references of the benchmark's paths, in float64.

Each module here named by a path adapter's ``REFERENCE`` has a
``compute(planes, fmt, config, precision)`` that returns, for the frames
of ``planes``, the real-valued answers of every output the path makes
(before rounding, clipped to the output's range), in the layout the path
returns them. The matrices and coefficients come from the configuration
file alone (``lanczos.py``, :func:`yuv_to_rgb`); nothing here imports
the program or takes anything it made.

``precision`` is ``"float64"`` for the reference. Any other dtype name
gives the control: the same arithmetic with the weights, the colour
coefficients and each pass's result rounded to that dtype, which are the
cast points at which the program holds its compute dtype.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

#: the precision the control computes in, one step below the compute
#: dtype a configuration states
CONTROL_BELOW = {"float64": "float32", "float32": "bfloat16",
                 "bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn"}


def rounder(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """float64 -> float64 rounded to ``precision`` (identity for
    float64)."""
    if precision == "float64":
        return lambda t: t
    dtype = getattr(torch, precision)
    return lambda t: t.to(dtype).to(torch.float64)


def matrix(weights: np.ndarray, device: torch.device,
           q: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """A float64 numpy matrix on ``device``, rounded by ``q``."""
    return q(torch.from_numpy(np.ascontiguousarray(weights)).to(device))


def split_420(planes: Tuple[torch.Tensor, ...], fmt: str, height: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Y, U and V planes (float64) of NV12 ``(frames,)`` or I420
    ``(y, u, v)`` frames of ``height`` rows."""
    if fmt == "NV12":
        nv12 = planes[0]
        uv = nv12[:, height:height * 3 // 2]
        y, u, v = nv12[:, :height], uv[..., 0::2], uv[..., 1::2]
    elif fmt == "I420":
        y, u, v = planes
    else:
        raise ValueError(f"not a 4:2:0 format: {fmt!r}")
    return tuple(p.to(torch.float64) for p in (y, u, v))


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               config: dict, q: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """[..., 3] RGB of float64 Y, U, V samples by the configuration's
    matrix and offsets (``rgb = M @ [Y - luma_offset, U - chroma_offset,
    V - chroma_offset]``), clipped to [0, 255]."""
    m = q(torch.tensor(config["yuv_to_rgb"], dtype=torch.float64))
    yo = y - float(config["luma_offset"])
    uo = u - float(config["chroma_offset"])
    vo = v - float(config["chroma_offset"])
    chans = [float(m[c, 0]) * yo + float(m[c, 1]) * uo + float(m[c, 2]) * vo
             for c in range(3)]
    return torch.stack(chans, dim=-1).clamp(0.0, 255.0)


def resize_2d(x: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor,
              q: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """[b, h, w] -> [b, dh, dw]: the rows by ``wh`` [dh, h] (that result
    rounded by ``q``), then the columns by ``ww`` [dw, w]."""
    return torch.matmul(q(torch.matmul(wh, x)), ww.T)
