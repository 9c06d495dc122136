"""Batched on-device video analytics: histograms, luma statistics,
scene-change scores.

Counterpart of ``vali_tpu/ops/analytics.py``: elementwise and reduction
code over ``[N, H, W]`` (or ``[N, H, W, C]``) batches, one result row per
frame, as plain PyTorch ops on the frames' device. The histogram is one
``scatter_add_`` of ones over ``row * bins + bin`` into an int32 lattice
(integer adds: the counts do not depend on their order). Scene-change
scoring blends the mean absolute difference of consecutive frames (SAD)
with their histogram L1 distance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import get_device
from .fused import to_f32

__all__ = [
    "histogram_batch",
    "luma_stats_batch",
    "frame_diff_scores",
    "hist_delta_scores",
    "scene_change_scores",
    "detect_scene_changes",
]


def _flat_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(1, x.dim()))


def histogram_batch(frames: torch.Tensor, bins: int = 256,
                    value_range: Optional[Tuple[float, float]] = None
                    ) -> torch.Tensor:
    """Per-frame histogram: [N, ...] -> [N, bins] int32.

    ``value_range`` is a half-open ``(lo, hi)`` interval split into
    ``bins`` equal cells; values outside it are clamped into the edge
    bins (clipped pixels count as clipped). It defaults to ``(0, 256)``
    for uint8 and ``(0, 65536)`` for uint16 frames and is required for
    any other dtype. A sample's bin is ``(x - lo) * (bins / (hi - lo))``
    in float32, truncated toward zero."""
    if value_range is None:
        if frames.dtype == torch.uint8:
            value_range = (0.0, 256.0)
        elif frames.dtype == torch.uint16:
            value_range = (0.0, 65536.0)
        else:
            raise ValueError(
                "value_range is required for non-uint8/uint16 inputs")
    lo, hi = float(value_range[0]), float(value_range[1])
    if not hi > lo:
        raise ValueError(f"empty value_range {value_range}")
    n = frames.shape[0]
    x = to_f32(frames.reshape(n, -1))
    # the scale rounds to float32 first, as a weakly typed constant does
    scale = float(np.float32(bins / (hi - lo)))
    idx = torch.clamp(((x - lo) * scale).to(torch.int32), 0, bins - 1)
    rows = torch.arange(n, device=x.device, dtype=torch.int64)[:, None]
    flat = (rows * bins + idx).reshape(-1)
    out = torch.zeros(n * bins, dtype=torch.int32, device=x.device)
    out.scatter_add_(0, flat, torch.ones((), dtype=torch.int32,
                                         device=x.device).expand_as(flat))
    return out.reshape(n, bins)


def luma_stats_batch(frames: torch.Tensor) -> dict:
    """Per-frame exposure statistics: [N, ...] -> dict of [N] float32
    ``{"mean", "std", "min", "max"}``; ``std`` is the population standard
    deviation, from two passes (E[(x - mean)^2]: the one-pass form cancels
    in float32 on high-mean flat frames)."""
    x = to_f32(frames)
    dims = _flat_dims(x)
    mean = torch.mean(x, dim=dims)
    centered = x - mean.reshape(mean.shape + (1,) * (x.dim() - 1))
    var = torch.mean(centered * centered, dim=dims)
    return {
        "mean": mean,
        "std": torch.sqrt(torch.clamp(var, min=0.0)),
        "min": torch.amin(x, dim=dims),
        "max": torch.amax(x, dim=dims),
    }


def _default_peak(dtype: torch.dtype) -> float:
    """Signal peak by dtype: 255 (uint8), 65535 (uint16), 1.0 (float code
    values)."""
    if dtype == torch.uint8:
        return 255.0
    if dtype == torch.uint16:
        return 65535.0
    return 1.0


def _default_hist_range(dtype: torch.dtype, peak: Optional[float]
                        ) -> Tuple[float, float]:
    """Histogram range by dtype; integer codes with an explicit ``peak``
    get one code of headroom (hi = peak + 1), so that every code spans an
    equal bin width under the half-open range."""
    if peak is not None:
        if dtype in (torch.uint8, torch.uint16):
            return (0.0, float(peak) + 1.0)
        return (0.0, float(peak))
    if dtype == torch.uint8:
        return (0.0, 256.0)
    if dtype == torch.uint16:
        return (0.0, 65536.0)
    return (0.0, 1.0)


def frame_diff_scores(frames: torch.Tensor,
                      peak: Optional[float] = None) -> torch.Tensor:
    """Mean absolute difference between consecutive frames over ``peak``
    (default by dtype): [N, ...] -> [N-1] float32; row i scores the
    i -> i+1 transition."""
    if peak is None:
        peak = _default_peak(frames.dtype)
    x = to_f32(frames)
    d = torch.abs(x[1:] - x[:-1])
    return torch.mean(d, dim=_flat_dims(d)) / peak


def hist_delta_scores(frames: torch.Tensor, bins: int = 64,
                      value_range: Optional[Tuple[float, float]] = None
                      ) -> torch.Tensor:
    """Normalised histogram L1 distance between consecutive frames:
    [N, ...] -> [N-1] float32 in [0, 1]."""
    h = histogram_batch(frames, bins=bins, value_range=value_range)
    h = h.to(torch.float32)
    h = h / torch.sum(h, dim=1, keepdim=True)
    return 0.5 * torch.sum(torch.abs(h[1:] - h[:-1]), dim=1)


def scene_change_scores(frames: torch.Tensor, bins: int = 64,
                        peak: Optional[float] = None,
                        hist_weight: float = 0.5) -> torch.Tensor:
    """Blended shot-boundary score per transition: [N, ...] -> [N-1]
    float32 in [0, 1], ``hist_weight`` of histogram distance and the rest
    of SAD. ``peak`` defaults by dtype; pass the true peak (1023 / 4095)
    for LSB-aligned 10/12-bit uint16 frames."""
    sad = frame_diff_scores(frames, peak=peak)
    vrange = _default_hist_range(frames.dtype, peak)
    hd = hist_delta_scores(frames, bins=bins, value_range=vrange)
    return hist_weight * hd + (1.0 - hist_weight) * sad


def detect_scene_changes(frames, threshold: float = 0.3,
                         min_gap: int = 1, bins: int = 64,
                         peak: Optional[float] = None,
                         hist_weight: float = 0.5, *,
                         device: Optional[torch.device] = None
                         ) -> np.ndarray:
    """Indices i where frame i starts a new shot, as int64 numpy (each
    >= 1): scores on the device, then the threshold and a minimum gap on
    the host. ``frames`` is a tensor (scored on its own device) or a
    numpy array (copied to ``device``, default ``cuda:0``)."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames)).to(
            device if device is not None else get_device(0))
    scores = scene_change_scores(frames, bins=bins, peak=peak,
                                 hist_weight=hist_weight).cpu().numpy()
    cuts = []
    last = -(10 ** 9)
    for i, s in enumerate(scores, start=1):
        if s >= threshold and i - last >= min_gap:
            cuts.append(i)
            last = i
    return np.asarray(cuts, dtype=np.int64)
