"""Batched full-reference quality metrics on the device.

Counterpart of ``vali_tpu/ops/metrics.py``: MSE / PSNR / SSIM over
``[N, H, W]`` or ``[N, H, W, C]`` batches, one number per batch element,
computed where the frames already are. Plain PyTorch ops in float32 on
the inputs' device. The SSIM window means are two 1-D sliding-window sums
(``unfold`` then ``sum``), as the JAX module's ``reduce_window`` sums
are: a cumulative sum with differences would cancel in float32 over
1080 rows of squared 8-bit values.
"""

from __future__ import annotations

import math

import torch

from .fused import to_f32

__all__ = ["mse_batch", "psnr_batch", "ssim_batch"]


def _flat_dims(x: torch.Tensor):
    return tuple(range(1, x.dim()))


def mse_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-item mean squared error: [N, ...] x2 -> [N] float32."""
    d = to_f32(a) - to_f32(b)
    return torch.mean(d * d, dim=_flat_dims(d))


def psnr_batch(a: torch.Tensor, b: torch.Tensor,
               peak: float = 255.0) -> torch.Tensor:
    """Per-item PSNR in dB: [N, ...] x2 -> [N] float32;
    ``20 log10(peak) - 10 log10(mse)``, +inf for identical items."""
    mse = mse_batch(a, b)
    return torch.where(mse == 0.0, torch.full_like(mse, math.inf),
                       20.0 * math.log10(peak) - 10.0 * torch.log10(mse))


def _local_mean(img: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode ``win`` x ``win`` window mean over the trailing [H, W]
    axes: a window sum down the rows, then one along the columns."""
    s = img.unfold(1, win, 1).sum(-1)
    s = s.unfold(2, win, 1).sum(-1)
    return s / float(win * win)


def ssim_batch(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0,
               win: int = 8) -> torch.Tensor:
    """Per-item mean SSIM: [N, H, W] or [N, H, W, C] x2 -> [N] float32.

    Uniform ``win`` x ``win`` window (valid mode), K1 = 0.01, K2 = 0.03,
    unbiased (n - 1) window moments; channels fold into the batch and
    average back at the end."""
    a = to_f32(a)
    b = to_f32(b)
    if a.dim() == 4:
        n, h, w, c = a.shape
        per = ssim_batch(a.movedim(-1, 1).reshape(n * c, h, w),
                         b.movedim(-1, 1).reshape(n * c, h, w),
                         peak=peak, win=win)
        return per.reshape(n, c).mean(dim=1)
    _, h, w = a.shape
    if h < win or w < win:
        raise ValueError(f"frames {h}x{w} smaller than SSIM window {win}")
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a = _local_mean(a, win)
    mu_b = _local_mean(b, win)
    np_ = win * win
    norm = np_ / (np_ - 1.0)
    var_a = (_local_mean(a * a, win) - mu_a * mu_a) * norm
    var_b = (_local_mean(b * b, win) - mu_b * mu_b) * norm
    cov = (_local_mean(a * b, win) - mu_a * mu_b) * norm
    s = (((2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2))
         / ((mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)))
    return torch.mean(s, dim=_flat_dims(s))
