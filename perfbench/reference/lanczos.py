"""Resampling matrices of the configurations, worked out in float64.

A frozen statement of the resampling that the configurations name
(``"resample"``: a Lanczos kernel of ``a`` lobes, pixel-centre phase,
anti-aliased by stretching the kernel by the downscale factor, each row
normalised to 1), kept here so that a later change to the program's own
weight builders cannot move the yardstick. Nothing here imports the
program.
"""

from __future__ import annotations

import functools

import numpy as np


def _kernel(x: np.ndarray, a: int) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < a, np.sinc(x) * np.sinc(x / a), 0.0)


def _normalised(centers: np.ndarray, n_in: int, stretch: float,
                a: int) -> np.ndarray:
    """[n_out, n_in] float64: the kernel at each source sample's distance
    from each output centre (in source samples, over ``stretch``), every
    row scaled to sum to 1 (taps past an edge are dropped, so the edge
    pixels carry their weight)."""
    dist = (np.arange(n_in)[None, :] - centers[:, None]) / stretch
    w = _kernel(dist, a)
    s = w.sum(axis=1, keepdims=True)
    return w / np.where(s == 0.0, 1.0, s)


def _check(resample: dict) -> int:
    if (resample.get("kernel") != "lanczos"
            or resample.get("phase") != "center"
            or resample.get("antialias") is not True):
        raise ValueError(f"unsupported resampling {resample!r}")
    return int(resample["a"])


@functools.lru_cache(maxsize=64)
def _plane(n_in: int, n_out: int, a: int) -> np.ndarray:
    scale = n_in / n_out
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    return _normalised(centers, n_in, max(1.0, scale), a)


def plane_weights(n_in: int, n_out: int, resample: dict) -> np.ndarray:
    """[n_out, n_in] float64 weights of one axis of an image resized on its
    own grid: output sample o is centred on source position
    (o + 0.5) * n_in / n_out - 0.5. Read-only (cached)."""
    return _plane(n_in, n_out, _check(resample))


@functools.lru_cache(maxsize=64)
def _chroma(n_in: int, n_out: int, full: int, site: float,
            a: int) -> np.ndarray:
    scale = full / n_out
    dst = (np.arange(n_out) + 0.5) * scale - 0.5   # full-resolution position
    centers = (dst - site) / 2.0                   # chroma sample i at 2i+site
    return _normalised(centers, n_in, max(1.0, (full / 2) / n_out), a)


def chroma_weights(n_in: int, n_out: int, full: int, site: float,
                   resample: dict) -> np.ndarray:
    """[n_out, n_in] float64 weights from a half-resolution chroma axis
    straight onto the ``n_out`` luma-grid outputs of a ``full``-sample
    axis, chroma sample i sited at full-resolution position 2 i + ``site``.
    Read-only (cached)."""
    return _chroma(n_in, n_out, full, float(site), _check(resample))


def band_taps(weights: np.ndarray) -> int:
    """Source samples that all rows of ``weights`` read: each row's span
    from its first to its last nonzero weight."""
    nz = weights != 0.0
    has = nz.any(axis=1)
    first = nz.argmax(axis=1)
    last = weights.shape[1] - 1 - nz[:, ::-1].argmax(axis=1)
    return int(np.where(has, last - first + 1, 0).sum())
