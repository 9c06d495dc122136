"""Resampling-matrix builders (host side, numpy).

Counterpart of ``vali_tpu/ops/resize.py``: the same Lanczos-3 / bilinear /
nearest matrices with the same phase and anti-alias conventions, so the
banded kernels and the dense torch path resample exactly like the JAX
package. Each dense ``[n_out, n_in]`` matrix is built on the host once per
(in, out, filter) and cached.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

#: NPP-parity Lanczos-3: corner-aligned phase, no filter scaling.
LANCZOS = "lanczos"
BILINEAR = "bilinear"
NEAREST = "nearest"
#: Anti-aliased, pixel-center variants (PIL-style) — higher quality for
#: large downscales; use in ML preprocessing pipelines.
LANCZOS_AA = "lanczos_aa"
BILINEAR_AA = "bilinear_aa"

METHODS = (LANCZOS, BILINEAR, NEAREST, LANCZOS_AA, BILINEAR_AA)


def method_conventions(method: str):
    """(kern, support, phase, antialias) for a resize-method string,
    mirroring resize_weights' normalization — so chroma weight builders
    resample with exactly the same kernel, phase and antialias as the luma
    path. kern is None for NEAREST."""
    antialias, phase = None, None
    m = method
    if m == LANCZOS_AA:
        m, antialias, phase = LANCZOS, True, "center"
    elif m == BILINEAR_AA:
        m, antialias, phase = BILINEAR, True, "center"
    if antialias is None:
        antialias = False
    phase = phase or "corner"
    if m == LANCZOS:
        kern, support = (lambda x: _lanczos(x, 3.0)), 3.0
    elif m == BILINEAR:
        kern, support = _bilinear, 1.0
    elif m == NEAREST:
        kern, support = None, 0.5
    else:
        raise ValueError(f"Unknown resize method {method!r}")
    return kern, support, phase, antialias


def phase_positions(n_out: int, scale: float, phase: str) -> np.ndarray:
    """Destination sample positions in source coordinates for a phase."""
    if phase == "corner":
        return np.arange(n_out) * scale
    if phase == "tex":
        return np.arange(n_out) * scale - 0.5
    return (np.arange(n_out) + 0.5) * scale - 0.5


def _lanczos(x: np.ndarray, a: float) -> np.ndarray:
    x = np.abs(x)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(x < a, out, 0.0)


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.maximum(0.0, 1.0 - x)


@functools.lru_cache(maxsize=256)
def resize_weights(n_in: int, n_out: int, method: str = LANCZOS,
                   antialias: Optional[bool] = None,
                   phase: Optional[str] = None) -> np.ndarray:
    """Dense [n_out, n_in] resampling matrix, rows normalized to 1.

    phase:
      - "corner": src = i*scale — NPP nppiResize convention.
      - "center": src = (i+0.5)*scale - 0.5 — PIL/OpenCV convention.
      - "tex":    src = i*scale - 0.5 — the tex2D convention.

    The cached array is shared by every caller: treat it as read-only.
    """
    if method == LANCZOS_AA:
        method = LANCZOS
        antialias = True if antialias is None else antialias
        phase = phase or "center"
    elif method == BILINEAR_AA:
        method = BILINEAR
        antialias = True if antialias is None else antialias
        phase = phase or "center"
    if antialias is None:
        antialias = False
    phase = phase or "corner"

    if n_in == n_out and phase != "tex":
        return np.eye(n_out, dtype=np.float32)
    scale = n_in / n_out
    if method == NEAREST:
        idx = np.minimum((np.arange(n_out) + 0.5) * scale, n_in - 1)
        w = np.zeros((n_out, n_in), dtype=np.float32)
        w[np.arange(n_out), idx.astype(np.int64)] = 1.0
        return w
    if method == LANCZOS:
        support, kern = 3.0, lambda x: _lanczos(x, 3.0)
    elif method == BILINEAR:
        support, kern = 1.0, _bilinear
    else:
        raise ValueError(f"Unknown resize method {method!r}")
    fscale = max(1.0, scale) if antialias else 1.0
    if phase == "tex":
        centers = np.arange(n_out) * scale - 0.5
    elif phase == "corner":
        centers = np.arange(n_out) * scale
    else:
        centers = (np.arange(n_out) + 0.5) * scale - 0.5  # src coords
    # Evaluate the kernel on the full [n_out, n_in] grid; the support window
    # zeroes everything else. n_in <= a few thousand, so this stays small.
    src_pos = np.arange(n_in)[None, :]
    dist = (src_pos - centers[:, None]) / fscale
    w = kern(dist)
    # Edge handling: fold out-of-range taps into the nearest edge pixel by
    # renormalizing rows (equivalent for a partition-of-unity kernel
    # evaluated with clamped taps).
    row_sum = w.sum(axis=1, keepdims=True)
    w = w / np.where(row_sum == 0.0, 1.0, row_sum)
    return w.astype(np.float32)
