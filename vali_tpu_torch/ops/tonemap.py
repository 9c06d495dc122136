"""Batched HDR -> SDR tone mapping.

Counterpart of ``vali_tpu/ops/tonemap.py``, as plain elementwise PyTorch
ops in float32 on the frames' device over ``[N, H, W, 3]`` RGB batches:

  nonlinear code values (PQ / HLG, BT.2020 primaries)
    -> linear light (absolute nits)
    -> tone map luminance (BT.2390 EETF / Reinhard / Hable filmic)
    -> BT.2020 -> BT.709 gamut matrix
    -> BT.1886-style display gamma -> SDR code values

Transfer functions follow SMPTE ST 2084 (PQ) and ARIB STD-B67 / ITU-R
BT.2100 (HLG); the default operator is the ITU-R BT.2390 EETF knee,
applied to max(R, G, B) so that hue is preserved. The gamut product is
three multiply-adds per channel in IEEE float32: a reduced-precision
product is ~20 LSB off at the gamut-clip boundary once the 1/2.4 gamma
has amplified it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fused import to_f32

__all__ = [
    "pq_eotf", "pq_inv_eotf", "hlg_inv_oetf", "hlg_eotf",
    "BT2020_TO_BT709", "BT709_TO_BT2020",
    "bt2020_yuv_to_rgb", "tonemap_batch",
]

# SMPTE ST 2084 constants
_PQ_M1 = 2610.0 / 16384.0
_PQ_M2 = 2523.0 / 4096.0 * 128.0
_PQ_C1 = 3424.0 / 4096.0
_PQ_C2 = 2413.0 / 4096.0 * 32.0
_PQ_C3 = 2392.0 / 4096.0 * 32.0

# ARIB STD-B67 (HLG) constants
_HLG_A = 0.17883277
_HLG_B = 1.0 - 4.0 * _HLG_A
_HLG_C = 0.5 - _HLG_A * math.log(4.0 * _HLG_A)

#: Linear-light primaries conversion (ITU-R BT.2087 / derived from the
#: BT.2020 and BT.709 chromaticities, D65 white).
BT2020_TO_BT709 = np.array(
    [[1.660491, -0.587641, -0.072850],
     [-0.124550, 1.132900, -0.008349],
     [-0.018151, -0.100579, 1.118730]], dtype=np.float64)
BT709_TO_BT2020 = np.linalg.inv(BT2020_TO_BT709)


def pq_eotf(e: torch.Tensor) -> torch.Tensor:
    """ST 2084 EOTF: code value [0, 1] -> display luminance in nits."""
    e = torch.clamp(e, min=0.0)
    p = torch.pow(e, 1.0 / _PQ_M2)
    num = torch.clamp(p - _PQ_C1, min=0.0)
    den = _PQ_C2 - _PQ_C3 * p
    return 10000.0 * torch.pow(num / den, 1.0 / _PQ_M1)


def pq_inv_eotf(nits: torch.Tensor) -> torch.Tensor:
    """ST 2084 inverse EOTF: luminance in nits -> code value [0, 1]."""
    y = torch.pow(torch.clamp(nits, min=0.0) / 10000.0, _PQ_M1)
    return torch.pow((_PQ_C1 + _PQ_C2 * y) / (1.0 + _PQ_C3 * y), _PQ_M2)


def hlg_inv_oetf(e: torch.Tensor) -> torch.Tensor:
    """HLG inverse OETF: code value [0, 1] -> scene-linear light [0, 1]."""
    e = torch.clamp(e, min=0.0)
    lo = (e * e) / 3.0
    hi = (torch.exp((e - _HLG_C) / _HLG_A) + _HLG_B) / 12.0
    return torch.where(e <= 0.5, lo, hi)


def hlg_eotf(e: torch.Tensor, luma: torch.Tensor,
             peak_nits: float = 1000.0) -> torch.Tensor:
    """HLG EOTF (BT.2100): code values and scene luminance -> display
    nits, through the system OOTF ``peak * Y_s^(gamma - 1) * E_s`` with
    the BT.2100 reference gamma ``1.2 + 0.42 log10(peak / 1000)``."""
    gamma = 1.2 + 0.42 * math.log10(peak_nits / 1000.0)
    scene = hlg_inv_oetf(e)
    return peak_nits * torch.pow(
        torch.clamp(luma, min=1e-7), gamma - 1.0) * scene


def bt2020_yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      bit_depth: int = 10,
                      full_range: bool = False,
                      msb_aligned: bool = False) -> torch.Tensor:
    """BT.2020 (non-constant-luminance) YCbCr -> nonlinear RGB code
    values: per-plane [N, H, W] -> [N, H, W, 3] float32 in [0, 1].

    Chroma must already be co-sited with luma. ``msb_aligned`` says where
    the codes sit in a uint16 container: planar 10/12-bit decode output is
    LSB-aligned (the default), P010/P012 planes MSB-aligned (v16 = v10 <<
    6). The output stays PQ/HLG-encoded, ready for
    :func:`tonemap_batch`."""
    kr, kb = 0.2627, 0.0593
    kg = 1.0 - kr - kb
    scale = 256.0 if msb_aligned else float(1 << (bit_depth - 8))
    yf, uf, vf = to_f32(y), to_f32(u), to_f32(v)
    if full_range:
        maxv = (float(((1 << bit_depth) - 1) << (16 - bit_depth))
                if msb_aligned else float((1 << bit_depth) - 1))
        yn = yf / maxv
        un = uf / maxv - 0.5
        vn = vf / maxv - 0.5
    else:
        yn = (yf - 16.0 * scale) / (219.0 * scale)
        un = (uf - 128.0 * scale) / (224.0 * scale)
        vn = (vf - 128.0 * scale) / (224.0 * scale)
    r = yn + 2.0 * (1.0 - kr) * vn
    b = yn + 2.0 * (1.0 - kb) * un
    g = (yn - (2.0 * kb * (1.0 - kb) / kg) * un
         - (2.0 * kr * (1.0 - kr) / kg) * vn)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def _bt2390_eetf(ip: torch.Tensor, max_lum: float, max_ts: float
                 ) -> torch.Tensor:
    """ITU-R BT.2390 EETF on normalised-PQ luminance ``ip`` in [0, 1]
    (PQ signal over the source peak ``max_lum``), target peak ``max_ts``
    in the same space: identity below the knee, a Hermite spline above."""
    ks = 1.5 * max_ts - 0.5
    t = (ip - ks) / (1.0 - ks)
    t2 = t * t
    t3 = t2 * t
    p = ((2.0 * t3 - 3.0 * t2 + 1.0) * ks
         + (t3 - 2.0 * t2 + t) * (1.0 - ks)
         + (-2.0 * t3 + 3.0 * t2) * max_ts)
    return torch.where(ip < ks, ip, p)


def _np_pq_inv(nits: float) -> float:
    """ST 2084 inverse EOTF of a host constant (the curve's anchors)."""
    y = (max(nits, 0.0) / 10000.0) ** _PQ_M1
    return float(((_PQ_C1 + _PQ_C2 * y) / (1.0 + _PQ_C3 * y)) ** _PQ_M2)


def _tone_scale(lum_nits: torch.Tensor, peak_nits: float,
                target_nits: float, method: str) -> torch.Tensor:
    """Per-pixel gain mapping source luminance (nits) into
    [0, target_nits]: out_luminance / in_luminance."""
    lum = torch.clamp(lum_nits, min=1e-6)
    if target_nits >= peak_nits:
        # nothing to compress (and the BT.2390 knee would divide by 0)
        return torch.clamp(lum, max=target_nits) / lum
    if method == "bt2390":
        max_lum = _np_pq_inv(peak_nits)
        max_ts = _np_pq_inv(target_nits) / max_lum
        ip = pq_inv_eotf(lum) / max_lum
        out = pq_eotf(torch.clamp(_bt2390_eetf(ip, max_lum, max_ts),
                                  0.0, 1.0) * max_lum)
    elif method == "reinhard":
        # extended Reinhard, white point at the source peak
        x = lum / target_nits
        w = peak_nits / target_nits
        out = target_nits * (x * (1.0 + x / (w * w)) / (1.0 + x))
    elif method == "hable":
        a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30

        def curve(x):
            return ((x * (a * x + c * b) + d * e)
                    / (x * (a * x + b) + d * f)) - e / f

        x = lum / target_nits
        w = peak_nits / target_nits
        out = target_nits * curve(x) / float(curve(np.float64(w)))
    else:
        raise ValueError(f"unknown tone-map method '{method}'")
    return torch.clamp(out, max=target_nits) / lum


def _int_peak(dtype: torch.dtype) -> float:
    """The scale of [0, 1] onto an integer dtype's codes: its max, or for
    dtypes wider than float32's mantissa the largest float32 below it
    (float32(2^31 - 1) rounds up to 2^31, which the cast cannot hold)."""
    top = torch.iinfo(dtype).max
    peak = np.float32(top)
    if np.float64(peak) > np.float64(top):
        peak = np.nextafter(peak, np.float32(0.0))
    return float(peak)


def tonemap_batch(rgb: torch.Tensor, transfer: str = "pq",
                  peak_nits: float = 1000.0, target_nits: float = 100.0,
                  method: str = "bt2390", out_dtype=torch.uint8,
                  convert_gamut: bool = True,
                  out_gamma: float = 2.4) -> torch.Tensor:
    """HDR RGB batch -> SDR RGB batch: [N, H, W, 3] -> [N, H, W, 3].

    ``rgb`` holds nonlinear BT.2020 code values: float in [0, 1], uint16
    full scale (10-bit data in the MSBs, as P010 stores it) or uint8.
    ``transfer`` is ``"pq"`` or ``"hlg"`` (with the OOTF for
    ``peak_nits``); ``convert_gamut`` emits BT.709 primaries; the tone
    curve scales max(R, G, B); ``out_gamma`` is the display-inverse gamma
    of the SDR encode. Integer ``out_dtype`` values span the dtype's full
    code range; float ones lie in [0, 1]."""
    if rgb.dtype == torch.uint8:
        x = rgb.to(torch.float32) / 255.0
    elif rgb.dtype == torch.uint16:
        x = to_f32(rgb) / 65535.0
    else:
        x = rgb.to(torch.float32)

    wr, wg, wb = 0.2627, 0.6780, 0.0593   # BT.2020 luminance weights
    if transfer == "pq":
        lin = pq_eotf(x)
    elif transfer == "hlg":
        scene = hlg_inv_oetf(x)
        luma = (wr * scene[..., 0] + wg * scene[..., 1]
                + wb * scene[..., 2])[..., None]
        lin = hlg_eotf(x, luma, peak_nits=peak_nits)
    else:
        raise ValueError(f"unknown transfer '{transfer}'")

    peak = torch.amax(lin, dim=-1, keepdim=True)  # max(R,G,B) in nits
    gain = _tone_scale(peak, float(peak_nits), float(target_nits), method)
    lin = lin * gain

    if convert_gamut:
        m = BT2020_TO_BT709.astype(np.float32).tolist()
        lin = torch.stack([row[0] * lin[..., 0] + row[1] * lin[..., 1]
                           + row[2] * lin[..., 2] for row in m], dim=-1)

    sdr = torch.clamp(lin / float(target_nits), 0.0, 1.0)
    sdr = torch.pow(sdr, 1.0 / float(out_gamma))
    if out_dtype.is_floating_point:
        return sdr.to(out_dtype)
    # through int64, which holds every uint32 code exactly: float ->
    # uint16 / uint32 casts are not on every backend
    return torch.round(sdr * _int_peak(out_dtype)).to(torch.int64).to(
        out_dtype)
