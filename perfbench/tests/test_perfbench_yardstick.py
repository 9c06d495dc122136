"""The frozen byte and operation counts of the roofline metrics against
hand counts at the four cells' shapes.

A hand count takes each output sample's taps straight from the support
of the Lanczos-3 window: the source samples i with |i - c| < 3 s, where
c is the sample's centre and s the stretch (the downscale factor, or
1), clipped to the plane; one FMA is two operations."""

import math

import pytest

from perfbench import harness

RS = {"kernel": "lanczos", "a": 3, "antialias": True, "phase": "center"}


def taps(n_in, n_out, full=None, site=0.5):
    """Hand count of the taps of one axis: on its own grid, or (``full``
    given) from a half-resolution chroma axis onto the luma grid."""
    scale = (full or n_in) / n_out
    stretch = max(1.0, (full / 2 if full else n_in) / n_out)
    total = 0
    for o in range(n_out):
        c = (o + 0.5) * scale - 0.5
        if full:
            c = (c - site) / 2
        lo = max(0, math.floor(c - 3 * stretch) + 1)
        hi = min(n_in - 1, math.ceil(c + 3 * stretch) - 1)
        total += hi - lo + 1
    return total


def work(metric, cell):
    c = harness.cell(cell)
    return harness.metric_reader(metric).work(c.config, c.traffic)


def test_fused_preprocess_counts():
    b, h, w, d = 64, 1080, 1920, 224
    fmas = (taps(h, d) * w + 2 * taps(h // 2, d, h) * (w // 2)
            + d * (taps(w, d) + 2 * taps(w // 2, d, w)))
    hand = (b * (h * w * 3 // 2 + 3 * d * d), b * (2 * fmas + 21 * d * d))
    assert hand == (208_699_392, 3_096_739_840)
    assert work("nv12_preprocess_roofline", "fused_nv12_b64") == hand
    assert work("yuv420_preprocess_roofline", "fused_i420_b64") == hand


def test_convert_counts():
    b, h, w = 64, 1080, 1920
    hand = (b * (h * w * 3 // 2 + 3 * h * w), b * 21 * h * w)
    assert hand == (597_196_800, 2_786_918_400)
    assert work("nv12_to_rgb_roofline", "two_stage_nv12_b64") == hand


def test_packed_resize_counts():
    b, h, w, d = 64, 1080, 1920, 224
    hand = (b * 3 * (h * w + d * d),
            2 * b * 3 * (taps(h, d) * w + d * taps(w, d)))
    assert hand == (407_764_992, 5_730_975_744)
    assert work("packed_resize_roofline", "two_stage_nv12_b64") == hand


def test_nv12_resize_counts():
    b, h, w, dh, dw = 16, 2160, 3840, 1080, 1920
    fmas = ((taps(h, dh) + taps(h // 2, dh // 2)) * w + dh * taps(w, dw)
            + dh // 2 * 2 * taps(w // 2, dw // 2))
    hand = (b * (h * 3 // 2 * w + dh * 3 // 2 * dw), 2 * b * fmas)
    assert hand == (248_832_000, 3_577_512_960)
    assert work("nv12_resize_roofline", "resize_4k_nv12_b16") == hand


@pytest.mark.parametrize("metric,cell,ms", [
    ("nv12_preprocess_roofline", "fused_nv12_b64", 0.0623),
    ("nv12_to_rgb_roofline", "two_stage_nv12_b64", 0.1783),
    ("packed_resize_roofline", "two_stage_nv12_b64", 0.1217),
    ("nv12_resize_roofline", "resize_4k_nv12_b16", 0.0743)])
def test_every_kernel_is_bound_by_its_bytes(metric, cell, ms):
    from perfbench.roofline import least_s

    least, bound = least_s(*work(metric, cell))
    assert bound == "bytes" and round(least * 1e3, 4) == ms
