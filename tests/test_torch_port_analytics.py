"""vali_tpu_torch's analytics against vali_tpu's: the same numpy-seeded
uint8, uint16 and float batches, 3-D and 4-D, through both packages'
histograms, luma statistics and scene-change scores.

Envelopes: histograms and scene-cut indices equal; luma statistics and
scores rtol 1e-5 (float32 reductions in another order; scores also atol
1e-7, for the transitions inside a scene that score near 0); min / max
equal.
"""

import numpy as np
import pytest
import torch

from vali_tpu.ops import analytics as ref
from vali_tpu_torch.ops import analytics as port

CPU = torch.device("cpu")


def _frames(rng, shape, dtype):
    if dtype == np.float32:
        return rng.normal(0.5, 0.4, shape).astype(np.float32)
    top = 255 if dtype == np.uint8 else 65535
    return rng.integers(0, top + 1, shape).astype(dtype)


FRAMES = [((4, 24, 40), np.uint8), ((3, 24, 40, 3), np.uint8),
          ((4, 17, 23), np.uint16), ((3, 9, 11, 3), np.uint16),
          ((4, 20, 16), np.float32), ((3, 8, 10, 3), np.float32)]


@pytest.mark.parametrize("bins,value_range", [
    (256, None), (64, None), (37, None), (16, (-0.25, 1.25)),
    (10, (40.0, 200.0)), (7, (1000.0, 50000.0))])
@pytest.mark.parametrize("shape,dtype", FRAMES)
def test_histograms_are_bit_equal(shape, dtype, bins, value_range):
    """Including samples outside the range, clamped into the edge
    bins."""
    if value_range is None and dtype == np.float32:
        value_range = (0.0, 1.0)
    rng = np.random.default_rng(bins + shape[1])
    x = _frames(rng, shape, dtype)
    want = np.asarray(ref.histogram_batch(x, bins=bins,
                                          value_range=value_range))
    got = port.histogram_batch(torch.from_numpy(x), bins=bins,
                               value_range=value_range)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(1) == x[0].size).all()


@pytest.mark.parametrize("shape,dtype", FRAMES)
def test_luma_stats_match(shape, dtype):
    x = _frames(np.random.default_rng(shape[2]), shape, dtype)
    want = ref.luma_stats_batch(x)
    got = port.luma_stats_batch(torch.from_numpy(x))
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("min", "max"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_flat_uint16_frame_has_zero_std():
    """Two-pass moments: a flat 60000 frame has std 0 (one pass gave
    ~139), and a near-flat one its true std."""
    flat = np.full((2, 64, 64), 60000, dtype=np.uint16)
    flat[1, 0, 0] = 60004
    st = port.luma_stats_batch(torch.from_numpy(flat))
    assert st["std"][0].item() == 0.0 and st["mean"][0].item() == 60000.0
    want = flat[1].astype(np.float64).std()
    assert abs(st["std"][1].item() - want) < 1e-2 * want + 1e-3
    np.testing.assert_allclose(
        st["std"].numpy(), np.asarray(ref.luma_stats_batch(flat)["std"]),
        rtol=1e-5)


def _clip_with_cuts(rng, dtype, top, n=12, cuts=(4, 9), h=24, w=32):
    """Noise scenes changing at ``cuts`` between the lower and the upper
    half of the code range, small jitter inside each."""
    frames, base, lo = [], None, top // 2
    for i in range(n):
        if i == 0 or i in cuts:
            lo = top // 2 - lo
            base = rng.integers(lo, lo + top // 2, (h, w))
        jitter = rng.integers(-top // 80, top // 80 + 1, (h, w))
        frames.append(np.clip(base + jitter, 0, top))
    x = np.stack(frames)
    return x.astype(dtype) if dtype != np.float32 else (
        x / top).astype(np.float32)


@pytest.mark.parametrize("dtype,top,peak", [
    (np.uint8, 255, None), (np.uint16, 65535, None),
    (np.uint16, 1023, 1023.0), (np.float32, 1000, None)])
def test_scene_change_scores_and_cuts_match(dtype, top, peak):
    x = _clip_with_cuts(np.random.default_rng(top), dtype, top)
    t = torch.from_numpy(x)
    for name, kw in (("frame_diff_scores", dict(peak=peak)),
                     ("hist_delta_scores", dict(bins=32)),
                     ("scene_change_scores", dict(peak=peak,
                                                  hist_weight=0.7))):
        if name == "hist_delta_scores" and dtype == np.float32:
            kw["value_range"] = (0.0, 1.0)
        want = np.asarray(getattr(ref, name)(x, **kw))
        got = getattr(port, name)(t, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    for threshold, min_gap in ((0.3, 1), (0.05, 3), (0.01, 1)):
        want = ref.detect_scene_changes(x, threshold, min_gap, peak=peak)
        for frames in (t, x):
            got = port.detect_scene_changes(frames, threshold, min_gap,
                                            peak=peak, device=CPU)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
    assert list(port.detect_scene_changes(t, peak=peak)) == [4, 9]


def test_numpy_frames_go_to_the_card_by_default():
    """No fallback: numpy frames need a card unless a device is named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.zeros((3, 8, 8), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.detect_scene_changes(x)
    assert len(port.detect_scene_changes(x, device=CPU)) == 0


def test_float_frames_need_a_range():
    with pytest.raises(ValueError, match="value_range is required"):
        port.histogram_batch(torch.zeros(2, 4, 4))
    with pytest.raises(ValueError, match="empty value_range"):
        port.histogram_batch(torch.zeros(2, 4, 4), value_range=(1.0, 1.0))
