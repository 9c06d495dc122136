"""vali_tpu_torch's quality metrics against vali_tpu's: the same
numpy-seeded uint8, uint16 and float batches, 3-D and 4-D, through both
packages' ``mse_batch``, ``psnr_batch`` and ``ssim_batch``.

Envelopes: MSE and PSNR rtol 1e-5, SSIM rtol 1e-5 (1e-4 on a 1080-row
pair): both compute in float32 with the same formulas; only the order of
the reductions differs. Identical frames give +inf PSNR and SSIM 1 in
both.
"""

import numpy as np
import pytest
import torch

from vali_tpu.ops import metrics as ref
from vali_tpu_torch.ops import metrics as port


def _pair(rng, shape, dtype):
    if dtype == np.float32:
        a = rng.random(shape, dtype=np.float32)
        return a, np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(
            np.float32)
    top = 255 if dtype == np.uint8 else 65535
    a = rng.integers(0, top + 1, shape).astype(dtype)
    noise = rng.integers(-top // 20, top // 20 + 1, shape)
    return a, np.clip(a + noise, 0, top).astype(dtype)


CASES = [((3, 24, 40), np.uint8, 255.0),
         ((3, 24, 40, 3), np.uint8, 255.0),
         ((2, 17, 23), np.uint16, 65535.0),
         ((2, 17, 23, 3), np.uint16, 65535.0),
         ((2, 20, 16), np.float32, 1.0),
         ((2, 20, 16, 2), np.float32, 1.0)]


@pytest.mark.parametrize("shape,dtype,peak", CASES)
def test_metrics_match_the_reference(shape, dtype, peak):
    rng = np.random.default_rng(len(shape) * 7 + shape[1])
    a, b = _pair(rng, shape, dtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name, kw in (("mse_batch", {}), ("psnr_batch", dict(peak=peak)),
                     ("ssim_batch", dict(peak=peak))):
        want = np.asarray(getattr(ref, name)(a, b, **kw))
        got = getattr(port, name)(ta, tb, **kw)
        assert got.dtype == torch.float32 and got.shape == (shape[0],)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("win", [3, 8, 11])
def test_ssim_window_sizes(win):
    rng = np.random.default_rng(win)
    a, b = _pair(rng, (2, 33, 29), np.uint8)
    want = np.asarray(ref.ssim_batch(a, b, win=win))
    got = port.ssim_batch(torch.from_numpy(a), torch.from_numpy(b), win=win)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_identical_frames():
    a = np.random.default_rng(1).integers(0, 256, (2, 16, 16), np.uint8)
    t = torch.from_numpy(a)
    assert torch.isinf(port.psnr_batch(t, t)).all()
    assert (port.mse_batch(t, t) == 0).all()
    np.testing.assert_allclose(port.ssim_batch(t, t).numpy(), 1.0,
                               rtol=1e-6)


def test_ssim_on_a_1080_row_pair():
    """Window sums over 1080 rows of squared 8-bit values: a cumulative
    sum would cancel here; the separable sums hold rtol 1e-4."""
    rng = np.random.default_rng(1080)
    a, b = _pair(rng, (1, 1080, 96), np.uint8)
    want = np.asarray(ref.ssim_batch(a, b))
    got = port.ssim_batch(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_window_larger_than_frame_raises():
    t = torch.zeros(1, 6, 20)
    with pytest.raises(ValueError, match="smaller than SSIM window"):
        port.ssim_batch(t, t)
