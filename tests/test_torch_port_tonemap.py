"""vali_tpu_torch's tone mapping against vali_tpu's: the same numpy-seeded
HDR batches (uint16 MSB codes, uint8 and float code values) through both
packages' transfer functions, BT.2020 YCbCr -> RGB and ``tonemap_batch``
with both transfers and all three methods, into uint8, uint16, int32 and
float outputs.

Envelopes: transfer functions and the YCbCr conversion rtol 1e-5 (the
same float32 formulas; transcendental functions of two libraries);
``tonemap_batch`` within 1 LSB of uint8 and uint16 outputs, and float
and int32 outputs within a 16-bit LSB (1/65535 of full scale: float32
computes them, and the HLG power chain differs by ~1e-5 between the two
libraries; an int32 code is far below a float32 step). The reference's
``tonemap_batch`` runs op by op (``jax.disable_jit``) here: compiled as
one XLA computation on the CPU, its fused power chain moves the tone
gain by up to 5e-5 relative against its own op-by-op result, which the
1/2.4 gamma amplifies to ~1e-4 of full scale near the gamut-clip
boundary; the port's op-by-op float32 matches the op-by-op reference.
"""

import jax
import numpy as np
import pytest
import torch

from vali_tpu.ops import tonemap as ref
from vali_tpu_torch.ops import tonemap as port


def _hdr(rng, dtype, shape=(2, 12, 16, 3)):
    """Code values over the whole range, a block of near-white and one
    of saturated BT.2020 primaries (the gamut-clip boundary)."""
    x = rng.random(shape)
    x[:, :2] = rng.uniform(0.7, 0.76, (shape[0], 2) + shape[2:])
    x[:, 2:4, :, 1:] *= 0.1
    if dtype == np.uint16:
        return (np.round(x * 1023).astype(np.uint16) << 6)
    if dtype == np.uint8:
        return np.round(x * 255).astype(np.uint8)
    return x.astype(np.float32)


def test_transfer_functions_match():
    e = np.linspace(-0.1, 1.0, 4001, dtype=np.float32)
    nits = np.linspace(0, 10000, 4001, dtype=np.float32)
    luma = np.linspace(0, 1, 4001, dtype=np.float32)
    for name, args in (("pq_eotf", (e,)), ("pq_inv_eotf", (nits,)),
                       ("hlg_inv_oetf", (e,)), ("hlg_eotf", (e, luma))):
        want = np.asarray(getattr(ref, name)(*args))
        got = getattr(port, name)(*(torch.from_numpy(a) for a in args))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(port.BT2020_TO_BT709, ref.BT2020_TO_BT709)
    np.testing.assert_array_equal(port.BT709_TO_BT2020, ref.BT709_TO_BT2020)


@pytest.mark.parametrize("bit_depth,full_range,msb", [
    (10, False, False), (12, False, False), (10, True, False),
    (12, True, False), (10, False, True), (12, True, True)])
def test_bt2020_yuv_to_rgb_matches(bit_depth, full_range, msb):
    rng = np.random.default_rng(bit_depth + 2 * full_range + 4 * msb)
    y, u, v = (rng.integers(0, 1 << bit_depth, (2, 8, 10)).astype(np.uint16)
               for _ in range(3))
    if msb:
        y, u, v = (p << (16 - bit_depth) for p in (y, u, v))
    kw = dict(bit_depth=bit_depth, full_range=full_range, msb_aligned=msb)
    want = np.asarray(ref.bt2020_yuv_to_rgb(y, u, v, **kw))
    got = port.bt2020_yuv_to_rgb(*(torch.from_numpy(p) for p in (y, u, v)),
                                 **kw)
    assert got.shape == (2, 8, 10, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


OUT = [(np.uint8, torch.uint8), (np.uint16, torch.uint16),
       (np.int32, torch.int32), (np.float32, torch.float32)]


@pytest.mark.parametrize("out", OUT, ids=lambda o: str(o[1]))
@pytest.mark.parametrize("transfer,method,in_dtype", [
    ("pq", "bt2390", np.uint16), ("pq", "reinhard", np.float32),
    ("pq", "hable", np.uint8), ("hlg", "bt2390", np.float32),
    ("hlg", "reinhard", np.uint16), ("hlg", "hable", np.uint16)])
def test_tonemap_batch_matches(transfer, method, in_dtype, out):
    np_out, torch_out = out
    rng = np.random.default_rng(len(transfer + method) + in_dtype().itemsize)
    x = _hdr(rng, in_dtype)
    kw = dict(transfer=transfer, peak_nits=1000.0, target_nits=100.0,
              method=method)
    with jax.disable_jit():
        want = np.asarray(ref.tonemap_batch(x, out_dtype=np_out, **kw))
    got = port.tonemap_batch(torch.from_numpy(x), out_dtype=torch_out, **kw)
    assert got.dtype == torch_out and got.shape == x.shape
    got = got.to(torch.int64 if torch_out == torch.uint16 else got.dtype)
    d = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    if np_out in (np.uint8, np.uint16):
        assert d.max() <= 1, d.max()
    else:
        scale = 1.0 if np_out == np.float32 else np.iinfo(np_out).max
        assert d.max() <= scale / 65535, d.max() / scale
    # what the test is for: the SDR image is not flat
    assert np.ptp(want) > 0.3 * (np.iinfo(np_out).max
                                 if np_out != np.float32 else 1.0)


def test_no_gamut_conversion_and_target_above_peak():
    x = _hdr(np.random.default_rng(7), np.float32)
    for kw in (dict(convert_gamut=False), dict(target_nits=2000.0),
               dict(out_gamma=2.2, peak_nits=4000.0)):
        with jax.disable_jit():
            want = np.asarray(ref.tonemap_batch(x, **kw))
        got = port.tonemap_batch(torch.from_numpy(x), **kw).numpy()
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_unknown_names_raise():
    x = torch.zeros(1, 2, 2, 3)
    with pytest.raises(ValueError, match="tone-map method"):
        port.tonemap_batch(x, method="aces")
    with pytest.raises(ValueError, match="transfer"):
        port.tonemap_batch(x, transfer="slog3")


def test_wide_integer_peak_white_stays_in_range():
    """Peak white scales by the largest float32 below the max of uint32
    and int32 (float32(2^31 - 1) rounds up to 2^31)."""
    e = float(port.pq_inv_eotf(torch.tensor(1000.0)))
    white = torch.full((1, 4, 4, 3), e)
    for odt in (torch.uint32, torch.int32):
        w = port.tonemap_batch(white, out_dtype=odt).to(torch.int64)
        top = torch.iinfo(odt).max
        assert 0 <= w.min().item() and w.max().item() <= top
        assert w.min().item() >= int(top * 0.999)
