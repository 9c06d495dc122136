"""vali_tpu_torch's FCN against vali_tpu's: the JAX model's
``init_params(PRNGKey(0))`` weights carried over with
``params_from_numpy``, the same numpy-seeded batches through both
``apply``s, and the golden synth oracle driven end to end through the
port (its decoder, its dense fused preprocess, its FCN).

Envelopes:
- bfloat16 weights (the model's own): the golden oracle's
  (tests/test_e2e_segmentation.py): max |logit difference| <= 0.02 x
  max |logit|, and per-frame class histograms agreeing > 0.98. Both
  frameworks round the activations to bfloat16 after every layer, but
  accumulate the convolutions in other orders.
- float32 weights: rtol 1e-4, atol 1e-5 (float32 sums of up to 2,304
  products in another order). The JAX model's ``apply`` refuses float32
  weights (its first convolution would mix its bfloat16 input with them),
  so the JAX side there is the JAX model's own ``_conv`` at the weights'
  dtype, with ``apply``'s cast points: what the port does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vali_tpu.models import fcn as ref_fcn
from vali_tpu_torch.models import fcn

CPU = torch.device("cpu")
NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def bf16():
    """(JAX params, the port's model) with the JAX model's bfloat16
    PRNGKey(0) weights."""
    p = ref_fcn.init_params(jax.random.PRNGKey(0))
    return p, fcn.params_from_numpy(_numpy(p), device=CPU)


def _ref_apply_at_weight_dtype(params, x):
    """The JAX model's apply with each convolution at the weights'
    dtype (its ``apply`` with bfloat16 weights)."""
    h = jnp.asarray(x).astype(jnp.bfloat16)
    if x.dtype == np.uint8:
        h = h / 255.0
    for i in range(4):
        p = params[f"conv{i}"]
        h = jax.nn.relu(ref_fcn._conv(h.astype(p["w"].dtype), p["w"],
                                      stride=2 if i else 1) + p["b"])
    p = params["head"]
    return ref_fcn._conv(h, p["w"]) + p["b"]


def _golden_envelope(got, want):
    """The e2e oracle's envelope on [N, h, w, 21] logits."""
    scale = max(float(np.abs(want).max()), 1.0)
    assert np.abs(got - want).max() / scale <= 0.02
    for g, w in zip(got, want):
        hg = np.bincount(g.argmax(-1).reshape(-1), minlength=21)
        hw = np.bincount(w.argmax(-1).reshape(-1), minlength=21)
        assert np.minimum(hg, hw).sum() / hw.sum() > 0.98, (hg, hw)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 64, 64, 3), np.float32),
    ((2, 65, 47, 3), np.float32),   # odd: SAME pads (1, 1) and (0, 1)
    ((2, 64, 64, 3), np.uint8),
])
def test_bf16_logits_match_the_reference(bf16, shape, dtype):
    params, model = bf16
    rng = np.random.default_rng(sum(shape))
    x = (rng.integers(0, 256, shape).astype(np.uint8) if dtype == np.uint8
         else rng.standard_normal(shape).astype(np.float32))
    want = np.asarray(ref_fcn.apply(params, jnp.asarray(x)), np.float32)
    got = fcn.apply(model, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _golden_envelope(got.float().detach().numpy(), want)
    classes = fcn.predict_classes(model, torch.from_numpy(x))
    assert classes.shape == want.shape[:3]


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (2, 65, 47, 3)])
def test_f32_logits_match_the_reference(shape):
    params = ref_fcn.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = fcn.params_from_numpy(_numpy(params), device=CPU)
    assert model.conv0.weight.dtype == torch.float32
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = np.asarray(_ref_apply_at_weight_dtype(params, x))
    got = fcn.apply(model, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,stride,pads", [
    (224, 2, (0, 1)), (65, 2, (1, 1)), (47, 2, (1, 1)), (64, 1, (1, 1)),
    (33, 2, (1, 1)), (8, 2, (0, 1))])
def test_same_padding_is_xlas(n, stride, pads):
    """(before, after) as XLA pads a 3-tap window: the odd pixel at the
    end, so a stride-2 layer on an even size pads (0, 1)."""
    assert fcn._same_pads(n, 3, stride) == pads
    assert -(-n // stride) == (n + sum(pads) - 3) // stride + 1


def test_init_params_is_seeded_he_normal():
    a = fcn.init_params(torch.Generator().manual_seed(3), device=CPU)
    b = fcn.init_params(torch.Generator().manual_seed(3), device=CPU)
    assert [n for n, _ in a.named_children()] == [
        "conv0", "conv1", "conv2", "conv3", "head"]
    for ca, cb, (cout, cin, k, s) in zip(a.layers(), b.layers(), [
            (32, 3, 3, 1), (64, 32, 3, 2), (128, 64, 3, 2),
            (256, 128, 3, 2), (21, 256, 1, 1)]):
        assert torch.equal(ca.weight, cb.weight)
        assert ca.weight.shape == (cout, cin, k, k) and ca.stride == (s, s)
        assert ca.weight.dtype == torch.bfloat16 and not ca.bias.any()
        std = ca.weight.float().std().item()
        assert abs(std / np.sqrt(2.0 / (k * k * cin)) - 1) < 0.2
    out = fcn.apply(a, torch.zeros(1, 32, 32, 3, dtype=torch.uint8))
    assert out.shape == (1, 4, 4, 21)


def test_default_device_is_the_card():
    """No fallback: with no card the default device raises, and the CPU
    is taken only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fcn.init_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        fcn.FCN()


def test_golden_oracle_through_the_port(tmp_path):
    """decode -> dense fused preprocess -> FCN with the JAX model's
    PRNGKey(0) weights, all in the port, held to the committed oracle
    tests/data/e2e_golden_synth.npz at test_e2e_segmentation's envelope
    (5 frames of the synthesised sweep clip)."""
    from make_e2e_golden import DATA, SYNTH_KW

    from vali_tpu_torch.core.enums import ColorRange, ColorSpace
    from vali_tpu_torch.engine.decoder import PyDecoder
    from vali_tpu_torch.memory.host import host_frame_to_planes
    from vali_tpu_torch.ops.fused import fused_preprocess
    from vali_tpu_torch.utils.synth import synthesize_clip

    golden = np.load(os.path.join(DATA, "e2e_golden_synth.npz"))
    clip = synthesize_clip(str(tmp_path / "synth.mp4"), **SYNTH_KW)
    model = fcn.params_from_numpy(
        _numpy(ref_fcn.init_params(jax.random.PRNGKey(0))), device=CPU)
    dec = PyDecoder(clip, {}, gpu_id=-1)
    frame = np.zeros(dec.HostFrameSize, dtype=np.uint8)
    batch = []
    for _ in range(5):
        ok, _ = dec.DecodeSingleFrame(frame)
        assert ok
        planes = host_frame_to_planes(frame, dec.Format, dec.Width,
                                      dec.Height)
        batch.append(tuple(torch.from_numpy(p.copy()) for p in planes))
    planes = tuple(torch.stack(p) for p in zip(*batch))
    rgb = fused_preprocess(planes, dec.Format, dec.Width, dec.Height, 224,
                           224, ColorSpace.BT_709, ColorRange.MPEG,
                           out_dtype=torch.float32, normalize=NORM)
    r, b = rgb[0, ..., 0], rgb[0, ..., 2]
    assert (r - b).abs().mean().item() > 0.2, "the clip lost its chroma"
    logits = fcn.apply(model, rgb).float().detach().numpy()
    want = golden["logits_frame0"].astype(np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    assert np.abs(logits[0] - want).max() / scale < 0.02
    for i, lg in enumerate(logits):
        hist = np.bincount(lg.argmax(-1).reshape(-1), minlength=21)
        want_hist = golden["class_hists"][i]
        agree = np.minimum(hist, want_hist).sum() / want_hist.sum()
        assert agree > 0.98, (i, hist, want_hist)
