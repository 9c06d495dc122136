"""vali_tpu_torch's tensor-parallel FCN and multi-device dry run against
vali_tpu on the CPU: ``param_specs`` against the JAX model's, the forward
on a "model" axis of 2 against JAX ``fcn.apply``, the dry run's training
step against ``jax.value_and_grad`` of the reference's loss on the JAX
mesh (8 virtual CPU devices), and ``python -m
vali_tpu_torch.parallel.dryrun``. The JAX model's weights
(``init_params(PRNGKey(0), num_classes=16, widths=(16, 32))``, as the
reference's dry run draws them) go to the port as numpy arrays.

Envelopes: bf16 logits within max |Δ| <= 0.02 x max |logit| (the FCN's,
PERF.md §2); the training step's are stated at its test."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from vali_tpu.core.enums import ColorRange, ColorSpace, PixelFormat
from vali_tpu.models import fcn as jfcn
from vali_tpu.ops.fused import fused_preprocess as jfused
from vali_tpu_torch.models import fcn as tfcn
from vali_tpu_torch.parallel import dryrun
from vali_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: HWIO axis of each OIHW axis
OIHW_FROM_HWIO = (3, 2, 0, 1)


@pytest.fixture(scope="module")
def jparams():
    return jfcn.init_params(jax.random.PRNGKey(0), num_classes=16,
                            widths=(16, 32))


def _numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _model(jparams):
    return tfcn.params_from_numpy(_numpy(jparams), CPU)


def test_param_specs_match_the_reference_axis_for_axis(jparams):
    ref = jfcn.param_specs(jparams)
    ours = tfcn.param_specs(_model(jparams))
    assert len(ours) == 2 * len(ref) == 6
    for layer, leaves in ref.items():
        w, b = ours[f"{layer}.weight"], ours[f"{layer}.bias"]
        assert tuple(w) == tuple(leaves["w"][i] for i in OIHW_FROM_HWIO)
        assert tuple(b) == tuple(leaves["b"]) == ("model",)


def _mesh(shape, names):
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [CPU] * grid.size
    return tmesh.Mesh(grid.reshape(shape), names)


def test_shard_params_cut_output_channels(jparams):
    model = _model(jparams)
    shards = tfcn.shard_params(model, _mesh((1, 2), ("data", "model")))
    assert [s.position for s in shards] == [0, 1]
    for name, p in model.named_parameters():
        parts = [dict(s.named_parameters())[name] for s in shards]
        assert all(q.shape[0] == p.shape[0] // 2 for q in parts)
        assert torch.equal(torch.cat([q.detach() for q in parts]),
                           p.detach())
    with pytest.raises(ValueError, match="divide"):
        tfcn.shard_params(tfcn.params_from_numpy(tfcn.numpy_params(
            np.random.default_rng(0), widths=(16, 32)), CPU),
            _mesh((1, 2), ("data", "model")))  # 21 classes over 2


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_tensor_parallel_forward_matches_jax(jparams, dtype):
    rng = np.random.default_rng(6)
    x = (rng.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
         if dtype == "u8" else rng.random((2, 32, 48, 3), np.float32))
    ref = np.asarray(jfcn.apply(jparams, jnp.asarray(x)).astype(
        jnp.float32))
    model = _model(jparams)
    shards = tfcn.shard_params(model, _mesh((1, 2), ("data", "model")))
    with torch.no_grad():
        ours = tfcn.apply_sharded(shards, torch.from_numpy(x)).float()
        whole = tfcn.apply(model, torch.from_numpy(x)).float()
    assert ours.shape == whole.shape == ref.shape == (2, 16, 24, 16)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(ours.numpy() - ref).max() <= 0.02 * scale
    assert (ours - whole).abs().max().item() <= 0.02 * scale


def _jax_step(jparams, nv12, labels, B, H, W, DH, DW):
    """The reference dry run's loss and gradients (its ``loss_fn``, on its
    (data 2, spatial 2, model 2) mesh)."""
    devices = jax.devices()[:8]
    mesh = JaxMesh(np.array(devices).reshape(2, 2, 2),
                   ("data", "spatial", "model"))
    params = jax.device_put(jparams, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), jfcn.param_specs(jparams)))
    nv12 = jax.device_put(jnp.asarray(nv12),
                          NamedSharding(mesh, JP("data", "spatial", None)))
    labels = jax.device_put(jnp.asarray(labels),
                            NamedSharding(mesh, JP("data", None, None)))

    def loss_fn(params, nv12_plane, labels):
        rgb = jfused((nv12_plane,), PixelFormat.NV12, W, H, DW, DH,
                     ColorSpace.BT_709, ColorRange.MPEG,
                     out_dtype=jnp.float32)
        logits = jfcn.apply(params, rgb)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)
        return jnp.mean(nll)

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, nv12,
                                                           labels)
    return float(loss), _numpy(grads)


def _jax_bias_grads(jparams, nv12, labels, H, W, DH, DW):
    """The reference's bias gradients summed in float64: ``jax.grad`` of
    its ``loss_fn`` with a zero bf16 tap added to every layer's output
    (``fcn.apply``'s forward otherwise, so the values are the same) gives
    each layer's bf16 output cotangent, pixel by pixel; summed here over
    the pixels, where XLA's bias gradient sums it in bf16."""
    rgb = jfused((jnp.asarray(nv12),), PixelFormat.NV12, W, H, DW, DH,
                 ColorSpace.BT_709, ColorRange.MPEG, out_dtype=jnp.float32)
    names = [f"conv{i}" for i in range(len(jparams) - 1)] + ["head"]

    def loss_fn(taps):
        h = rgb.astype(jnp.bfloat16)
        for i, name in enumerate(names):
            p = jparams[name]
            stride = 2 if 0 < i < 4 and name != "head" else 1
            h = jfcn._conv(h, p["w"], stride=stride) + p["b"] + taps[i]
            if name != "head":
                h = jax.nn.relu(h)
        logp = jax.nn.log_softmax(h.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None],
                                   axis=-1)
        return jnp.mean(nll)

    shapes, h = [], rgb
    for i, name in enumerate(names):
        stride = 2 if 0 < i < 4 and name != "head" else 1
        h = jfcn._conv(h.astype(jnp.bfloat16), jparams[name]["w"],
                       stride=stride)
        shapes.append(h.shape)
    taps = [jnp.zeros(shp, jnp.bfloat16) for shp in shapes]
    cots = jax.jit(jax.grad(loss_fn))(taps)
    return {f"{name}.bias": np.asarray(c, np.float64).sum(axis=(0, 1, 2))
            for name, c in zip(names, cots)}


def _port_step(jparams, nv12, labels, dtype):
    """The port's dry-run step on a (2, 2, 2) mesh of the CPU with the
    JAX model's weights in ``dtype``: (loss, the reduced gradients in
    HWIO, the unsharded model, the replicas, the preprocess callable)."""
    mesh = dryrun.mesh3([CPU] * 8)
    model = tfcn.params_from_numpy(_numpy(jparams), CPU, dtype=dtype)
    reps = dryrun.replicas(model, mesh, tfcn.param_specs(model))
    loss, prep = dryrun.loss_and_grads(
        mesh, reps, tmesh.shard_planes((nv12,), mesh),
        torch.from_numpy(labels))
    grads = {}
    for name, g in dryrun.gathered_grads(reps[(0, 0)]).items():
        g = g.float().numpy()
        grads[name] = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
    return loss.item(), grads, model, reps, prep


def step_readings(jparams, labels_seed=7, planes_seed=0):
    """The dry run's step (B = 4) through both packages. Returns (the
    reference's loss, the port's, the port's with float32 weights, {leaf:
    (|port - port f32|, |JAX - port f32|, |port - JAX|), each the largest
    over the leaf's largest float32 magnitude}, the port's step's parts
    (model, replicas, preprocess callable) and labels)."""
    B, H, W, DH, DW = 4, dryrun.H, dryrun.W, dryrun.DH, dryrun.DW
    nv12 = dryrun.make_planes(B, H, W, seed=planes_seed)
    labels = np.random.default_rng(labels_seed).integers(
        0, 16, (B, DH // 2, DW // 2))
    ref_loss, ref_grads = _jax_step(jparams, nv12, labels.astype(np.int32),
                                    B, H, W, DH, DW)
    loss, grads, model, reps, prep = _port_step(jparams, nv12, labels,
                                                torch.bfloat16)
    loss32, exact, _, _, _ = _port_step(jparams, nv12, labels,
                                        torch.float32)
    bias64 = _jax_bias_grads(jparams, nv12, labels, H, W, DH, DW)
    readings = {}
    for layer, leaves in ref_grads.items():
        for attr, key in (("weight", "w"), ("bias", "b")):
            want = leaves[key].astype(np.float32)
            got, f32 = grads[f"{layer}.{attr}"], exact[f"{layer}.{attr}"]
            assert got.shape == want.shape == f32.shape
            scale = np.abs(f32).max()
            assert scale > 0
            pairs = [(got, f32), (want, f32), (got, want)]
            if attr == "bias":
                pairs += [(bias64[f"{layer}.bias"], f32),
                          (got, bias64[f"{layer}.bias"])]
            readings[f"{layer}.{attr}"] = tuple(
                float(np.abs(a - b).max() / scale) for a, b in pairs)
    return ref_loss, loss, loss32, readings, (model, reps, prep, nv12,
                                              labels)


def test_training_step_matches_jax_value_and_grad(jparams):
    """Loss within 1e-3 relative of the reference's. Gradients: every one
    within 0.02 x its largest magnitude of the same step with the same
    weights held in float32 (the gradient the bf16 step approximates);
    weights within 0.05 of the reference's; biases within 0.02 of the
    reference's own output cotangents summed in float64, and within 0.12
    of its bias gradients, which XLA sums over the 1024 pixels in bf16 on
    the CPU and which land 3-16 % of the largest magnitude off the float32
    gradient (the per-leaf readings over four seeds are in PERF.md §2;
    the test file run as a script prints them). The update is ``p - 1e-3
    g`` of each replica's own reduced gradient, cast to bf16, element for
    element; it moves some parameters, and its difference from the
    update of the step without a mesh stays within 0.02 x 1e-3 max|g|
    beyond one bf16 ulp; the replicas stay equal."""
    ref_loss, loss, _, readings, (model, reps, prep, nv12, labels) = \
        step_readings(jparams)
    assert abs(loss - ref_loss) <= 1e-3 * abs(ref_loss)
    for leaf, (own, _, vs_jax, *f64) in readings.items():
        assert own <= 0.02, leaf
        assert vs_jax <= (0.05 if leaf.endswith("weight") else 0.12), leaf
        assert leaf.endswith("weight") or f64[1] <= 0.02, leaf
    model.zero_grad()
    dryrun.unsharded_loss_and_grads(model, nv12, torch.from_numpy(labels))
    wrong, moved, off = dryrun.update_differences(reps, model)
    assert wrong == 0 and moved > 0 and off <= dryrun.GRAD_TOL
    assert dryrun.LR == 1e-3  # the reference's step
    first = dict(reps[(0, 0)][0].named_parameters())
    for rep in reps.values():
        for n, p in rep[0].named_parameters():
            assert p.dtype == torch.bfloat16 and p.grad is None
            assert torch.equal(p, first[n])
    assert max(prep.received.values()) > 0


@pytest.mark.parametrize("data,spatial", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_replicas_sit_on_their_places_model_devices(jparams, data, spatial):
    """Each (data, spatial) replica's shards lie on that place's "model"
    positions: a (2, 2, 2) mesh with the CPU at those two positions and
    the meta device everywhere else."""
    grid = np.empty((2, 2, 2), dtype=object)
    grid[...] = torch.device("meta")
    grid[data, spatial, :] = CPU
    mesh = tmesh.Mesh(grid, ("data", "spatial", "model"))
    shards = tfcn.shard_params(_model(jparams), mesh, data=data,
                               spatial=spatial)
    assert [s.position for s in shards] == [0, 1]
    assert {p.device for s in shards for p in s.parameters()} == {CPU}
    reps = dryrun.replicas(_model(jparams), mesh)
    assert sorted(reps) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {s.device for s in reps[(data, spatial)]} == {CPU}


def test_dryrun_module_prints_the_shard_evidence():
    proc = subprocess.run(
        [sys.executable, "-m", "vali_tpu_torch.parallel.dryrun", "8",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for leg in ("serve", "resize", "pipeline"):
        assert f"SHARD_EVIDENCE {leg}" in proc.stdout, proc.stdout[-2000:]
    assert "OK" in proc.stdout.splitlines()[-1]


def test_dryrun_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["2"])


@pytest.mark.parametrize("n,want", [(8, (2, 2, 2)), (4, (1, 2, 2)),
                                    (2, (1, 2, 1)), (3, (3, 1, 1))])
def test_factor_follows_the_reference(n, want):
    assert dryrun.factor(n) == want


if __name__ == "__main__":
    # the per-leaf readings behind the training-step bounds, over a few
    # label and input seeds (run from the repository root):
    #   PYTHONPATH=. JAX_PLATFORMS=cpu \
    #   XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    #   python tests/test_torch_port_dryrun.py
    params = jfcn.init_params(jax.random.PRNGKey(0), num_classes=16,
                              widths=(16, 32))
    for labels_seed, planes_seed in ((7, 0), (8, 1), (9, 2), (10, 3)):
        ref_loss, loss, loss32, readings, _ = step_readings(
            params, labels_seed, planes_seed)
        print(f"seeds labels={labels_seed} planes={planes_seed}: loss jax "
              f"{ref_loss} port {loss} port-f32 {loss32}")
        for leaf, r in readings.items():
            print(f"  {leaf}: |port-port_f32|={r[0]:.4f} "
                  f"|jax-port_f32|={r[1]:.4f} |port-jax|={r[2]:.4f}"
                  + (f" |jax_f64sum-port_f32|={r[3]:.4f} "
                     f"|port-jax_f64sum|={r[4]:.4f}" if len(r) > 3 else "")
                  + " (x max|g f32|)")
