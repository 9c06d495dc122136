"""The multi-device dry run: counterpart of ``__graft_entry__.entry`` and
``_dryrun_impl``.

Builds a (data, spatial, model) mesh over N positions and drives the
parallel paths on tiny shapes, each leg checked by its shards' shapes:

  - serve:    ``sharded_kernel_preprocess`` over "data" (the NV12
    preprocess kernel on every position's block);
  - resize:   the NV12 resize kernel on every data block;
  - pipeline: ``MultiStreamPipeline(mesh=)`` over in-memory
    ``HostFrameSource`` streams;
  - then ONE training step: NV12 split over data x spatial through
    ``sharded_preprocess`` into float32, the tensor-parallel FCN
    (channels over "model") once per (data, spatial) place, each
    replica on its share of the frames, a log-softmax NLL, autograd, the
    gradients summed over the replicas, and ``p - 1e-3 * g`` in float32
    cast back to each parameter's dtype.

The step needs no backward kernel: the gradient reaches only the
convolutions (cuDNN's here, XLA's in the reference); the uint8 input
carries none. Run it as

    python -m vali_tpu_torch.parallel.dryrun N [--device cpu]

The N positions take the machine's cards in turn (a card repeats where
there are fewer than N), or the CPU with ``--device cpu``; with no card
and no ``--device`` it fails.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..models import fcn
from ..ops.fused import fused_preprocess
from ..utils.device import get_device, num_devices
from .mesh import (Mesh, P, ShardedTensor, distribute, map_over_data,
                   shard_planes, sharded_kernel_preprocess,
                   sharded_preprocess)

#: the training step's geometry: NV12 H x W -> DH x DW, and the FCN
H, W, DH, DW = 64, 128, 32, 32
NUM_CLASSES, WIDTHS = 16, (16, 32)
#: the serving legs' geometry
PH, PW, PDH, PDW = 96, 256, 32, 64
LR = 1e-3
#: the split step against the step without a mesh: the loss within 1e-3
#: relative, every gradient within 0.02 x its largest magnitude (bf16
#: activations and cotangents summed in another order; the CPU test holds
#: the port's gradients within 0.02 of float32 weights' too)
LOSS_RTOL, GRAD_TOL = 1e-3, 0.02


def make_planes(batch: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """[batch, h*3/2, w] uint8 NV12 planes drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, h * 3 // 2, w), dtype=np.uint8)


def factor(n: int) -> Tuple[int, int, int]:
    """(data, spatial, model) of ``n`` positions, as the reference
    factors them."""
    spatial = 2 if n % 2 == 0 else 1
    model = 2 if n % 4 == 0 else 1
    return n // (spatial * model), spatial, model


def mesh3(devices: List[torch.device]) -> Mesh:
    """The (data, spatial, model) mesh over ``devices``."""
    data, spatial, model = factor(len(devices))
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(data, spatial, model),
                ("data", "spatial", "model"))


def device_grid(n: int, device: Optional[str] = None) -> List[torch.device]:
    """``n`` mesh positions' devices: the cards in turn (a card repeats
    where there are fewer than ``n``), or ``device`` ``n`` times. With no
    card and no ``device`` it raises."""
    if device is not None:
        return [torch.device(device)] * n
    get_device(0)  # raises where there is no card
    return [torch.device("cuda", i % num_devices()) for i in range(n)]


def replicas(model: fcn.FCN, mesh: Mesh, specs=None
             ) -> Dict[Tuple[int, int], List[fcn.FCNShard]]:
    """The tensor-parallel model once per (data, spatial) place, as the
    reference replicates its parameters over "data" and "spatial": each
    replica's shards on its place's "model" positions."""
    return {(d, s): fcn.shard_params(model, mesh, specs, data=d, spatial=s)
            for d in range(mesh.axis_size("data"))
            for s in range(mesh.axis_size("spatial"))}


def reduce_grads(reps) -> None:
    """Sum every parameter's gradient over the replicas ``reps`` in
    float32 and give each replica the sum, in its parameter's dtype on its
    device: the all-reduce of a data-parallel step."""
    groups = list(reps.values())
    for k in range(len(groups[0])):
        for ps in zip(*(list(g[k].parameters()) for g in groups)):
            total = sum(p.grad.float().to(ps[0].device) for p in ps)
            for p in ps:
                p.grad = total.to(p.device, p.dtype)


def loss_and_grads(mesh: Mesh, reps, nv12, labels: torch.Tensor,
                   src_w: int = W, src_h: int = H, dst_w: int = DW,
                   dst_h: int = DH):
    """The step's forward and backward: ``nv12`` split over data x
    spatial through ``sharded_preprocess`` into float32; each data
    block's frames split over its spatial places, every part through the
    replica of its (data, spatial) place (``reps``, from
    :func:`replicas`); the mean log-softmax NLL against ``labels`` [B,
    dst_h/2, dst_w/2]; autograd; then the gradients summed over the
    replicas (:func:`reduce_grads`). Returns (loss, the preprocess
    callable)."""
    prep = sharded_preprocess(mesh, PixelFormat.NV12, src_w, src_h, dst_w,
                              dst_h, ColorSpace.BT_709, ColorRange.MPEG,
                              out_dtype=torch.float32)
    rgb = prep(nv12 if isinstance(nv12, tuple) else (nv12,))
    n_spatial = mesh.axis_size("spatial")
    home = reps[(0, 0)][0].device
    total, count = None, 0
    for s in rgb.shards:
        if mesh.coord(s.position, "model"):
            continue  # the block again, on the replica's other shards
        d = mesh.coord(s.position, "data")
        sp = mesh.coord(s.position, "spatial")
        n = s.data.shape[0]
        lo, hi = sp * n // n_spatial, (sp + 1) * n // n_spatial
        if lo == hi:
            continue
        rep = reps[(d, sp)]
        out = fcn.apply_sharded(rep, s.data[lo:hi])
        logp = F.log_softmax(out.float(), dim=-1)
        b0 = s.index[0].start
        lab = labels[b0 + lo:b0 + hi].to(rep[0].device)
        nll = -torch.gather(logp, -1, lab[..., None]).sum().to(home)
        total = nll if total is None else total + nll
        count += lab.numel()
    loss = total / count
    loss.backward()
    reduce_grads(reps)
    return loss, prep


def unsharded_loss_and_grads(model: fcn.FCN, nv12, labels: torch.Tensor,
                             src_w: int = W, src_h: int = H,
                             dst_w: int = DW, dst_h: int = DH
                             ) -> torch.Tensor:
    """The same step without a mesh, on the model's device: the dense
    preprocess of the whole batch, the whole FCN, the mean NLL. Fills the
    model's ``grad``s; returns the loss."""
    dev = model.conv0.weight.device
    rgb = fused_preprocess((torch.as_tensor(nv12).to(dev),),
                           PixelFormat.NV12, src_w, src_h, dst_w, dst_h,
                           ColorSpace.BT_709, ColorRange.MPEG,
                           out_dtype=torch.float32)
    logp = F.log_softmax(fcn.apply(model, rgb).float(), dim=-1)
    loss = -torch.gather(logp, -1, labels.to(dev)[..., None]).mean()
    loss.backward()
    return loss


def step_differences(reps, loss: torch.Tensor, model: fcn.FCN,
                     loss_w: torch.Tensor) -> Tuple[float, float]:
    """(|loss - loss_w| / |loss_w|, the largest gradient difference over
    the gradient's largest magnitude): the split step (``reps``, its
    gradients reduced) against the step without a mesh (``model``)."""
    grads = gathered_grads(reps[(0, 0)])
    worst = 0.0
    for name, p in model.named_parameters():
        g = p.grad.float().cpu()
        worst = max(worst, (grads[name].float() - g).abs().max().item()
                    / max(g.abs().max().item(), 1e-12))
    return abs(loss.item() - loss_w.item()) / abs(loss_w.item()), worst


def sgd_update(shards) -> None:
    """``p - 1e-3 * g`` in float32, cast back to the parameter's dtype, in
    place."""
    with torch.no_grad():
        for s in shards:
            for p in s.parameters():
                p.copy_((p.float() - LR * p.grad.float()).to(p.dtype))
                p.grad = None


def _ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` at each value of the
    float32 tensor ``x`` (0 at 0)."""
    e = torch.frexp(x).exponent.float() - 1
    return torch.where(x != 0, torch.finfo(dtype).eps * torch.exp2(e),
                       torch.zeros_like(x))


def update_differences(reps, model: fcn.FCN) -> Tuple[int, int, float]:
    """Apply :func:`sgd_update` to every replica of the split step and
    hold the update to ``p - LR * g``. ``model`` is the step without a
    mesh, its gradients filled and its parameters not yet updated.

    Returns (the elements, over every replica, that differ from ``p - LR
    * g`` of their own gradient in float32 cast to the parameter's dtype;
    the elements of the first replica that moved; the largest difference
    between the first replica's update and ``model``'s, ``p - LR * g``
    cast so, beyond one unit in the last place of the parameter's dtype
    (the two float32 updates may round to neighbours), over ``LR *
    max|g|`` of ``model``)."""
    shards = [s for r in reps.values() for s in r]
    saved = [[(p.detach().clone(), p.grad.detach().clone())
              for p in s.parameters()] for s in shards]
    sgd_update(shards)
    wrong = 0
    for s, pairs in zip(shards, saved):
        for p, (p0, g) in zip(s.parameters(), pairs):
            want = (p0.float() - LR * g.float()).to(p.dtype)
            wrong += (p.detach() != want).sum().item()
    first = reps[(0, 0)]
    moved, worst = 0, 0.0
    for name, p in model.named_parameters():
        after = torch.cat([dict(s.named_parameters())[name].detach().cpu()
                           for s in first]).float()
        p0, g = p.detach().float().cpu(), p.grad.float().cpu()
        want = (p0 - LR * g).to(p.dtype).float()
        moved += (after != p0).sum().item()
        room = _ulp(torch.maximum(after.abs(), want.abs()), p.dtype)
        excess = ((after - p0) - (want - p0)).abs() - room
        worst = max(worst, excess.clamp(min=0).max().item()
                    / max(LR * g.abs().max().item(), 1e-30))
    return wrong, moved, worst


def gathered_grads(shards) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient assembled along its output channels, in
    position order, on the CPU (``conv0.weight`` OIHW, ... )."""
    names = [n for n, _ in shards[0].named_parameters()]
    return {n: torch.cat([dict(s.named_parameters())[n].grad.cpu()
                          for s in shards], dim=0) for n in names}


def _evidence(out: ShardedTensor) -> List:
    """(position, device, block shape) of every shard, sorted."""
    return sorted((tuple(int(c) for c in s.position), str(s.device),
                   tuple(s.data.shape)) for s in out.shards)


def serving_legs(devices: List[torch.device]) -> None:
    """serve, resize and pipeline over a "data" mesh of ``devices``, each
    leg's shards checked against the shapes the reference asserts."""
    from ..ops.nv12_preprocess import nv12_preprocess
    from ..ops.nv12_resize import nv12_resize
    from ..pipeline.multistream import MultiStreamPipeline
    from ..utils.synth import HostFrameSource

    n = len(devices)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    data_mesh = Mesh(grid, ("data",))
    PB = n

    # --- serve: the NV12 preprocess kernel on every data block ----------
    serve = sharded_kernel_preprocess(data_mesh, PW, PH, PDW, PDH,
                                      ColorSpace.BT_709, ColorRange.MPEG)
    pnv12 = distribute(make_planes(PB, PH, PW, seed=1), data_mesh,
                       P("data"))
    for s in pnv12.shards:
        if tuple(s.data.shape) != (PB // n, PH * 3 // 2, PW):
            raise AssertionError(f"per-position shard {s.data.shape}, "
                                 f"expected {(PB // n, PH * 3 // 2, PW)}")
    rgb = serve(pnv12)
    if rgb.shape != (PB, 3, PDH, PDW):
        raise AssertionError(f"serve output {rgb.shape}")
    ev = _evidence(rgb)
    if (any(shp != (PB // n, 3, PDH, PDW) for _, _, shp in ev)
            or len({p for p, _, _ in ev}) != n):
        raise AssertionError(f"serve shards {ev}")
    home = devices[0]
    whole = nv12_preprocess(torch.from_numpy(make_planes(
        PB, PH, PW, seed=1)).to(home), src_w=PW, src_h=PH, dst_w=PDW,
        dst_h=PDH)
    if not torch.equal(rgb.gather(home), whole):
        raise AssertionError("serve differs from one unsharded launch")
    print(f"SHARD_EVIDENCE serve: per-position output shards {ev}",
          flush=True)

    # --- resize: the NV12 resize kernel on every data block -------------
    resize = map_over_data(lambda x: nv12_resize(
        x, src_w=PW, src_h=PH, dst_w=PW // 2, dst_h=PH // 2), data_mesh)
    rnv12 = make_planes(PB, PH, PW, seed=2)
    small = resize(rnv12)
    if small.shape != (PB, (PH // 2) * 3 // 2, PW // 2):
        raise AssertionError(f"resize output {small.shape}")
    ev = _evidence(small)
    if any(shp != (PB // n, (PH // 2) * 3 // 2, PW // 2)
           for _, _, shp in ev) or len(ev) != n:
        raise AssertionError(f"resize shards {ev}")
    whole = nv12_resize(torch.from_numpy(rnv12).to(home), src_w=PW,
                        src_h=PH, dst_w=PW // 2, dst_h=PH // 2)
    if not torch.equal(small.gather(home), whole):
        raise AssertionError("resize differs from one unsharded launch")
    print(f"SHARD_EVIDENCE resize: per-position output shards {ev}",
          flush=True)

    # --- pipeline: in-memory streams -> data-split batches --------------
    frames = make_planes(4, 48, 64, seed=3).reshape(4, -1)

    def pipeline(mesh):
        return MultiStreamPipeline(
            [HostFrameSource(list(frames), PixelFormat.NV12, 64, 48)
             for _ in range(n)], dst_w=32, dst_h=32,
            gpu_id=home.index if home.type == "cuda" else -1,
            batch_size=n, sync_streams=True, mesh=mesh)

    whole, _ = next(iter(pipeline(None)))
    pipe = pipeline(data_mesh)
    for batch, ids in pipe:
        if batch.shape[1:] != (32, 32, 3) or len(batch.shards) != n \
                or batch.device_set != set(devices):
            raise AssertionError(f"pipeline batch {batch}")
        if not torch.equal(batch.gather(home), whole):
            raise AssertionError("the pipeline's split batch differs from "
                                 "its batch without a mesh")
        ev = _evidence(batch)
        if any(shp[0] != batch.shape[0] // n for _, _, shp in ev):
            raise AssertionError(f"pipeline shards {ev}")
        print(f"SHARD_EVIDENCE pipeline: per-position batch shards {ev}",
              flush=True)
        pipe.stop()
        break


def training_step(devices: List[torch.device]) -> float:
    """The sharded training step over the (data, spatial, model) mesh of
    ``devices``; checks the input split, the halo bound, a finite loss,
    the loss, the gradients and the update against the same step without
    a mesh on the first device. Returns the loss."""
    mesh = mesh3(devices)
    data, spatial, _ = factor(len(devices))
    B = max(2, data * 2)
    # the reference draws from PRNGKey(0); the port from a seeded numpy
    # generator, in the JAX model's layout
    model = fcn.params_from_numpy(
        fcn.numpy_params(np.random.default_rng(0), num_classes=NUM_CLASSES,
                         widths=WIDTHS), devices[0], dtype=torch.bfloat16)
    reps = replicas(model, mesh, fcn.param_specs(model))
    host = make_planes(B, H, W)
    nv12 = shard_planes((host,), mesh)
    expected = (B // data, (H * 3 // 2) // spatial, W)
    shapes = sorted({tuple(s.data.shape) for s in nv12[0].shards})
    if shapes != [expected]:
        raise AssertionError(f"input shards {shapes} != {[expected]}")
    labels = torch.zeros((B, DH // 2, DW // 2), dtype=torch.int64)
    loss, prep = loss_and_grads(mesh, reps, nv12, labels)
    if not np.isfinite(loss.item()):
        raise AssertionError("non-finite loss in the dry run")
    # no position receives its data group's whole input
    group_bytes = B // data * (H * 3 // 2) * W
    for pos, got in prep.received.items():
        if got + prep.held[pos] >= group_bytes:
            raise AssertionError(
                f"position {pos} received {got} B and holds "
                f"{prep.held[pos]} B of its group's {group_bytes} B input")
    lrel, worst = step_differences(
        reps, loss, model, unsharded_loss_and_grads(model, host, labels))
    if lrel > LOSS_RTOL or worst > GRAD_TOL:
        raise AssertionError(f"the split step is {lrel} (loss) and {worst} "
                             f"(gradients) off the step without a mesh")
    wrong, moved, off = update_differences(reps, model)
    if wrong or not moved or off > GRAD_TOL:
        raise AssertionError(f"the update: {wrong} elements off p - lr*g, "
                             f"{moved} moved, {off} x lr*max|g| off the "
                             f"step without a mesh")
    print(f"HALO_BYTES received per position "
          f"{sorted(prep.received.items())} of {group_bytes} B per data "
          f"group", flush=True)
    print(f"FCN replicas (data, spatial) -> model devices "
          f"{ {k: [str(s.device) for s in r] for k, r in reps.items()} }",
          flush=True)
    return loss.item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.parallel.dryrun",
        description="multi-device dry run of the port's parallel paths")
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="mesh positions (default 8)")
    ap.add_argument("--device", default=None,
                    help="put every position on this device (e.g. cpu); "
                         "default: the machine's cards in turn")
    args = ap.parse_args(argv)
    devices = device_grid(args.n, args.device)
    serving_legs(devices)
    loss = training_step(devices)
    print(f"dryrun({args.n}) on {sorted(str(d) for d in set(devices))}: "
          f"loss={loss} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
