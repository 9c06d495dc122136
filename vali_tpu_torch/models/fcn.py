"""A compact fully-convolutional segmentation model.

Counterpart of ``vali_tpu/models/fcn.py``: the small FCN that consumes the
pipeline's ``[N, H, W, 3]`` batches (the JAX package's analogue of the
reference's torchvision FCN-ResNet101 test). Layers ``conv0..conv3`` are
3x3 at stride 1, 2, 2, 2, each followed by ReLU, then a 1x1 ``head``;
batches go in and logits come out NHWC, as in the JAX model.

The cast points are the JAX model's: the input goes to bfloat16 first (a
uint8 input is divided by 255 in bfloat16), each convolution runs in the
weights' dtype with no fused bias, and the bias is added to the rounded
convolution output (a fused bias would round once where the JAX model
rounds twice). "SAME" padding is XLA's: ``pad_total = max((ceil(n / s) -
1) * s + k - n, 0)`` with the odd pixel at the end, so a stride-2 layer
on an even size pads (0, 1), where ``padding=1`` would pad (1, 1) and
shift every window.

The convolutions are cuDNN's (``F.conv2d``) on channels-last tensors: the
NHWC input permuted to NCHW is already channels-last in memory, so no
layout copy is made. The JAX package leaves them to XLA, outside any
Pallas kernel. With float32 weights they run with TF32 off
(``ops.fused.exact_f32_matmul``).

Tensor parallelism (the multi-device dry run, ``parallel/dryrun.py``):
:func:`param_specs` shards every layer's output channels over the mesh's
"model" axis, as the JAX model's does; :func:`shard_params` cuts a model
into one :class:`FCNShard` per "model" position of one (data, spatial)
place (a replica: the reference replicates the parameters over "data"
and "spatial"), and :func:`apply_sharded` runs them: each position
computes its channels of a layer from the whole input of that layer, and
the slices are gathered along channels, in position order, before the
next layer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused import exact_f32_matmul
from ..parallel.mesh import Mesh, P, PartitionSpec
from ..utils.device import get_device

WIDTHS = (32, 64, 128, 256)
NUM_CLASSES = 21


def _stride(i: int) -> int:
    return 2 if 0 < i < 4 else 1


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(h: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """One layer: SAME-padded convolution in the weights' dtype, then the
    bias added to its output."""
    k, s = conv.kernel_size[0], conv.stride[0]
    top, bottom = _same_pads(h.shape[2], k, s)
    left, right = _same_pads(h.shape[3], k, s)
    h = h.to(conv.weight.dtype)
    if top or bottom or left or right:
        h = F.pad(h, (left, right, top, bottom))
    return F.conv2d(h, conv.weight, stride=s) + conv.bias.view(1, -1, 1, 1)


def _device(device) -> torch.device:
    """``device``, or the first CUDA card (raises where there is none)."""
    return torch.device(device) if device is not None else get_device(0)


class FCN(nn.Module):
    """The segmentation model: ``conv0..conv{len(widths)-1}`` and ``head``.

    The weights are left uninitialised: make a model with
    :func:`init_params` or :func:`params_from_numpy`. ``device`` defaults
    to ``cuda:0``."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 widths: Tuple[int, ...] = WIDTHS,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None):
        super().__init__()
        device = _device(device)
        cin = 3
        for i, cout in enumerate(widths):
            self.add_module(f"conv{i}", nn.utils.skip_init(
                nn.Conv2d, cin, cout, 3, stride=_stride(i), device=device,
                dtype=dtype))
            cin = cout
        self.head = nn.utils.skip_init(nn.Conv2d, cin, num_classes, 1,
                                       device=device, dtype=dtype)
        self.num_layers = len(widths)
        self.to(memory_format=torch.channels_last)

    def layers(self):
        """The convolutions in order, the head last."""
        return [getattr(self, f"conv{i}") for i in range(self.num_layers)
                ] + [self.head]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] uint8 or float -> [N, H', W', num_classes] logits
        in the weights' dtype."""
        h = _model_input(x)
        *convs, head = self.layers()
        with exact_f32_matmul():
            for conv in convs:
                h = torch.relu(_conv(h, conv))
            return _conv(h, head).permute(0, 2, 3, 1)


def _model_input(x: torch.Tensor) -> torch.Tensor:
    """The model's first cast points: bfloat16 (a uint8 input divided by
    255 in bfloat16), NHWC -> NCHW."""
    h = x.to(torch.bfloat16)
    if x.dtype == torch.uint8:
        h = h / 255.0
    return h.permute(0, 3, 1, 2)


def param_specs(model: nn.Module) -> Dict[str, PartitionSpec]:
    """Tensor-parallel specs: output channels sharded over 'model'.

    Keyed by parameter name; the port's weights are OIHW, so a weight's
    spec names axis 0 (``P("model", None, None, None)``) where the JAX
    model's HWIO spec names axis 3: the same output channels."""
    return {name: P("model", None, None, None) if p.dim() == 4
            else P("model") for name, p in model.named_parameters()}


class FCNShard(nn.Module):
    """One "model" position's slice of an :class:`FCN`: every layer's
    output channels ``[k*c/M, (k+1)*c/M)`` over all of its input
    channels, on that position's device."""

    def __init__(self, model: FCN, specs: Dict[str, PartitionSpec],
                 position: int, parts: int, device: torch.device):
        super().__init__()
        self.position, self.device = position, device
        self.num_layers = model.num_layers
        params = dict(model.named_parameters())
        for name, conv in zip([f"conv{i}" for i in range(model.num_layers)]
                              + ["head"], model.layers()):
            part = nn.utils.skip_init(
                nn.Conv2d, conv.in_channels, conv.out_channels // parts,
                conv.kernel_size, stride=conv.stride, device=device,
                dtype=conv.weight.dtype)
            with torch.no_grad():
                for attr in ("weight", "bias"):
                    full = params[f"{name}.{attr}"]
                    getattr(part, attr).copy_(_slice(
                        full, specs[f"{name}.{attr}"], position, parts))
            self.add_module(name, part.to(memory_format=torch.channels_last))

    def layers(self):
        """The convolutions in order, the head last."""
        return [getattr(self, f"conv{i}") for i in range(self.num_layers)
                ] + [self.head]


def _slice(t: torch.Tensor, spec: PartitionSpec, k: int, parts: int
           ) -> torch.Tensor:
    """Block ``k`` of ``parts`` of ``t`` along the dimension ``spec``
    puts on "model" (``t`` whole where it names none)."""
    if "model" not in spec:
        return t
    dim = spec.index("model")
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"{n} channels do not divide over {parts} model "
                         f"positions")
    return t.narrow(dim, k * (n // parts), n // parts)


def shard_params(model: FCN, mesh: Mesh,
                 specs: Optional[Dict[str, PartitionSpec]] = None, *,
                 data: int = 0, spatial: int = 0) -> List[FCNShard]:
    """One :class:`FCNShard` per position of the mesh's "model" axis (one
    where it has none), on the device of the position with that "model"
    index, ``data`` on "data" and ``spatial`` on "spatial" (an axis the
    mesh lacks is left out): one replica of the tensor-parallel model.
    ``specs`` defaults to :func:`param_specs`; channel counts that do not
    divide raise."""
    specs = param_specs(model) if specs is None else specs
    parts = mesh.axis_size("model")
    at = {"data": data, "spatial": spatial}
    shards = []
    for k in range(parts):
        pos = tuple(k if name == "model" else at.get(name, 0)
                    for name in mesh.axis_names)
        shards.append(FCNShard(model, specs, k, parts, mesh.device(pos)))
    return shards


def apply_sharded(shards: List[FCNShard], x: torch.Tensor) -> torch.Tensor:
    """Tensor-parallel :func:`apply`: [N, H, W, 3] -> [N, H', W',
    num_classes] logits on the first shard's device.

    Each shard computes its channels of a layer from that layer's whole
    input, copied to its device; the slices are then gathered along
    channels in position order, once per distinct device. The copies are
    differentiable, so a loss on the result back-propagates into every
    shard's parameters. The cast points are :class:`FCN`'s."""
    h = _model_input(x)
    inputs = {s.device: h.to(s.device) for s in shards}
    n = shards[0].num_layers
    with exact_f32_matmul():
        for i in range(n + 1):
            outs = []
            for s in shards:
                o = _conv(inputs[s.device], s.layers()[i])
                outs.append(torch.relu(o) if i < n else o)
            inputs = {dev: torch.cat([o.to(dev) for o in outs], dim=1)
                      for dev in inputs}
    return inputs[shards[0].device].permute(0, 2, 3, 1)


def init_params(generator: Optional[torch.Generator] = None,
                num_classes: int = NUM_CLASSES,
                widths: Tuple[int, ...] = WIDTHS,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None) -> FCN:
    """A model with He-normal weights drawn from ``generator`` (a CPU
    ``torch.Generator``, seeded 0 when None) and zero biases. The draws
    are float32 in the JAX model's HWIO order, then cast to ``dtype``;
    the numbers differ from ``jax.random``'s (use
    :func:`params_from_numpy` to carry the JAX model's weights over)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = FCN(num_classes, widths, dtype, device)
    with torch.no_grad():
        for conv in model.layers():
            cout, cin, kh, kw = conv.weight.shape
            w = torch.randn((kh, kw, cin, cout), generator=generator)
            conv.weight.copy_((w * math.sqrt(2.0 / (kh * kw * cin)))
                              .permute(3, 2, 0, 1))
            conv.bias.zero_()
    return model


def _tensor(a) -> torch.Tensor:
    """A host copy of ``a``'s values (bfloat16 arrays of ml_dtypes, as
    JAX hands them out, keep their bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.uint16)).view(torch.bfloat16)
    return torch.tensor(a)


def numpy_params(rng: np.random.Generator,
                 num_classes: int = NUM_CLASSES,
                 widths: Tuple[int, ...] = WIDTHS) -> Dict:
    """He-normal float32 weights and zero biases from a numpy generator,
    in the JAX model's nested-dict HWIO layout (random weights made from
    a seed, for :func:`params_from_numpy`)."""
    params, cin = {}, 3
    for name, k, cout in [(f"conv{i}", 3, c) for i, c in enumerate(widths)
                          ] + [("head", 1, num_classes)]:
        w = rng.standard_normal((k, k, cin, cout), dtype=np.float32)
        params[name] = {"w": w * np.float32(np.sqrt(2.0 / (k * k * cin))),
                        "b": np.zeros(cout, np.float32)}
        cin = cout
    return params


def params_from_numpy(params: Dict, device: Optional[torch.device] = None,
                      *, dtype: Optional[torch.dtype] = None) -> FCN:
    """The JAX model's parameters as a loaded :class:`FCN`.

    ``params`` is ``vali_tpu.models.fcn.init_params``'s nested dict as
    numpy arrays: ``{"conv0": {"w": HWIO, "b": [cout]}, ..., "head":
    ...}``. Weights are permuted HWIO -> OIHW and cast to ``dtype``
    (default: the arrays' own dtype) on ``device`` (default ``cuda:0``)."""
    names = sorted((k for k in params if k.startswith("conv")),
                   key=lambda k: int(k[4:]))
    widths = tuple(int(np.shape(params[k]["w"])[3]) for k in names)
    if dtype is None:
        dtype = _tensor(params["conv0"]["w"]).dtype
    model = FCN(int(np.shape(params["head"]["w"])[3]), widths, dtype,
                device)
    with torch.no_grad():
        for name, conv in zip(names + ["head"], model.layers()):
            conv.weight.copy_(_tensor(params[name]["w"]).permute(3, 2, 0, 1))
            conv.bias.copy_(_tensor(params[name]["b"]))
    return model


def apply(model: FCN, x: torch.Tensor) -> torch.Tensor:
    """x: [N, H, W, 3] uint8 or float -> per-pixel class logits."""
    return model(x)


def predict_classes(model: FCN, x: torch.Tensor) -> torch.Tensor:
    """Per-pixel argmax class: [N, H', W'] int64."""
    with torch.no_grad():
        return torch.argmax(apply(model, x), dim=-1)
