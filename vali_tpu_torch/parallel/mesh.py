"""Batches split over a grid of devices.

Counterpart of ``vali_tpu/parallel/mesh.py``. The JAX package picks a
``jax.sharding.Mesh``, annotates shardings and lets XLA insert the
collectives; PyTorch runs eagerly, so here every split, copy and gather is
written out. Axes:

  - "data":    frames/streams (pure data parallel: no communication)
  - "spatial": image rows; each position computes an equal share of the
    output rows from the source rows their bands read (owner computes,
    with a halo fetched from the positions that hold it), then the output
    rows are gathered within the data group (dst is small)
  - "model":   output channels of the FCN (``models/fcn.py``)

:class:`Mesh` and :class:`PartitionSpec` are small copies of JAX's, since
the port does not import ``jax.sharding``. The one difference in
behaviour: **a device may repeat in the port's Mesh**. torch has one CPU
device, where JAX's tests get eight virtual ones, and one card can hold
every position of a mesh; positions are told apart by their place in the
grid, not by their device, so the splits, the per-position streams, the
halo copies and the channel gathers all run on one device as they would
on several.

A sharded result is a :class:`ShardedTensor`, the counterpart of a sharded
``jax.Array``: its global ``shape`` and ``dtype``, one :class:`Shard` per
mesh position (position, device, global index, data), like
``addressable_shards``.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..core.enums import ColorRange, ColorSpace, PixelFormat
from ..ops.fused import fused_resample, preprocess_weights
from ..ops.resize import LANCZOS_AA
from ..utils.device import get_device, num_devices


class PartitionSpec(tuple):
    """How each dimension of an array is split: a mesh axis name, or None
    for a dimension that every position holds whole (JAX's
    ``PartitionSpec``; dimensions past its length are whole too)."""

    def __new__(cls, *axes):
        for a in axes:
            if a is not None and not isinstance(a, str):
                raise TypeError(f"PartitionSpec entries are axis names or "
                                f"None, got {a!r}")
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """An ndarray of ``torch.device`` with one name per axis.

    ``shape`` maps each axis name to its size, in order; ``devices`` is
    the grid. A device may repeat (see the module docstring)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {grid.shape} need "
                             f"{grid.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            self.devices[pos] = torch.device(grid[pos])

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 where the mesh has no such axis."""
        return self.shape.get(name, 1)

    def coord(self, position: Tuple[int, ...], name: str) -> int:
        """``position``'s index along axis ``name`` (0 where the mesh has
        no such axis)."""
        if name not in self.axis_names:
            return 0
        return position[self.axis_names.index(name)]

    def positions(self) -> Iterator[Tuple[int, ...]]:
        """Every position of the grid, in row-major order."""
        return np.ndindex(self.devices.shape)

    def device(self, position: Tuple[int, ...]) -> torch.device:
        return self.devices[position]

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(data: int = 0, spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, spatial) mesh. data=0 means "all devices / spatial".

    ``devices`` defaults to every CUDA card (``cuda:0``, ``cuda:1``, ...);
    with no card that raises, as ``get_device(0)`` does: pass
    ``devices=[torch.device("cpu")] * n`` for a mesh on the host."""
    if devices is None:
        get_device(0)  # raises where there is no card
        devices = [torch.device("cuda", i) for i in range(num_devices())]
    devices = list(devices)
    if data <= 0:
        data = len(devices) // spatial
    if data * spatial != len(devices):
        devices = devices[: data * spatial]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(data, spatial), ("data", "spatial"))


class Shard(NamedTuple):
    """One position's block of a :class:`ShardedTensor`."""
    position: Tuple[int, ...]
    device: torch.device
    index: Tuple[slice, ...]   # the block's place in the global array
    data: torch.Tensor


def _key(index: Tuple[slice, ...]) -> Tuple[Tuple[int, int], ...]:
    return tuple((s.start, s.stop) for s in index)


class ShardedTensor:
    """A global array held as blocks on the positions of a mesh.

    ``shards`` has one :class:`Shard` per position; positions that hold
    the same block (replicas along an axis the spec does not name) each
    have their own copy. ``device_set`` is the set of distinct devices;
    :meth:`gather` and :meth:`numpy` assemble the global array, each
    distinct block once."""

    def __init__(self, shape: Tuple[int, ...], mesh: Mesh,
                 spec: PartitionSpec, shards: List[Shard]):
        self.shape = tuple(shape)
        self.mesh, self.spec, self.shards = mesh, spec, list(shards)
        self.dtype = self.shards[0].data.dtype

    @property
    def device_set(self) -> set:
        return {s.device for s in self.shards}

    def gather(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (default: the first shard's)."""
        device = torch.device(device) if device is not None else \
            self.shards[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for s in self.shards:
            if _key(s.index) not in done:
                done.add(_key(s.index))
                out[s.index] = s.data.to(device)
        return out

    def numpy(self) -> np.ndarray:
        return self.gather(torch.device("cpu")).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def head(self, n: int) -> "ShardedTensor":
        """The first ``n`` rows along dimension 0 (the pipeline's EOS
        tail slices its padding off with it); positions left with no row
        drop out."""
        shards = []
        for s in self.shards:
            b0, b1 = s.index[0].start, s.index[0].stop
            if b0 >= n:
                continue
            k = min(b1, n) - b0
            shards.append(s._replace(
                index=(slice(b0, b0 + k),) + s.index[1:], data=s.data[:k]))
        return ShardedTensor((n,) + self.shape[1:], self.mesh, self.spec,
                             shards)

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, {len(self.shards)} shards)")


def _shard_index(shape: Tuple[int, ...], mesh: Mesh, spec: PartitionSpec,
                position: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The global block that ``position`` holds under ``spec``. A split
    dimension that its axis does not divide raises ValueError, as
    ``jax.device_put`` does."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    index = []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            index.append(slice(0, n))
            continue
        if axis not in mesh.axis_names:
            raise ValueError(f"spec {spec} names axis {axis!r}, which mesh "
                             f"{mesh.shape} lacks")
        parts = mesh.axis_size(axis)
        if n % parts:
            raise ValueError(f"dimension {dim} of shape {shape} does not "
                             f"divide over axis {axis!r} of size {parts}")
        k = mesh.coord(position, axis)
        index.append(slice(k * (n // parts), (k + 1) * (n // parts)))
    return tuple(index)


def distribute(x, mesh: Mesh, spec: PartitionSpec) -> ShardedTensor:
    """Place ``x`` (a tensor or host ndarray) on ``mesh`` under ``spec``:
    one copy per position (``jax.device_put(x, NamedSharding(mesh,
    spec))``). Host input goes to a card through a pinned buffer with a
    non_blocking copy; on the host each position gets its own copy, so a
    caller that reuses its array cannot change a shard."""
    shape = tuple(x.shape)
    indices = [(pos, _shard_index(shape, mesh, spec, pos))
               for pos in mesh.positions()]
    shards = []
    for pos, idx in indices:
        dev = mesh.device(pos)
        if isinstance(x, np.ndarray) and dev.type == "cuda":
            data = torch.from_numpy(np.ascontiguousarray(
                x[idx])).pin_memory().to(dev, non_blocking=True)
        elif isinstance(x, np.ndarray):
            data = torch.from_numpy(np.array(x[idx]))
        else:
            data = x[idx].to(dev, non_blocking=True, copy=True)
        shards.append(Shard(pos, dev, idx, data))
    return ShardedTensor(shape, mesh, spec, shards)


def shard_planes(planes, mesh: Mesh) -> Tuple[ShardedTensor, ...]:
    """Place batched planes on the mesh: batch over data, rows over
    spatial."""
    return tuple(distribute(p, mesh, P("data", "spatial", None))
                 for p in planes)


def _as_sharded(x, mesh: Mesh, spec: PartitionSpec) -> ShardedTensor:
    """``x`` on ``mesh`` under ``spec``: a ShardedTensor laid out so is
    taken as it is, a tensor or ndarray is distributed; a ShardedTensor
    under another mesh or spec raises."""
    if isinstance(x, ShardedTensor):
        if x.mesh is not mesh or tuple(x.spec) != tuple(spec):
            raise ValueError(f"input sharded as {x.spec} on {x.mesh}, "
                             f"expected {spec} on {mesh}")
        return x
    return distribute(x, mesh, spec)


def on_position_streams(jobs: Sequence[Tuple[torch.device,
                                             Sequence[torch.Tensor],
                                             Callable[[], torch.Tensor]]]
                        ) -> Tuple[List[torch.Tensor], List]:
    """Run each ``(device, inputs, fn)`` job: on a card on a CUDA stream
    of its own, ordered after the work already queued on the caller's
    stream; then make the caller's stream wait on every job's event.

    Tensors crossing streams are marked with ``record_stream``: the inputs
    for the job's stream, the outputs (made on the job's stream) for the
    caller's, or the caching allocator could hand their memory out while a
    kernel still reads it. Host jobs just run. Returns the outputs and the
    CUDA events (empty for host jobs)."""
    outs, pending = [], []
    for dev, inputs, fn in jobs:
        if dev.type != "cuda":
            outs.append(fn())
            continue
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            out = fn()
        for t in inputs:
            if t.device.type == "cuda":
                t.record_stream(side)
        event = torch.cuda.Event()
        event.record(side)
        outs.append(out)
        pending.append((caller, event, out))
    for caller, event, out in pending:
        caller.wait_event(event)
        out.record_stream(caller)
    return outs, [e for _, e, _ in pending]


def map_over_data(fn: Callable[[torch.Tensor], torch.Tensor], mesh: Mesh
                  ) -> Callable[..., ShardedTensor]:
    """``fn`` mapped over the "data" axis (``shard_map`` with in_specs and
    out_specs ``P("data")``): every position runs ``fn`` on its own block
    of the batch, on its own device and stream (:func:`on_position_streams`);
    positions along other axes hold replicas and each computes its own.
    The callable takes a tensor, an ndarray or a ShardedTensor under
    ``P("data")`` and returns a ShardedTensor under ``P("data")``."""
    if "data" not in mesh.axis_names:
        raise ValueError("mesh needs a 'data' axis")
    spec = P("data")

    def run(x) -> ShardedTensor:
        x = _as_sharded(x, mesh, spec)
        outs, _ = on_position_streams(
            [(s.device, [s.data], (lambda s=s: fn(s.data)))
             for s in x.shards])
        shards = [Shard(s.position, s.device,
                        (s.index[0],) + tuple(slice(0, n)
                                              for n in o.shape[1:]), o)
                  for s, o in zip(x.shards, outs)]
        return ShardedTensor((x.shape[0],) + tuple(outs[0].shape[1:]),
                             mesh, spec, shards)

    return run


def sharded_kernel_preprocess(mesh: Mesh, src_w: int, src_h: int,
                              dst_w: int, dst_h: int,
                              space: ColorSpace = ColorSpace.BT_709,
                              crange: ColorRange = ColorRange.MPEG,
                              out_dtype=None, planar: bool = True):
    """Multi-device wrapper for the banded NV12 kernel (the counterpart of
    ``sharded_pallas_preprocess``): the batch is split over the mesh's
    "data" axis and each position runs ``ops/nv12_preprocess`` on its own
    block, on its own device and CUDA stream (no communication). Input is
    [B, >= H*3/2, W] with B divisible by the data-axis size; output is
    [B@data, 3, dst_h, dst_w], or [B@data, dst_h, dst_w, 3] unless
    ``planar``. On CPU tensors each block takes the kernel's plain
    version, as the wrapper does."""
    from ..ops.nv12_preprocess import nv12_preprocess

    if out_dtype is None:
        out_dtype = torch.uint8

    def local_fn(nv12_shard):
        out = nv12_preprocess(
            nv12_shard, src_w=src_w, src_h=src_h, dst_w=dst_w, dst_h=dst_h,
            space=space, crange=crange, out_dtype=out_dtype)
        return out if planar else out.movedim(1, -1)

    return map_over_data(local_fn, mesh)


#: formats whose planes are split over "spatial": per plane, the
#: components it stores as (first plane row, which row matrix: 0 luma,
#: 1 chroma); NV12's one plane holds the luma rows and, from row H, the
#: interleaved UV rows
def _plane_parts(src_fmt: PixelFormat, src_h: int):
    if src_fmt in (PixelFormat.NV12, PixelFormat.P10, PixelFormat.P12):
        return [[(0, 0), (src_h, 1)]]
    if src_fmt in (PixelFormat.YUV420, PixelFormat.YUV420_10bit,
                   PixelFormat.YUV422, PixelFormat.YUV444,
                   PixelFormat.YUV444_10bit):
        return [[(0, 0)], [(0, 1)], [(0, 1)]]
    raise ValueError(f"sharded_preprocess does not support {src_fmt.name}")


def _band(dense: np.ndarray, o0: int, o1: int) -> Tuple[int, int]:
    """[first, last + 1) of the source rows that output rows [o0, o1) of
    ``dense`` read (their weights' non-zero span)."""
    cols = np.flatnonzero((dense[o0:o1] != 0.0).any(axis=0))
    return int(cols[0]), int(cols[-1]) + 1


class SpatialPreprocess:
    """The callable :func:`sharded_preprocess` returns.

    ``received`` maps each position to the input bytes it received from
    the other positions in the last call (the halo); ``held`` to the
    bytes of the input it holds itself. No position receives its data
    group's whole input."""

    def __init__(self, mesh, src_fmt, src_w, src_h, dst_w, dst_h, space,
                 crange, out_dtype, planar, method):
        if "data" not in mesh.axis_names:
            raise ValueError("mesh needs a 'data' axis")
        self.mesh = mesh
        self.src_fmt = PixelFormat(src_fmt)
        self.src_w, self.src_h = src_w, src_h
        self.dst_w, self.dst_h = dst_w, dst_h
        self.space, self.crange = space, crange
        self.out_dtype, self.planar = out_dtype, planar
        self.parts = _plane_parts(self.src_fmt, src_h)
        self.weights = preprocess_weights(self.src_fmt, src_w, src_h, dst_w,
                                          dst_h, method)
        self.n_spatial = mesh.axis_size("spatial")
        if dst_h < self.n_spatial:
            raise ValueError(f"{dst_h} output rows cannot split over "
                             f"{self.n_spatial} spatial positions")
        self.received: Dict[Tuple[int, ...], int] = {}
        self.held: Dict[Tuple[int, ...], int] = {}

    def _rows(self, s: int) -> Tuple[int, int]:
        """The output rows spatial position ``s`` computes."""
        n = self.n_spatial
        return s * self.dst_h // n, (s + 1) * self.dst_h // n

    def _group(self, x: ShardedTensor, pos) -> List[Shard]:
        """The shards of ``x`` on ``pos``'s data group and its place on
        every other axis but "spatial", in spatial order."""
        if "spatial" not in self.mesh.axis_names:
            return [s for s in x.shards if s.position == pos]
        ax = self.mesh.axis_names.index("spatial")
        group = [s for s in x.shards
                 if s.position[:ax] + s.position[ax + 1:]
                 == pos[:ax] + pos[ax + 1:]]
        return sorted(group, key=lambda s: s.position[ax])

    def _window(self, x: ShardedTensor, pos, r0: int, r1: int
                ) -> torch.Tensor:
        """Plane rows [r0, r1) of ``pos``'s batch block on its device:
        its own rows as a view, the others copied from the positions that
        hold them (counted in ``received``)."""
        dev = self.mesh.device(pos)
        pieces = []
        for s in self._group(x, pos):
            a, b = s.index[1].start, s.index[1].stop
            lo, hi = max(r0, a), min(r1, b)
            if lo >= hi:
                continue
            piece = s.data[:, lo - a:hi - a]
            if s.position != pos:
                piece = piece.to(dev, non_blocking=True, copy=True)
                self.received[pos] += piece.numel() * piece.element_size()
            pieces.append(piece)
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)

    def _block(self, planes: Tuple[ShardedTensor, ...], pos
               ) -> torch.Tensor:
        """The output rows of ``pos`` [b, rows, dst_w, 3]."""
        o0, o1 = self._rows(self.mesh.coord(pos, "spatial"))
        wy_h, wc_h, wy_w, wc_w = self.weights
        row_mats = (wy_h, wc_h)
        comps, mats = [], [None, None]
        for x, parts in zip(planes, self.parts):
            for first, which in parts:
                a, b = _band(row_mats[which], o0, o1)
                comps.append(self._window(x, pos, first + a, first + b))
                mats[which] = row_mats[which][o0:o1, a:b]
        if len(comps) == 2:  # NV12: the UV rows hold U and V interleaved
            uv = comps[1].unflatten(2, (comps[1].shape[2] // 2, 2))
            comps = [comps[0], uv[..., 0], uv[..., 1]]
        return fused_resample(tuple(comps), (mats[0], mats[1], wy_w, wc_w),
                              self.src_fmt, self.space, self.crange,
                              self.out_dtype)

    def __call__(self, planes) -> ShardedTensor:
        spec = P("data", "spatial", None)
        planes = tuple(_as_sharded(p, self.mesh, spec) for p in planes)
        if len(planes) != len(self.parts):
            raise ValueError(f"{self.src_fmt.name} has {len(self.parts)} "
                             f"planes, got {len(planes)}")
        positions = list(self.mesh.positions())
        self.received = {pos: 0 for pos in positions}
        self.held = {pos: sum(
            s.data.numel() * s.data.element_size()
            for x in planes for s in x.shards if s.position == pos)
            for pos in positions}
        blocks = {pos: self._block(planes, pos) for pos in positions}
        shards = []
        for pos in positions:
            dev = self.mesh.device(pos)
            group = [s.position for s in self._group(planes[0], pos)]
            full = torch.cat([blocks[g].to(dev, non_blocking=True)
                              for g in group], dim=1)
            if self.planar:
                full = full.movedim(-1, 1)
            bidx = next(s.index[0] for s in planes[0].shards
                        if s.position == pos)
            shards.append(Shard(pos, dev, (bidx,) + tuple(
                slice(0, n) for n in full.shape[1:]), full))
        b = planes[0].shape[0]
        shape = ((b, 3, self.dst_h, self.dst_w) if self.planar
                 else (b, self.dst_h, self.dst_w, 3))
        return ShardedTensor(shape, self.mesh, P("data"), shards)


def sharded_preprocess(
    mesh: Mesh,
    src_fmt: PixelFormat,
    src_w: int,
    src_h: int,
    dst_w: int,
    dst_h: int,
    space: ColorSpace = ColorSpace.BT_709,
    crange: ColorRange = ColorRange.MPEG,
    out_dtype=torch.uint8,
    planar: bool = False,
    method: str = LANCZOS_AA,
) -> SpatialPreprocess:
    """The dense fused preprocess (``ops/fused.fused_preprocess``) across
    the mesh.

    Inputs are [B@data, H@spatial, W] planes (ShardedTensors from
    :func:`shard_planes`, or tensors / ndarrays, which are placed so);
    the output is [B@data, dst_h, dst_w, 3], the same on every spatial
    position of a data group. Each spatial position computes an equal
    share of the output rows from the source rows that those rows' bands
    read, fetching the ones other positions hold; for NV12 that band lies
    in both the luma rows and the UV rows of the one plane, and either may
    sit on another position."""
    return SpatialPreprocess(mesh, src_fmt, src_w, src_h, dst_w, dst_h,
                             space, crange, out_dtype, planar, method)

