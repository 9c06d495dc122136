"""vali_tpu_torch.parallel.mesh and MultiStreamPipeline(mesh=) against
vali_tpu on the CPU. The JAX side runs on the conftest's 8 virtual CPU
devices; the port's meshes repeat the one CPU device. Inputs are
numpy-seeded and fed to both packages.

Envelopes: the dense route's (tests/test_torch_port_preprocess.py): uint8
within 1 LSB on < 1e-3 of the samples, float32 within 1e-5; the banded
kernel's plain version against the Pallas kernel in interpret mode the
same for uint8."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

from vali_tpu.core.enums import ColorRange, ColorSpace, PixelFormat
from vali_tpu.parallel import mesh as jmesh
from vali_tpu.pipeline.multistream import \
    MultiStreamPipeline as JaxPipeline
from vali_tpu_torch.ops.fused import fused_preprocess
from vali_tpu_torch.parallel import mesh as tmesh
from vali_tpu_torch.pipeline.multistream import MultiStreamPipeline
from vali_tpu_torch.utils.synth import synthesize_clip

CPU = torch.device("cpu")
BT709 = dict(space=ColorSpace.BT_709, crange=ColorRange.MPEG)


def _cpus(n):
    return [CPU] * n


def _u8_close(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == np.uint8:
        _u8_close(a, b)
    else:
        assert np.abs(a.astype(np.float64) - b).max() <= 1e-5


def _planes(rng, fmt, b, w, h):
    """numpy storage-layout planes of 8-bit ``fmt``."""
    if fmt == PixelFormat.NV12:
        dims = [(h * 3 // 2, w)]
    elif fmt == PixelFormat.YUV420:
        dims = [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    else:  # YUV422
        dims = [(h, w), (h, w // 2), (h, w // 2)]
    return [rng.integers(0, 256, (b,) + d, dtype=np.uint8) for d in dims]


@pytest.mark.parametrize("data,spatial", [(0, 1), (0, 2), (4, 2), (2, 1)])
def test_make_mesh_shapes_match_jax(data, spatial):
    ref = jmesh.make_mesh(data, spatial)
    ours = tmesh.make_mesh(data, spatial, devices=_cpus(8))
    assert ours.axis_names == tuple(ref.axis_names) == ("data", "spatial")
    assert ours.shape == dict(ref.shape)
    assert ours.devices.shape == ref.devices.shape
    assert ours.size == ref.devices.size


def test_make_mesh_needs_a_card_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()


def _position_of(ref_mesh, device):
    return tuple(int(i) for i in np.argwhere(ref_mesh.devices == device)[0])


def _norm(index, shape):
    return tuple(s.indices(n)[:2] for s, n in zip(index, shape))


@pytest.mark.parametrize("fmt", [PixelFormat.NV12, PixelFormat.YUV420])
@pytest.mark.parametrize("data,spatial", [(0, 2), (4, 2), (2, 1), (0, 1)])
def test_shard_planes_indices_match_addressable_shards(fmt, data, spatial):
    planes = _planes(np.random.default_rng(1), fmt, 8, 64, 48)
    ref_mesh = jmesh.make_mesh(data, spatial)
    ours_mesh = tmesh.make_mesh(data, spatial, devices=_cpus(8))
    for ref, ours, x in zip(jmesh.shard_planes(tuple(planes), ref_mesh),
                            tmesh.shard_planes(tuple(planes), ours_mesh),
                            planes):
        want = {_position_of(ref_mesh, s.device): _norm(s.index, x.shape)
                for s in ref.addressable_shards}
        got = {s.position: _norm(s.index, x.shape) for s in ours.shards}
        assert got == want
        for s in ours.shards:
            assert s.device == CPU
            assert np.array_equal(s.data.numpy(), x[s.index])
        assert np.array_equal(ours.numpy(), x)
        assert ours.shape == tuple(ref.shape) and ours.device_set == {CPU}


def test_shard_planes_refuses_what_does_not_divide():
    x = np.zeros((3, 72, 64), np.uint8)
    with pytest.raises(ValueError):
        jmesh.shard_planes((x,), jmesh.make_mesh(0, 2))
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_planes((x,), tmesh.make_mesh(0, 2, devices=_cpus(8)))


def test_host_shards_are_copies():
    """A caller that reuses its host array cannot change a shard."""
    x = np.arange(8 * 6 * 4, dtype=np.uint8).reshape(8, 6, 4)
    sharded = tmesh.shard_planes((x,), tmesh.make_mesh(
        0, 2, devices=_cpus(8)))[0]
    want = x.copy()
    x[:] = 0
    assert np.array_equal(sharded.numpy(), want)


@pytest.mark.parametrize("fmt,out", [
    (PixelFormat.NV12, "u8"), (PixelFormat.NV12, "f32"),
    (PixelFormat.YUV420, "u8"), (PixelFormat.YUV422, "f32")])
def test_sharded_preprocess_matches_jax(fmt, out):
    """spatial = 2, data = 4 (B = 8, 48x64 -> 32x32), as
    tests/test_pipeline.py runs the reference; held to the reference and
    to the port's unsharded route, and no position receives its data
    group's whole input."""
    B, H, W = 8, 48, 64
    planes = _planes(np.random.default_rng(2), fmt, B, W, H)
    jdt, tdt = ((jnp.uint8, torch.uint8) if out == "u8"
                else (jnp.float32, torch.float32))
    ref_mesh = jmesh.make_mesh(spatial=2)
    ref = jmesh.sharded_preprocess(ref_mesh, fmt, W, H, 32, 32, **BT709,
                                   out_dtype=jdt)(
        jmesh.shard_planes(tuple(planes), ref_mesh))
    mesh = tmesh.make_mesh(spatial=2, devices=_cpus(8))
    fn = tmesh.sharded_preprocess(mesh, fmt, W, H, 32, 32, **BT709,
                                  out_dtype=tdt)
    ours = fn(tmesh.shard_planes(tuple(planes), mesh))
    assert ours.shape == tuple(ref.shape) == (B, 32, 32, 3)
    _close(ours.numpy(), np.asarray(ref))
    whole = fused_preprocess(tuple(torch.from_numpy(p) for p in planes),
                             fmt, W, H, 32, 32, **BT709, out_dtype=tdt)
    _close(ours.numpy(), whole.numpy())
    # every position of a data group holds the whole of its output rows
    for s in ours.shards:
        assert s.index[0] == slice(2 * s.position[0], 2 * s.position[0] + 2)
        assert np.array_equal(s.data.numpy(), ours.numpy()[s.index])
    group_bytes = sum(p.nbytes for p in planes) // 4
    for pos, got in fn.received.items():
        assert 0 < got and got + fn.held[pos] < group_bytes


def test_sharded_preprocess_halo_reaches_both_planes_of_nv12():
    """1080p NV12 over spatial = 2: position 0 holds luma rows 0-809 and
    needs UV rows that position 1 holds; position 1 holds luma rows
    810-1079 and all of UV and needs luma rows position 0 holds. Each
    receives its bands' rows only, under a quarter of the frame's 1620
    (one narrow frame is enough to count)."""
    H, W = 1080, 64
    nv12 = np.random.default_rng(3).integers(0, 256, (1, H * 3 // 2, W),
                                             dtype=np.uint8)
    mesh = tmesh.make_mesh(1, 2, devices=_cpus(2))
    fn = tmesh.sharded_preprocess(mesh, PixelFormat.NV12, W, H, 32, 224,
                                  **BT709)
    out = fn(tmesh.shard_planes((nv12,), mesh))
    rows = {pos: got // W for pos, got in fn.received.items()}
    assert all(0 < r < H * 3 // 2 // 4 for r in rows.values()), rows
    assert fn.held == {(0, 0): 810 * W, (0, 1): 810 * W}
    whole = fused_preprocess((torch.from_numpy(nv12),), PixelFormat.NV12,
                             W, H, 32, 224, **BT709)
    _close(out.numpy(), whole.numpy())


def test_sharded_kernel_preprocess_matches_sharded_pallas():
    """B = 8, 96x256 -> 32x64 on four positions, against the reference's
    shard_map'd Pallas kernel in interpret mode (tests/test_pipeline.py
    runs it the same way); the port's four positions take the kernel's
    plain version on the CPU."""
    from vali_tpu.ops.pallas_fused import (pallas_nv12_preprocess,
                                           required_pad_rows)

    B, H, W, DH, DW = 8, 96, 256, 32, 64
    pad = required_pad_rows(W, H, DH)
    nv12 = np.random.default_rng(4).integers(
        0, 256, (B, H * 3 // 2 + pad, W), dtype=np.uint8)
    ref_mesh = JaxMesh(np.array(jax.devices()[:4]), ("data",))

    def local_fn(shard):
        return pallas_nv12_preprocess(shard, src_w=W, src_h=H, dst_w=DW,
                                      dst_h=DH, interpret=True)

    ref = np.asarray(jax.jit(jmesh._shard_map(
        local_fn, mesh=ref_mesh, in_specs=JP("data", None, None),
        out_specs=JP("data", None, None, None)))(jnp.asarray(nv12)))
    grid = np.empty(4, dtype=object)
    grid[:] = _cpus(4)
    mesh = tmesh.Mesh(grid, ("data",))
    ours = tmesh.sharded_kernel_preprocess(mesh, W, H, DW, DH)(nv12)
    assert ours.shape == ref.shape == (B, 3, DH, DW)
    _u8_close(ours.numpy(), ref)
    assert sorted((s.position, tuple(s.data.shape)) for s in ours.shards) \
        == [((k,), (2, 3, DH, DW)) for k in range(4)]
    packed = tmesh.sharded_kernel_preprocess(mesh, W, H, DW, DH,
                                             planar=False)(nv12)
    assert np.array_equal(packed.numpy(), np.moveaxis(ours.numpy(), 1, -1))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "c.mp4")
    return synthesize_clip(path, 96, 64, n=7, chroma="sweep")


def _batches(pipe):
    return [(np.asarray(batch), list(ids), batch) for batch, ids in pipe]


@pytest.mark.parametrize("data,spatial", [(4, 1), (2, 2)])
def test_pipeline_on_a_mesh_matches_jax(clip, data, spatial):
    """One clip of 7 frames in batches of 4: the last batch is an EOS tail
    of 3 frames, padded to the data axis and cut back."""
    ref = _batches(JaxPipeline(
        [clip], 48, 32, gpu_id=0, batch_size=4,
        mesh=jmesh.make_mesh(data, spatial, jax.devices()[:4])))
    mesh = tmesh.make_mesh(data, spatial, devices=_cpus(4))
    ours = _batches(MultiStreamPipeline([clip], 48, 32, gpu_id=-1,
                                        batch_size=4, mesh=mesh))
    assert [ids for _, ids, _ in ours] == [ids for _, ids, _ in ref] == [
        [0] * 4, [0] * 3]
    for (a, _, batch), (b, _, _) in zip(ours, ref):
        assert a.shape == b.shape == (len(a), 32, 48, 3)
        _u8_close(a, b)
        assert isinstance(batch, tmesh.ShardedTensor)
        assert len({s.position for s in batch.shards}) == len(batch.shards)
    tail = ours[1][2]
    rows = sorted({(s.index[0].start, s.index[0].stop)
                   for s in tail.shards})
    per = 4 // data
    assert rows == [(k * per, min((k + 1) * per, 3))
                    for k in range(data) if k * per < 3]


def test_pipeline_on_a_mesh_equals_the_pipeline_without_one(clip):
    """Split or not, the same batches, bit for bit."""
    whole = [(np.asarray(b), ids) for b, ids in MultiStreamPipeline(
        [clip] * 2, 48, 32, gpu_id=-1, batch_size=2, sync_streams=True)]
    mesh = tmesh.make_mesh(2, 1, devices=_cpus(2))
    split = [(np.asarray(b), ids) for b, ids in MultiStreamPipeline(
        [clip] * 2, 48, 32, gpu_id=-1, batch_size=2, sync_streams=True,
        mesh=mesh)]
    assert len(whole) == len(split) == 7
    for (a, ia), (b, ib) in zip(whole, split):
        assert ia == ib and np.array_equal(a, b)
