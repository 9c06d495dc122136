"""The port's samples 9-14 (vali_tpu_torch/samples: multistream and its
jpeg mode, detection preprocess, segmentation, multichip, scene
detection, HDR tone mapping), each run as ``python -m
vali_tpu_torch.samples.<name> ... --device cpu`` on the clip
tests/test_samples.py runs the JAX samples on, printing what that file
asserts of them; and the pipeline samples' functions driven in process
by in-memory streams and held to vali_tpu on the JAX CPU backend: each
batch to the JAX package's preprocess (or letterbox) of its rows'
frames, the segmentation classes to the JAX model's on the same weights,
and the mesh sample's batches, ids and end-of-stream tail to the JAX
pipeline on a mesh of the conftest's CPU devices.

Envelopes, the port's against JAX (tests/test_torch_port_preprocess.py,
tests/test_torch_port_fcn.py): uint8 within 1 LSB on < 1e-3 of the
samples, float32 within 1e-5; FCN classes: per-frame class histograms
agreeing > 0.98. Each batch is also held, bit for bit, to the port's own
dense preprocess, which the pipeline runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_samples import CLIP, run_sample  # noqa: F401
from vali_tpu.core import enums as jenums
from vali_tpu.models import fcn as ref_fcn
from vali_tpu.ops import fused as ref_fused
from vali_tpu.parallel import mesh as ref_mesh
from vali_tpu.pipeline.multistream import \
    MultiStreamPipeline as JaxPipeline
from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
from vali_tpu_torch.ops.fused import fused_preprocess
from vali_tpu_torch.utils.synth import HostFrameSource, synthesize_clip

CPU = torch.device("cpu")


def test_sample_multistream(CLIP):
    out = run_sample("sample_multistream", CLIP, "2", timeout=300)
    assert "fps end-to-end" in out


def test_sample_multistream_jpeg(CLIP):
    out = run_sample("sample_multistream", CLIP, "2", "jpeg", timeout=300)
    assert "jpeg pipeline: 192 JPEGs" in out


def test_sample_detection_preprocess(CLIP):
    out = run_sample("sample_detection_preprocess", CLIP, "2", "320")
    assert "scale" in out and "letterboxed" in out


def test_sample_segmentation(CLIP):
    out = run_sample("sample_segmentation", CLIP, "1", timeout=300)
    assert "segmented" in out


def test_sample_multichip(CLIP):
    out = run_sample("sample_multichip", CLIP, "4", "2", timeout=300)
    assert "OK: 2 sharded batches across 4 devices" in out


def test_sample_scene_detection(CLIP):
    out = run_sample("sample_scene_detection", CLIP)
    assert "cuts at frames:" in out and out.strip().endswith("OK")


def test_sample_hdr_tonemap():
    # self-synthesizing: no input clip needed
    out = run_sample("sample_hdr_tonemap", timeout=300)
    assert "tone-mapped to SDR" in out
    assert "wrote SDR stream" in out and out.strip().endswith("OK")


W, H, N_STREAMS, N_FRAMES = 128, 96, 3, 4


@pytest.fixture(scope="module")
def frames():
    """One seeded YUV420 host frame per stream."""
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, (N_STREAMS, W * H * 3 // 2), dtype=np.uint8)


def streams(frames):
    """Stream s repeats frame s, so a batch row is known from its id."""
    return [HostFrameSource([f] * N_FRAMES, PixelFormat.YUV420, W, H)
            for f in frames]


def _planes(frames):
    """(Y, U, V) of the host frames: [stream, h, w] numpy arrays."""
    c = frames[:, W * H:].reshape(-1, 2, H // 2, W // 2)
    return frames[:, :W * H].reshape(-1, H, W), c[:, 0].copy(), \
        c[:, 1].copy()


def reference(frames, dst_w, dst_h, letterbox=False, **kw):
    """[stream, dst_h, dst_w, 3] numpy: each stream's frame through
    vali_tpu's dense preprocess, or its letterbox, on the JAX CPU
    backend."""
    op = ref_fused.letterbox_preprocess if letterbox \
        else ref_fused.fused_preprocess
    return np.asarray(op(
        tuple(jnp.asarray(p) for p in _planes(frames)),
        jenums.PixelFormat.YUV420, W, H, dst_w, dst_h,
        jenums.ColorSpace.BT_709, jenums.ColorRange.MPEG, **kw))


def expected(frames, dst_w, dst_h, **kw):
    """[stream, dst_h, dst_w, 3]: each stream's frame through the port's
    dense preprocess, which the pipeline runs on the CPU."""
    return fused_preprocess(
        tuple(torch.from_numpy(p) for p in _planes(frames)),
        PixelFormat.YUV420, W, H, dst_w, dst_h, ColorSpace.BT_709,
        ColorRange.MPEG, **kw)


def close_to_jax(got, want):
    """The port's envelope against JAX: uint8 within 1 LSB on < 1e-3 of
    the samples, float32 within 1e-5."""
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
    else:
        assert np.abs(got.astype(np.float64) - want).max() <= 1e-5


def held(seen):
    """(the batches stacked, their ids), after checking that every
    stream's frames all came, once each."""
    batch = torch.cat([b for b, _ in seen])
    ids = [i for _, ids in seen for i in ids]
    assert batch.shape[0] == N_STREAMS * N_FRAMES
    assert sorted(ids) == sorted(list(range(N_STREAMS)) * N_FRAMES)
    return batch, ids


def test_multistream_run_on_in_memory_streams(frames):
    from vali_tpu_torch.samples import sample_multistream

    seen = []
    n, _ = sample_multistream.run(streams(frames), CPU,
                                  on_batch=lambda b, i: seen.append((b, i)))
    assert n == N_STREAMS * N_FRAMES
    batch, ids = held(seen)
    close_to_jax(batch, reference(frames, 224, 224)[ids])
    assert torch.equal(batch, expected(frames, 224, 224)[ids])


def test_detection_run_on_in_memory_streams(frames):
    from vali_tpu_torch.samples import sample_detection_preprocess

    seen = []
    n, _, geometry = sample_detection_preprocess.run(
        streams(frames), CPU, 160, on_batch=lambda b, i: seen.append((b, i)))
    assert geometry == ref_fused.letterbox_params(W, H, 160, 160)
    batch, ids = held(seen)
    close_to_jax(batch, reference(frames, 160, 160, letterbox=True)[ids])
    iw, ih, left, top, _ = geometry
    canvas = torch.full_like(batch, 114)
    canvas[:, top:top + ih, left:left + iw] = expected(frames, iw, ih)[ids]
    assert torch.equal(batch, canvas)


def _histograms_agree(got, want, n_classes=21):
    """The FCN's golden envelope on classes: each frame's class histogram
    shares > 0.98 of its pixels with the reference's."""
    for g, w in zip(got, want):
        hg = np.bincount(g.reshape(-1), minlength=n_classes)
        hw = np.bincount(w.reshape(-1), minlength=n_classes)
        assert np.minimum(hg, hw).sum() / hw.sum() > 0.98, (hg, hw)


def test_segmentation_run_on_in_memory_streams(frames):
    from vali_tpu_torch.models import fcn
    from vali_tpu_torch.samples import sample_segmentation

    params = ref_fcn.init_params(jax.random.PRNGKey(0))
    model = fcn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device=CPU)
    seen = []
    n, used = sample_segmentation.run(
        streams(frames), CPU, model=model,
        on_batch=lambda b, i, c: seen.append(((b, c), i)))
    assert used is model and n == N_STREAMS * N_FRAMES
    batch, ids = held([(b, i) for (b, _), i in seen])
    want = reference(frames, 224, 224, out_dtype=jnp.float32)[ids]
    close_to_jax(batch, want)
    assert torch.equal(batch, expected(frames, 224, 224,
                                       out_dtype=torch.float32)[ids])
    classes = torch.cat([c for (_, c), _ in seen])
    _histograms_agree(classes.numpy(), np.asarray(
        ref_fcn.predict_classes(params, jnp.asarray(want))))
    assert torch.equal(classes, fcn.predict_classes(model, batch))


def test_multichip_run_on_in_memory_streams(frames):
    from vali_tpu_torch.samples import sample_multichip

    seen = []
    done = sample_multichip.run(
        streams(frames) + streams(frames)[:1], CPU, 4, 2,
        on_batch=lambda b, i: seen.append((b, i)))
    assert done == 2
    for batch, ids in seen:
        assert batch.shape == (8, 224, 224, 3) and len(batch.shards) == 4
        rows = [i % N_STREAMS for i in ids]
        close_to_jax(batch.gather(CPU), reference(frames, 224, 224)[rows])
        assert torch.equal(batch.gather(CPU),
                           expected(frames, 224, 224)[rows])


@pytest.fixture(scope="module")
def clip7(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("multichip") / "c.mp4")
    return synthesize_clip(path, 96, 64, n=7, chroma="sweep")


def test_multichip_run_matches_the_jax_pipeline_on_a_mesh(clip7):
    """One clip of 7 frames over two positions in batches of 4: the
    second batch is the end-of-stream tail of 3 frames, split 2 + 1."""
    from vali_tpu_torch.samples import sample_multichip

    seen = []
    assert sample_multichip.run([clip7], CPU, 2, 2,
                                on_batch=lambda b, i: seen.append((b, i)))\
        == 2
    ref = [(np.asarray(b), list(i)) for b, i in JaxPipeline(
        [clip7], 224, 224, gpu_id=0, batch_size=4,
        mesh=ref_mesh.make_mesh(2, 1, jax.devices()[:2]))]
    assert [list(i) for _, i in seen] == [i for _, i in ref] == [
        [0] * 4, [0] * 3]
    for (batch, _), (want, _) in zip(seen, ref):
        close_to_jax(batch.gather(CPU), want)
    rows = [sorted((s.index[0].start, s.index[0].stop)
                   for s in batch.shards) for batch, _ in seen]
    assert rows == [[(0, 2), (2, 4)], [(0, 2), (2, 3)]]


@pytest.mark.parametrize("n", [1, 3, 5])
def test_multichip_positions_repeat_the_device(n):
    from vali_tpu_torch.samples.sample_multichip import positions

    assert positions(CPU, n) == [CPU] * n
