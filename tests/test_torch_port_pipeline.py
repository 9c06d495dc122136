"""vali_tpu_torch decode and pipeline against vali_tpu on the CPU: host
frames from the shared native engine, MultiStreamPipeline batches and ids,
teardown, and device selection."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vali_tpu
from vali_tpu.pipeline.multistream import \
    MultiStreamPipeline as JaxPipeline
from vali_tpu_torch.core.formats import format_info
from vali_tpu_torch.engine.decoder import PyDecoder
from vali_tpu_torch.pipeline.multistream import MultiStreamPipeline
from vali_tpu_torch.utils.synth import HostFrameSource, synthesize_clip

NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clips") / "sweep.mp4")
    return synthesize_clip(path, 96, 64, n=6, chroma="sweep")


def _decode_all(dec):
    frames = []
    while True:
        frame = np.zeros(dec.HostFrameSize, np.uint8)
        ok, _ = dec.DecodeSingleFrame(frame)
        if not ok:
            return frames
        frames.append(frame)


def test_decoder_host_frames_match(clip):
    ours = PyDecoder(clip, {}, gpu_id=-1)
    ref = vali_tpu.PyDecoder(clip, {}, gpu_id=-1)
    assert (ours.Width, ours.Height, int(ours.Format), ours.HostFrameSize) \
        == (ref.Width, ref.Height, int(ref.Format), ref.HostFrameSize)
    assert ours.Format.name == "YUV420"  # software-decoded H.264
    a, b = _decode_all(ours), _decode_all(ref)
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def _collect(pipe):
    return [(np.asarray(batch), list(ids)) for batch, ids in pipe]


@pytest.mark.parametrize("mode", ["u8", "f32_norm", "letterbox"])
def test_pipeline_matches_jax(clip, mode):
    kw = {}
    if mode == "f32_norm":
        jkw, tkw = dict(out_dtype=jnp.float32, normalize=NORM), \
            dict(out_dtype=torch.float32, normalize=NORM)
    else:
        jkw, tkw = {}, {}
    if mode == "letterbox":
        kw = dict(letterbox=True, pad_value=90, planar=True)
    ours = _collect(MultiStreamPipeline(
        [clip] * 3, 64, 64, gpu_id=-1, sync_streams=True, **kw, **tkw))
    ref = _collect(JaxPipeline(
        [clip] * 3, 64, 64, gpu_id=0, sync_streams=True, **kw, **jkw))
    # drains to EOS: one batch per frame, every stream in each batch
    assert len(ours) == len(ref) == 6
    for (a, ida), (b, idb) in zip(ours, ref):
        assert ida == idb == [0, 1, 2]
        assert a.shape == b.shape
        if a.dtype == np.uint8:
            d = np.abs(a.astype(int) - b.astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3
        else:
            assert np.abs(a - b).max() <= 1e-5


def _frame_sources(clip, n):
    dec = PyDecoder(clip, {}, gpu_id=-1)
    frames = _decode_all(dec)
    return [HostFrameSource(frames, dec.Format, dec.Width, dec.Height)
            for _ in range(n)]


@pytest.mark.parametrize("sync", [True, False])
def test_pipeline_frame_sources_match_clip(clip, sync):
    """Decoder-object sources carrying a clip's decoded frames give the
    clip's batches; in arrival order every stream's frames stay in order."""
    ref = _collect(MultiStreamPipeline([clip] * 3, 64, 64, gpu_id=-1,
                                       sync_streams=True))
    ours = _collect(MultiStreamPipeline(
        _frame_sources(clip, 3), 64, 64, gpu_id=-1, sync_streams=sync,
        batch_size=2 if not sync else None))
    if sync:
        assert [ids for _, ids in ours] == [ids for _, ids in ref]
        for (a, _), (b, _) in zip(ours, ref):
            assert np.array_equal(a, b)
        return
    rows = {0: [], 1: [], 2: []}
    for batch, ids in ours:
        for row, sid in zip(batch, ids):
            rows[sid].append(row)
    for sid, got in rows.items():
        want = [b[sid] for b, _ in ref]
        assert len(got) == len(want) == 6
        assert all(np.array_equal(x, y) for x, y in zip(got, want))


def test_pipeline_frame_source_geometry_mismatch(clip):
    srcs = _frame_sources(clip, 1)
    info = format_info(srcs[0].Format)
    other = HostFrameSource(
        [np.zeros(info.host_size(32, 32), np.uint8)], srcs[0].Format, 32, 32)
    with pytest.raises(ValueError, match="differs from source 0"):
        MultiStreamPipeline(srcs + [other], 32, 32, gpu_id=-1)


def test_iterator_break_joins_workers(clip):
    """Abandoning the iterator (break without pipe.stop()) must still tear
    the pipeline down: decode workers unblocked and joined."""
    pipe = MultiStreamPipeline([clip] * 2, dst_w=32, dst_h=32, gpu_id=-1,
                               batch_size=2)
    for batch, ids in pipe:
        assert batch.shape == (2, 32, 32, 3)
        break
    for w in pipe._workers:
        w.join(timeout=10.0)
        assert not w.is_alive()


def test_gpu_id_needs_cuda(clip):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError):
        MultiStreamPipeline([clip], 32, 32, gpu_id=0)
    with pytest.raises(RuntimeError):
        PyDecoder(clip, {}, gpu_id=0)
