"""vali_tpu_torch's PyDecoder against vali_tpu's on the same synthesised
clip (256x144, 12 frames, sweep chroma, Matroska): every property, Probe,
Metadata, Stats, DisplayRotation, motion vectors, KEY_FRAMES mode, a
BufferedReader over a file object, and the Surface path
(DecodeSingleSurface / DecodeSingleSurfaceAsync, seeks through a
SeekContext) into CPU Surfaces (``device=cpu``) against the JAX package's
Surfaces on its CPU device. Both wrap the same native engine, so planes and
packet data must be equal, bit for bit.

One difference is on purpose: the port writes the decoded frame into the
Surface's planes in place (VALI's own semantics), where the JAX package
swaps new arrays into the Surface because JAX arrays are immutable. So a
torch view of a plane taken before the decode sees the new frame.
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import vali_tpu as ref
import vali_tpu_torch as port
from vali_tpu_torch.core.formats import format_info
from vali_tpu_torch.engine.decoder import STAGING_SLOTS, StagingRing
from vali_tpu_torch.memory.host import host_frame_to_planes, upload_host_frame
from vali_tpu_torch.utils.device import get_stream
from vali_tpu_torch.utils.synth import synthesize_clip

W, H, N = 256, 144, 12
CPU = torch.device("cpu")
PROPERTIES = ["Width", "Height", "Level", "Profile", "Delay", "GopSize",
              "Bitrate", "NumFrames", "NumStreams", "StreamIndex",
              "HostFrameSize", "Framerate", "AvgFramerate", "Timebase",
              "StartTime", "Duration", "ColorSpace", "ColorRange", "Format",
              "IsVFR", "IsAccelerated", "Mode", "DisplayRotation"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return synthesize_clip(str(tmp_path_factory.mktemp("dec") / "c.mkv"),
                           W, H, n=N, chroma="sweep")


def _plain(v):
    """An enum as its (name, value), so the two packages' enums compare."""
    return (v.name, int(v)) if isinstance(v, enum.Enum) else v


def _host_frames(pkg, clip, opts=None):
    dec = pkg.PyDecoder(clip, opts or {}, gpu_id=-1)
    frame = np.zeros(dec.HostFrameSize, np.uint8)
    out = []
    while dec.DecodeSingleFrame(frame)[0]:
        out.append(frame.copy())
    return dec, out


def _surfaces(clip, n, async_=False, seek=None):
    """{"port" / "ref": (planes, packet data) of each of the first ``n``
    frames decoded into a Surface (after a seek when given)}."""
    pdec = port.PyDecoder(clip, {}, gpu_id=0, device=CPU)
    rdec = ref.PyDecoder(clip, {}, gpu_id=0)
    out = {"port": ([], []), "ref": ([], [])}
    for pkg, dec, name in ((port, pdec, "port"), (ref, rdec, "ref")):
        mk = dict(device=CPU) if pkg is port else {}
        surf = pkg.Surface.Make(dec.Format, dec.Width, dec.Height, **mk)
        run = (dec.DecodeSingleSurfaceAsync if async_
               else dec.DecodeSingleSurface)
        for i in range(n):
            pkt = pkg.PacketData()
            args = (surf, pkt) if not (seek and i == 0) else (
                surf, pkt, pkg.SeekContext(seek_frame=seek))
            ok, info = run(*args)
            assert ok and info.name == "SUCCESS", (name, i, info)
            if pkg is port:
                planes = [p.numpy().copy() for p in surf.plane_tensors()]
            else:
                planes = [np.asarray(a).copy() for a in surf.plane_arrays()]
            out[name][0].append(planes)
            out[name][1].append(dataclasses.asdict(pkt))
    return out


@pytest.mark.parametrize("name", PROPERTIES)
def test_properties_are_the_reference_s(clip, name):
    decs = [pkg.PyDecoder(clip, {}, gpu_id=-1) for pkg in (port, ref)]
    ours, theirs = (_plain(getattr(d, name)) for d in decs)
    assert ours == theirs
    frame = np.zeros(decs[0].HostFrameSize, np.uint8)
    for d in decs:   # and after three frames
        for _ in range(3):
            assert d.DecodeSingleFrame(frame)[0]
    assert _plain(getattr(decs[0], name)) == _plain(getattr(decs[1], name))


def test_probe_metadata_and_stats_are_the_reference_s(clip):
    def probe(pkg):
        return [{k: _plain(v) for k, v in dataclasses.asdict(sp).items()}
                for sp in pkg.PyDecoder.Probe(clip)]

    assert probe(port) == probe(ref) and len(probe(port)) == 1
    assert probe(port)[0]["width"] == W
    pdec, pframes = _host_frames(port, clip)
    rdec, rframes = _host_frames(ref, clip)
    assert len(pframes) == len(rframes) == N
    assert all(np.array_equal(a, b) for a, b in zip(pframes, rframes))
    assert pdec.Metadata == rdec.Metadata
    assert pdec.Stats == rdec.Stats and pdec.Stats["num_frm_recv"] == N
    assert pdec.DisplayRotation == rdec.DisplayRotation
    assert isinstance(pdec.Stream, int)


@pytest.fixture(scope="module")
def moving_clip(tmp_path_factory):
    """6 frames of seeded noise scrolling 4 pixels a frame: the P frames
    carry motion vectors (the gradient clip's do not)."""
    from vali_tpu_torch.engine.muxer import PyMuxer

    rng = np.random.default_rng(5)
    tex = rng.integers(16, 236, (H, W + 64)).astype(np.uint8)
    enc = port.PyNvEncoder({"s": f"{W}x{H}", "bf": "0", "lookahead": "0",
                            "fps": "30"}, 0, None, port.PixelFormat.NV12)
    uv = np.full(W * H // 2, 128, np.uint8)
    packets, pkt = [], np.zeros(0, np.uint8)
    for i in range(6):
        y = np.ascontiguousarray(tex[:, 4 * i:4 * i + W]).reshape(-1)
        if enc.EncodeSingleFrame(np.concatenate([y, uv]), pkt):
            packets.append(pkt.tobytes())
    while enc.FlushSinglePacket(pkt) and pkt.size:
        packets.append(pkt.tobytes())
    path = str(tmp_path_factory.mktemp("mv") / "moving.mkv")
    with PyMuxer(path, W, H, fps=30.0) as mux:
        for i, p in enumerate(packets):
            assert mux.Mux(p, pts=i / 30.0)[0]
    return path


def test_motion_vectors_are_the_reference_s(moving_clip):
    opts = {"flags2": "+export_mvs"}
    decs = [pkg.PyDecoder(moving_clip, opts, gpu_id=-1)
            for pkg in (port, ref)]
    frame = np.zeros(decs[0].HostFrameSize, np.uint8)
    seen = 0
    for _ in range(6):
        for d in decs:
            assert d.DecodeSingleFrame(frame)[0]
        ours, theirs = (d.MotionVectors for d in decs)
        assert ours.dtype == port.MOTION_VECTOR_DTYPE
        assert ours.dtype.descr == theirs.dtype.descr
        assert ours.tobytes() == theirs.tobytes()
        seen += ours.size
    assert seen > 0
    ours["motion_x"] //= np.maximum(ours["motion_scale"], 1)  # writable


def test_key_frames_mode(clip):
    out = []
    for pkg in (port, ref):
        dec = pkg.PyDecoder(clip, {}, gpu_id=-1)
        dec.SetMode(pkg.DecodeMode.KEY_FRAMES)
        assert dec.Mode.name == "KEY_FRAMES"
        frame = np.zeros(dec.HostFrameSize, np.uint8)
        frames = []
        while dec.DecodeSingleFrame(frame)[0]:
            frames.append(frame.copy())
        out.append(frames)
    assert 1 <= len(out[0]) == len(out[1]) < N
    assert all(np.array_equal(a, b) for a, b in zip(*out))


def test_buffered_reader_over_a_file_object(clip):
    _, by_url = _host_frames(port, clip)
    with open(clip, "rb") as f:
        dec = port.PyDecoder(port.BufferedReader(f), {}, gpu_id=-1)
        frame = np.zeros(dec.HostFrameSize, np.uint8)
        frames = []
        while dec.DecodeSingleFrame(frame)[0]:
            frames.append(frame.copy())
    assert len(frames) == N
    assert all(np.array_equal(a, b) for a, b in zip(frames, by_url))
    with pytest.raises(TypeError):
        port.BufferedReader(object())


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_decode_into_surfaces_is_the_reference_s(clip, async_):
    """Every frame decoded into a CPU Surface: planes bit-equal to JAX's,
    packet data equal, and equal to the host-frame decode."""
    out = _surfaces(clip, N, async_)
    (pp, pk), (rp, rk) = out["port"], out["ref"]
    _, host = _host_frames(port, clip)
    for i in range(N):
        assert len(pp[i]) == len(rp[i]) == 3          # YUV420
        for a, b in zip(pp[i], rp[i]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        want = host_frame_to_planes(host[i], port.PixelFormat.YUV420, W, H)
        assert all(np.array_equal(a, b) for a, b in zip(pp[i], want))
    assert pk == rk and pk[0]["key"] == 1


def test_seek_into_a_surface_is_the_reference_s(clip):
    out = _surfaces(clip, 3, seek=7)
    for ours, theirs in zip(out["port"][0], out["ref"][0]):
        assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    assert out["port"][1] == out["ref"][1]
    _, host = _host_frames(port, clip)
    want = host_frame_to_planes(host[7], port.PixelFormat.YUV420, W, H)
    assert all(np.array_equal(a, b) for a, b in zip(out["port"][0][0], want))
    # a SeekContext in the packet-data slot is taken as the seek
    dec = port.PyDecoder(clip, {}, gpu_id=0, device=CPU)
    surf = port.Surface.Make(port.PixelFormat.YUV420, W, H, device=CPU)
    assert dec.DecodeSingleSurfaceAsync(
        surf, port.SeekContext(seek_frame=7))[0]
    assert all(np.array_equal(p.numpy(), w)
               for p, w in zip(surf.plane_tensors(), want))


def test_a_rejected_surface_consumes_no_frame(clip):
    dec = port.PyDecoder(clip, {}, gpu_id=0, device=CPU)
    F = port.PixelFormat
    small = port.Surface.Make(F.YUV420, W // 2, H // 2, device=CPU)
    nv12 = port.Surface.Make(F.NV12, W, H, device=CPU)
    assert dec.DecodeSingleSurface(small) == (
        False, port.TaskExecInfo.SRC_DST_SIZE_MISMATCH)
    assert dec.DecodeSingleSurface(nv12) == (
        False, port.TaskExecInfo.SRC_DST_FMT_MISMATCH)
    assert dec.DecodeSingleSurface(port.Surface()) == (
        False, port.TaskExecInfo.INVALID_INPUT)
    assert dec.DecodeSingleSurface(None) == (
        False, port.TaskExecInfo.INVALID_INPUT)
    elsewhere = port.Surface.Make(F.YUV420, W, H,
                                  device=torch.device("meta"))
    assert dec.DecodeSingleSurface(elsewhere) == (
        False, port.TaskExecInfo.INVALID_INPUT)
    surf = port.Surface.Make(F.YUV420, W, H, device=CPU)
    assert dec.DecodeSingleSurface(surf) == (True,
                                            port.TaskExecInfo.SUCCESS)
    _, host = _host_frames(port, clip)
    want = host_frame_to_planes(host[0], F.YUV420, W, H)
    assert all(np.array_equal(p.numpy(), w)
               for p, w in zip(surf.plane_tensors(), want))


def test_each_path_refuses_the_other_s_call(clip):
    """The host-frame path returns (False, FAIL) for a Surface, the
    Surface path for a host frame; neither raises."""
    host = port.PyDecoder(clip, {}, gpu_id=-1)
    surf = port.Surface.Make(port.PixelFormat.YUV420, W, H, device=CPU)
    fail = (False, port.TaskExecInfo.FAIL)
    assert host.DecodeSingleSurface(surf) == fail
    assert host.DecodeSingleSurfaceAsync(surf) == fail
    dev = port.PyDecoder(clip, {}, gpu_id=0, device=CPU)
    assert dev.DecodeSingleFrame(np.zeros(1, np.uint8)) == fail


def test_a_view_taken_before_the_decode_sees_the_frame(clip):
    dec = port.PyDecoder(clip, {}, gpu_id=0, device=CPU)
    surf = port.Surface.Make(port.PixelFormat.YUV420, W, H, device=CPU)
    luma = torch.from_dlpack(surf.Planes[0])
    planes = surf.plane_tensors()
    assert int(luma.max()) == 0
    assert dec.DecodeSingleSurface(surf)[0]
    _, host = _host_frames(port, clip)
    assert np.array_equal(luma.numpy(), host[0][:W * H].reshape(H, W))
    assert all(a is b for a, b in zip(planes, surf.plane_tensors()))


def test_the_surface_path_needs_a_card_or_a_device(clip):
    with pytest.raises(ValueError, match="host-frame"):
        port.PyDecoder(clip, {}, gpu_id=-1, device=CPU)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.PyDecoder(clip, {}, gpu_id=0)


def test_the_ring_copies_only_a_frame_its_fill_wrote():
    """StagingRing.upload, the step DecodeSingleSurface takes after a
    decode: a fill's error code comes back and nothing is copied; a frame
    the fill writes lands in the Surface's own planes."""
    F = port.PixelFormat
    ring = StagingRing(CPU)
    assert ring.stream.device == CPU and ring.stream.torch_stream is None
    surf = port.Surface.Make(F.NV12, 64, 48, device=CPU)
    before = surf.plane_tensors()
    assert ring.upload(lambda buf: -3, F.NV12, 64, 48, surf) == -3
    assert all(int(p.max()) == 0 for p in before)
    frame = np.random.default_rng(5).integers(
        1, 256, format_info(F.NV12).host_size(64, 48)).astype(np.uint8)

    def fill(buf):
        buf[:] = frame
        return buf.nbytes
    assert ring.upload(fill, F.NV12, 64, 48, surf) == frame.size
    want = host_frame_to_planes(frame, F.NV12, 64, 48)
    for plane, w, b in zip(surf.plane_tensors(), want, before):
        assert plane is b and np.array_equal(plane.numpy(), w)


@pytest.mark.parametrize("fmt", ["NV12", "P10", "YUV420", "YUV420_10bit",
                                 "YUV444"])
def test_upload_host_frame_writes_the_planes_in_place(fmt):
    fmt = port.PixelFormat[fmt]
    info = format_info(fmt)
    rng = np.random.default_rng(int(fmt))
    frame = rng.integers(0, 256, info.host_size(64, 48)).astype(np.uint8)
    surf = port.Surface.Make(fmt, 64, 48, device=CPU)
    before = surf.plane_tensors()
    ring = StagingRing(CPU)
    stage = ring.take(frame.size)
    stage.numpy()[:] = frame
    assert upload_host_frame(stage, fmt, 64, 48, surf,
                             get_stream(None, -1)) is None
    want = host_frame_to_planes(frame, fmt, 64, 48)
    for plane, w, b in zip(surf.plane_tensors(), want, before):
        assert plane is b and plane.numpy().dtype == w.dtype
        assert np.array_equal(plane.numpy(), w)
    with pytest.raises(ValueError, match="does not fit"):
        upload_host_frame(stage, fmt, 32, 48, surf, get_stream(None, -1))


def test_the_staging_ring_waits_before_reusing_a_buffer():
    """A buffer is handed out again only after the event of the copy that
    read it has completed; a new size gets a new buffer."""
    class Event:
        def __init__(self):
            self.waited = 0

        def synchronize(self):
            self.waited += 1

    ring = StagingRing(CPU)
    events, bufs = [], []
    for i in range(STAGING_SLOTS):
        bufs.append(ring.take(100))
        events.append(Event())
        ring.guard(events[-1])
    assert len({id(b) for b in bufs}) == STAGING_SLOTS
    assert [e.waited for e in events] == [0] * STAGING_SLOTS
    assert ring.take(100) is bufs[0] and events[0].waited == 1
    ring.guard(None)
    assert ring.take(100) is bufs[1] and events[1].waited == 1
    grown = ring.take(200)
    assert events[2].waited == 1 and grown.numel() == 200
    for i in range(3, STAGING_SLOTS):
        assert ring.take(100) is bufs[i] and events[i].waited == 1
    assert ring.take(100) is bufs[0] and events[0].waited == 1
