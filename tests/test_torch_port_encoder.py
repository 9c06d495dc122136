"""vali_tpu_torch's PyNvEncoder Surface path against vali_tpu's: the same
numpy-seeded NV12 frames, held by port Surfaces on the CPU and by JAX
Surfaces on JAX's CPU device, go through EncodeSingleSurface (with an SEI
payload, ``sync`` and ``append``), Reconfigure (a bitrate change and a
forced IDR) and Flush, and give the same packets, byte for byte. Both wrap
the same native engine, so a difference is the wrapper's. The option
table, the capability table, Format and GetFrameSizeInBytes are equal too.

No test here bounds the codec's frame delay: when a packet first arrives
is the codec's business (the reference's own fixed-delay test is a known
red)."""

import numpy as np
import pytest
import torch

import vali_tpu as ref
import vali_tpu_torch as port
from vali_tpu_torch.core.formats import format_info
from vali_tpu_torch.memory.host import download_host_frame

W, H, N = 128, 96, 10
SETTINGS = {"s": f"{W}x{H}", "bf": "0", "lookahead": "0", "gop": "30",
            "fps": "30", "bitrate": "1M"}
SEI = np.frombuffer(bytes(range(16)) + b"port sei payload", np.uint8)


@pytest.fixture(scope="module")
def frames():
    """N flat NV12 frames: seeded noise over a moving gradient."""
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:H * 3 // 2, 0:W]
    return [((xx + 2 * yy + 5 * i) % 200 + rng.integers(0, 40, xx.shape))
            .astype(np.uint8).reshape(-1) for i in range(N)]


def _surface(pkg, frame, fmt="NV12"):
    kw = dict(gpu_id=-1) if pkg is port else {}
    return pkg.Surface.from_numpy(frame, pkg.PixelFormat[fmt], width=W,
                                  height=H, **kw)


def _encode(pkg, frames, append=False, sync=False, reconfigure=None):
    """(packets of the encode calls, bytes of Flush) of one encoder of
    ``pkg``: the SEI on frame 0; ``reconfigure`` (settings, force_idr) is
    applied before frame N // 2."""
    enc = pkg.PyNvEncoder(SETTINGS, 0, None, pkg.PixelFormat.NV12)
    packets, grown = [], np.zeros(0, np.uint8)
    for i, f in enumerate(frames):
        if reconfigure is not None and i == N // 2:
            assert enc.Reconfigure(*reconfigure)
        pkt = grown if append else np.zeros(0, np.uint8)
        ok = enc.EncodeSingleSurface(_surface(pkg, f), pkt,
                                     sei=SEI if i == 0 else None,
                                     sync=sync, append=append)
        if ok and not append:
            packets.append(pkt.tobytes())
    if append:
        packets.append(grown.tobytes())
    rest = np.zeros(0, np.uint8)
    enc.Flush(rest)
    return packets, rest.tobytes()


@pytest.mark.parametrize("append,sync", [(False, False), (True, False),
                                         (False, True)],
                         ids=["plain", "append", "sync"])
def test_surfaces_encode_to_the_reference_s_packets(frames, append, sync):
    ours = _encode(port, frames, append, sync)
    theirs = _encode(ref, frames, append, sync)
    assert ours == theirs
    assert SEI.tobytes()[16:] in b"".join(ours[0]) + ours[1]
    if not append:   # every frame comes out, in calls or in the flush
        assert len(ours[0]) >= 1 and ours[1]


@pytest.mark.parametrize("reconfigure", [
    ({"bitrate": "200k"}, False), ({}, True), ({"bitrate": "3M"}, True)],
    ids=["bitrate", "idr", "bitrate+idr"])
def test_reconfigure_gives_the_reference_s_packets(frames, reconfigure):
    ours = _encode(port, frames, reconfigure=reconfigure)
    assert ours == _encode(ref, frames, reconfigure=reconfigure)
    assert ours != _encode(port, frames)


def test_surface_and_host_frame_give_the_same_packets(frames):
    """EncodeSingleSurface downloads exactly the host frame
    EncodeSingleFrame takes."""
    enc = port.PyNvEncoder(SETTINGS, 0, None, port.PixelFormat.NV12)
    other = port.PyNvEncoder(SETTINGS, 0, None, port.PixelFormat.NV12)
    for f in frames:
        a, b = np.zeros(0, np.uint8), np.zeros(0, np.uint8)
        assert (enc.EncodeSingleSurface(_surface(port, f), a)
                == other.EncodeSingleFrame(f, b))
        assert a.tobytes() == b.tobytes()


def test_none_or_empty_surface_drains_one_packet(frames):
    out = []
    for pkg in (port, ref):
        enc = pkg.PyNvEncoder(SETTINGS, 0, None, pkg.PixelFormat.NV12)
        for f in frames[:4]:
            enc.EncodeSingleSurface(_surface(pkg, f), np.zeros(0, np.uint8))
        got = []
        for surf in (None, pkg.Surface(), None, None, None, None):
            pkt = np.zeros(0, np.uint8)
            got.append((enc.EncodeSingleSurface(surf, pkt), pkt.tobytes()))
        out.append(got)
    assert out[0] == out[1]


def test_a_mismatched_surface_raises(frames):
    enc = port.PyNvEncoder(SETTINGS, 0, None, port.PixelFormat.NV12)
    pkt = np.zeros(0, np.uint8)
    yuv = port.Surface.Make(port.PixelFormat.YUV420, W, H, gpu_id=-1)
    small = port.Surface.Make(port.PixelFormat.NV12, W // 2, H, gpu_id=-1)
    for surf in (yuv, small):
        with pytest.raises(RuntimeError, match="size/format"):
            enc.EncodeSingleSurface(surf, pkt)
    assert enc.EncodeSurface == enc.EncodeSingleSurface


def test_tables_and_sizes_are_the_reference_s():
    assert port.GetNvencParams() == ref.GetNvencParams()
    assert len(port.GetNvencParams()) > 10
    for fmt, s in (("NV12", SETTINGS),
                   ("YUV444", dict(SETTINGS, codec="h264")),
                   ("NV12", dict(SETTINGS, codec="hevc"))):
        a = port.PyNvEncoder(s, 0, None, port.PixelFormat[fmt])
        b = ref.PyNvEncoder(s, 0, None, ref.PixelFormat[fmt])
        assert a.Format.name == b.Format.name == fmt
        assert a.GetFrameSizeInBytes() == b.GetFrameSizeInBytes() == (
            format_info(a.Format).host_size(W, H))
        assert ({c.name: v for c, v in a.Capabilities.items()}
                == {c.name: v for c, v in b.Capabilities.items()})


@pytest.mark.parametrize("fmt", ["NV12", "P10", "YUV420", "YUV420_10bit",
                                 "RGB", "RGB_32F_PLANAR"])
def test_download_host_frame_is_the_flat_host_frame(fmt):
    info = format_info(port.PixelFormat[fmt])
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, info.host_size(W, H)).astype(np.uint8)
    surf = _surface(port, frame, fmt)
    out = download_host_frame(surf)
    assert out.dtype == np.uint8 and np.array_equal(out, frame)
    with pytest.raises(ValueError, match="empty"):
        download_host_frame(port.Surface())
    assert surf.device == torch.device("cpu")
