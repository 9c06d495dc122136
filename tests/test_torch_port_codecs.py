"""vali_tpu_torch's PyNvEncoder and PyMuxer against vali_tpu's: the same
numpy-seeded NV12 frames and settings go through both packages' encoders
(EncodeSingleFrame, then FlushSinglePacket) and give the same packets,
byte for byte, with and without ``append`` and with an SEI payload. Both
wrap the same native engine, so a difference is the wrapper's. Each
stream is then muxed by its package's PyMuxer, and the two files decode
through the port's PyDecoder to the same frames.

No test here bounds the codec's frame delay: when a packet first arrives
is the codec's business (the reference's own fixed-delay test is a known
red)."""

import numpy as np
import pytest

import vali_tpu as ref
import vali_tpu_torch as port
from vali_tpu.engine.muxer import PyMuxer as RefMuxer
from vali_tpu_torch.engine.decoder import PyDecoder
from vali_tpu_torch.engine.muxer import PyMuxer as PortMuxer

W, H, N = 128, 96, 10
SETTINGS = {"s": f"{W}x{H}", "bf": "0", "lookahead": "0", "gop": "4",
            "fps": "30"}
SEI = np.frombuffer(bytes(range(16)) + b"port sei payload", np.uint8)


@pytest.fixture(scope="module")
def frames():
    """N flat NV12 frames: a moving luma gradient with noise, smooth
    chroma."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(N):
        y = np.clip(16 + (xx + 3 * yy + 9 * i) % 200
                    + rng.integers(0, 12, (H, W)), 0, 255).astype(np.uint8)
        uv = np.empty((H // 2, W), np.uint8)
        uv[:, 0::2] = (64 + 4 * i + yy[:H // 2, 0::2]) % 256
        uv[:, 1::2] = (192 - 2 * i + xx[:H // 2, 0::2] // 4) % 256
        out.append(np.concatenate([y.reshape(-1), uv.reshape(-1)]))
    return out


def _encode(pkg, frames, append):
    """The packets of one encoder of ``pkg``: the SEI payload on the first
    frame; with ``append`` every packet of the encode calls goes into one
    growing array (one entry), then each flushed packet on its own."""
    enc = pkg.PyNvEncoder(SETTINGS, 0, None, pkg.PixelFormat.NV12)
    packets, grown = [], np.zeros(0, np.uint8)
    for i, f in enumerate(frames):
        pkt = grown if append else np.zeros(0, np.uint8)
        ok = enc.EncodeSingleFrame(f, pkt, sei=SEI if i == 0 else None,
                                   append=append)
        if ok and not append:
            packets.append(pkt.tobytes())
    if append:
        packets.append(grown.tobytes())
    while True:
        pkt = np.zeros(0, np.uint8)
        if not enc.FlushSinglePacket(pkt) or not pkt.size:
            break
        packets.append(pkt.tobytes())
    return packets


@pytest.mark.parametrize("append", [False, True])
def test_encoders_give_the_same_packets(frames, append):
    ours = _encode(port, frames, append)
    theirs = _encode(ref, frames, append)
    assert len(ours) == len(theirs)
    assert ours == theirs
    assert SEI.tobytes()[16:] in b"".join(ours)
    if not append:
        assert len(ours) == N   # one access unit per frame, bf=0


def _decode(path):
    dec = PyDecoder(path, {}, gpu_id=-1)
    assert (dec.Width, dec.Height) == (W, H)
    frame = np.zeros(dec.HostFrameSize, np.uint8)
    out = []
    while dec.DecodeSingleFrame(frame)[0]:
        out.append(frame.copy())
    return out


@pytest.mark.parametrize("ext", [".mp4", ".mkv"])
def test_muxed_streams_decode_to_the_same_frames(tmp_path, frames, ext):
    files = {}
    for name, pkg, muxer in (("port", port, PortMuxer),
                             ("ref", ref, RefMuxer)):
        packets = _encode(pkg, frames, append=False)
        path = str(tmp_path / f"{name}{ext}")
        with muxer(path, W, H, fps=30.0) as mux:
            for i, p in enumerate(packets):
                ok, info = mux.Mux(p, pts=i / 30.0, key=(i % 4 == 0))
                assert ok, (name, i, info)
        files[name] = path
    ours, theirs = _decode(files["port"]), _decode(files["ref"])
    assert len(ours) == len(theirs) == N
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)
    # the decoded frames are the encoded ones, up to the codec's loss
    err = np.abs(ours[3][:W * H].astype(int) - frames[3][:W * H].astype(int))
    assert err.mean() < 6
