"""``python -m vali_tpu_torch`` against ``python -m vali_tpu`` on the same
synthesised clip: ``probe`` and ``decode`` print the same lines (the
measured frame rate and seconds masked); ``transcode --device cpu`` hands
the encoder NV12 frames within 1 LSB on < 1e-3 of the samples of the JAX
CLI's loop (the turbo resize's bf16 sums, taken in another order, may land
on the other side of a rounding tie), and the two output files decode to
the same frame count and size, each frame within 40 dB PSNR of the other;
``bench --device cpu`` prints the bench's one JSON line (at reduced
sizes); without a card and without ``--device cpu`` transcode fails
rather than run on the CPU.

The ``cmd_*`` functions run in-process; the JAX CLI runs the Pallas
resize in interpret mode on the CPU, as its own tests do."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import vali_tpu as ref
import vali_tpu.__main__ as ref_cli
import vali_tpu_torch as port
import vali_tpu_torch.__main__ as port_cli
from vali_tpu_torch.utils.synth import synthesize_clip

W, H, N = 192, 112, 6
DST = "128x72"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return synthesize_clip(str(tmp_path_factory.mktemp("cli") / "in.mp4"),
                           W, H, n=N, chroma="sweep")


def _mask(text):
    """The lines with the measured seconds and frame rate masked."""
    return re.sub(r"in [0-9.]+s = [0-9.]+ fps", "in <s> = <fps>", text)


@pytest.mark.parametrize("cmd,args", [("probe", []), ("decode", []),
                                      ("decode", ["4"])])
def test_probe_and_decode_print_the_reference_s_lines(clip, capsys, cmd,
                                                      args):
    getattr(port_cli, f"cmd_{cmd}")([clip] + args)
    ours = capsys.readouterr().out
    getattr(ref_cli, f"cmd_{cmd}")([clip] + args)
    theirs = capsys.readouterr().out
    assert _mask(ours) == _mask(theirs)
    assert ours.count("\n") == (1 if cmd == "probe" else 2)
    if cmd == "decode":
        assert f"decoded {args[0] if args else N} frames" in ours


def _recording(monkeypatch, cls, frames, to_host):
    """Wrap ``cls.EncodeSingleSurface`` so every Surface it is handed is
    kept, as a flat host frame, in ``frames``."""
    encode = cls.EncodeSingleSurface

    def recorded(self, surface, *args, **kwargs):
        frames.append(to_host(surface))
        return encode(self, surface, *args, **kwargs)

    monkeypatch.setattr(cls, "EncodeSingleSurface", recorded)


def _decode(path):
    dec = port.PyDecoder(path, {}, gpu_id=-1)
    frame = np.zeros(dec.HostFrameSize, np.uint8)
    out = []
    while dec.DecodeSingleFrame(frame)[0]:
        out.append(frame.copy())
    return (dec.Width, dec.Height), out


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_transcode_on_the_cpu_matches_the_reference(clip, tmp_path,
                                                    monkeypatch, capsys):
    ours, theirs = [], []
    _recording(monkeypatch, port.PyNvEncoder, ours,
               lambda s: np.concatenate([p.numpy().reshape(-1)
                                         for p in s.plane_tensors()]))
    _recording(monkeypatch, ref.PyNvEncoder, theirs,
               lambda s: np.asarray(s.to_numpy()).reshape(-1).copy())
    out_port, out_ref = str(tmp_path / "port.h264"), str(tmp_path /
                                                          "ref.h264")
    assert port_cli.main(["transcode", clip, out_port, DST,
                          "--device", "cpu"]) == 0
    ref_cli.cmd_transcode([clip, out_ref, DST])
    printed = capsys.readouterr().out.splitlines()
    assert printed == [f"transcoded {N} frames -> {out_port}",
                       f"transcoded {N} frames -> {out_ref}"]
    dw, dh = (int(v) for v in DST.split("x"))
    assert len(ours) == len(theirs) == N
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (dw * dh * 3 // 2,)
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
    (size_a, frames_a), (size_b, frames_b) = _decode(out_port), _decode(
        out_ref)
    assert size_a == size_b == (dw, dh)
    assert len(frames_a) == len(frames_b) == N
    assert min(_psnr(a, b) for a, b in zip(frames_a, frames_b)) >= 40.0


def test_bench_runs_on_the_cpu(capsys, monkeypatch, clip):
    """bench --device cpu prints one JSON line with the six configs and
    exits 0, at reduced sizes, without importing the root bench.py or
    bench_configs.py (which import JAX): an import of them would raise
    here."""
    from vali_tpu_torch import bench, bench_configs

    monkeypatch.setitem(sys.modules, "bench", None)
    monkeypatch.setitem(sys.modules, "bench_configs", None)
    for name in ("clip_848", "clip_1080"):
        monkeypatch.setattr(bench_configs, name, lambda: clip)
    for name, value in dict(B=2, H=H, W=W, DST=32, STREAMS=2, INFER_BATCH=2,
                            TRANSCODE_SRC=(256, 144),
                            TRANSCODE_DST=(W, H)).items():
        monkeypatch.setattr(bench_configs, name, value)
    for name, value in dict(H4K=288, W4K=512, B4R=2, B4_DENSE=1, B4=1,
                            H2D_FRAMES=2).items():
        monkeypatch.setattr(bench, name, value)
    assert port_cli.main(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["device"] == "cpu" and line["value"] > 0
    assert list(line["configs"]) == [
        "1_sw_decode_cpu_convert", "5_pipeline_chipside",
        "2_tpu_two_stage_convert_resize",
        "4_decode_preprocess_inference_e2e", "3_transcode_4k_hevc",
        "5_pipeline_64x1080p_jpeg"]
    assert all(rec["value"] > 0 for rec in line["configs"].values())


def test_usage_and_bad_options(capsys):
    assert port_cli.main([]) == 1
    assert port_cli.main(["nope"]) == 1
    assert port_cli.main(["transcode", "--device"]) == 1
    assert "Commands:" in capsys.readouterr().out
    assert port_cli.main(["transcode", "a", "b", "--device", "tpu"]) == 2
    assert "--device must be" in capsys.readouterr().err


def test_transcode_without_a_card_fails(clip, tmp_path):
    """No option on a machine without CUDA: a clear message and a
    non-zero exit, never a run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = tmp_path / "out.h264"
    res = subprocess.run(
        [sys.executable, "-m", "vali_tpu_torch", "transcode", clip,
         str(out), DST], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert not out.exists()
