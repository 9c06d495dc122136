"""The port's samples 1-8 (vali_tpu_torch/samples: device info, profile,
decode, seek, network decode, transcode, JPEG, torch interop), each run
as ``python -m vali_tpu_torch.samples.<name> ... --device cpu`` on the
clip tests/test_samples.py runs the JAX samples on, printing what that
file asserts of them; and every sample refusing to run without a CUDA
device unless ``--device cpu`` asks for the CPU."""

import importlib
import os
import subprocess
import sys

import pytest
import torch

from torch_port_samples import CLIP, REPO, run_sample  # noqa: F401

SAMPLES = ("get_device_info", "sample_profile", "sample_decode",
           "sample_seek", "sample_decode_from_network", "sample_transcode",
           "sample_jpeg", "sample_torch_interop", "sample_multistream",
           "sample_detection_preprocess", "sample_segmentation",
           "sample_multichip", "sample_scene_detection",
           "sample_hdr_tonemap")


def test_sample_device_info():
    out = run_sample("get_device_info")
    assert "accelerators:" in out
    assert "codec" in out


def test_sample_profile(tmp_path):
    out = run_sample("sample_profile", str(tmp_path), timeout=300)
    assert "trace" in out.lower()
    trace = (tmp_path / "trace.json").read_text()
    assert "vali::preprocess_batch" in trace


def test_sample_decode(CLIP):
    out = run_sample("sample_decode", CLIP)
    assert "decoded 96 frames" in out


def test_sample_seek(CLIP):
    out = run_sample("sample_seek", CLIP)
    assert "seek 1.5s" in out


def test_sample_network(CLIP):
    out = run_sample("sample_decode_from_network", CLIP)
    assert "decoded 60 frames" in out


def test_sample_transcode(tmp_path, CLIP):
    out_path = str(tmp_path / "out.h264")
    out = run_sample("sample_transcode", CLIP, out_path, "320", "180")
    assert "transcoded 96 frames" in out
    assert os.path.getsize(out_path) > 1000


def test_sample_jpeg(CLIP):
    out = run_sample("sample_jpeg", CLIP, "2")
    assert out.count(".jpg") >= 2


def test_sample_torch_interop(CLIP):
    out = run_sample("sample_torch_interop", CLIP, "2")
    assert "round trip OK" in out


def test_a_sample_without_a_card_exits_with_the_clis_message():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "vali_tpu_torch.samples.sample_profile"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "runs on a CUDA device" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("name", SAMPLES)
@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_every_sample_refuses_to_run_without_a_card(name, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    main = importlib.import_module(f"vali_tpu_torch.samples.{name}").main
    with pytest.raises(SystemExit) as exit_:
        main(argv)
    assert exit_.value.code == 2
    captured = capsys.readouterr()
    assert f"vali_tpu_torch: {name} runs on a CUDA device" in captured.err
    assert captured.out == ""


@pytest.mark.parametrize("argv", [["--device"], ["--device", "tpu"]])
def test_a_sample_refuses_a_malformed_device(argv, capsys):
    from vali_tpu_torch.samples import sample_profile

    with pytest.raises(SystemExit) as exit_:
        sample_profile.main(argv)
    assert exit_.value.code == 2
    assert "--device" in capsys.readouterr().err
