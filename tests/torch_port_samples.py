"""What the two files of the port's sample tests share: the clip the
samples read and running a sample as a subprocess on the CPU."""

import os
import subprocess
import sys

import pytest

from conftest import has_reference_data, reference_data_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def CLIP(tmp_path_factory):
    """The reference's test clip where the checkout has it, else the same
    geometry (848x464, 96 frames, 30 fps) synthesised by the port."""
    if has_reference_data("test.mp4"):
        return reference_data_path("test.mp4")
    from vali_tpu_torch.utils.synth import synthesize_clip

    return synthesize_clip(
        str(tmp_path_factory.mktemp("port_samples") / "clip.mp4"))


def run_sample(name, *args, timeout=180):
    """``python -m vali_tpu_torch.samples.<name> *args --device cpu``
    from the repository root; its standard output, after asserting exit
    code 0."""
    proc = subprocess.run(
        [sys.executable, "-m", f"vali_tpu_torch.samples.{name}", *args,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    return proc.stdout
