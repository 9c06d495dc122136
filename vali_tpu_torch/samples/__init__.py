"""The port's samples: one module for each script of ``samples/``.

Run each from the repository root with the arguments of the script of
the same name:

    python -m vali_tpu_torch.samples.<name> [arguments] [--device cuda|cpu]

A sample runs on the first CUDA card by default (``--device cuda:N``
names another card). Where the machine has no CUDA device it exits with
code 2 and the CLI's message, unless ``--device cpu`` asks for the CPU:
there is no quiet fallback. A sample that reads a clip and is given none
synthesises one (848x464, 96 frames, 30 fps) in a temporary directory
with the package's own encoder and muxer. The four pipeline samples
(``sample_multistream``, ``sample_detection_preprocess``,
``sample_segmentation``, ``sample_multichip``) keep their body in a
function that takes the pipeline's sources, so that in-memory streams
(``utils/synth.HostFrameSource``) can drive them without decode.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile


def command_line(argv, name):
    """(torch device, the other arguments) of a sample's command line.
    Exits with code 2 after a message when ``--device`` has no name or
    names no device of this machine."""
    from ..__main__ import _device, pop_device

    device_name, args = pop_device(sys.argv[1:] if argv is None else argv)
    if device_name is None:
        print(f"{name}: --device needs a name: cuda, cuda:N or cpu",
              file=sys.stderr)
        raise SystemExit(2)
    device = _device(device_name, name)
    if device is None:
        raise SystemExit(2)
    return device, args


@contextlib.contextmanager
def clip_argument(args, i=0):
    """``args[i]``, or a clip synthesised for the block's duration."""
    if len(args) > i:
        yield args[i]
        return
    from ..utils.synth import synthesize_clip

    with tempfile.TemporaryDirectory(prefix="vali_sample_") as tmp:
        yield synthesize_clip(os.path.join(tmp, "clip.mp4"))


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
