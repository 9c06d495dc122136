"""End-to-end inference: multi-stream decode -> fused preprocess on the
card -> segmentation model, no host round trip after decode.

Analogue of the reference's sample_segmentation_cvcuda_interop.ipynb /
tests/test_TorchSegmentation.py: decoded frames are preprocessed into
float32 tensors on the device and flow straight into the port's FCN
(random bf16 weights from a seed).

Usage: python -m vali_tpu_torch.samples.sample_segmentation [video]
           [n_streams] [--device cuda|cpu]
"""

import torch

from . import clip_argument, command_line
from ..models import fcn
from ..pipeline.multistream import MultiStreamPipeline
from ..utils.device import device_gpu_id


def run(sources, device, model=None, on_batch=None):
    """Segment ``sources`` on ``device`` with ``model`` (default: the
    FCN with seeded random weights); ``on_batch(batch, ids, classes)``
    sees every batch. Returns (frames, the model)."""
    if model is None:
        model = fcn.init_params(device=device)
    pipe = MultiStreamPipeline(sources, dst_w=224, dst_h=224,
                               gpu_id=device_gpu_id(device),
                               out_dtype=torch.float32)
    frames = 0
    for batch, ids in pipe:
        classes = fcn.predict_classes(model, batch)
        frames += batch.shape[0]
        if on_batch is not None:
            on_batch(batch, ids, classes)
        if frames % 64 < batch.shape[0]:
            hist = torch.bincount(classes[0].reshape(-1),
                                  minlength=4)[:4].tolist()
            print(f"{frames} frames; classes[0] histogram head: {hist}")
    print(f"segmented {frames} frames from {len(sources)} streams on "
          f"{device}")
    return frames, model


def main(argv=None):
    device, args = command_line(argv, "sample_segmentation")
    n_streams = int(args[1]) if len(args) > 1 else 2
    with clip_argument(args) as uri:
        run([uri] * n_streams, device)


if __name__ == "__main__":
    main()
