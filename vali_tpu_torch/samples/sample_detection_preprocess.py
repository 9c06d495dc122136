"""Detection-serving preprocess: letterbox N streams to a fixed square
model input (YOLO convention: aspect-preserving resize, centred gray-114
canvas), with the geometry needed to map boxes back to source pixels.

Usage: python -m vali_tpu_torch.samples.sample_detection_preprocess
           [video] [n_streams] [input_size] [--device cuda|cpu]
"""

import time

from . import clip_argument, command_line, synchronize
from ..ops.fused import letterbox_params
from ..pipeline.multistream import MultiStreamPipeline
from ..utils.device import device_gpu_id


def run(sources, device, dst=640, on_batch=None):
    """Letterbox ``sources`` to ``dst`` x ``dst`` on ``device``;
    ``on_batch(batch, ids)`` sees every batch. Returns (frames, seconds,
    (content width, content height, left, top, scale))."""
    pipe = MultiStreamPipeline(sources, dst_w=dst, dst_h=dst,
                               gpu_id=device_gpu_id(device), letterbox=True)
    geometry = letterbox_params(pipe.src_w, pipe.src_h, dst, dst)
    iw, ih, left, top, scale = geometry
    print(f"source {pipe.src_w}x{pipe.src_h} -> content {iw}x{ih} at "
          f"(+{left},+{top}), scale {scale:.4f}")

    frames = 0
    t0 = time.perf_counter()
    pad_checked = False
    for batch, ids in pipe:
        frames += batch.shape[0]
        if on_batch is not None:
            on_batch(batch, ids)
        if not pad_checked:
            img = batch[0]
            bar = img[:top] if top else img[:, :left]
            if not bool((bar == 114).all()):
                raise RuntimeError("letterbox bars must be gray 114")
            pad_checked = True
            # a detector's xyxy output maps back with:
            #   src_xy = (box_xy - (left, top)) / scale
    synchronize(device)
    dt = time.perf_counter() - t0
    print(f"letterboxed {frames} frames to {dst}x{dst} in {dt:.2f}s "
          f"= {frames / dt:.1f} fps on {device}")
    return frames, dt, geometry


def main(argv=None):
    device, args = command_line(argv, "sample_detection_preprocess")
    n_streams = int(args[1]) if len(args) > 1 else 4
    dst = int(args[2]) if len(args) > 2 else 640
    with clip_argument(args) as uri:
        run([uri] * n_streams, device, dst)


if __name__ == "__main__":
    main()
