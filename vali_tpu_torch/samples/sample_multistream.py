"""The north-star pipeline: N concurrent streams -> batched fused
preprocess on the card (BASELINE.json config 5).

Usage: python -m vali_tpu_torch.samples.sample_multistream [video]
           [n_streams] [jpeg] [--device cuda|cpu]

With ``jpeg`` the batches are JPEG-encoded as well: the colour
conversion, DCT and quantisation on the device, the entropy coding on
the host.
"""

import time

from . import clip_argument, command_line, synchronize
from ..pipeline.multistream import MultiStreamPipeline
from ..utils.device import device_gpu_id

DST = 224


def run(sources, device, on_batch=None):
    """Stream ``sources`` through the pipeline to 224x224 on ``device``;
    ``on_batch(batch, ids)`` sees every batch. Returns (frames, seconds
    on the host clock, the device's work finished)."""
    pipe = MultiStreamPipeline(sources, dst_w=DST, dst_h=DST,
                               gpu_id=device_gpu_id(device))
    t0 = time.perf_counter()
    frames = 0
    for batch, ids in pipe:
        frames += batch.shape[0]
        if on_batch is not None:
            on_batch(batch, ids)
    synchronize(device)
    dt = time.perf_counter() - t0
    print(f"{len(sources)} streams: {frames} frames in {dt:.2f}s "
          f"= {frames / dt:.1f} fps end-to-end on {device}")
    return frames, dt


def run_jpeg(sources, device):
    """Config-5 variant: batched preprocess + device-assisted JPEG
    encode. Returns (JPEG byte arrays of the last batch, count,
    seconds)."""
    from ..core.enums import PixelFormat
    from ..engine.jpeg import jpeg_encode_device
    from ..memory.surface import Surface

    pipe = MultiStreamPipeline(sources, dst_w=DST, dst_h=DST,
                               gpu_id=device_gpu_id(device))
    total, blobs = 0, []
    t0 = time.perf_counter()
    for batch, ids in pipe:
        surfaces = [Surface.from_torch(batch[i], PixelFormat.RGB)
                    for i in range(batch.shape[0])]
        blobs = jpeg_encode_device(surfaces, quality=85)
        total += len(blobs)
    dt = time.perf_counter() - t0
    print(f"jpeg pipeline: {total} JPEGs in {dt:.2f}s "
          f"= {total / dt:.1f} jpeg/s (host entropy coding on {device})")
    return blobs, total, dt


def main(argv=None):
    device, args = command_line(argv, "sample_multistream")
    n_streams = int(args[1]) if len(args) > 1 else 8
    with clip_argument(args) as uri:
        if len(args) > 2 and args[2] == "jpeg":
            run_jpeg([uri] * n_streams, device)
        else:
            run([uri] * n_streams, device)


if __name__ == "__main__":
    main()
