"""Detect shot boundaries in a clip with on-device analytics.

Decodes the luma planes, moves the clip to the device, scores every
frame transition there (blended SAD + histogram-L1, ops/analytics.py)
and prints the detected cuts plus per-shot exposure statistics: three
reductions over data already on the device, no per-frame host loop.

Usage: python -m vali_tpu_torch.samples.sample_scene_detection [video]
           [threshold] [--device cuda|cpu]
"""

import numpy as np
import torch

from . import clip_argument, command_line
from ..ops import analytics


def main(argv=None):
    device, args = command_line(argv, "sample_scene_detection")
    import vali_tpu_torch as vali

    threshold = float(args[1]) if len(args) > 1 else 0.3
    with clip_argument(args) as uri:
        dec = vali.PyDecoder(uri, {}, gpu_id=-1)
        w, h = dec.Width, dec.Height
        print(f"{uri}: {w}x{h} {dec.Format.name}, {dec.NumFrames} frames")

        # the luma plane is all the detector needs: skip the chroma copy.
        # Signal peak by format: P10/P12 planes are MSB-aligned uint16
        # (v16 = v10<<6, peak 65472); planar yuv420p10 is LSB (peak 1023).
        F = vali.PixelFormat
        if dec.Format in (F.P10, F.P12):
            dtype, peak = np.uint16, float(1023 << 6)
        elif dec.Format == F.YUV420_10bit:
            dtype, peak = np.uint16, 1023.0
        else:
            dtype, peak = np.uint8, 255.0
        frames = []
        buf = np.ndarray(dec.HostFrameSize, dtype=np.uint8)
        while dec.DecodeSingleFrame(buf)[0]:
            frames.append(buf.view(dtype)[:w * h].reshape(h, w).copy())
    clip = torch.from_numpy(np.stack(frames)).to(device)
    print(f"decoded {clip.shape[0]} luma planes")

    scores = analytics.scene_change_scores(clip, peak=peak).cpu().numpy()
    cuts = analytics.detect_scene_changes(clip, threshold=threshold,
                                          min_gap=3, peak=peak)
    print(f"max transition score {scores.max():.3f}, "
          f"median {np.median(scores):.3f}")
    print(f"cuts at frames: "
          f"{[int(c) for c in cuts] if len(cuts) else '(none)'}")

    # per-shot exposure stats
    bounds = [0, *cuts.tolist(), clip.shape[0]]
    mean = analytics.luma_stats_batch(clip)["mean"].cpu().numpy()
    for a, b in zip(bounds[:-1], bounds[1:]):
        print(f"shot [{a}:{b}): mean luma {mean[a:b].mean():.1f}")
    print("OK")


if __name__ == "__main__":
    main()
