"""Frame source ``yuv420``: a traffic mix's file of parameters and a
configuration -> a ring of distinct device-resident batches of 4:2:0
8-bit frames (NV12 or I420), made on the device from the seed.

The ring stands in for a decoder's surface pool: batch i of a run is
ring slot i mod ``ring``. Each plane is a seeded smooth field (seeded
values on a grid of ``content.cell_px`` samples, interpolated) plus
seeded noise of +-``content.noise``, so that a misplaced tap, row or
plane shows in the output. The same seed, sizes and device give the same
frames.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

#: frame formats the generator makes, with their storage layout:
#: NV12 [B, H*3/2, W] (Y rows, then U/V interleaved rows), I420 one
#: [B, H*W*3/2] buffer carved into Y [B, H, W], U and V [B, H/2, W/2]
FORMATS = ("NV12", "I420")


def _field(g: torch.Generator, b: int, h: int, w: int, cell: int,
           noise: int, device: torch.device) -> torch.Tensor:
    """[b, h, w] uint8: a smooth seeded field plus seeded noise."""
    coarse = torch.randint(0, 256, (b, 1, -(-h // cell) + 1,
                                    -(-w // cell) + 1), generator=g,
                           device=device, dtype=torch.uint8)
    smooth = F.interpolate(coarse.float(), size=(h, w), mode="bilinear",
                           align_corners=False)[:, 0]
    jitter = torch.randint(-noise, noise + 1, (b, h, w), generator=g,
                           device=device, dtype=torch.int16)
    return (smooth.round_() + jitter).clamp_(0, 255).to(torch.uint8)


def make_batch(g: torch.Generator, fmt: str, b: int, h: int, w: int,
               content: dict, device: torch.device
               ) -> Tuple[torch.Tensor, ...]:
    """One batch of ``b`` frames of ``fmt``, as its planes."""
    cell, noise = int(content["cell_px"]), int(content["noise"])
    y = _field(g, b, h, w, cell, noise, device)
    u, v = (_field(g, b, h // 2, w // 2, cell, noise, device)
            for _ in range(2))
    if fmt == "NV12":
        frames = torch.empty((b, h * 3 // 2, w), dtype=torch.uint8,
                             device=device)
        frames[:, :h] = y
        uv = frames[:, h:].view(b, h // 2, w // 2, 2)
        uv[..., 0], uv[..., 1] = u, v
        return (frames,)
    if fmt == "I420":
        flat = torch.empty((b, h * w * 3 // 2), dtype=torch.uint8,
                           device=device)
        c = h * w // 4
        planes = (flat[:, :h * w].view(b, h, w),
                  flat[:, h * w:h * w + c].view(b, h // 2, w // 2),
                  flat[:, h * w + c:].view(b, h // 2, w // 2))
        for dst, src in zip(planes, (y, u, v)):
            dst.copy_(src)
        return planes
    raise ValueError(f"unknown frame format {fmt!r}; known: {FORMATS}")


def make_ring(config: dict, traffic: dict, seed: int,
              device: torch.device) -> List[Tuple[torch.Tensor, ...]]:
    """``traffic["ring"]`` distinct batches of ``traffic["batch"]`` frames
    of the configuration's size, made from ``seed`` on ``device``."""
    if traffic["ring"] < traffic["inflight"] + 1:
        raise ValueError("the ring must hold more batches than are in flight")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return [make_batch(g, traffic["format"], traffic["batch"],
                       config["height"], config["width"], traffic["content"],
                       device)
            for _ in range(traffic["ring"])]
