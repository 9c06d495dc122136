"""nv12_to_rgb_roofline: the NV12 -> packed RGB kernel
(csrc/nv12_to_rgb.cu: the staged block of csrc/convert_staged.cuh, or the
per-pixel kernel), percent of its roofline.

Work of a batch: each NV12 frame read once, [H, 3W] uint8 written once,
the colour conversion's 21 operations a pixel."""

import re

from perfbench import roofline

KERNEL = re.compile(r"convert_staged_kernel<|nv12_to_rgb_scalar")
LAUNCHES_PER_CALL = 1
CSC_OPS = 21


def work(config, traffic):
    """(bytes, operations) of one call."""
    b, h, w = traffic["batch"], config["height"], config["width"]
    return b * (h * 3 // 2 * w + 3 * h * w), b * CSC_OPS * h * w


def read(sl):
    return roofline.share(sl, KERNEL, LAUNCHES_PER_CALL,
                          *work(sl.config, sl.traffic),
                          "nv12_to_rgb_roofline")
