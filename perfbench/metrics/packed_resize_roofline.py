"""packed_resize_roofline: the banded resize kernel on packed RGB
(csrc/banded_resize.cu, lane stride 3), percent of its roofline.

Work of a uint8 batch: each [H, 3W] image read once, each [DH, 3DW]
written once; the H pass's taps over every source lane and the W pass's
over every output row, one FMA being two operations."""

import re

from perfbench import roofline
from perfbench.reference import lanczos

KERNEL = re.compile(r"banded_resize_kernel<[^()]*,\s*3>")
LAUNCHES_PER_CALL = 1
CHANNELS = 3


def work(config, traffic):
    """(bytes, operations) of one call."""
    b, rs = traffic["batch"], config["resample"]
    h, w, dh, dw = (config[k] for k in ("height", "width", "dst_height",
                                        "dst_width"))
    taps_h = lanczos.band_taps(lanczos.plane_weights(h, dh, rs))
    taps_w = lanczos.band_taps(lanczos.plane_weights(w, dw, rs))
    nbytes = b * CHANNELS * (h * w + dh * dw)
    return nbytes, 2 * b * CHANNELS * (taps_h * w + dh * taps_w)


def read(sl):
    return roofline.share(sl, KERNEL, LAUNCHES_PER_CALL,
                          *work(sl.config, sl.traffic),
                          "packed_resize_roofline")
