"""nv12_resize_roofline: the banded resize kernel on NV12
(csrc/banded_resize.cu: a luma launch at lane stride 1 and a chroma
launch at lane stride 2 a call), percent of its roofline.

Work of a uint8 batch: each NV12 frame read once and each output frame
written once; luma and the interleaved chroma resample as their own
images (chroma on the half grid, both channels of a pair), the H pass's
taps over every source lane and the W pass's over every output row, one
FMA being two operations."""

import re

from perfbench import roofline
from perfbench.reference import lanczos

KERNEL = re.compile(r"banded_resize_kernel<[^()]*,\s*[12]>")
LAUNCHES_PER_CALL = 2


def work(config, traffic):
    """(bytes, operations) of one call."""
    b, rs = traffic["batch"], config["resample"]
    h, w, dh, dw = (config[k] for k in ("height", "width", "dst_height",
                                        "dst_width"))
    taps = lanczos.band_taps
    luma_h = taps(lanczos.plane_weights(h, dh, rs))
    luma_w = taps(lanczos.plane_weights(w, dw, rs))
    chroma_h = taps(lanczos.plane_weights(h // 2, dh // 2, rs))
    chroma_w = taps(lanczos.plane_weights(w // 2, dw // 2, rs))
    fmas = (luma_h + chroma_h) * w + dh * luma_w + (dh // 2) * 2 * chroma_w
    nbytes = b * (h * 3 // 2 * w + (dh + dh // 2) * dw)
    return nbytes, 2 * b * fmas


def read(sl):
    return roofline.share(sl, KERNEL, LAUNCHES_PER_CALL,
                          *work(sl.config, sl.traffic),
                          "nv12_resize_roofline")
