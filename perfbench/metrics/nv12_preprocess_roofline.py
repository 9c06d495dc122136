"""nv12_preprocess_roofline: the fused preprocess kernel on NV12 frames,
percent of its roofline: the tensor-core route of uint8 -> uint8 batches
(csrc/nv12_wgmma_preprocess.cu) or the banded FMA kernel of every other
call (csrc/banded_preprocess.cu, layout 0), whichever the batch takes.

Work of a uint8 -> uint8 batch: each 4:2:0 frame read once, the RGB
output written once; the H pass's taps over every luma and chroma column,
the W pass's taps and the colour tail (21 operations a pixel), one FMA
being two operations."""

import re

from perfbench import roofline
from perfbench.reference import lanczos

KERNEL = re.compile(r"preprocess_kernel<[^()]*,\s*0>")
LAUNCHES_PER_CALL = 1
CSC_OPS = 21


def work(config, traffic):
    """(bytes, operations) of one call."""
    b, rs = traffic["batch"], config["resample"]
    h, w, dh, dw = (config[k] for k in ("height", "width", "dst_height",
                                        "dst_width"))
    sx, sy = config["chroma_site"]
    taps = lanczos.band_taps
    luma_h = taps(lanczos.plane_weights(h, dh, rs))
    luma_w = taps(lanczos.plane_weights(w, dw, rs))
    chroma_h = taps(lanczos.chroma_weights(h // 2, dh, h, sy, rs))
    chroma_w = taps(lanczos.chroma_weights(w // 2, dw, w, sx, rs))
    fmas = (luma_h * w + 2 * chroma_h * (w // 2)
            + dh * (luma_w + 2 * chroma_w))
    nbytes = b * (h * w + 2 * (h // 2) * (w // 2) + 3 * dh * dw)
    return nbytes, b * (2 * fmas + CSC_OPS * dh * dw)


def read(sl):
    return roofline.share(sl, KERNEL, LAUNCHES_PER_CALL,
                          *work(sl.config, sl.traffic),
                          "nv12_preprocess_roofline")
