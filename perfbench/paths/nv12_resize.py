"""Path: ``vali_tpu_torch.ops.nv12_resize.nv12_resize``, NV12 frames ->
NV12 frames at the destination size (the banded ``nv12_resize`` kernel on
a card: a luma and a chroma launch a batch), the route PySurfaceResizer
takes for NV12."""

from __future__ import annotations

REFERENCE = "nv12_resize"
OUTPUTS = ("nv12",)


def entry(config: dict, traffic: dict):
    """The call the window makes on each batch's planes."""
    if traffic["format"] != "NV12":
        raise ValueError("the NV12 resize path takes NV12 frames")
    from vali_tpu_torch.ops.nv12_resize import nv12_resize

    w, h = config["width"], config["height"]
    dw, dh = config["dst_width"], config["dst_height"]
    method = config["method"]

    def call(planes):
        return (nv12_resize(planes[0], src_w=w, src_h=h, dst_w=dw, dst_h=dh,
                            method=method),)
    return call
