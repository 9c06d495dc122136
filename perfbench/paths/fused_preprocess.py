"""Path: ``vali_tpu_torch.pipeline.multistream.preprocess_batch``, the
fused convert + resize of a batch of 4:2:0 frames (NV12 or I420 planes)
into [B, dst_height, dst_width, 3] RGB. On a card it launches the banded
``nv12_preprocess`` or ``yuv420_preprocess`` kernel, once a batch."""

from __future__ import annotations

REFERENCE = "preprocess"
OUTPUTS = ("rgb",)


def entry(config: dict, traffic: dict):
    """The call the window makes on each batch's planes."""
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.pipeline.multistream import preprocess_batch

    fmt = {"NV12": PixelFormat.NV12, "I420": PixelFormat.YUV420}[
        traffic["format"]]
    w, h = config["width"], config["height"]
    dw, dh = config["dst_width"], config["dst_height"]
    space = ColorSpace[config["color_space"]]
    crange = ColorRange[config["color_range"]]
    method = config["method"]

    def call(planes):
        return (preprocess_batch(planes, fmt, w, h, dw, dh, space=space,
                                 crange=crange, method=method),)
    return call
