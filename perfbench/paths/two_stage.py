"""Path: ``vali_tpu_torch.ops.csc.convert_batch`` (NV12 -> packed RGB at
full size, the ``nv12_to_rgb`` kernel on a card), then
``vali_tpu_torch.ops.resize.resize_batch`` (packed RGB -> the destination
size, the ``packed_resize`` kernel): the route of code written against
VALI's PySurfaceConverter and PySurfaceResizer."""

from __future__ import annotations

REFERENCE = "convert_resize"
OUTPUTS = ("rgb", "small")


def entry(config: dict, traffic: dict):
    """The call the window makes on each batch's planes."""
    if traffic["format"] != "NV12":
        raise ValueError("the two-stage path converts NV12 frames")
    from vali_tpu_torch.core.details import ColorspaceConversionContext
    from vali_tpu_torch.core.enums import ColorRange, ColorSpace, PixelFormat
    from vali_tpu_torch.ops.csc import convert_batch
    from vali_tpu_torch.ops.resize import resize_batch

    w, h = config["width"], config["height"]
    dw, dh = config["dst_width"], config["dst_height"]
    cc = ColorspaceConversionContext(ColorSpace[config["color_space"]],
                                     ColorRange[config["color_range"]])
    method = config["method"]

    def call(planes):
        rgb = convert_batch(planes, PixelFormat.NV12, PixelFormat.RGB, w, h,
                            cc)
        return rgb[0], resize_batch(rgb, PixelFormat.RGB, w, h, dw, dh,
                                    method=method)[0]
    return call
