"""vali_tpu_torch: the PyTorch + CUDA port of vali-tpu.

Same public names and module layout as ``vali_tpu``, on PyTorch tensors
with an explicit ``torch.device``; the TPU kernels are hand-written CUDA
kernels for Hopper (``csrc/``), built from source at first use. This
package imports torch and numpy, never JAX or ``vali_tpu``.
"""

__version__ = "0.1.0"

from .core.enums import (  # noqa: F401
    NO_PTS,
    ColorRange,
    ColorSpace,
    DecodeMode,
    DLDeviceType,
    FfmpegLogLevel,
    NV_ENC_CAPS,
    PixelFormat,
    SeekMode,
    TaskExecInfo,
    TaskExecStatus,
)
from .core.details import (  # noqa: F401
    MOTION_VECTOR_DTYPE,
    ColorspaceConversionContext,
    MotionVector,
    PacketData,
    SeekContext,
    StreamParams,
    TaskExecDetails,
)
from .utils.device import num_devices  # noqa: F401

# Enum members re-exported at module level, matching the reference's
# pybind11 export style.
for _enum in (PixelFormat, ColorSpace, ColorRange, TaskExecInfo, DecodeMode,
              FfmpegLogLevel, NV_ENC_CAPS, DLDeviceType):
    for _m in _enum:
        if _m.name not in globals():
            globals()[_m.name] = _m
del _enum, _m


def GetNumGpus() -> int:
    """Number of CUDA devices (parity: reference GetNumGpus)."""
    return num_devices()


_LAZY = {
    "Surface": ".memory.surface",
    "SurfacePlane": ".memory.surface",
    "CudaBuffer": ".memory.surface",
    "CudaStreamEvent": ".utils.device",
    "PySurfaceConverter": ".transforms",
    "PySurfaceResizer": ".transforms",
    "PySurfaceRotator": ".transforms",
    "PySurfaceUD": ".transforms",
    "PyFrameUploader": ".transforms",
    "PySurfaceDownloader": ".transforms",
    "PyDecoder": ".engine.decoder",
    "BufferedReader": ".engine.decoder",
    "SetFFMpegLogLevel": ".engine.decoder",
    "GetNvencParams": ".engine.encoder",
    "PyFrameConverter": ".engine.frame_converter",
    "PyNvEncoder": ".engine.encoder",
    "PyMuxer": ".engine.muxer",
    "PyNvJpegEncoder": ".engine.jpeg",
    "NvJpegEncodeContext": ".engine.jpeg",
    "MultiStreamPipeline": ".pipeline.multistream",
}


def __getattr__(name):
    mod_path = _LAZY.get(name)
    if mod_path is None:
        raise AttributeError(
            f"module 'vali_tpu_torch' has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(mod_path, __name__)
    val = getattr(mod, name)
    globals()[name] = val
    return val


def __dir__():
    return sorted(set(list(globals().keys()) + list(_LAZY.keys())))
