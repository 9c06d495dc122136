"""Device selection.

Counterpart of ``vali_tpu/utils/device.py``: a VALI-style ``gpu_id`` maps
onto an explicit ``torch.device``. ``gpu_id >= 0`` names a CUDA card and
raises when there is none; ``-1`` is the host path, taken only when asked
for.
"""

from __future__ import annotations

import torch


def num_devices() -> int:
    """Number of CUDA devices (reference ``GetNumGpus``)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_device(gpu_id: int) -> torch.device:
    """Map a VALI-style gpu_id onto a torch.device (-1 = CPU)."""
    if gpu_id == -1:
        return torch.device("cpu")
    n = num_devices()
    if gpu_id < 0 or gpu_id >= n:
        raise RuntimeError(
            f"Invalid device id {gpu_id}; have {n} CUDA device(s)"
            + ("" if torch.cuda.is_available()
               else " (this PyTorch build or machine has no CUDA)"))
    return torch.device("cuda", gpu_id)


def kernel_platform_available(device) -> bool:
    """True when ``device`` runs the package's CUDA kernels: strictly a
    CUDA device. Counterpart of ``pallas_platform_available``."""
    return torch.device(device).type == "cuda"
