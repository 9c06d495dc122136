"""Device selection, streams and stream events.

Counterpart of ``vali_tpu/utils/device.py``: a VALI-style ``gpu_id`` maps
onto an explicit ``torch.device``. ``gpu_id >= 0`` names a CUDA card and
raises when there is none; ``-1`` is the host path, taken only when asked
for.

Streams are real CUDA streams here (the reference's ``CudaResMgr`` stream
cache, src/TC/src/CudaUtils.cpp:185-299): a :class:`Stream` wraps a
``torch.cuda.Stream``. Stream handles are raw ``cudaStream_t`` values, as
in the reference: ``None`` or 0 is the device's default stream, any other
integer a stream the caller owns (``torch.cuda.ExternalStream``), and an
op's ``Stream`` property hands its handle back in the same form.
:class:`CudaStreamEvent` is a ``torch.cuda.Event`` (reference VALI.cpp:
281-314). On the CPU every stream is a no-op ledger: host work is done
when the call returns.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Optional

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


def device_gpu_id(device) -> int:
    """The VALI-style gpu_id of a torch device: its card's index, or -1
    for the CPU (the inverse of :func:`get_device`)."""
    device = torch.device(device)
    return (device.index or 0) if device.type == "cuda" else -1


def kernel_platform_available(device) -> bool:
    """True when ``device`` runs the package's CUDA kernels: strictly a
    CUDA device. Counterpart of ``pallas_platform_available``."""
    return torch.device(device).type == "cuda"


class Stream:
    """A completion domain on one device.

    ``handle`` is the raw ``cudaStream_t`` on CUDA (0 for the default
    stream) and a ledger number on the CPU; ``torch_stream`` is the
    ``torch.cuda.Stream``, or None on the CPU."""

    __slots__ = ("handle", "device", "torch_stream")

    def __init__(self, handle: int, device: torch.device,
                 torch_stream: Optional[torch.cuda.Stream] = None):
        self.handle = int(handle)
        self.device = device
        self.torch_stream = torch_stream

    def context(self):
        """Make this the current stream inside the block (CUDA), after
        ordering it behind the work already queued on the caller's current
        stream, so an op never reads a plane before its producer wrote
        it."""
        if self.torch_stream is None:
            return contextlib.nullcontext()
        current = torch.cuda.current_stream(self.device)
        if current != self.torch_stream:
            self.torch_stream.wait_stream(current)
        return torch.cuda.stream(self.torch_stream)

    def synchronize(self) -> None:
        """Block until the work queued on this stream has finished."""
        if self.torch_stream is not None:
            self.torch_stream.synchronize()


_cpu_handles = itertools.count(1)


def get_stream(handle: Optional[int] = None, gpu_id: int = 0) -> Stream:
    """The stream of ``handle`` on ``gpu_id``: None or 0 = the device's
    default stream, any other integer a caller-owned ``cudaStream_t``."""
    device = get_device(gpu_id)
    if device.type != "cuda":
        return Stream(handle or 0, device)
    if not handle:
        ts = torch.cuda.default_stream(device)
    else:
        ts = torch.cuda.ExternalStream(int(handle), device=device)
    return Stream(ts.cuda_stream, device, ts)


def new_stream(gpu_id: int = 0) -> Stream:
    """A fresh stream on ``gpu_id`` (a new ledger number on the CPU)."""
    device = get_device(gpu_id)
    if device.type != "cuda":
        return Stream(next(_cpu_handles), device)
    ts = torch.cuda.Stream(device=device)
    return Stream(ts.cuda_stream, device, ts)


class CudaStreamEvent:
    """Event on a stream (API parity: reference VALI.cpp:281-314).

    ``Record()`` records the event on the stream (``cuEventRecord``);
    ``Wait()`` blocks the host until the work queued before the record has
    finished (``cuEventSynchronize``). Both are no-ops on the CPU."""

    def __init__(self, stream: int = 0, gpu_id: int = 0):
        self._stream = get_stream(stream, gpu_id)
        self._event = (torch.cuda.Event()
                       if self._stream.torch_stream is not None else None)

    def Record(self) -> None:
        """Record the event on the stream (parity: CudaStreamEvent Record)."""
        if self._event is not None:
            self._event.record(self._stream.torch_stream)

    def Wait(self) -> None:
        """Block until the recorded work has finished (parity:
        CudaStreamEvent Wait)."""
        if self._event is not None:
            self._event.synchronize()
