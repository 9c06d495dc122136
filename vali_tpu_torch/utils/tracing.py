"""Tracing scopes.

Counterpart of ``vali_tpu/utils/tracing.py`` and of the reference's NVTX
ranges (``NvtxMark`` RAII in every task Run(), reference
src/TC/inc/Tasks.hpp:32-59): every op body runs inside a
``torch.profiler.record_function`` scope, so it shows up in
``torch.profiler`` traces, and inside an NVTX range where CUDA is
available. Runtime-gated by env ``VALI_TPU_TRACE=0`` (default on).
"""

from __future__ import annotations

import contextlib
import os

import torch

_enabled = os.environ.get("VALI_TPU_TRACE", "1") not in ("0", "")


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


@contextlib.contextmanager
def op_scope(name: str):
    if not _enabled:
        yield
        return
    label = f"vali::{name}"
    with torch.profiler.record_function(label):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(label):
                yield
        else:
            yield
