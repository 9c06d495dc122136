"""Loader for the native engine extension.

The port's native demux/decode/encode engine is its own extension
module, ``vali_tpu_torch._native``, built from the repository's C++
engine (``src/native``) into ``build/vali_tpu_torch/native/`` at first
use (``engine/_native_build.py``) and loaded from there by file path.
It never reads the JAX package's extension. Both packages' extensions
may live in one process: each is dlopen'ed with ``RTLD_LOCAL`` and built
with hidden visibility, under its own module name, so their symbols and
state stay apart; they share the dlopen'ed libav libraries, so
``SetFFMpegLogLevel`` in one package sets FFmpeg's log level for both.
A failed build raises ImportError with the tail of the compiler's output,
and the failure is remembered.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import sys
import threading

from . import _native_build

MODULE = "vali_tpu_torch._native"
_native = None
_error: Exception | None = None
_lock = threading.Lock()


def load_native():
    """The engine's extension module, built and loaded on first use."""
    if _native is not None:
        return _native
    with _lock:
        return _load_native_locked()


def _load(path: str):
    loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
    spec = importlib.util.spec_from_file_location(MODULE, path,
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    sys.modules[MODULE] = mod
    return mod


def _load_native_locked():
    global _native, _error
    if _native is not None:
        return _native
    if _error is not None:
        raise ImportError(
            f"native engine unavailable: {_error}") from _error
    try:
        path = _native_build.build()
    except (RuntimeError, OSError) as e:
        _error = e
        lines = str(e).splitlines() or [repr(e)]
        raise ImportError(f"Failed to build the native engine: {lines[0]}\n"
                          + "\n".join(lines[-15:])) from e
    try:
        _native = _load(path)
    except ImportError as e:
        _error = e
        raise
    return _native
