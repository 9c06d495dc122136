"""Loader for the native engine extension.

The port shares the native demux/decode/encode engine with ``vali_tpu``:
the extension built from ``src/native`` into ``vali_tpu/_native*.so``. It
is loaded here by file path, so that ``vali_tpu`` (and with it JAX) is
never imported. If ``vali_tpu`` already loaded the extension in this
process, that module is reused. When the library is missing it is built
with ``setup.py build_ext --inplace`` (FFmpeg headers via pkg-config and
libjpeg are needed); a failure raises ImportError with the build's output
and is remembered.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import threading

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_native = None
_error: Exception | None = None
_lock = threading.Lock()


def load_native():
    # Fast path without the lock; the build path below must be
    # serialized — two threads racing `setup.py build_ext --inplace`
    # into the same build dir clobber each other's .o/.so files.
    if _native is not None:
        return _native
    with _lock:
        return _load_native_locked()


def _library_path():
    for suffix in importlib.machinery.EXTENSION_SUFFIXES:
        path = os.path.join(_REPO_ROOT, "vali_tpu", "_native" + suffix)
        if os.path.exists(path):
            return path
    return None


def _load(path: str):
    name = "vali_tpu_torch._native"
    loader = importlib.machinery.ExtensionFileLoader(name, path)
    spec = importlib.util.spec_from_file_location(name, path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    sys.modules[name] = mod
    return mod


def _load_native_locked():
    global _native, _error
    if _native is not None:
        return _native
    if _error is not None:
        raise ImportError(
            f"native engine unavailable: {_error}") from _error
    shared = sys.modules.get("vali_tpu._native")
    if shared is not None:
        _native = shared
        return _native
    path = _library_path()
    if path is None and os.path.exists(os.path.join(_REPO_ROOT, "setup.py")):
        try:
            subprocess.run(
                [sys.executable, "setup.py", "build_ext", "--inplace"],
                cwd=_REPO_ROOT, check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            _error = e
            detail = "\n".join(
                (e.stdout + e.stderr).splitlines()[-15:])
            raise ImportError(
                f"Failed to build the native engine: {e}\n{detail}") from e
        path = _library_path()
    if path is None:
        _error = ImportError("native engine library not found")
        raise _error
    try:
        _native = _load(path)
    except ImportError as e:
        _error = e
        raise
    return _native
