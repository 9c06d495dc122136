"""Build and load the package's CUDA kernels.

The kernels are CUDA C++ for Hopper (``csrc/*.cu``) with a plain C
interface, in two shared libraries: the product kernels (``_SOURCES``,
:func:`load_kernels`, under ``build/vali_tpu_torch_kernels/``) and the
labs' kernels (``_LAB_SOURCES``, :func:`load_lab_kernels`, under
``build/vali_tpu_torch_lab_kernels/``), so that a product wrapper's first
launch compiles no lab source. At first use each source of a library is
compiled by its own nvcc process, all started together, and the objects
are linked into the library beside the package, keyed by a hash of the
sources, headers and flags, under a file lock so concurrent processes
build once (``utils/_build.locked_build``); later calls load the cached
library with ``ctypes``. Importing the package never runs nvcc. A failed
build raises with the tail of nvcc's output.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import threading
from typing import List, Sequence

from ..utils._build import locked_build, source_key

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cuda_errors.cu (banded_error_string, which check() reads) goes into both
_SOURCES = ("csrc/banded_preprocess.cu", "csrc/nv12_wgmma_preprocess.cu",
            "csrc/banded_resize.cu", "csrc/nv12_to_rgb.cu",
            "csrc/cuda_errors.cu")
_LAB_SOURCES = ("csrc/nv12_variants.cu", "csrc/nv12_grouped.cu",
                "csrc/nv12_static2.cu", "csrc/nv12_staged.cu",
                "csrc/nv12_combo.cu", "csrc/nv12_prodlike.cu",
                "csrc/nv12_chains.cu",
                "csrc/nv12_aligned.cu", "csrc/nv12_phases.cu",
                "csrc/nv12_skewed.cu",
                "csrc/nv12_streamed.cu", "csrc/nv12_slabs.cu",
                "csrc/nv12_striped.cu",
                "csrc/nv12_to_rgb_variants.cu", "csrc/nv12_convert_staged.cu",
                "csrc/cuda_errors.cu")
_HEADERS = ("csrc/banded_common.cuh", "csrc/banded_preprocess.cuh",
            "csrc/wgmma_common.cuh", "csrc/aligned_passes.cuh",
            "csrc/aligned_block.cuh",
            "csrc/tma_common.cuh", "csrc/static2_passes.cuh",
            "csrc/convert_staged.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "vali_tpu_torch_kernels")
LAB_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                             "vali_tpu_torch_lab_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
# the preprocess launchers' planar heads, then the shared tail: batch,
# geometry, tables, taps, block geometry, CSC tail, compute, out, stream
_PREPROCESS = [_I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _IP, _FP, _I, _P,
               _I, _P]
_SIGNATURES = {
    "nv12_preprocess_launch": [_P, _I, _LL, _LL] + _PREPROCESS,
    # the frames, geometry, tail, S2's tables at 16 rows, out, stream
    "nv12_wgmma_preprocess_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _FP, _P, _P, _I, _I, _P, _P,
        _P, _P],
    "yuv420_preprocess_launch": [_P, _P, _P, _I] + [_LL] * 6 + _PREPROCESS,
    "yuv422_preprocess_launch": [_P, _P, _P] + [_LL] * 6 + _PREPROCESS,
    "yuv444_preprocess_launch": [_P, _P, _P] + [_LL] * 6 + _PREPROCESS,
    "plane_resize_launch": [
        _P, _I, _LL, _LL, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
        _I, _I, _I, _P, _LL, _LL, _P],
    "packed_resize_launch": [
        _P, _I, _LL, _LL, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
        _I, _I, _I, _P, _LL, _LL, _P],
    "nv12_resize_launch": [
        _P, _I, _LL, _LL, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
        _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "nv12_to_rgb_launch": [_P, _LL, _LL, _I, _I, _I, _I, _FP, _I, _P, _P,
                           _P],
}
# the product library's queries (int functions that launch nothing)
_QUERIES = {
    "nv12_to_rgb_tma_route": [_P, _LL, _LL, _I, _P],
}
_LAB_SIGNATURES = {
    "nv12_stream_floor_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    "nv12_grouped_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _FP,
        _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "nv12_static2_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _FP, _I, _P, _P, _I, _I, _P, _P,
        _P, _P],
    "nv12_staged_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _FP, _I, _I, _I, _P, _P, _I, _I,
        _P, _P, _P, _P],
    "nv12_staged_probe_launch": [_P, _I, _P, _I, _I, _I, _P, _P],
    "nv12_combo_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _FP, _I, _I, _P, _P, _I, _I,
        _P, _P, _P, _P],
    "nv12_chains_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _FP, _I, _I, _P, _P, _I, _I,
        _P, _P, _P, _P],
    "nv12_tchroma_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _FP, _I, _P, _P, _I, _I, _P, _P,
        _P, _P],
    "nv12_chains_probe_launch": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "nv12_prodlike_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _FP, _I, _I, _P, _P, _I, _I,
        _P, _P, _P, _P, _P],
    "nv12_convert_staged_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _FP, _I, _P, _P, _P],
    "nv12_convert_staged_probe_launch": [
        _P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    "nv12_convert_probe_launch": [
        _P, _LL, _LL, _I, _I, _I, _I, _FP, _I, _P, _I, _P, _P],
}
# the earlier CUDA-core NV12 resize lab's launchers (their A/Bs build them
# from an earlier checkout): frames, geometry, luma and chroma band
# tables, then each launcher's knobs, the output and the stream
_RESIZE_LAB = [_P, _LL, _LL, _I, _I, _I, _I, _I,
               _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I]
# lab kernel aligned: per plane B, starts, k_pad, ranges, their count, H
# columns, heads, fragments
_ALIGNED_PLANE = [_P, _P, _I, _P, _I, _I, _P, _P]
# lab kernel streamed: aligned's plane, then the ring's slots, the runs,
# the blocks' first runs and their count
_STREAMED_PLANE = _ALIGNED_PLANE + [_I, _P, _P, _I]
# lab kernel slabs: aligned's plane (B: the pieces' B_p), then the strips'
# first pieces, the pieces and B's blocks a strip
_SLABS_PLANE = _ALIGNED_PLANE + [_P, _P, _I]
# lab kernel striped: B, starts, k_pad, stripes, the most pixels a stripe
# holds, the widest tile band, the tiles' order, heads, fragments
_STRIPED_PLANE = [_P, _P, _I, _P, _I, _I, _P, _P, _P]
_LAB_SIGNATURES.update({
    "nv12_resize_aligned_launch": [_P, _LL, _LL, _I, _I, _I, _I, _I]
    + _ALIGNED_PLANE * 2 + [_P, _P],
    "nv12_resize_streamed_launch": [_P, _LL, _LL, _I, _I, _I, _I, _I]
    + _STREAMED_PLANE * 2 + [_I, _I, _P, _P],
    # aligned's planes, then the sink's partition per plane and h_only's
    # owned pixels, the mode, the sink, its words, the residency query
    "nv12_resize_phases_launch": [_P, _LL, _LL, _I, _I, _I, _I, _I]
    + _ALIGNED_PLANE * 2 + [_P] * 5 + [_I, _P, _I, _P, _P, _P],
    # aligned's planes, then the frames a block, the residency query
    "nv12_resize_skewed_launch": [_P, _LL, _LL, _I, _I, _I, _I, _I]
    + _ALIGNED_PLANE * 2 + [_I, _P, _P, _P],
    "nv12_resize_slabs_launch": [_P, _LL, _LL, _I, _I, _I, _I, _I]
    + _SLABS_PLANE * 2 + [_I, _P, _P],
    "nv12_resize_striped_launch": [_P, _LL, _LL, _I, _I, _I, _I, _I]
    + _STRIPED_PLANE * 2 + [_I, _I, _I, _P, _P, _P, _P],
})

_libs = {}
# one lock a library, so that the product's and the labs' build together
_locks = {"product": threading.Lock(), "lab": threading.Lock()}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of vali_tpu_torch are built from source at first use")


def _source_key(sources=_SOURCES) -> str:
    return source_key(NVCC_FLAGS, _PKG_DIR, sources + _HEADERS)


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"vali_kernels_{_source_key()}.so")


def lab_library_path() -> str:
    return os.path.join(LAB_BUILD_DIR,
                        f"vali_lab_kernels_{_source_key(_LAB_SOURCES)}.so")


def _load(which: str, sources: Sequence[str],
          signatures: dict) -> ctypes.CDLL:
    """Library ``which`` ("product" or "lab"), built from ``sources`` on
    first use, its launchers given their ctypes ``signatures``; loaded
    once a process (a wrapper's later calls hash no source)."""
    lib = _libs.get(which)
    if lib is not None:
        return lib
    with _locks[which]:
        if which in _libs:
            return _libs[which]
        path = library_path() if which == "product" else lab_library_path()
        if not os.path.exists(path):  # nvcc is needed only to build
            nvcc = [_nvcc(), *NVCC_FLAGS]
            locked_build(path, nvcc,
                         [os.path.join(_PKG_DIR, rel) for rel in sources],
                         [*nvcc, "-shared"])
        lib = ctypes.CDLL(path)
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.banded_error_string.argtypes = [ctypes.c_int]
        lib.banded_error_string.restype = ctypes.c_char_p
        _libs[which] = lib
        return lib


def load_kernels() -> ctypes.CDLL:
    """The product kernels' shared library, built on first use."""
    return _load("product", _SOURCES, {**_SIGNATURES, **_QUERIES})


def load_lab_kernels() -> ctypes.CDLL:
    """The labs' kernels' shared library, built on first use."""
    return _load("lab", _LAB_SOURCES, _LAB_SIGNATURES)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.banded_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def included_files(source: str, include_dirs: Sequence[str] = ()
                   ) -> List[str]:
    """``source`` and every file it includes with ``#include "..."``, at any
    depth, as absolute paths: each looked up beside the file that includes
    it, then in ``include_dirs``, as nvcc does."""
    found, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        with open(path) as f:
            names = _INCLUDE.findall(f.read())
        for name in names:
            for d in (os.path.dirname(path), *include_dirs):
                cand = os.path.abspath(os.path.join(d, name))
                if os.path.exists(cand):
                    todo.append(cand)
                    break
    return found


def build_source(source: str, subdir: str, tag: str, signatures: dict,
                 flags: Sequence[str] = (),
                 include_dirs: Sequence[str] = ()) -> ctypes.CDLL:
    """``source`` alone, built with ``flags`` into
    ``build/<subdir>/<tag>_<key>.so`` beside the package's kernels, and
    loaded with its launchers' ctypes ``signatures``. The key hashes the
    tools, the flags and every file the source includes
    (:func:`included_files`), so an edited header builds anew; the build
    runs under :func:`locked_build`'s lock. The labs' A/B builds (an earlier
    source, a build knob) go through it."""
    incs = [f"-I{os.path.abspath(d)}" for d in include_dirs]
    nvcc = [_nvcc(), *NVCC_FLAGS]
    files = included_files(source, include_dirs)
    key = source_key([*NVCC_FLAGS, *flags, *incs], "/", files)
    path = os.path.join(os.path.dirname(BUILD_DIR), subdir,
                        f"{tag}_{key}.so")
    locked_build(path, [*nvcc, *flags, *incs], [os.path.abspath(source)],
                 [*nvcc, "-shared"])
    lib = ctypes.CDLL(path)
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib
