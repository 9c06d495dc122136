"""Build the package's own native engine extension.

The native demux/decode/encode engine is the repository's C++ engine
under ``src/native``: the seven sources ``setup.py`` lists, with its
flags (``-std=c++17 -O2 -fvisibility=hidden``, FFmpeg's include
directories from pkg-config, ``-ljpeg``; ``VALI_DIRECT_LINK=1`` defines
the macro and links libav as ``setup.py`` does). The package builds its
own extension module from them, ``vali_tpu_torch._native``, at first use:
each source is compiled by its own C++ compiler process, all started
together, and the objects are linked into
``build/vali_tpu_torch/native/_native-<key><EXT_SUFFIX>`` beside the
package, keyed by a hash of the sources, the headers under ``src/native``
and the flags. ``utils/_build.locked_build`` holds an inter-process file
lock, so concurrent processes build once, and compiles in a private
directory and moves the finished library into place, so a process that
has the library mapped never sees it rewritten. FFmpeg's headers and libjpeg are needed at
build time; without ``VALI_DIRECT_LINK`` the libav libraries themselves
are opened at run time (``src/native/av_runtime.hpp``).

``python -m vali_tpu_torch.engine._native_build`` builds the engine
ahead of use and prints the library's path and the seconds it took.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sysconfig
import time

from ..utils._build import locked_build, source_key

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "src", "native")
#: setup.py's Extension(sources=...), relative to the repository root
SOURCES = ("src/native/module.cpp", "src/native/module_codecs.cpp",
           "src/native/decoder.cpp", "src/native/encoder.cpp",
           "src/native/frameconv.cpp", "src/native/jpeg.cpp",
           "src/native/muxer.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "vali_tpu_torch", "native")
FLAGS = ("-std=c++17", "-O2", "-fvisibility=hidden")
FFMPEG_PKGS = ("libavformat", "libavcodec", "libavutil", "libswscale")


def direct_link() -> bool:
    """``VALI_DIRECT_LINK``, read as ``setup.py`` reads it."""
    return os.environ.get("VALI_DIRECT_LINK", "").strip().lower() in (
        "1", "true", "yes", "on")


def _pkg_config(kind: str) -> list:
    cmd = ["pkg-config", f"--{kind}", *FFMPEG_PKGS]
    try:
        return subprocess.check_output(cmd, text=True,
                                       stderr=subprocess.STDOUT).split()
    except FileNotFoundError as e:
        raise RuntimeError(f"{' '.join(cmd)}: pkg-config not found") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"{' '.join(cmd)} failed: {e.output.strip()}"
                           ) from e


def flags() -> tuple:
    """(compile flags, link flags), as setup.py's Extension gets them."""
    cflags = ["-fPIC", *FLAGS, f"-I{NATIVE_DIR}",
              f"-I{sysconfig.get_paths()['include']}"]
    cflags += [t for t in _pkg_config("cflags") if t.startswith("-I")]
    ldflags = ["-ljpeg"]
    if direct_link():
        cflags.append("-DVALI_DIRECT_LINK=1")
        ldflags += [t for t in _pkg_config("libs")
                    if t.startswith(("-L", "-l"))]
    return cflags, ldflags


def _compiler() -> list:
    return shlex.split(sysconfig.get_config_var("CXX") or "c++")


def _key(cflags, ldflags) -> str:
    names = sorted(n for n in os.listdir(NATIVE_DIR)
                   if n.endswith((".cpp", ".hpp")))
    return source_key(_compiler() + cflags + ldflags, NATIVE_DIR, names)


def build() -> str:
    """The path of the engine's extension module, built on first use.

    Raises RuntimeError (pkg-config or the compiler failed, with the tail
    of their output) or OSError."""
    if not os.path.isdir(NATIVE_DIR):
        raise RuntimeError(f"the native engine's sources are not beside "
                           f"the package (no {NATIVE_DIR})")
    cflags, ldflags = flags()
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    path = os.path.join(BUILD_DIR,
                        f"_native-{_key(cflags, ldflags)}{suffix}")
    return locked_build(path, [*_compiler(), *cflags],
                        [os.path.join(_REPO_ROOT, src) for src in SOURCES],
                        [*_compiler(), "-shared"], ldflags)


if __name__ == "__main__":
    t0 = time.perf_counter()
    print(f"{build()} in {time.perf_counter() - t0:.2f} s")
