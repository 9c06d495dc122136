"""Compile a shared library once, however many processes ask for it.

The package's two native builds, the CUDA kernels
(``ops/_cuda_build.py``) and the native engine
(``engine/_native_build.py``), differ only in their sources, tools and
flags; both go through :func:`locked_build`, which keys nothing itself:
the caller names the library after :func:`source_key`.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence


def source_key(words: Sequence[str], root: str,
               names: Sequence[str]) -> str:
    """16 hex digits of a hash of ``words`` (the tools and flags) and of
    each file of ``names`` under ``root``: its name and its bytes."""
    h = hashlib.sha256(" ".join(words).encode())
    for name in names:
        with open(os.path.join(root, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def run_all(cmds) -> None:
    """Run the commands in parallel; raise with the first failure's
    output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        output = proc.communicate()[0]
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, output)
    if failed is not None:
        cmd, code, output = failed
        tail = "\n".join(output.splitlines()[-40:])
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed (exit {code}): "
            f"{' '.join(cmd)}\n{tail}")


def locked_build(out_path: str, compile_cmd: Sequence[str],
                 sources: Sequence[str], link_cmd: Sequence[str],
                 link_flags: Sequence[str] = ()) -> str:
    """``out_path``, built unless it is there already.

    Each source is compiled by ``[*compile_cmd, "-c", "-o", obj, src]``,
    all at once, and the objects are linked by ``[*link_cmd, "-o", lib,
    *objs, *link_flags]`` in a private directory beside ``out_path``; the
    library is then moved into place with ``os.replace``, so a process
    that has it mapped never sees it rewritten. An ``flock`` on ``lock``
    in that directory makes concurrent processes build once. Raises
    RuntimeError with the tail of a failed tool's output."""
    build_dir = os.path.dirname(out_path)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out_path):
                _compile(out_path, compile_cmd, sources, link_cmd,
                         link_flags)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return out_path


def _compile(out_path, compile_cmd, sources, link_cmd, link_flags) -> None:
    tmp = tempfile.mkdtemp(prefix="build-", dir=os.path.dirname(out_path))
    try:
        objs = [os.path.join(tmp, f"{i}.o") for i in range(len(sources))]
        run_all([[*compile_cmd, "-c", "-o", obj, src]
                 for src, obj in zip(sources, objs)])
        lib = os.path.join(tmp, os.path.basename(out_path))
        run_all([[*link_cmd, "-o", lib, *objs, *link_flags]])
        os.replace(lib, out_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
