"""Cold build times of the CUDA kernel libraries of one or more checkouts
of the repository, on the card's machine.

For each ``--root`` (``.`` for this checkout, or an earlier one unpacked
with ``git archive``), a fresh Python process imports that checkout's
``vali_tpu_torch.ops._cuda_build``, points its build directories at a new
directory under the checkout's git-ignored ``build/`` (so that nothing
built before is reused) and times ``load_kernels()``, the product's
library, and then, where the checkout has one, ``load_lab_kernels()``, the
labs'; each builds its sources with one nvcc process a source, all
started together. The roots run one after the other, so no two builds
share the machine's cores. Prints one JSON line a root::

    python -m vali_tpu_torch.lab.build_time --root _chip/parent --root .
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, os, shutil, sys, tempfile, time
sys.path.insert(0, os.getcwd())
from vali_tpu_torch.ops import _cuda_build as cb
os.makedirs("build", exist_ok=True)
tmp = tempfile.mkdtemp(prefix="build_time-", dir="build")
try:
    cb.BUILD_DIR = os.path.join(os.path.abspath(tmp), "product")
    cb.LAB_BUILD_DIR = os.path.join(os.path.abspath(tmp), "lab")
    out = {"product_sources": len(cb._SOURCES)}
    t = time.perf_counter()
    cb.load_kernels()
    out["product_s"] = time.perf_counter() - t
    if hasattr(cb, "load_lab_kernels"):
        out["lab_sources"] = len(cb._LAB_SOURCES)
        t = time.perf_counter()
        cb.load_lab_kernels()
        out["lab_s"] = time.perf_counter() - t
finally:
    shutil.rmtree(tmp)
print(json.dumps(out))
"""


def build_times(root: str) -> dict:
    """The cold build times of ``root``'s libraries, in their own
    process."""
    run = subprocess.run([sys.executable, "-c", _CHILD],
                         cwd=os.path.abspath(root), capture_output=True,
                         text=True, timeout=1800)
    if run.returncode != 0:
        raise RuntimeError(f"the build in {root} failed:\n"
                           f"{run.stderr[-4000:]}")
    return dict(root=root, **json.loads(run.stdout.splitlines()[-1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vali_tpu_torch.lab.build_time",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout of the repository (repeatable; "
                         "default: this one)")
    args = ap.parse_args(argv)
    for root in args.root or ["."]:
        print(json.dumps(build_times(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
