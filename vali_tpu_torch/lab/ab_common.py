"""What the labs' A/B scripts share: the builds of an earlier source and
of the current one with its build knobs, views that move a frame's rows
off 16-byte alignment or give them a pitch, the differing samples of two
uint8 outputs and the kernels' envelope over them, alternating timing
rounds, each launch's device time from ``torch.profiler``, and each
kernel instance's registers and spills from ``nvcc -Xptxas -v``."""

from __future__ import annotations

import os
import re
import subprocess
import tempfile
from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops import _cuda_build
from .timing import time_ms


def build_earlier(source: str, subdir: str, signatures: dict):
    """An earlier source, its own headers first on the include path, built
    into ``build/<subdir>/`` with its launchers' C ``signatures``."""
    return _cuda_build.build_source(
        source, subdir, "earlier", signatures,
        include_dirs=[os.path.dirname(os.path.abspath(source))])


def build_current(name: str, subdir: str, launchers: Sequence[str],
                  flags: Sequence[str] = (),
                  extra: Optional[dict] = None):
    """The current ``csrc/<name>`` alone, with -D ``flags``, built into
    ``build/<subdir>/`` with its ``launchers``' signatures (and ``extra``
    ones)."""
    source = os.path.join(_cuda_build._PKG_DIR, "csrc", name)
    tag = name.removeprefix("nv12_").removesuffix(".cu") + "".join(
        f.split("=")[-1].removeprefix("-D").lower() for f in flags)
    signatures = {k: _cuda_build._LAB_SIGNATURES[k] for k in launchers}
    signatures.update(extra or {})
    return _cuda_build.build_source(source, subdir, tag, signatures,
                                    tuple(flags))


_PTXAS_FN = re.compile(r"Function properties for (\S+)|Compiling entry "
                       r"function '(\S+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")


def ptxas_report(name: str, instance: Callable[[str], Optional[str]],
                 flags: Sequence[str] = ()) -> Dict[str, object]:
    """Per kernel instance of ``csrc/<name>`` (``instance`` maps a mangled
    kernel name to the instance's name, or None to skip it), from ``nvcc
    -Xptxas -v``: registers and spill store and load bytes; and, under
    "warnings", every line of ptxas's C75xx warnings."""
    source = os.path.join(_cuda_build._PKG_DIR, "csrc", name)
    with tempfile.TemporaryDirectory() as tmp:
        run = subprocess.run(
            [_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, *flags, "-Xptxas",
             "-v", "-c", "-o", os.path.join(tmp, "k.o"), source],
            capture_output=True, text=True, timeout=900)
    text = run.stdout + run.stderr
    if run.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{text[-4000:]}")
    out, key = {}, None
    for line in text.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            key = instance(m.group(1) or m.group(2))
            continue
        if key is None:
            continue
        row = out.setdefault(key, {})
        if (r := _PTXAS_REGS.search(line)):
            row["registers"] = int(r.group(1))
        if (sp := _PTXAS_SPILL.search(line)):
            row["spill_store_bytes"] = int(sp.group(1))
            row["spill_load_bytes"] = int(sp.group(2))
    out["warnings"] = [ln for ln in text.splitlines()
                       if re.search(r"C75\d\d", ln)]
    return out


def padded_view(x: torch.Tensor, pad: int, off: int) -> torch.Tensor:
    """``x`` as a view of a buffer with ``pad`` more columns a row,
    starting ``off`` bytes into its rows."""
    b, rows, w = x.shape
    big = torch.zeros((b, rows, w + pad + off), dtype=x.dtype,
                      device=x.device)
    big[:, :, off:off + w] = x
    return big[:, :, off:off + w]


def differ(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Samples in which two uint8 outputs differ, and by how much."""
    d = (a.int() - b.int()).abs()
    return dict(differ=int((d > 0).sum().item()), maxdiff=int(d.max().item()))


def within_envelope(d: dict, samples: int) -> bool:
    """The kernels' uint8 envelope: 1 LSB on fewer than 1e-3 of the
    samples."""
    return d["maxdiff"] <= 1 and d["differ"] < 1e-3 * samples


def rounds(calls: dict, pairs: int) -> dict:
    """``pairs`` rounds of :func:`time_ms` of each call, the order reversed
    every other round: each call's times."""
    times = {k: [] for k in calls}
    names = list(calls)
    for i in range(pairs):
        for k in (names if i % 2 == 0 else names[::-1]):
            times[k].append(time_ms(calls[k]))
    return times


def kernel_ms(calls: dict, reps: int = 20) -> dict:
    """Each call's kernels' mean device ms by name (torch.profiler), in
    launch order."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out[name] = {e.key: e.device_time_total / e.count / 1e3
                     for e in prof.key_averages()
                     if e.count and e.device_time_total}
    return out
