"""What the labs' A/B scripts share: the builds of an earlier source and
of the current one with its build knobs, views that move a frame's rows
off 16-byte alignment or give them a pitch, the differing samples of two
uint8 outputs and the kernels' envelope over them, alternating timing
rounds and their summary (medians, ranges, each round's ratios), each
launch's device time from ``torch.profiler``, each kernel instance's
registers and spills from ``nvcc -Xptxas -v``, the card's name and power
limit, and the command line of an A/B (:func:`main`)."""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    """Per kernel instance of ``csrc/<name>`` (or of the source at the
    absolute path ``name``, its own directory first on the include path;
    ``instance`` maps a mangled kernel name to the instance's name, or None
    to skip it), from ``nvcc -Xptxas -v``: registers and spill store and
    load bytes; and, under "warnings", every line of ptxas's C75xx
    warnings."""
    if os.path.isabs(name):
        source, incs = name, [f"-I{os.path.dirname(name)}"]
    else:
        source, incs = os.path.join(_cuda_build._PKG_DIR, "csrc", name), []
    with tempfile.TemporaryDirectory() as tmp:
        run = subprocess.run(
            [_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, *flags, *incs,
             "-Xptxas", "-v", "-c", "-o", os.path.join(tmp, "k.o"), source],
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


def summary(times: dict, ratios: Sequence[Tuple[str, str]]) -> dict:
    """Median and range of each call's times (``<name>_ms``,
    ``<name>_range``), and for each pair (a, b) of ``ratios`` each round's
    a / b and their median."""
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_range": [min(v), max(v)] for k, v in times.items()})
    for a, b in ratios:
        r = [x / y for x, y in zip(times[a], times[b])]
        out[f"{a}_over_{b}"] = r
        out[f"{a}_over_{b}_median"] = statistics.median(r)
    return out


def summary_line(title: str, row: dict, names: Sequence[str],
                 ratios: Sequence[Tuple[str, str]], smi: str) -> str:
    """One line of a timed case's :func:`summary`: each name's median and
    range, then each ratio's median, then the card."""
    parts = [f"{n} {row[f'{n}_ms']:.4f} ({row[f'{n}_range'][0]:.4f}-"
             f"{row[f'{n}_range'][1]:.4f})" for n in names]
    parts += [f"{a}/{b} {row[f'{a}_over_{b}_median']:.3f}"
              for a, b in ratios]
    return f"{title} (ms): " + "; ".join(parts) + f" ({smi})"


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(prog: str, doc: str, earlier_help: str,
         run: Callable[..., Tuple[dict, List[dict]]],
         failures: Callable[[dict, List[dict]], List[str]],
         line: Callable[[List[dict], str], str],
         argv: Optional[Sequence[str]] = None) -> int:
    """The command line of an A/B against an earlier source: ``earlier``,
    ``--pairs`` (timing rounds, default 10) and ``--out`` (the reports and
    rows as JSON). Prints the card, then ``run(earlier, pairs, log)``'s
    lines, then ``line(rows, card)`` and the failures;
    exits 1 on a failure or without a card."""
    ap = argparse.ArgumentParser(prog=f"python -m {prog}",
                                 description=doc.split("\n\n")[0])
    ap.add_argument("earlier", help=earlier_help)
    ap.add_argument("--pairs", type=int, default=10,
                    help="timing rounds at the timed case (default 10)")
    ap.add_argument("--out", help="write the reports and rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"{prog}: needs a CUDA device", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    reports, rows = run(args.earlier, args.pairs,
                        log=lambda s: print(s, flush=True))
    print(line(rows, smi), flush=True)
    bad = failures(reports, rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, **reports, "rows": rows}, f, indent=1)
    print(f"failures: {bad or 'none'}")
    return 1 if bad else 0


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
