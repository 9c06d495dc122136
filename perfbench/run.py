"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a profiled
slice of the window. The last line of standard output is the result as
one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error. Exits non-zero, printing no result, where
there is no CUDA card or fewer cards than the cell asks for, and where
the process loaded JAX or the JAX package.
"""

import time

STARTED = time.perf_counter()   # set-up counts from the process's start

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "perfbench")
# the checkout's root, not this folder, is where imports start
sys.path[0] = ROOT
# caches the program or its libraries may write stay inside the checkout,
# at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(CACHE, sub)
# Python's bytecode too, also where the environment turns it off
# (PYTHONDONTWRITEBYTECODE): else every run compiles torch's sources
# again, seconds of set-up, and only the first run in a checkout should
# compile
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(CACHE, "pycache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    w = harness.cell(args.workload).workload
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < w["chips"]:
        print(f"perfbench: {args.workload} needs {w['chips']} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), started=STARTED)
    return harness.report(result)


if __name__ == "__main__":
    sys.exit(main())
