"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2] \
        [--out chiprun_out/<cell>.json]

For each of ``--seeds`` a short window at the cell's load runs the
program and its sampled batches are compared with the reference (the
lower readings). For each of ``--control-seeds`` the same run is made
with the control, the reference one precision below the configuration's
compute dtype, in the program's place (the upper readings). For each of
``--fault-seeds`` every fault of ``faults.py`` is planted under the
timed path. Prints one JSON object and writes it to ``--out``.
"""

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from perfbench import faults, harness, tracing

    if not torch.cuda.is_available():
        print("perfbench: calibrate needs a CUDA card", file=sys.stderr)
        return 3
    quiet = lambda s: print(s, file=sys.stderr)  # noqa: E731
    report = {"workload": args.workload,
              "card": tracing.card_name(harness.Card().name()),
              "program": {}, "control": {}, "faults": {}}

    def run(seed, **kw):
        r = harness.run(args.workload, seed, args.seconds, False, log=quiet,
                        **kw)
        return {k: v["value"] for k, v in r["checks"].items()}, r

    for seed in args.seeds:
        t = time.perf_counter()
        readings, r = run(seed)
        report["program"][seed] = {**readings, "correct": r["correct"],
                                   **{k: v["value"]
                                      for k, v in r["metrics"].items()},
                                   "s": time.perf_counter() - t}
        print(seed, report["program"][seed], file=sys.stderr, flush=True)
    for seed in args.control_seeds:
        readings, r = run(seed, control=True)
        report["control"][seed] = {**readings, "correct": r["correct"]}
        print("control", seed, readings, r["correct"], file=sys.stderr,
              flush=True)
    for seed in args.fault_seeds:
        for name, wrap in faults.FAULTS.items():
            readings, r = run(seed, wrap=wrap)
            report["faults"].setdefault(name, {})[seed] = {
                **readings, "correct": r["correct"]}
            print(name, seed, readings, r["correct"], file=sys.stderr,
                  flush=True)
    for kind in ("program", "control"):
        vals = list(report[kind].values())
        if vals:
            keys = [k for k in vals[0] if k.startswith("max_err_lsb.")]
            report[kind + "_range"] = {
                k: [min(v[k] for v in vals), max(v[k] for v in vals)]
                for k in keys}
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
