"""The comparison that decides ``correct``.

After the window, the outputs of the batches sampled from the seed are
held against the plain reference of the path (``reference/``), computed
again from the same frames in blocks of frames. Each number compared is
the widest gap, in output LSBs, between an output sample and the
reference's real-valued answer for it, one number per output the path
makes (``max_err_lsb.<output>``); each has its limit in
``limits/<workload>.json``.

A ring may live on the host (frames a path stages to the card itself)
while the outputs are on the card: the reference computes where the
outputs are, each block of frames moved there first.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, Sequence, Tuple

import torch

from .reference import CONTROL_BELOW

HERE = os.path.dirname(os.path.abspath(__file__))
#: frames the reference takes at a time
BLOCK = 8


def limits(workload: str) -> Dict[str, float]:
    """The limit of each number compared in ``workload``."""
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def reference(path_mod):
    """The reference module a path adapter names."""
    return importlib.import_module(f"perfbench.reference.{path_mod.REFERENCE}")


def gaps(samples: Sequence[Tuple[int, object]], ring, path_mod, config: dict,
         traffic: dict, precision: str = "float64") -> Dict[str, float]:
    """``max_err_lsb.<output>``: the widest gap between each output of the
    sampled batches ``(index, outputs)`` and the reference computed at
    ``precision`` from ring slot ``index mod len(ring)``, on the outputs'
    device. A batch whose outputs never came (None) reads infinity."""
    ref = reference(path_mod)
    worst = {f"max_err_lsb.{o}": 0.0 for o in path_mod.OUTPUTS}
    for index, outs in samples:
        if outs is None:
            return {k: float("inf") for k in worst}
        planes, device = ring[index % len(ring)], outs[0].device
        for f0 in range(0, planes[0].shape[0], BLOCK):
            block = tuple(p[f0:f0 + BLOCK].to(device) for p in planes)
            refs = ref.compute(block, traffic["format"], config, precision)
            for key, out, want in zip(worst, outs, refs):
                got = out[f0:f0 + BLOCK].to(torch.float64)
                worst[key] = max(worst[key],
                                 float((got - want).abs().max()))
    return worst


def control_call(path_mod, config: dict, traffic: dict):
    """The control put in the program's place: the reference computed one
    precision below the configuration's compute dtype, rounded to the
    outputs' uint8 like the program's, block by block."""
    ref = reference(path_mod)
    precision = CONTROL_BELOW[config["compute_dtype"]]

    def call(planes):
        parts = [ref.compute(tuple(p[f0:f0 + BLOCK] for p in planes),
                             traffic["format"], config, precision)
                 for f0 in range(0, planes[0].shape[0], BLOCK)]
        return tuple(torch.round(torch.cat(outs)).to(torch.uint8)
                     for outs in zip(*parts))
    return call


def judged(readings: Dict[str, float], limit: Dict[str, float]
           ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {number: {value, limit}}): correct when every number lies
    at or under its limit (NaN does not)."""
    checks = {k: {"value": v, "limit": limit[k]} for k, v in readings.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
