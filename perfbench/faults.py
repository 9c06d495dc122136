"""Faults planted under the timed path, each a wrapper of a path's entry
call, for the checks that the comparison catches them (``tests/`` and
``calibrate.py``). None is used by a benchmark run."""

from __future__ import annotations

import torch


def stale(call):
    """The step leaves its state unchanged: each batch gets the outputs of
    the batch before it."""
    last = {}

    def f(planes):
        out = call(planes)
        prev, last["out"] = last.get("out", out), out
        return prev
    return f


def half(call):
    """Half of the batch left out: the entry runs on the first half, the
    rest of each output is left zero."""
    def f(planes):
        b = planes[0].shape[0]
        part = call(tuple(p[:b // 2] for p in planes))
        return tuple(torch.cat([o, torch.zeros((b - b // 2,) + o.shape[1:],
                                               dtype=o.dtype,
                                               device=o.device)])
                     for o in part)
    return f


def altered(call):
    """An answer altered where it is produced: one sample of the first
    frame of the last output moved by half the uint8 range."""
    def f(planes):
        out = call(planes)
        out[-1][(0,) * out[-1].dim()] += 128
        return out
    return f


FAULTS = {"stale": stale, "half": half, "altered": altered}
