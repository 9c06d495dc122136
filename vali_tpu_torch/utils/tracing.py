"""Spans and counters of the port.

Counterpart of ``vali_tpu/utils/tracing.py`` and of the reference's NVTX
ranges (``NvtxMark`` RAII in every task Run(), reference
src/TC/inc/Tasks.hpp:32-59).

``with span(name):`` records a :class:`Span` on ``time.perf_counter_ns``
into a bounded in-memory store (:func:`spans`, :func:`clear`; the oldest
span goes first, counted as ``spans.dropped``) while tracing is on:

- after ``enable(True)``, or with ``VALI_TPU_TRACE=1`` in the
  environment: each span is then also a
  ``torch.profiler.record_function("vali::<name>")`` range, and an NVTX
  range where CUDA is available, so profiler traces and nsys show it;
- while a ``torch.profiler`` is recording: the store fills, and no range
  is made, so the profiled trace holds only what the program ran.

Off (the default), a span site costs one call that returns a shared
no-op context. Counters (:func:`count`, :func:`counters`) are always on:
``launches.<wrapper>`` counts a product wrapper's kernel launches (CPU
calls are not launches), ``tables.built.<table>`` a cached table's
builds, ``stage.pinned_allocs`` the staging buffers pinned.
"""

from __future__ import annotations

import collections
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

#: spans the store holds
CAPACITY = 50_000
PREFIX = "vali::"


class Span(NamedTuple):
    """One span: ``parent`` is the name of the span open on the same
    thread when this one began (None for an outermost span); every span
    under one outermost span shares its ``call_id``."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    call_id: int
    thread: int


_enabled = os.environ.get("VALI_TPU_TRACE", "0") not in ("0", "")
_store: collections.deque = collections.deque(maxlen=CAPACITY)
_counters: Dict[str, int] = collections.defaultdict(int)
_lock = threading.Lock()
_local = threading.local()
_call_ids = itertools.count()


def enable(on: bool = True) -> bool:
    """Turn spans on (with their profiler and NVTX ranges) or off;
    returns the previous setting."""
    global _enabled
    was, _enabled = _enabled, bool(on)
    return was


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A span that records itself."""
    __slots__ = ("name", "parent", "call_id", "start", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # stamped first: the span's own cost on entry counts inside it
        self.start = time.perf_counter_ns()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent, self.call_id = stack[-1].name, stack[-1].call_id
        else:
            self.parent, self.call_id = None, next(_call_ids)
        stack.append(self)
        self.stack = stack
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        rec = (self.name, self.start, end, self.parent, self.call_id,
               threading.get_ident())
        with _lock:
            if len(_store) == CAPACITY:
                _counters["spans.dropped"] += 1
            _store.append(rec)
        return False


class _Ranged(_On):
    """A span that records itself inside a profiler range and, where CUDA
    is available, an NVTX range."""
    __slots__ = ("ranges",)

    def __enter__(self):
        label = PREFIX + self.name
        self.ranges = (torch.profiler.record_function(label),) + (
            (torch.cuda.nvtx.range(label),)
            if torch.cuda.is_available() else ())
        for r in self.ranges:
            r.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        for r in reversed(self.ranges):
            r.__exit__(None, None, None)
        return False


def span(name: str):
    """A context that records span ``name`` while tracing is on (see the
    module's docstring), else the shared no-op context."""
    if _enabled:
        return _Ranged(name)
    if _profiler._is_profiler_enabled:
        return _On(name)
    return _OFF


def spans() -> List[Span]:
    """The stored spans, in the order they ended."""
    with _lock:
        return [Span._make(rec) for rec in _store]


def clear() -> None:
    """Empty the store (the counters stay)."""
    with _lock:
        _store.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counters[name] += n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counters)


def traced_build(fn):
    """Trace ``fn``, the body of a cached table (under
    ``functools.lru_cache``): each of its runs, a cache miss, is a
    ``tables.build`` span and counts ``tables.built.<fn's name>``."""
    key = "tables.built." + fn.__name__

    @functools.wraps(fn)
    def build(*args, **kwargs):
        count(key)
        with span("tables.build"):
            return fn(*args, **kwargs)
    return build
