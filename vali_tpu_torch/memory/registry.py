"""Allocation-tracking registry.

TPU-native analogue of the reference's compile-time
``TRACK_TOKEN_ALLOCATIONS`` registry (reference
src/TC/src/MemoryInterfaces.cpp:27-115): every Surface/Buffer registers on
construction and deregisters via weakref finalizer, so leaks show up as a
non-empty registry dump. Always compiled in; enabled at runtime via
``vali_tpu.memory.registry.enable(True)`` or env ``VALI_TPU_TRACK_ALLOCS=1``.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Dict, Tuple

_lock = threading.Lock()
_enabled = os.environ.get("VALI_TPU_TRACK_ALLOCS", "0") not in ("0", "")
_next_id = [0]
_live: Dict[int, Tuple[str, int]] = {}  # id -> (kind, nbytes)


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


def register(obj: object, kind: str, nbytes: int) -> None:
    if not _enabled:
        return
    with _lock:
        alloc_id = _next_id[0]
        _next_id[0] += 1
        _live[alloc_id] = (kind, int(nbytes))
    weakref.finalize(obj, _deregister, alloc_id)


def _deregister(alloc_id: int) -> None:
    with _lock:
        _live.pop(alloc_id, None)


def live_allocations() -> Dict[int, Tuple[str, int]]:
    with _lock:
        return dict(_live)


def live_bytes() -> int:
    with _lock:
        return sum(n for _, n in _live.values())


def dump() -> str:
    allocs = live_allocations()
    if not allocs:
        return "vali_tpu allocation registry: empty"
    lines = [f"vali_tpu allocation registry: {len(allocs)} live objects"]
    for alloc_id, (kind, nbytes) in sorted(allocs.items()):
        lines.append(f"  #{alloc_id}: {kind} {nbytes} bytes")
    return "\n".join(lines)
