"""The table of peaks and a kernel's share of its roofline.

A kernel's least time is the larger of the bytes it must move (each
input byte read once, each output byte written once) over the card's
memory rate and its operations over the card's peak rate; its share is
that least time over the time the kernel took on the device. The peaks
are NVIDIA's data sheet for one H100 SXM (dense rates): the bf16 tensor
cores' rate is the fastest type that computes the kernels' bfloat16 cast
points. Each ``metrics/<kernel>_roofline.py`` counts its kernel's
bytes and operations.
"""

from __future__ import annotations

from typing import Optional

#: H100 SXM data sheet: HBM3 3.35 TB/s, bf16 tensor cores 989 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def least_s(nbytes: float, ops: float):
    """(least seconds, "bytes" or "operations": which bound it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(sl, pattern, launches_per_call: int, nbytes: float, ops: float,
          name: str) -> Optional[float]:
    """Percent of the roofline of the kernel whose device operations
    ``pattern`` finds in the slice ``sl``, ``launches_per_call`` of them a
    call doing ``nbytes`` and ``ops``; None where the slice has none. Logs
    which bound applies and the card beside the share."""
    ops_found = sl.kernels(pattern)
    if not ops_found:
        return None
    calls = len(ops_found) / launches_per_call
    took = sum(e - s for _, s, e in ops_found) * 1e-6 / calls
    least, bound = least_s(nbytes, ops)
    pct = 100.0 * least / took
    sl.log(f"{name}: {bound}-bound, {nbytes} bytes and {ops} operations a "
           f"call -> least {least * 1e3:.6f} ms; the kernel took "
           f"{took * 1e3:.6f} ms a call over {calls:g} calls "
           f"({len(ops_found)} launches): {pct:.4f} % on {sl.card}")
    return pct
