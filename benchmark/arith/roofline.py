"""The card's published peaks and the least time a piece of work can take.

``bound`` and the peaks are frozen from the program's chip script.  Peaks:
NVIDIA H100 SXM data sheet (dense, at 700 W).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12   # HBM3
PEAK_FP64_PER_S = 34e12      # FP64, outside the tensor cores
PEAK_FP64_TC_PER_S = 67e12   # FP64 on the tensor cores: the card's fastest FP64 rate


def bound(ops: float, nbytes: float, peak: float = PEAK_FP64_TC_PER_S) -> dict:
    """The least time (s) the card could take for ``ops`` operations moving
    ``nbytes`` (each input read once and each output written once): the
    bytes at the HBM rate against the operations at ``peak``; the larger
    one bounds."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / peak
    return {"bytes": nbytes, "ops": ops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
