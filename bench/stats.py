"""Order statistics the readers share."""

from __future__ import annotations


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile of ``values``, interpolated linearly
    between the closest ranks; None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
