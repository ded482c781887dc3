"""Rate and tail arithmetic of the end-to-end metrics.

A rate is all the work of the window over all its time; a tail is over
every sample, with a sample that never completed counted as missing (the
caller passes ``inf`` for it, so it sorts last).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

__all__ = ["rate", "percentile", "lateness"]


def rate(work: float, seconds: float) -> float:
    """``work`` over ``seconds`` (both of the whole window)."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return float(work) / float(seconds)


def percentile(samples: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of every sample (NumPy's linear
    interpolation); missing samples are ``inf`` and count."""
    a = np.asarray(samples, np.float64)
    if a.size == 0:
        raise ValueError("no samples")
    a = np.sort(a)
    pos = (a.size - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, a.size - 1)
    if not math.isfinite(a[hi]):
        return float(a[hi]) if pos > lo else float(a[lo])
    return float(a[lo] + (a[hi] - a[lo]) * (pos - lo))


def lateness(late_s: Sequence[float]) -> dict:
    """How late the open-loop generator sent: p95 and max, in ms."""
    a = np.asarray(late_s, np.float64) * 1e3
    if a.size == 0:
        return {"p95_ms": 0.0, "max_ms": 0.0, "sends": 0}
    return {"p95_ms": percentile(a, 95), "max_ms": float(a.max()),
            "sends": int(a.size)}
