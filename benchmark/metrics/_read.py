"""Readers several metrics share."""

from __future__ import annotations

__all__ = ["idle_pct", "section_pct"]


def idle_pct(records: dict):
    """The device's idle share of the traced window, in %."""
    prof = records.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def section_pct(sections: dict, names, window_s: float):
    """The share of ``window_s`` the engine spent in the sections
    ``names``, in %."""
    total = sum(sections.get(n, 0.0) for n in names)
    if window_s <= 0 or total <= 0:
        return None
    return 100.0 * total / window_s
