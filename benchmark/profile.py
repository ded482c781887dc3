"""Device busy time, idle gaps and kernel time from ``torch.profiler``.

A frozen copy of the port's ``bench.ooc.profile_call``, so that a change to
the port cannot change the yardstick.  One change: the engine's ``Timer``
sections are recorded on the host clock from whatever thread runs them
(the server's flusher runs them off the main thread, where profiler ranges
are not recorded) and placed on the trace's time axis through one range on
the calling thread.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict

import torch

__all__ = ["SectionRecorder", "profile_call"]

_CALL = "benchmark traced window"


class SectionRecorder:
    """Stands in for an engine's ``Timer``: the same totals and counts, and
    every section's ``(start, end, name)`` on ``time.perf_counter``."""

    def __init__(self, timer):
        self.totals, self.counts = timer.totals, timer.counts
        self.spans: list = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + (t1 - t0)
                self.counts[name] = self.counts.get(name, 0) + 1
                self.spans.append((t0, t1, name))


def profile_call(eng, fn: Callable[[], object], top: int = 10) -> Dict:
    """``fn()`` once under ``torch.profiler`` with ``eng.timer`` recorded:
    the window's length, the device's busy time (the union of its activity
    intervals), every kernel's summed device time, the ``top`` longest
    idle gaps with the innermost section the host was in at each gap's
    middle (None between sections), and each section's host time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    saved = eng.timer
    rec = SectionRecorder(saved)
    eng.timer = rec
    try:
        with profile(activities=acts) as prof:
            with record_function(_CALL):
                t0 = time.perf_counter()
                fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        eng.timer = saved
    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    (w0, w1), = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == _CALL and e.device_type == cpu]
    sections = [(w0 + (a - t0) * 1e6, w0 + (b - t0) * 1e6, name)
                for a, b, name in rec.spans]
    dev = [e for e in events if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)
           and e.name != _CALL]
    busy_us, end, gaps = 0.0, w0, []
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        s, e = max(s, w0), min(e, w1)
        if e <= s:  # outside the window
            continue
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy_us += e - max(s, end)
            end = e
    if w1 > end:
        gaps.append((end, w1))

    def section_at(t: float):
        inside = [(b - a, name) for a, b, name in sections if a <= t <= b]
        return min(inside)[1] if inside else None

    longest = [[str(section_at((a + b) / 2)), (b - a) / 1e6]
               for a, b in sorted(gaps, key=lambda g: g[1] - g[0],
                                  reverse=True)[:top]]
    kernels: Dict[str, float] = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels_s": dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
        "idle_gaps": longest,
        "sections_s": _section_totals(rec.spans),
    }


def _section_totals(spans) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for a, b, name in spans:
        out[name] = out.get(name, 0.0) + (b - a)
    return out
