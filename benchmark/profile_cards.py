"""Each card's busy time, idle gaps and kernel time from ``torch.profiler``,
for a cell whose program runs on several cards of one process.

``profile.profile_call`` takes the union of every device's activity, which
over four cards reads "some card busy".  Here each card's activity is
merged on its own: its busy time (the union of its activity intervals in
the traced window) and its idle gaps, each gap named ``card<k>:<section>``
by the innermost engine section the host was in at its middle (``None``
between sections).  ``busy_s`` is the **mean of the cards' busy times**,
so ``1 - busy_s / window_s`` is the cards' mean idle share.  Kernel time
is summed over the cards by kernel name, and kept by card too.  The
sections are recorded by ``profile.SectionRecorder``, as in
``profile_call``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import torch

from benchmark.profile import _CALL, SectionRecorder, _section_totals

__all__ = ["profile_call_cards", "reduce_cards"]


def _merge(spans, w0: float, w1: float):
    """``(busy_us, gaps)`` of the intervals ``spans`` clipped to the window
    ``[w0, w1]``: the length of their union and the stretches it leaves."""
    busy, end, gaps = 0.0, w0, []
    for s, e in sorted(spans):
        s, e = max(s, w0), min(e, w1)
        if e <= s:  # outside the window
            continue
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps


def reduce_cards(dev_events: Sequence, w0: float, w1: float,
                 sections: Sequence, cards: Sequence[int] | None = None,
                 top: int = 10) -> Dict:
    """The per-card reduction of one traced window ``[w0, w1]`` (us).

    ``dev_events``: ``(card, name, start_us, end_us)`` of every device
    activity; ``sections``: ``(start_us, end_us, name)`` of the engine's
    sections on the same axis; ``cards``: the cards the program ran on (a
    card with no activity reads busy 0), by default those with events."""
    by_card: Dict[int, list] = {}
    kernels: Dict[str, float] = {}
    per_card: Dict[str, Dict[str, float]] = {}
    for card, name, s, e in dev_events:
        by_card.setdefault(int(card), []).append((s, e))
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e6
        mine = per_card.setdefault(str(int(card)), {})
        mine[name] = mine.get(name, 0.0) + (e - s) / 1e6
    cards = sorted(by_card) if cards is None else [int(k) for k in cards]

    def section_at(t: float):
        inside = [(b - a, name) for a, b, name in sections if a <= t <= b]
        return min(inside)[1] if inside else None

    busy, gaps = {}, []
    for k in cards:
        b, g = _merge(by_card.get(k, []), w0, w1)
        busy[k] = b / 1e6
        gaps += [(f"card{k}:{section_at((a + z) / 2)}", (z - a) / 1e6)
                 for a, z in g]
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(busy.values()) / len(busy) if busy else 0.0,
        "busy_by_card_s": {str(k): v for k, v in busy.items()},
        "kernels_s": dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
        "kernels_by_card_s": per_card,
        "idle_gaps": [[name, s] for name, s in gaps[:top]],
    }


def profile_call_cards(eng, fn: Callable[[], object], cards: Sequence[int],
                       top: int = 10) -> Dict:
    """``fn()`` once under ``torch.profiler`` with ``eng.timer`` recorded,
    every card of ``cards`` synchronised before the window closes:
    ``reduce_cards`` of its device activity, and each section's host time
    (``sections_s``)."""
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
                    for k in cards:
                        torch.cuda.synchronize(k)
    finally:
        eng.timer = saved
    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    (w0, w1), = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == _CALL and e.device_type == cpu]
    sections = [(w0 + (a - t0) * 1e6, w0 + (b - t0) * 1e6, name)
                for a, b, name in rec.spans]
    dev = [(e.device_index, e.name, e.time_range.start, e.time_range.end)
           for e in events if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)
           and e.name != _CALL]
    out = reduce_cards(dev, w0, w1, sections, cards, top)
    out["sections_s"] = _section_totals(rec.spans)
    return out
