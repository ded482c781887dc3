"""Structured logging and stage timing.

  - ``get_logger``: a namespaced stdlib logger (``apsim``) with one-line
    records;
  - ``profile_trace``: a ``torch.profiler`` context that writes a Chrome
    trace of everything inside it (host activity, and the card's kernels
    and copies on a CUDA device);
  - ``Timer``: wall-clock section timing that feeds the engine's stage split.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time

__all__ = ["get_logger", "profile_trace", "Timer"]

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


def get_logger(name: str = "apsim") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


_trace_seq = itertools.count()


@contextlib.contextmanager
def profile_trace(log_dir: str, cuda: bool | None = None):
    """Trace everything inside the context with ``torch.profiler`` and
    write it to ``log_dir`` as ``trace_<pid>_<time ns>_<n>.json`` (Chrome
    trace format: open it in Perfetto or ``chrome://tracing``).  ``cuda``:
    record the card's activity too; by default when CUDA is available."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    name = f"trace_{os.getpid()}_{time.time_ns()}_{next(_trace_seq)}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


class Timer:
    """Accumulating section timer: ``with timer.section("score"): ...``;
    ``timer.totals`` maps section -> seconds."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
