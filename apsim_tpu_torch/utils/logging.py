"""Structured logging and stage timing.

  - ``get_logger``: a namespaced stdlib logger (``apsim``) with one-line
    records;
  - ``Timer``: wall-clock section timing that feeds the engine's stage split.

The JAX package's ``profile_trace`` (a ``jax.profiler`` context) has no
counterpart yet: the engine refuses ``profile_dir`` until the torch profiler
is wired in.
"""

from __future__ import annotations

import contextlib
import logging
import time

__all__ = ["get_logger", "Timer"]

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
