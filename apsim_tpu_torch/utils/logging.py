"""Structured logging and stage timing.

  - ``get_logger``: a namespaced stdlib logger (``apsim``) with one-line
    records;
  - ``profile_trace``: a ``torch.profiler`` context that writes a Chrome
    trace of everything inside it, on every thread of the process (host
    activity, the ``Timer`` sections, and the card's kernels and copies on
    a CUDA device);
  - ``Timer``: wall-clock section timing that feeds the engine's stage
    split, and while a profiler records, one profiler range a section;
  - ``batch_id``: the micro-batch whose work the current thread runs (set
    by the server); the ranges opened meanwhile carry it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import logging
import os
import re
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["get_logger", "profile_trace", "init_profiler", "Timer",
           "batch_id", "SPAN_PREFIX", "span_of"]

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"

# the name of a Timer section's profiler range is this prefix, the
# section's name and, inside a micro-batch, "#<batch id>"; the traces that
# ``profile_trace`` writes carry the id as the range's ``args["batch"]``
SPAN_PREFIX = "apsim::"

batch_id: contextvars.ContextVar = contextvars.ContextVar(
    "apsim_batch_id", default=None)


def get_logger(name: str = "apsim") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def span_of(range_name: str):
    """``(section, batch id or None)`` of a profiler range a ``Timer``
    opened, None for any other range."""
    if not range_name.startswith(SPAN_PREFIX):
        return None
    name, _, batch = range_name[len(SPAN_PREFIX):].partition("#")
    return name, (int(batch) if batch else None)


_trace_seq = itertools.count()
_tracing = threading.Lock()  # one profile_trace at a time in the process


def _all_threads():
    """The profiler's option to record every thread, where torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def init_profiler(cuda: bool) -> None:
    """One empty profiler session on this thread.  A process's first
    session sets up the profiler's CUDA tracing, which takes seconds and
    expects the thread that loaded torch; a process whose traces start on
    a worker thread (the server's flusher) opens one here first, so that
    the worker neither stalls on the set-up nor runs it off that
    thread."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])):
        pass


@contextlib.contextmanager
def profile_trace(log_dir: str, cuda: bool | None = None):
    """Trace everything inside the context, on every thread of the process,
    with ``torch.profiler`` and write it to ``log_dir`` as
    ``trace_<pid>_<time ns>_<n>.json`` (Chrome trace format: open it in
    Perfetto or ``chrome://tracing``).  ``cuda``: record the card's
    activity too; by default when CUDA is available.  Where another
    profiler already records, its trace takes this context's activity:
    the context yields None and writes nothing."""
    from torch.profiler import ProfilerActivity, profile

    if _profiler._is_profiler_enabled or not _tracing.acquire(blocking=False):
        yield None
        return
    try:
        if cuda is None:
            cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=acts, **_all_threads()) as prof:
            yield prof
        name = (f"trace_{os.getpid()}_{time.time_ns()}_{next(_trace_seq)}"
                ".json")
        _export(prof, os.path.join(log_dir, name))
    finally:
        _tracing.release()


# a Timer range's name with a batch id, up to its event's args
_BATCHED = re.compile(r'"name": "' + re.escape(SPAN_PREFIX)
                      + r'(\w+)#(\d+)"([^{}]*?"args": \{)(\s*\})?')


def _batch_arg(m: re.Match) -> str:
    rest = "}" if m.group(4) else ", "
    return (f'"name": "{SPAN_PREFIX}{m.group(1)}"{m.group(3)}'
            f'"batch": {m.group(2)}{rest}')


def _export(prof, path: str) -> None:
    """The Chrome trace with each ``Timer`` range under its section's name
    and its batch id, if any, in ``args["batch"]`` (a text substitution:
    a trace runs to tens of MB)."""
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    text, n = _BATCHED.subn(_batch_arg, text)
    if n:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)


def _open_range(name: str):
    batch = batch_id.get()
    rf = _profiler.record_function(
        SPAN_PREFIX + name + ("" if batch is None else f"#{batch}"))
    rf.__enter__()
    return rf


class Timer:
    """Accumulating section timer: ``with timer.section("score"): ...``;
    ``timer.totals`` maps section -> seconds, ``timer.counts`` section ->
    calls.  While a ``torch.profiler`` session records, each section is
    also a profiler range (``SPAN_PREFIX`` + name, nested as the sections
    nest), so the trace shows it on the kernels' time axis; otherwise a
    section keeps no record beyond the two maps."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()  # sections close on several threads

    @contextlib.contextmanager
    def section(self, name: str):
        rf = _open_range(name) if _profiler._is_profiler_enabled else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1
            if rf is not None:
                rf.__exit__(None, None, None)
