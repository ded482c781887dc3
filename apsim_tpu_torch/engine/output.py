"""Result model and emission modes (copied from
``apsim_tpu/engine/output.py``; host only).

Reference parity:
  - ``SimilarityOutput(output: HashMap[qid -> HashMap[cid -> sim]],
    outputMoment)`` with its pretty-printer (Message.scala:20-35);
  - immediate emission when ``outputIODuration <= 0`` vs time-batched
    coalescing flushed every ``outputIODuration`` ms
    (IndexingWorkerActor.scala:122-141), ``OutputBatcher``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Sequence

import numpy as np

__all__ = ["PairResult", "SimilarityOutput", "OutputBatcher"]


@dataclasses.dataclass
class PairResult:
    """Canonical all-pairs result: arrays of equal length with row indices
    ``i < j`` into the engine's row space, exact fp64 similarities, and the
    external string ids."""

    i: np.ndarray
    j: np.ndarray
    sims: np.ndarray
    ids: Sequence[str]

    @property
    def n_pairs(self) -> int:
        return int(self.i.size)

    def id_pairs(self) -> List[tuple[str, str, float]]:
        return [
            (self.ids[int(a)], self.ids[int(b)], float(s))
            for a, b, s in zip(self.i, self.j, self.sims)
        ]

    def pair_set(self) -> set[tuple[str, str]]:
        """Unordered pair-identity set — the parity oracle's comparison key."""
        out = set()
        for a, b in zip(self.i, self.j):
            x, y = self.ids[int(a)], self.ids[int(b)]
            out.add((x, y) if x <= y else (y, x))
        return out

    def to_similarity_output(self, symmetric: bool = True) -> "SimilarityOutput":
        """Expand to the reference's query->candidates map.  With
        ``symmetric=True`` both (a,b) and (b,a) appear, matching the
        index-before-query behavior for batch joins."""
        out: Dict[str, Dict[str, float]] = {}
        for a, b, s in self.id_pairs():
            out.setdefault(a, {})[b] = s
            if symmetric:
                out.setdefault(b, {})[a] = s
        return SimilarityOutput(out, time.time())


@dataclasses.dataclass
class SimilarityOutput:
    """``Message.scala:20-35`` parity: per-query similar-vector maps plus the
    emission timestamp (``outputMoment``; seconds here, ms in the reference)."""

    output: Dict[str, Dict[str, float]]
    output_moment: float

    def __str__(self) -> str:
        sb: List[str] = []
        for qid, sims in self.output.items():
            sb.append("---------------------------------")
            sb.append(f"{qid}:")
            for cid, sim in sims.items():
                sb.append(f"{cid},{sim};")
            sb.append("\n")
        return "".join(sb)

    def merge_into(self, buf: Dict[str, Dict[str, float]]) -> None:
        for qid, sims in self.output.items():
            buf.setdefault(qid, {}).update(sims)


class OutputBatcher:
    """Emission-mode switch.

    ``duration_ms <= 0``: every ``emit`` call forwards immediately (the
    reference's ``outputWritingDuration <= 0`` branch).  Otherwise results
    coalesce into a write buffer that a timer thread flushes every
    ``duration_ms`` (the ``IOTicket`` loop, IndexingWorkerActor.scala:135-141).
    """

    def __init__(
        self,
        sink: Callable[[SimilarityOutput], None],
        duration_ms: int = 0,
    ):
        self._sink = sink
        self._duration_ms = duration_ms
        self._buf: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._timer: threading.Thread | None = None
        self._stop = threading.Event()
        if duration_ms > 0:
            self._timer = threading.Thread(target=self._loop, daemon=True)
            self._timer.start()

    def emit(self, out: SimilarityOutput) -> None:
        if self._duration_ms <= 0:
            if out.output:
                self._sink(out)
            return
        with self._lock:
            out.merge_into(self._buf)

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, {}
        if buf:
            self._sink(SimilarityOutput(buf, time.time()))

    def close(self) -> None:
        self._stop.set()
        if self._timer is not None:
            self._timer.join(timeout=2.0)
        self.flush()

    def _loop(self) -> None:
        while not self._stop.wait(self._duration_ms / 1000.0):
            self.flush()
