"""Result model (copied from ``apsim_tpu/engine/output.py``).

Reference parity: ``SimilarityOutput(output: HashMap[qid -> HashMap[cid ->
sim]], outputMoment)`` with its pretty-printer (Message.scala:20-35).  The
time-batched emission (``OutputBatcher``) belongs to the serving stack and
is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["PairResult", "SimilarityOutput"]


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
