"""Faithful CPU port of the reference's similarity algorithm — the measured
baseline (BASELINE.md: "the baseline must be measured, not quoted").  A
copy of ``apsim_tpu/bench/baseline.py`` (host-only NumPy) on the port's
``CSRMatrix``; the same corpus gives the same pair set in both packages.

Port of:
  - ``IndexingWorkerActor.buildInvertedIndex`` (IndexingWorkerActor.scala:61-71):
    a ``dim -> set(vector_idx)`` inverted index over a growing vector store;
  - ``IndexingWorkerActor.querySimilarItems`` (:74-111): per query vector,
    walk the posting set of every nonzero dim, deduplicate candidates, score
    each with
  - ``CommonUtils.calculateSimilarity`` (CommonUtils.scala:98-117): build a
    fresh ``dict`` per vector pair and accumulate products over the smaller
    map — reproducing the reference's dominant cost (per-candidate-pair map
    construction) in the same asymptotic shape.

Known deviation (deliberate, SURVEY.md fine-print #3): the reference's
first-dimension dedup bug (``outputSimSet.contains`` checked before the entry
exists, IndexingWorkerActor.scala:89) nondeterministically *drops* pairs; this
port keeps the dedup but not the bug, so its output is the correct pair set
and can be parity-checked against both the oracle and the TPU engine.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from ..vector.batch import CSRMatrix

__all__ = ["ReferenceBaseline", "measure_baseline"]


def calculate_similarity(
    idx1: np.ndarray, val1: np.ndarray, idx2: np.ndarray, val2: np.ndarray
) -> float:
    """CommonUtils.calculateSimilarity port: per-pair hash-map dot product
    (the HashMap build per call is the reference's hot-loop cost)."""
    m1 = dict(zip(idx1.tolist(), val1.tolist()))
    m2 = dict(zip(idx2.tolist(), val2.tolist()))
    if len(m2) < len(m1):
        m1, m2 = m2, m1
    sim = 0.0
    for i, v in m1.items():
        w = m2.get(i)
        if w is not None:
            sim += v * w
    return sim


class ReferenceBaseline:
    """Streaming inverted-index engine with the reference's data structures."""

    def __init__(self, similarity_threshold: float):
        self.tau = similarity_threshold
        self.store: List[Tuple[str, np.ndarray, np.ndarray]] = []
        self.inverted_index: Dict[int, Set[int]] = {}
        self.pairs_scored = 0  # calculateSimilarity invocations

    def index_batch(
        self, batch: Sequence[Tuple[str, np.ndarray, np.ndarray]]
    ) -> Dict[str, Dict[str, float]]:
        """IndexData handling: index-before-query, then emit per-query maps
        (IndexingWorkerActor.scala:123-132)."""
        base = len(self.store)
        for vid, idx, val in batch:
            self.store.append((vid, idx, val))
            cur = len(self.store) - 1
            for d in idx.tolist():
                self.inverted_index.setdefault(d, set()).add(cur)
        out: Dict[str, Dict[str, float]] = {}
        for k in range(base, len(self.store)):
            qid, qidx, qval = self.store[k]
            sims = out.setdefault(qid, {})
            seen: Set[int] = set()
            for d in qidx.tolist():
                for cand in self.inverted_index.get(d, ()):
                    if cand == k or cand in seen:
                        continue
                    seen.add(cand)
                    cid, cidx, cval = self.store[cand]
                    self.pairs_scored += 1
                    sim = calculate_similarity(cidx, cval, qidx, qval)
                    if sim >= self.tau:
                        sims[cid] = sim
        return out

    def all_pairs(self, csr: CSRMatrix, ids: Sequence[str] | None = None
                  ) -> Set[Tuple[str, str]]:
        if ids is None:
            ids = [str(i) for i in range(csr.n_rows)]
        batch = []
        for i in range(csr.n_rows):
            s, e = int(csr.indptr[i]), int(csr.indptr[i + 1])
            batch.append((ids[i], csr.indices[s:e], csr.data[s:e]))
        out = self.index_batch(batch)
        pairs: Set[Tuple[str, str]] = set()
        for q, sims in out.items():
            for c in sims:
                pairs.add((q, c) if q <= c else (c, q))
        return pairs


def measure_baseline(
    csr: CSRMatrix,
    tau: float,
    max_rows: int | None = None,
    time_budget_s: float = 120.0,
) -> dict:
    """Run the reference-algorithm port on (a prefix of) the corpus and
    report decided-pairs/sec.  ``decided pairs`` = n(n-1)/2 — the number of
    pair decisions the join semantically makes — so throughput is comparable
    across engines regardless of internal pruning."""
    n = csr.n_rows if max_rows is None else min(csr.n_rows, max_rows)
    eng = ReferenceBaseline(tau)
    pairs: Set[Tuple[str, str]] = set()
    t0 = time.perf_counter()
    deadline = t0 + time_budget_s
    done = 0
    # row-at-a-time streaming (the reference's own ingest shape) so the
    # budget is ENFORCED: after row k the decided-pair count is exactly
    # k(k+1)/2, keeping the throughput metric well-defined on early stop
    for i in range(n):
        s, e = int(csr.indptr[i]), int(csr.indptr[i + 1])
        out = eng.index_batch(
            [(str(i), csr.indices[s:e], csr.data[s:e])]
        )
        for q, sims in out.items():
            for c in sims:
                pairs.add((q, c) if q <= c else (c, q))
        done = i + 1
        if time.perf_counter() > deadline:
            break
    dt = time.perf_counter() - t0
    decided = done * (done - 1) / 2
    return {
        "n_rows": done,
        "seconds": dt,
        "pairs_found": len(pairs),
        "pairs_scored_internal": eng.pairs_scored,
        "decided_pairs": decided,
        "decided_pairs_per_sec": decided / dt if dt > 0 else float("inf"),
        "timed_out": done < n,
        "pair_set": pairs,
    }
