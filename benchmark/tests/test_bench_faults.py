"""A run whose timed path is broken underneath comes out not correct.

Each cell runs on the CPU at a tiny size (the harness's look for a card
skipped), once sound and once with each fault the cell can have: a step
that returns its state unchanged, half of the work left out, an answer
altered where it is produced, a threshold shifted either way.  (No cell
spans chips, so none has an exchange between chips to leave out.)
``SHIFTED`` holds the threshold faults, which ``test_bench_card.py`` also
plants at the cells' own sizes on the card.
"""

import importlib.util
import os

import pytest

from apsim_tpu_torch.engine.chunked import ChunkedAllPairs
from apsim_tpu_torch.engine.engine import _CompletedInsert
from apsim_tpu_torch.engine.output import PairResult, SimilarityOutput
from benchmark import harness

_spec = importlib.util.spec_from_file_location(
    "benchmark_run_under_test", os.path.join(harness.BENCH, "run.py"))
RUN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(RUN)

CORPUS = {"terms": 2000, "dup_rate": 0.15}
TINY = {
    "rcv1_join_200k": {"config": {"rows": 2500, "corpus": CORPUS},
                       "params": {"check_rows": 600, "warm_joins": 1}},
    "rcv1_ingest_440k_over": {
        "config": {"index_rows": 2500, "max_flush_batch": 32,
                   "corpus": CORPUS},
        "params": {"children": 10, "warm_s": 0.3, "check_vectors": 200}},
}


def _run(cell, seed=2**35 + 11):
    return RUN.run_cell(cell, seed, 1.5, False, device="cpu",
                        overrides=TINY[cell])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def _half_pairs(monkeypatch):
    real = ChunkedAllPairs.all_pairs

    def half(self, tau=None):
        res = real(self, tau)
        keep = slice(0, res.n_pairs // 2)
        return PairResult(res.i[keep], res.j[keep], res.sims[keep], res.ids)

    monkeypatch.setattr(ChunkedAllPairs, "all_pairs", half)


def _altered_pair(monkeypatch):
    real = ChunkedAllPairs.all_pairs

    def altered(self, tau=None):
        res = real(self, tau)
        sims = res.sims.copy()
        sims[::7] = sims[::7] * (1 - 1e-6)
        return PairResult(res.i, res.j, sims, res.ids)

    monkeypatch.setattr(ChunkedAllPairs, "all_pairs", altered)


def _stale_join(monkeypatch):
    """Every join after the first returns the first's answer unchanged,
    and the first drops its last pair."""
    real = ChunkedAllPairs.all_pairs
    kept = {}

    def stale(self, tau=None):
        if "r" not in kept:
            res = real(self, tau)
            kept["r"] = PairResult(res.i[:-1], res.j[:-1], res.sims[:-1],
                                   res.ids)
        return kept["r"]

    monkeypatch.setattr(ChunkedAllPairs, "all_pairs", stale)


def _insert_wrap(monkeypatch, fn):
    real = ChunkedAllPairs.insert

    def wrapped(self, vectors, tau=None, bulk=False, defer=False):
        vectors = list(vectors)
        out = fn(self, real, vectors, tau, bulk)
        return _CompletedInsert(out) if defer else out

    monkeypatch.setattr(ChunkedAllPairs, "insert", wrapped)


def _half_batch(monkeypatch):
    def half(self, real, vectors, tau, bulk):
        return real(self, vectors[: (len(vectors) + 1) // 2], tau, bulk)

    _insert_wrap(monkeypatch, half)


def _unchanged(monkeypatch):
    def nothing(self, real, vectors, tau, bulk):
        # the scheduled sends: fresh rows after warm-up
        if not any(v[0][0] == "f" and int(v[0][1:]) >= 100 for v in vectors):
            return real(self, vectors, tau, bulk)
        return SimilarityOutput({}, 0.0)

    _insert_wrap(monkeypatch, nothing)


def _altered_answer(monkeypatch):
    def altered(self, real, vectors, tau, bulk):
        out = real(self, vectors, tau, bulk)
        for ans in out.output.values():
            for cid in list(ans)[:1]:
                ans[cid] = ans[cid] * (1 - 1e-6)
        return out

    _insert_wrap(monkeypatch, altered)


def shifted(delta: float):
    """A fault that runs the timed path at the threshold moved by
    ``delta``: every join and every insert of the engine."""

    def fault(monkeypatch):
        join = ChunkedAllPairs.all_pairs

        def all_pairs(self, tau=None):
            base = self.cfg.similarity_threshold if tau is None else tau
            return join(self, base + delta)

        def moved(self, real, vectors, tau, bulk):
            base = self.cfg.similarity_threshold if tau is None else tau
            return real(self, vectors, base + delta, bulk)

        monkeypatch.setattr(ChunkedAllPairs, "all_pairs", all_pairs)
        _insert_wrap(monkeypatch, moved)

    fault.__name__ = f"_threshold_{'up' if delta > 0 else 'down'}"
    return fault


SHIFTED = [shifted(0.05), shifted(-0.05)]

FAULTS = [
    ("rcv1_join_200k", _half_pairs),
    ("rcv1_join_200k", _altered_pair),
    ("rcv1_join_200k", _stale_join),
    *(("rcv1_join_200k", f) for f in SHIFTED),
    ("rcv1_ingest_440k_over", _half_batch),
    ("rcv1_ingest_440k_over", _unchanged),
    ("rcv1_ingest_440k_over", _altered_answer),
    *(("rcv1_ingest_440k_over", f) for f in SHIFTED),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]
