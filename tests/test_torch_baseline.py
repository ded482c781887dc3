"""The port's copy of the CPU reference-algorithm baseline
(``apsim_tpu_torch.bench.baseline``): ``tests/test_baseline.py``'s three
cases on the port's ``CSRMatrix``, and the JAX package's pair set on the
same corpus.  Every comparison is of exact pair sets."""

import numpy as np
import pytest

from apsim_tpu.bench.baseline import ReferenceBaseline as JaxBaseline
from apsim_tpu_torch.bench.baseline import ReferenceBaseline, measure_baseline
from apsim_tpu_torch.vector.batch import CSRMatrix

from oracle import brute_force_pairs, random_sparse_corpus


def to_pt(csr):
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                     csr.data)


def test_baseline_matches_oracle():
    rng = np.random.default_rng(13)
    csr = random_sparse_corpus(rng, 120, 250)
    for tau in (0.4, 0.6):
        got = ReferenceBaseline(tau).all_pairs(to_pt(csr))
        assert got == brute_force_pairs(csr, tau)


def test_baseline_streaming_batches():
    rng = np.random.default_rng(14)
    csr = random_sparse_corpus(rng, 90, 200)
    eng = ReferenceBaseline(0.5)
    pairs = set()
    for s in range(0, csr.n_rows, 13):
        e = min(s + 13, csr.n_rows)
        batch = []
        for i in range(s, e):
            lo, hi = int(csr.indptr[i]), int(csr.indptr[i + 1])
            batch.append((str(i), csr.indices[lo:hi], csr.data[lo:hi]))
        out = eng.index_batch(batch)
        for q, sims in out.items():
            for c in sims:
                pairs.add((q, c) if q <= c else (c, q))
    assert pairs == brute_force_pairs(csr, 0.5)


def test_measure_baseline_reports():
    rng = np.random.default_rng(15)
    csr = random_sparse_corpus(rng, 60, 150)
    rep = measure_baseline(to_pt(csr), 0.5, max_rows=40)
    assert rep["n_rows"] == 40
    assert rep["decided_pairs"] == 40 * 39 / 2
    assert rep["decided_pairs_per_sec"] > 0
    assert not rep["timed_out"]
    prefix = type(csr)(
        40, csr.n_cols, csr.indptr[:41],
        csr.indices[: int(csr.indptr[40])], csr.data[: int(csr.indptr[40])],
    )
    assert rep["pair_set"] == brute_force_pairs(prefix, 0.5)


@pytest.mark.parametrize("tau", [0.3, 0.5])
def test_baseline_equals_jax(tau):
    rng = np.random.default_rng(16)
    csr = random_sparse_corpus(rng, 140, 300)
    ids = [f"v{i}" for i in range(csr.n_rows)]
    eng = ReferenceBaseline(tau)
    got = eng.all_pairs(to_pt(csr), ids)
    jax_eng = JaxBaseline(tau)
    assert got == jax_eng.all_pairs(csr, ids)
    assert eng.pairs_scored == jax_eng.pairs_scored
    assert got
