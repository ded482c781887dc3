"""The plain reference against a brute-force float64 NumPy join, the
comparison on hand-made answers, and the control failing it."""

import numpy as np
import pytest
import torch

from benchmark import corpus as corpus_mod
from benchmark.reference.compare import LIMITS, compare
from benchmark.reference.cosine import neighbours

PARAMS = {"terms": 400, "vector_dim": 1 << 20, "median_terms": 20.0,
          "sigma": 0.6, "min_terms": 4, "max_terms": 200, "zipf_s": 0.7,
          "zipf_offset": 25.0, "dup_rate": 0.05}


def _dense(c):
    ptr, idx, val = c.host()
    d = np.zeros((c.n_rows, c.terms))
    for r in range(c.n_rows):
        d[r, idx[ptr[r]:ptr[r + 1]]] = val[ptr[r]:ptr[r + 1]]
    return d


@pytest.fixture(scope="module")
def small():
    return corpus_mod.make_corpus(PARAMS, 700, 99, "cpu")


def test_reference_equals_brute_force(small):
    d = _dense(small)
    tau = 0.3
    want = d[:100] @ d.T
    wq, wc = np.nonzero(want >= tau)
    qi, ci, s = neighbours(corpus_mod.take_rows(small, np.arange(100)),
                           small, tau, 0.0, q_block=37, c_block=101)
    got = dict(zip(zip(qi.tolist(), ci.tolist()), s.tolist()))
    assert set(got) == set(zip(wq.tolist(), wc.tolist()))
    assert max(abs(got[k] - want[k]) for k in got) < 1e-12
    assert len(got) > 100  # more than the self pairs


def test_compare_counts():
    tau, b = 0.7, 1e-10
    ref_k = np.array([1, 2, 3, 4, 5])
    ref_s = np.array([0.9, 0.7 + 1e-12, 0.69, 0.8, 0.95])
    # exact answers: 1, 4, 5 (2 lies in the band: either way)
    r = compare([1, 4, 5], [0.9, 0.8, 0.95], ref_k, ref_s, tau, b)
    assert (r["missing"], r["extra"], r["sim_gap"]) == (0, 0, 0.0)
    r = compare([1, 2, 4, 5], [0.9, 0.7, 0.8, 0.95], ref_k, ref_s, tau, b)
    assert (r["missing"], r["extra"]) == (0, 0)
    r = compare([1, 4], [0.9, 0.8 + 1e-6], ref_k, ref_s, tau, b)
    assert r["missing"] == 1 and r["sim_gap"] == pytest.approx(1e-6)
    r = compare([1, 3, 4, 5, 9, 9], [0.9, 0.69, 0.8, 0.95, 1.0, 1.0],
                ref_k, ref_s, tau, b)
    assert r["extra"] == 3  # 3 is below tau, 9 unknown, 9 given twice
    r = compare([1, 4, 5], [0.9, 0.8, 0.95], ref_k, ref_s, tau, b,
                required=[True, True, True, True, False])
    assert r["missing"] == 0


def test_float32_control_fails_and_float64_passes(small):
    tau = 0.3
    q = corpus_mod.take_rows(small, np.arange(200))
    q64, c64, s64 = neighbours(q, small, tau, 1e-6, torch.float64)
    q32, c32, s32 = neighbours(q, small, tau, 1e-6, torch.float32)
    n = small.n_rows
    ref = (q64 * n + c64, s64)
    keep64, keep32 = s64 >= tau, s32 >= tau
    ok = compare(ref[0][keep64], s64[keep64], *ref, tau)
    ctl = compare((q32 * n + c32)[keep32], s32[keep32], *ref, tau)
    assert all(ok[k] <= LIMITS[k] for k in LIMITS)
    assert any(ctl[k] > LIMITS[k] for k in LIMITS)
