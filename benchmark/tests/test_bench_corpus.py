"""The card's corpus generator: a seed gives the same rows, a corpus is
the prefix of a longer one, its shape before near-duplicates matches the
port's ``rcv1_like_corpus`` within stated tolerances, and its
near-duplicates put pairs on both sides of tau."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import corpus as corpus_mod
from benchmark.harness import BENCH

with open(os.path.join(BENCH, "configs", "rcv1_selfjoin_t07.json")) as f:
    PARAMS = json.load(f)["corpus"]
N = 20_000


@pytest.fixture(scope="module")
def ours():
    return corpus_mod.make_corpus(PARAMS, N, 2**40 + 3, "cpu")


@pytest.fixture(scope="module")
def base():
    """The same seed without near-duplicates: ``rcv1_like_corpus`` has
    none."""
    return corpus_mod.make_corpus(dict(PARAMS, near_rate=0.0), N, 2**40 + 3,
                                  "cpu")


@pytest.fixture(scope="module")
def theirs():
    from apsim_tpu_torch.bench.scale import rcv1_like_corpus

    return rcv1_like_corpus(N, seed=5)


def test_same_seed_same_rows(ours):
    again = corpus_mod.make_corpus(PARAMS, N, 2**40 + 3, "cpu")
    for a, b in zip((ours.indptr, ours.indices, ours.data),
                    (again.indptr, again.indices, again.data)):
        assert torch.equal(a, b)
    other = corpus_mod.make_corpus(PARAMS, N, 2**40 + 4, "cpu")
    assert not torch.equal(ours.indices[:1000], other.indices[:1000])


def test_prefix_of_a_longer_corpus(ours):
    longer = corpus_mod.make_corpus(PARAMS, 70_000, 2**40 + 3, "cpu")
    m = int(ours.indptr[-1])
    assert torch.equal(longer.indptr[:N + 1], ours.indptr)
    assert torch.equal(longer.indices[:m], ours.indices)
    assert torch.equal(longer.data[:m], ours.data)


def test_rows_are_unit_norm_and_sorted(ours):
    ptr, idx, val = ours.host()
    sq = np.add.reduceat(val * val, ptr[:-1])
    assert np.allclose(sq, 1.0, atol=1e-12)
    d = np.diff(idx.astype(np.int64))
    starts = np.zeros(idx.size, bool)
    starts[ptr[:-1]] = True
    assert (d[~starts[1:]] > 0).all()


def _dup_share(indptr, indices, data):
    rows = {}
    dup = 0
    for r in range(indptr.size - 1):
        key = (indices[indptr[r]:indptr[r + 1]].tobytes(),
               data[indptr[r]:indptr[r + 1]].tobytes())
        dup += key in rows
        rows[key] = r
    return dup / (indptr.size - 1)


def test_shape_matches_rcv1_like_corpus(base, theirs):
    ptr, idx, val = base.host()
    # mean terms a row within 3 %
    a, b = np.diff(ptr).mean(), np.diff(theirs.indptr).mean()
    assert abs(a / b - 1) < 0.03
    # the length distribution's quartiles within 5 %
    qa = np.percentile(np.diff(ptr), [25, 50, 75])
    qb = np.percentile(np.diff(theirs.indptr), [25, 50, 75])
    assert np.all(np.abs(qa / qb - 1) < 0.05)
    # the document-frequency curve: the top 10 / 100 / 1,000 ranks hold the
    # same share of entries within 5 % (relative)
    dfa = np.sort(np.bincount(idx, minlength=PARAMS["terms"]))[::-1]
    dfb = np.sort(np.bincount(theirs.indices,
                              minlength=PARAMS["terms"]))[::-1]
    for k in (10, 100, 1000):
        sa, sb = dfa[:k].sum() / dfa.sum(), dfb[:k].sum() / dfb.sum()
        assert abs(sa / sb - 1) < 0.05, k
    # duplicates: 1 % of rows, within 0.3 points
    assert abs(_dup_share(ptr, idx, val) - PARAMS["dup_rate"]) < 0.003
    assert abs(_dup_share(theirs.indptr, theirs.indices, theirs.data)
               - PARAMS["dup_rate"]) < 0.003


def test_near_duplicates_spread_across_tau(ours):
    """Pairs at or above 0.5 among the rows: the exact copies at 1.0, and
    the near-duplicates spread over 0.5-1.0 with some on each side of the
    configuration's 0.7 and some within 0.01 of it."""
    from benchmark.reference.cosine import neighbours

    qi, ci, s = neighbours(ours, ours, 0.5, 0.0, q_block=4096,
                           c_block=4096)
    s = s[qi < ci]
    exact = (s > 1 - 1e-12).sum()
    assert exact >= 0.8 * PARAMS["dup_rate"] * N
    near = s[s <= 1 - 1e-12]
    assert near.size >= 0.8 * PARAMS["near_rate"] * N
    counts = np.histogram(near, bins=[0.5, 0.6, 0.7, 0.8, 0.9, 1.0])[0]
    assert (counts >= 0.1 * near.size).all(), counts
    assert (np.abs(near - 0.7) < 0.01).sum() >= 10
