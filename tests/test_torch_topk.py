"""The port's ``Engine.topk`` and frozen-index matching on the CPU, and the
streaming device ops under them (``match_rows_extract``,
``queries_match_extract``, ``topk_scores``), against the JAX package on
the same seeded inputs and against the fp64 brute-force oracle.

Tolerances: top-k lists equal the JAX engine's id for id, with fp64 scores
within 1e-12 (both re-rank the same fetched rows in fp64 with one stable
sort, so ties order the same); frozen-match outputs equal as
``{query: {candidate}}`` maps with fp64 similarities within 1e-12; the
ops' candidate sets equal the JAX ops' where no fp32 score lies within
1e-6 of the threshold, and their top scores agree within 1e-6.
"""

import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu.engine.engine as jax_engine_mod
import apsim_tpu_torch as pt
from apsim_tpu.ops import score as jax_score
from apsim_tpu.vector.batch import CSRMatrix
from apsim_tpu.vector.sparse import SparseVector, Vectors
from apsim_tpu_torch.engine import engine as pt_engine_mod
from apsim_tpu_torch.ops import score as pt_score
from apsim_tpu_torch.vector.batch import pack_coo_i32

from oracle import random_sparse_corpus

DIM = 700


def cfg_kw(**kw):
    base = dict(vector_dim=DIM, row_bucket=256, dim_bucket=2048,
                query_tile=256)
    base.update(kw)
    return base


def engines(csr=None, **kw):
    """(port engine on the CPU, JAX engine), both built from ``csr``."""
    p = pt.Engine(pt.AllPairsConfig(**cfg_kw(**kw)), "cpu")
    j = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**cfg_kw(**kw)))
    if csr is not None:
        p.build(to_pt(csr))
        j.build(csr)
    return p, j


def to_pt(csr):
    return pt.CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                        csr.data)


def pv(v):
    return pt.SparseVector(v.size, v.indices, v.values)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(43)
    base = random_sparse_corpus(rng, 290, DIM, n_hot_dims=12)
    rows = [base.row(i) for i in range(base.n_rows)]
    rows += [base.row(i) for i in range(0, 30, 3)]  # exact duplicates: ties
    return CSRMatrix.from_vectors(rows, DIM).normalized()


@pytest.fixture(scope="module")
def queries(corpus):
    """Corpus rows (self matches and duplicate ties at 1.0), fresh random
    rows, one unnormalized row and one with dims the index never saw."""
    rng = np.random.default_rng(44)
    fresh = random_sparse_corpus(rng, 20, DIM, n_hot_dims=12)
    qs = [(f"c{i}", corpus.row(i)) for i in (0, 3, 7, 150, 299)]
    qs += [(f"f{i}", fresh.row(i)) for i in range(fresh.n_rows)]
    r = fresh.row(0)
    qs.append(("big", SparseVector(DIM, r.indices, r.values * 3.0)))
    return qs


def assert_same_topk(rp, rj):
    assert list(rp) == list(rj)
    for q in rp:
        assert [c for c, _ in rp[q]] == [c for c, _ in rj[q]], q
        for (_, a), (_, b) in zip(rp[q], rj[q]):
            assert abs(a - b) <= 1e-12


def assert_same_output(op, oj):
    assert {q: set(c) for q, c in op.output.items()} == {
        q: set(c) for q, c in oj.output.items()}
    for q, cands in op.output.items():
        for c, s in cands.items():
            assert abs(s - oj.output[q][c]) <= 1e-12


# ------------------------------------------------------------------ topk
@pytest.mark.parametrize("k", [1, 5, 12])
@pytest.mark.parametrize("case", ["default", "bfloat16"])
def test_topk_equals_jax_and_oracle(corpus, queries, case, k):
    kw = {"default": {}, "bfloat16": {"dtype": "bfloat16"}}[case]
    p, j = engines(corpus, **kw)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    rp = p.topk([(q, pv(v)) for q, v in queries], k)
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    assert_same_topk(rp, j.topk(queries, k))
    dense = corpus.to_dense()
    qd = np.stack([v.to_array() for _, v in queries])
    s = qd @ dense.T
    for qi, (q, _) in enumerate(queries):
        want = np.sort(s[qi])[::-1][:k]
        got = np.array([sc for _, sc in rp[q]])
        assert np.allclose(got, want, rtol=0, atol=1e-12)
        assert all(abs(s[qi, int(c)] - sc) <= 1e-12 for c, sc in rp[q])
    assert rp["c0"][0][1] == pytest.approx(1.0)


def test_topk_query_with_unseen_dims(corpus):
    p, j = engines(corpus)
    unseen = [d for d in range(DIM - 1, 0, -1)
              if p.compact.cols_of(np.array([d]))[0] < 0
              and d not in set(corpus.indices.tolist())][:2]
    assert len(unseen) == 2
    q = [("q", Vectors.sparse(DIM, sorted(unseen), [0.6, 0.8]))]
    rp = p.topk([(n, pv(v)) for n, v in q], 3)
    assert_same_topk(rp, j.topk(q, 3))
    assert [s for _, s in rp["q"]] == [0.0, 0.0, 0.0]


def near_tie_corpus(n=200, base=0.9):
    # n vectors whose similarity to e0 differs only at the 1e-13 level:
    # tied in fp32, strictly ordered in fp64, the best at the LAST row
    vecs = []
    for i in range(n):
        s = base + i * 1e-13
        vecs.append(SparseVector(DIM, np.array([0, 1 + i], np.int32),
                                 np.array([s, np.sqrt(1.0 - s * s)])))
    q = SparseVector(DIM, np.array([0], np.int32), np.array([1.0]))
    return CSRMatrix.from_vectors(vecs, DIM), q


def test_topk_exact_under_near_ties():
    corpus, q = near_tie_corpus()
    p, j = engines(corpus)
    got = p.topk([("q", pv(q))], 3)["q"]
    n = corpus.n_rows
    assert [g[0] for g in got] == [str(n - 1), str(n - 2), str(n - 3)]
    assert got[0][1] == pytest.approx(0.9 + (n - 1) * 1e-13, abs=1e-15)
    assert_same_topk({"q": got}, j.topk([("q", q)], 3))


def test_topk_after_streaming(corpus, queries):
    """Top-k over an index that grew through inserts (rows and dims)."""
    p, j = engines(dim_bucket=64)
    rng = np.random.default_rng(2)
    for s in range(0, corpus.n_rows, 70):
        batch = [(str(i), corpus.row(i))
                 for i in range(s, min(s + 70, corpus.n_rows))]
        # a few vectors on dims no earlier row used
        batch.append((f"n{s}", Vectors.sparse(
            DIM, sorted(rng.choice(np.arange(650, DIM), 3, replace=False)),
            [0.6, 0.6, np.sqrt(0.28)])))
        p.insert([(i, pv(v)) for i, v in batch], tau=0.7)
        j.insert(batch, tau=0.7)
    assert (p.row_cap, p.dim_cap) == (j.row_cap, j.dim_cap)
    assert_same_topk(p.topk([(q, pv(v)) for q, v in queries], 6),
                     j.topk(queries, 6))


def test_topk_edges():
    p, j = engines()
    assert p.topk([], 3) == {} and p.topk([("q", pv(
        Vectors.sparse(DIM, [0], [1.0])))], 3) == {"q": []}
    one = CSRMatrix.from_vectors([Vectors.sparse(DIM, [0], [1.0])], DIM)
    p, j = engines(one)
    q = [("q", Vectors.sparse(DIM, [0], [1.0]))]
    rp = p.topk([(n, pv(v)) for n, v in q], 5)
    assert len(rp["q"]) == 1  # k clamped to the corpus size
    assert_same_topk(rp, j.topk(q, 5))
    assert p.topk([], 3) == {}


def test_topk_helpers_equal_jax():
    """``assemble_topk`` and ``fetch_exact_topk`` (host code) give the JAX
    package's answers on tie-dense inputs, and the fetch grows until the
    margin proof holds."""
    rng = np.random.default_rng(5)
    nq, n_rows = 6, 500
    scores = np.round(rng.random((nq, n_rows)), 2)  # many exact ties
    order = np.argsort(-scores, axis=1, kind="stable")

    def fetch(kf):
        calls.append(kf)
        return np.take_along_axis(scores, order[:, :kf], 1), order[:, :kf]

    out = []
    for mod in (pt_engine_mod, jax_engine_mod):
        calls = []
        rows, kf = mod.fetch_exact_topk(fetch, n_rows, 5, 0.3)
        out.append((rows.tolist(), kf, list(calls)))
    assert out[0] == out[1] and len(out[0][2]) > 1
    qi = np.repeat(np.arange(nq), 40)
    cand = rng.integers(0, 30, qi.size)
    sims = np.round(rng.random(qi.size), 1)
    ids = [f"r{i}" for i in range(30)]
    qids = [f"q{i}" for i in range(nq)]
    got = pt_engine_mod.assemble_topk(qids, qi, cand, sims, 7, ids)
    assert got == jax_engine_mod.assemble_topk(qids, qi, cand, sims, 7, ids)


# ------------------------------------------------------- frozen matching
@pytest.mark.parametrize("case", ["default", "highest"])
def test_frozen_match_equals_jax(corpus, queries, case):
    """Frozen inserts query without indexing: the JAX engine's output,
    with the unnormalized query widening the margin."""
    kw = {"default": {}, "highest": {"matmul_precision": "highest"}}[case]
    p, j = engines(corpus, **kw)
    p.freeze()
    j.freeze()
    for tau in (0.3, 0.8):
        op = p.insert([(q, pv(v)) for q, v in queries], tau=tau)
        assert_same_output(op, j.insert(queries, tau=tau))
    assert p.n_rows == corpus.n_rows and "c0" in op.output
    assert p._max_norm == j._max_norm == pytest.approx(1.0)
    assert p.stats["pairs_emitted"] == j.stats["pairs_emitted"]


def test_dormant_topk_and_frozen_match():
    a = 1 / np.sqrt(2)
    v = Vectors.sparse
    corpus = CSRMatrix.from_vectors(
        [v(DIM, [5, 7], [a, a]), v(DIM, [5, 8], [a, a]),
         v(DIM, [100, 101], [a, a])], DIM)
    p, j = engines(corpus)
    q = v(DIM, [100, 101], [a, a])  # only dormant dims
    rp = p.topk([("q", pv(q))], 2)
    assert rp["q"][0] == ("2", pytest.approx(1.0))
    assert_same_topk(rp, j.topk([("q", q)], 2))
    p.freeze()
    j.freeze()
    op = p.insert([("probe", pv(q))], tau=0.9)
    assert op.output["probe"]["2"] == pytest.approx(1.0)
    assert_same_output(op, j.insert([("probe", q)], tau=0.9))


# ------------------------------------------------------------- the ops
@pytest.fixture(scope="module")
def built(corpus):
    return engines(corpus, matmul_precision="highest")


def test_match_rows_extract_equals_jax(built):
    """The batch's rows (from row 260 on) against the index: the JAX
    tile match's candidates with the columns below 260 masked."""
    p, j = built
    n0, n = 260, p.n_rows
    tau_eff = 0.3
    q = p.x[n0:n0 + 48]  # 48 = n - n0 rounded up to 8
    rows, cols = pt_score.match_rows_extract(p.x, q, n0, n, tau_eff,
                                             "highest")
    got = set(zip(rows.tolist(), cols.tolist()))
    (bi, bj), packed = jax_score.match_tile_extract(
        j.x, np.int32(256), np.int32(n0), np.float32(tau_eff), 256, 1 << 16,
        "highest")
    r, c, count, _ = jax_score.unpack_head(np.asarray(packed))
    if count > r.size:
        r, c = jax_score.decode_pairs((bi, bj), count)
    assert got == set(zip(r.tolist(), c.tolist())) and len(got) > 40
    assert all(a != b and b >= n0 for a, b in got)
    s = (p.x[:n].double() @ p.x[:n].double().T).numpy()
    assert np.all(np.abs(s[:, n0:][s[:, n0:] > 0] - tau_eff) > 1e-6)


def test_queries_match_and_topk_scores_equal_jax(built, queries):
    p, j = built
    qcsr = CSRMatrix.from_vectors([v for _, v in queries], DIM)
    compact = p.compact.map_csr(p._drop_unmapped(to_pt(qcsr)))
    rows_b = np.repeat(np.arange(compact.n_rows), np.diff(compact.indptr))
    coo = pack_coo_i32(rows_b, compact.indices, compact.data, compact.n_rows)
    q = pt_score.densify_rows(coo, compact.n_rows, p.dim_cap, p.x.dtype,
                              "cpu")
    tau_eff = 0.35
    r, c = pt_score.queries_match_extract(p.x, q, tau_eff, "highest")
    (bi, bj), packed = jax_score.dense_queries_extract(
        j.x, q.numpy(), np.float32(tau_eff), 1 << 16, "highest")
    jr, jc, count, _ = jax_score.unpack_head(np.asarray(packed))
    assert count <= jr.size
    assert set(zip(r.tolist(), c.tolist())) == set(zip(jr.tolist(),
                                                       jc.tolist()))
    s, rows = pt_score.topk_scores(p.x, q, p.n_rows, 9, "highest")
    js, jrows = jax_score.topk_scores(j.x, q.numpy(), np.int32(p.n_rows), 9,
                                      "highest")
    assert np.allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    assert bool((rows < p.n_rows).all()) and rows.dtype == torch.int64
    # a short index: rows past n_rows score -inf and are never returned
    s2, r2 = pt_score.topk_scores(p.x, q, 5, 5, "highest")
    assert bool((r2 < 5).all()) and bool(torch.isfinite(s2).all())
