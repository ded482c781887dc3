"""The port's chunked streaming path on the CPU (``ChunkedAllPairs.insert``
matched online on the resident, host, paneled and rebuild routes, dormant
activation, freeze and frozen matching, ``topk``, width splits, the cost
router, checkpoints and the join after a stream) against the JAX package's
``ChunkedAllPairs`` on the same seeded stream, case for case as the
streaming legs of ``tests/test_chunked.py``, and against the fp64
brute-force oracle.

Tolerances: every insert's output equals the JAX engine's as a
``{query: {candidate}}`` map, with fp64 similarities within 1e-12; after
every batch the entry buffers (device and host mirror), the counts,
``_chunk_cap`` and ``_chunk_width`` equal JAX's exactly, the resident
stack equals JAX's ``_mslab`` exactly (bf16 compared as its fp32 values,
bit for bit), and the stats equal JAX's; a device candidate set contains
every oracle pair at ``tau_eff``.
"""

import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu_torch as pt
from apsim_tpu.engine import ChunkedAllPairs as JaxChunked
from apsim_tpu.vector.batch import CSRMatrix
from apsim_tpu.vector.sparse import Vectors
from apsim_tpu_torch.ops import chunked as chunked_ops

from oracle import brute_force_pairs, brute_force_sims, random_sparse_corpus

DIM = 500
STATS = ("insert_batches", "vectors_dropped_admission", "vectors_indexed",
         "pairs_emitted", "dormant_dims")
INF = float("inf")
# route -> (config overrides, engine attributes); the same on both engines
ROUTES = {
    "resident": ({}, {}),
    "host": (dict(match_slab_budget_mb=0), {"_rebuild_ns_per_nnz": INF}),
    "paneled": (dict(match_slab_budget_mb=0), {"_host_stream_match": False}),
    "rebuild": (dict(match_slab_budget_mb=0),
                {"_host_stream_match": False, "_paneled_match": False}),
}


def cfg_kw(**kw):
    base = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64)
    base.update(kw)
    return base


def engines(route="resident", chunk_dim=64, attrs=None, **cfg):
    """(port engine on the CPU, JAX engine) of one configuration."""
    ckw, rattrs = ROUTES[route]
    kw = cfg_kw(**{**ckw, **cfg})
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**kw), "cpu",
                           chunk_dim=chunk_dim)
    j = JaxChunked(apsim_tpu.AllPairsConfig(**kw), chunk_dim=chunk_dim)
    for eng in (p, j):
        for k, v in {**rattrs, **(attrs or {})}.items():
            setattr(eng, k, v)
    return p, j


def pv(v):
    return pt.SparseVector(v.size, v.indices, v.values)


def to_pt(csr):
    return pt.CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                        csr.data)


def head(csr, n):
    return CSRMatrix(n, csr.n_cols, csr.indptr[:n + 1],
                     csr.indices[:csr.indptr[n]], csr.data[:csr.indptr[n]])


def rows_of(csr, lo, hi, prefix=""):
    return [(f"{prefix}{i}", csr.row(i)) for i in range(lo, hi)]


def build_both(p, j, csr, ids=None):
    p.build(to_pt(csr), ids)
    j.build(csr, ids)
    assert_same_state(p, j)


def assert_same_output(op, oj):
    assert {q: set(c) for q, c in op.output.items()} == {
        q: set(c) for q, c in oj.output.items()}
    for q, cands in op.output.items():
        for c, s in cands.items():
            assert abs(s - oj.output[q][c]) <= 1e-12


def assert_same_state(p, j):
    assert p.n_rows == j.n_rows and p.ids == j.ids
    assert p.id_to_row == j.id_to_row
    assert set(p.stats) == set(j.stats)
    assert {k: p.stats[k] for k in STATS} == {k: j.stats[k] for k in STATS}
    if j._ent is None:
        assert p._ent is None
        return
    assert p.row_cap == j.row_cap
    assert (p._n_chunks, p._chunk_cap, p._chunk_width) == (
        j._n_chunks, j._chunk_cap, j._chunk_width)
    assert np.array_equal(p._counts, j._counts)
    for a, b, dev, jdev in zip(j._ent_host, p._ent_host, p._ent, j._ent):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(dev.numpy(), np.asarray(jdev))
    assert np.array_equal(p._ext_df, j._ext_df)
    assert np.array_equal(p.compact.ext_of_col, j.compact.ext_of_col)
    assert np.array_equal(p._dorm_rows, j._dorm_rows)
    assert (p._mslab is None) is (j._mslab is None)
    if j._mslab is not None:
        assert p._mslab.dtype == chunked_ops.slab_dtype(
            p.cfg.matmul_precision)
        assert np.array_equal(p._mslab.float().numpy(),
                              np.asarray(j._mslab).astype(np.float32))


def insert_both(p, j, batch, tau, **kw):
    op = p.insert([(i, pv(v)) for i, v in batch], tau=tau, **kw)
    oj = j.insert(batch, tau=tau, **kw)
    if kw.get("defer"):
        op, oj = op.result(), oj.result()
    assert_same_output(op, oj)
    assert_same_state(p, j)
    return op


def emitted_pairs(out, into: set) -> None:
    for q, cands in out.output.items():
        for c in cands:
            into.add((q, c) if q <= c else (c, q))


def oracle_cross(csr, qcsr, tau):
    """fp64 (index row, query local) pairs with dot >= tau."""
    s = qcsr.to_dense() @ csr.to_dense().T
    qi, ri = np.nonzero(s >= tau)
    return set(zip(ri.tolist(), qi.tolist()))


def device_candidates(p, qcsr, tau):
    """The device candidate set of external queries against the index."""
    ccsr = p.compact.map_csr(p._drop_unmapped(to_pt(qcsr)), extend=False)
    r, q = p._match_ccsr(ccsr, p.n_rows, p._tau_eff(tau))
    return set(zip(r.tolist(), q.tolist()))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    return random_sparse_corpus(rng, 220, DIM)


# ------------------------------------------------------------- streaming
@pytest.mark.parametrize("route", list(ROUTES))
def test_streaming_equals_batch_and_jax(route):
    """``test_chunked_streaming_equals_batch`` and
    ``test_chunked_streaming_slab_cache_matches_fallback`` on each route:
    every vector streamed in batches of 37 (the tail included), each
    batch's output and the index state equal the JAX engine's, the union
    of the outputs is the oracle's pair set, the device candidates of
    external queries contain every oracle pair, and the final join is
    exact."""
    rng = np.random.default_rng(11)
    corpus = random_sparse_corpus(rng, 150, DIM)
    tau = 0.4
    p, j = engines(route, chunk_dim=128)
    emitted = set()
    for s in range(0, corpus.n_rows, 37):
        out = insert_both(p, j, rows_of(corpus, s, min(s + 37,
                                                       corpus.n_rows)), tau)
        emitted_pairs(out, emitted)
    want = brute_force_pairs(corpus, tau)
    assert emitted == want and len(want) > 10
    assert (p._mslab is not None) is (route == "resident")
    assert (p._sort_state is not None) is (route == "paneled")
    queries = head(corpus, 40)
    if route != "host":
        cand = device_candidates(p, queries, tau)
        assert cand >= oracle_cross(corpus, queries, tau)
    assert p.all_pairs(tau).pair_set() == want


@pytest.mark.parametrize("route", ["resident", "paneled"])
def test_streaming_grows_capacity_and_dims(route):
    """``test_chunked_streaming_grows_capacity_and_dims``: brand-new dims
    in every batch double the chunk capacity (1,200 entries a batch over
    two chunks of 1,024 slots) and the chunk width."""
    rng = np.random.default_rng(3)
    p, j = engines(route, chunk_dim=64)
    seen = set()
    geoms = []
    for step in range(4):
        vecs = []
        for i in range(30):
            dims = np.sort(rng.choice(np.arange(step * 90, step * 90 + 90),
                                      40, replace=False)).astype(np.int32)
            vals = rng.random(40) + 0.1
            vals /= np.linalg.norm(vals)
            vecs.append((f"{step}:{i}", Vectors.sparse(DIM, dims, vals)))
        emitted_pairs(insert_both(p, j, vecs, 0.9), seen)
        geoms.append((p._chunk_cap, p._chunk_width))
    assert p.n_rows == 120
    assert geoms[0][0] < geoms[-1][0] and geoms[0][1] < geoms[-1][1]
    want = brute_force_pairs(p.shadow_csr(), 0.9, p.ids)
    assert p.all_pairs(0.9).pair_set() == want == seen


def test_insert_after_build_defer_and_bulk(corpus):
    """A build, then batches of 1, 32, 17 with ``defer`` and ``bulk``;
    ``defer=True`` returns an object whose ``result()`` is the output."""
    p, j = engines(chunk_dim=128)
    build_both(p, j, head(corpus, 150))
    emitted = p.all_pairs(0.5).pair_set()
    assert emitted == j.all_pairs(0.5).pair_set()
    s = 150
    for bs, kw in ((1, {}), (32, {"defer": True}), (17, {"bulk": True}),
                   (20, {})):
        emitted_pairs(insert_both(p, j, rows_of(corpus, s, s + bs), 0.5,
                                  **kw), emitted)
        s += bs
    assert emitted == brute_force_pairs(corpus, 0.5)
    assert p.stats["insert_batches"] == 4


@pytest.mark.parametrize("mode", ["ones", "real", "off"])
def test_admission_and_component_filter_equal_jax(corpus, mode):
    """Admission pruning and the component filter drop the same vectors
    as the JAX engine; the stats count them alike."""
    p, j = engines(chunk_dim=128, admission=mode, index_threshold=0.05)
    weak = [("w0", Vectors.sparse(DIM, [0, 1], [1e-4, 1e-4])),
            ("w1", Vectors.sparse(DIM, [5], [0.3])),
            ("e", Vectors.sparse(DIM, [], []))]
    for s in range(0, 120, 40):
        insert_both(p, j, rows_of(corpus, s, s + 40) + weak, 0.6)
    assert p.stats["vectors_dropped_admission"] > 0
    assert np.array_equal(p.max_weights, j.max_weights)


# ------------------------------------------------------------ dormant dims
def _dormant_corpus():
    # rows 0,1 share dim 5; row 2 has UNIQUE dims {100, 101} (dormant)
    v = Vectors.sparse
    a = 1 / np.sqrt(2)
    return CSRMatrix.from_vectors(
        [v(DIM, [5, 7], [a, a]), v(DIM, [5, 8], [a, a]),
         v(DIM, [100, 101], [a, a])], DIM)


@pytest.mark.parametrize("case", ["archived", "activation", "topk_frozen",
                                  "rebuild_clears"])
def test_dormant_equals_jax(case):
    """``test_chunked_dormant_archived_and_exact``, ``..._activation_on_
    insert``, ``..._topk_and_frozen_match`` and
    ``test_rebuild_clears_dormant_archive``."""
    a = 1 / np.sqrt(2)
    v = Vectors.sparse
    corpus = _dormant_corpus()
    p, j = engines(chunk_dim=16)
    build_both(p, j, corpus)
    assert p.stats["dormant_dims"] >= 2
    if case == "archived":
        assert p.all_pairs(0.3).pair_set() == brute_force_pairs(corpus, 0.3)
    elif case == "activation":
        out = insert_both(p, j, [("new", v(DIM, [100, 300], [a, a]))], 0.4)
        assert out.output["new"]["2"] == pytest.approx(0.5)
        assert p.stats["dormant_dims"] < j.stats["dormant_dims"] + 1
        assert p.all_pairs(0.4).pair_set() == brute_force_pairs(
            p.shadow_csr(), 0.4, p.ids)
    elif case == "topk_frozen":
        q = v(DIM, [100, 101], [a, a])  # only dormant dims
        rp, rj = p.topk([("q", pv(q))], 2), j.topk([("q", q)], 2)
        assert rp["q"][0] == ("2", pytest.approx(1.0))
        assert [r for r, _ in rp["q"]] == [r for r, _ in rj["q"]]
        p.freeze()
        j.freeze()
        out = insert_both(p, j, [("probe", q)], 0.9)
        assert out.output["probe"]["2"] == pytest.approx(1.0)
    else:
        small = CSRMatrix.from_vectors(
            [v(DIM, [5, 7], [a, a]), v(DIM, [5, 7], [a, a])], DIM)
        build_both(p, j, small, ["x", "y"])
        assert p.stats["dormant_dims"] == 0
        res = p.topk([("q", pv(v(DIM, [100, 101], [a, a])))], 2)["q"]
        assert all(r in ("x", "y") for r, _ in res)


def test_streaming_from_empty_with_dormant():
    """``test_chunked_streaming_from_empty_with_dormant``: the first batch
    builds (archiving df==1 dims), later batches activate them."""
    rng = np.random.default_rng(17)
    corpus = random_sparse_corpus(rng, 90, DIM)
    p, j = engines(chunk_dim=32)
    emitted = set()
    for s in range(0, 90, 30):
        emitted_pairs(insert_both(p, j, rows_of(corpus, s, s + 30), 0.4),
                      emitted)
    assert emitted == brute_force_pairs(corpus, 0.4)
    assert p.all_pairs(0.4).pair_set() == brute_force_pairs(corpus, 0.4)


# ----------------------------------------------------------------- frozen
def test_frozen_empty_insert_indexes_nothing():
    a = 1 / np.sqrt(2)
    p, j = engines(chunk_dim=16)
    p.freeze()
    j.freeze()
    assert p.frozen
    out = insert_both(p, j, [("p", Vectors.sparse(DIM, [1, 2], [a, a]))], 0.5)
    assert out.output == {} and p.n_rows == 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_freeze_external_match(route):
    """``test_chunked_freeze_external_match`` on every route: 40 external
    queries (copies and new vectors) equal the JAX engine's and the fp64
    oracle, and index nothing."""
    rng = np.random.default_rng(5)
    corpus = random_sparse_corpus(rng, 80, DIM)
    extra = random_sparse_corpus(np.random.default_rng(6), 20, DIM)
    p, j = engines(route, chunk_dim=128)
    build_both(p, j, corpus)
    p.freeze()
    j.freeze()
    batch = rows_of(corpus, 0, 20, "c") + rows_of(extra, 0, 20, "n")
    out = insert_both(p, j, batch, 0.5)
    assert p.n_rows == corpus.n_rows
    assert out.output["c0"]["0"] == pytest.approx(1.0)
    qcsr = CSRMatrix.from_vectors([v for _, v in batch], DIM)
    want = {(str(r), batch[q][0]) for r, q in oracle_cross(corpus, qcsr, 0.5)}
    assert {(c, q) for q, cs in out.output.items() for c in cs} == want
    p.unfreeze()
    assert not p.frozen


def test_host_match_external_and_dormant():
    """``test_chunked_host_match_external_and_dormant``: the host route's
    frozen match folds the archived entries in through the shadow, the
    device route through ``_dormant_hits``; both equal JAX's."""
    rng = np.random.default_rng(43)
    corpus = random_sparse_corpus(rng, 90, DIM)
    results = []
    for route in ("host", "paneled"):
        p, j = engines(route, chunk_dim=64)
        build_both(p, j, corpus)
        p.freeze()
        j.freeze()
        out = insert_both(p, j, rows_of(corpus, 0, 40, "q")[::3], 0.35)
        results.append({q: dict(s) for q, s in out.output.items()})
    assert results[0].keys() == results[1].keys() and any(results[0].values())
    for q in results[0]:
        assert results[0][q].keys() == results[1][q].keys()


# -------------------------------------------------- resident stack, router
def test_resident_and_rebuild_score_identically(corpus):
    """The resident stack and ``densify_chunk`` round each value once and
    alike: the two routes' score blocks are equal bit for bit (bf16 and
    fp32 stacks), and the stack equals the densified chunks."""
    for prec in ("default", "highest"):
        p = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw(
            matmul_precision=prec)), "cpu", chunk_dim=64)
        p.build(to_pt(corpus))
        stack = p._match_slabs()
        sdt = chunked_ops.slab_dtype(prec)
        for c in range(p._n_chunks):
            assert torch.equal(stack[c], chunked_ops.densify_chunk(
                *p._ent, p._counts, c, p.row_cap, p._chunk_width, sdt))
        ccsr = p.compact.map_csr(p._drop_unmapped(to_pt(head(corpus, 30))))
        q = p._bucket_queries(ccsr, 32)
        ra = chunked_ops.cached_match_extract(stack, q, 0, 0.3, 32, prec)
        rb = chunked_ops.chunked_match_extract(
            *p._ent, p._counts, q, 0, 0.3, p.row_cap, p._chunk_width, 32,
            prec)
        assert all(torch.equal(x, y) for x, y in zip(ra, rb))
        ta = chunked_ops.cached_topk(stack, q, p.n_rows, 32, 5, prec)
        tb = chunked_ops.chunked_topk(*p._ent, p._counts, q, p.n_rows,
                                      p.row_cap, p._chunk_width, 32, 5, prec)
        assert torch.equal(ta[0], tb[0])


def test_host_match_cost_router():
    """``test_host_match_cost_router``: the same decisions as JAX's."""
    rng = np.random.default_rng(47)
    corpus = random_sparse_corpus(rng, 120, DIM)
    p, j = engines(match_slab_budget_mb=0, chunk_dim=64)
    build_both(p, j, corpus)
    nnz = int(p.shadow_csr().indptr[-1])
    cold = np.array([DIM - 1], np.int64)
    assert p._ext_df[cold].sum() * p._host_ns_per_flop < nnz
    hot = np.tile(corpus.indices, 8)
    for q, host in ((cold, True), (hot, False)):
        assert p._use_host_match(q) is j._use_host_match(q) is host
    p._ext_df = None  # no document frequencies: stay on the device
    assert not p._use_host_match(cold)
    r, _ = engines(chunk_dim=64)
    r.build(to_pt(corpus))
    assert not r._use_host_match(cold)  # the resident stack fits


def test_slab_cache_lifecycle(corpus):
    """``test_chunked_slab_cache_lifecycle``: the stack is built on the
    first match, kept through same-geometry appends, dropped by
    ``all_pairs`` and rebuilt at a wider chunk width; exact throughout."""
    a = 1 / np.sqrt(2)
    p, j = engines(chunk_dim=64)
    build_both(p, j, head(corpus, 60))
    assert p._mslab is None
    insert_both(p, j, [("a", corpus.row(0))], 0.5)
    stack = p._mslab
    assert stack is not None and p.timer.counts["match_slabs"] == 1
    insert_both(p, j, [("b", corpus.row(1))], 0.5)
    assert p._mslab is stack and p.timer.counts["match_slabs"] == 1
    res = p.all_pairs(0.5)
    assert p._mslab is None
    assert res.pair_set() == brute_force_pairs(p.shadow_csr(), 0.5, p.ids)
    j.all_pairs(0.5)
    w0, step = p._chunk_width, 0
    while p._chunk_width == w0:
        d = 64 * p._n_chunks + step * 2
        insert_both(p, j, [
            (f"n{step}", Vectors.sparse(DIM, [d % DIM, (d + 1) % DIM],
                                        [a, a])),
            (f"m{step}", Vectors.sparse(DIM, [d % DIM, (d + 3) % DIM],
                                        [a, a]))], 0.5)
        step += 1
        assert step < 80, "width never grew"
    assert p._mslab is None or p._mslab.shape[2] == p._chunk_width
    assert p.all_pairs(0.5).pair_set() == brute_force_pairs(
        p.shadow_csr(), 0.5, p.ids)


# ------------------------------------------------------------------- topk
@pytest.mark.parametrize("budget", [0, 7168])
def test_topk_equals_jax_and_oracle(budget):
    """``test_chunked_topk_cache_matches_fallback``: the resident stack's
    top-k (bf16 scores, widened margin) and the rebuild route's (fp32 at
    "highest") both equal JAX's and the fp64 oracle."""
    rng = np.random.default_rng(7)
    corpus = random_sparse_corpus(rng, 120, DIM)
    p, j = engines(chunk_dim=64, match_slab_budget_mb=budget)
    build_both(p, j, corpus)
    queries = rows_of(corpus, 0, 40, "q")[::3] + [
        ("z", Vectors.sparse(DIM, [499], [1.0]))]
    rp = p.topk([(i, pv(v)) for i, v in queries], 5)
    rj = j.topk(queries, 5)
    assert (p._mslab is not None) is bool(budget)
    sims = brute_force_sims(corpus)
    assert rp.keys() == rj.keys()
    for q, _ in queries:
        assert [r for r, _ in rp[q]] == [r for r, _ in rj[q]]
        for (_, s0), (_, s1) in zip(rp[q], rj[q]):
            assert s0 == pytest.approx(s1, abs=1e-12)
        if q != "z":
            want = np.sort(sims[int(q[1:])])[::-1][:5]
            np.testing.assert_allclose([s for _, s in rp[q]], want,
                                       atol=1e-12)
    assert p.topk([], 3) == {}


def test_topk_width_split(corpus):
    """``test_chunked_topk_width_split``: the merged split result equals
    the unsplit one."""
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()), "cpu", chunk_dim=64)
    p.build(to_pt(corpus))
    queries = [(f"q{i}", pv(corpus.row(i))) for i in range(24)]
    whole = p.topk(queries, 3)
    p._match_width_limit = lambda: 8  # three sub-batches
    assert p.topk(queries, 3) == whole and len(whole) == 24


@pytest.mark.parametrize("route", ["resident", "paneled"])
def test_match_width_split_exact(route):
    """``test_chunked_match_width_split_exact``: batches wider than the
    width limit are matched in parts; intra-batch pairs across the split
    surface, and frozen matching takes the same split."""
    rng = np.random.default_rng(77)
    corpus = random_sparse_corpus(rng, 120, DIM)
    p, j = engines(route, chunk_dim=64)
    p._match_width_limit = j._match_width_limit = lambda: 16
    p._paneled_q_cap = j._paneled_q_cap = 16
    emitted = set()
    for s in range(0, corpus.n_rows, 50):
        emitted_pairs(insert_both(p, j, rows_of(corpus, s, min(
            s + 50, corpus.n_rows)), 0.4), emitted)
    assert emitted == brute_force_pairs(corpus, 0.4)
    p.freeze()
    j.freeze()
    out = insert_both(p, j, rows_of(corpus, 0, 40, "p"), 0.99)
    for i in range(40):
        assert out.output[f"p{i}"][str(i)] == pytest.approx(1.0)


# ---------------------------------------------------------- paneled route
def test_paneled_multi_panel_parity(corpus):
    """``test_paneled_match_multi_panel_parity``: panels of 128 rows (8
    for a row_cap of 1024 would need more rows; here 2), activations in the
    overflow region, every oracle pair surfaced by the stream."""
    p, j = engines("paneled", chunk_dim=64, dormant_dims=True)
    p._paneled_ph_cap = j._paneled_ph_cap = 128
    build_both(p, j, head(corpus, 150), [str(i) for i in range(150)])
    assert p._paneled_ok()
    outs = {}
    for s in range(150, corpus.n_rows, 7):
        outs.update(insert_both(p, j, rows_of(corpus, s, min(
            s + 7, corpus.n_rows)), 0.5).output)
    st = p._sort_state
    assert p._paneled_ph() == 128 and p.row_cap // 128 >= 2
    assert st["n_o"] > 0 and st["n_o"] == j._sort_state["n_o"]
    assert st["n_ent"] == j._sort_state["n_ent"]
    want = brute_force_pairs(corpus, 0.5)
    assert p.all_pairs(0.5).pair_set() == want
    for a, b in want:
        hi, lo = max(int(a), int(b)), min(int(a), int(b))
        if hi >= 150:
            assert str(lo) in outs.get(str(hi), {}), (lo, hi)


def test_paneled_overflow_consolidation(corpus):
    """``test_paneled_match_overflow_consolidation``: a tiny overflow
    region drops the sorted state; the next match re-sorts; exact."""
    p, j = engines("paneled", chunk_dim=64, dormant_dims=True)
    p._sort_o_cap = j._sort_o_cap = 4
    build_both(p, j, head(corpus, 150), [str(i) for i in range(150)])
    for s in range(150, corpus.n_rows, 7):
        insert_both(p, j, rows_of(corpus, s, min(s + 7, corpus.n_rows)), 0.5)
    assert p.timer.counts["sort_entries"] > 1  # re-sorted after a drop
    assert p.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)


def test_paneled_frozen_and_topk(corpus):
    """``test_paneled_match_frozen_and_topk``."""
    p, j = engines("paneled", chunk_dim=64, dormant_dims=True)
    build_both(p, j, corpus, [str(i) for i in range(corpus.n_rows)])
    p.freeze()
    j.freeze()
    assert p._paneled_ok()
    out = insert_both(p, j, [("q", corpus.row(3))], 0.5)
    sims = brute_force_sims(corpus)
    assert set(out.output["q"]) == {
        str(x) for x in np.flatnonzero(sims[3] >= 0.5)} | {"3"}
    got = [s for _, s in p.topk([("t", pv(corpus.row(1)))], 3)["t"]]
    np.testing.assert_allclose(got, np.sort(sims[1])[::-1][:3], atol=1e-12)


def test_sorted_state_equals_a_fresh_sort(corpus):
    """After a stream with activations, the sorted region plus the
    overflow region hold exactly the entry buffers' live entries (a fresh
    ``sort_entries`` of them), as multisets of (row, col, value)."""
    p, _ = engines("paneled", chunk_dim=64, dormant_dims=True)
    p.build(to_pt(head(corpus, 150)))
    for s in range(150, corpus.n_rows, 9):
        p.insert([(str(i), pv(corpus.row(i)))
                  for i in range(s, min(s + 9, corpus.n_rows))], tau=0.5)
    st = p._sort_state
    assert st is not None and st["n_o"] > 0
    r, g, v, n = chunked_ops.sort_entries(*p._ent, p._counts_dev, 1 << 16)

    def triples(rs, gs, vs):
        return sorted(zip(rs.tolist(), gs.tolist(), vs.tolist()))

    kept = triples(torch.cat([st["r_s"][:st["n_ent"]], st["r_o"][:st["n_o"]]]),
                   torch.cat([st["gc_s"][:st["n_ent"]],
                              st["gc_o"][:st["n_o"]]]),
                   torch.cat([st["v_s"][:st["n_ent"]], st["v_o"][:st["n_o"]]]))
    assert kept == triples(r[:n], g[:n], v[:n])
    rs = st["r_s"][:st["n_ent"]]
    assert torch.equal(rs, torch.sort(rs).values)  # the region stays sorted


# ------------------------------------------- the join after a stream (fault 2)
@pytest.mark.parametrize("step", ["activation_only", "same_panel_insert"])
def test_join_after_append_keeping_geometry(step):
    """An append that leaves the panel geometry ``(rb, tm, tn, n_panels,
    d_cap)`` as it was (an activation-only batch: its own entries are
    archived singletons; or a few rows inside the last panel) must not
    reuse the join state of the entries before it."""
    a = 1 / np.sqrt(2)
    v = Vectors.sparse
    rng = np.random.default_rng(29)
    base = random_sparse_corpus(rng, 200, DIM)
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()), "cpu",
                           chunk_dim=128, panel_rows=128)
    j = JaxChunked(apsim_tpu.AllPairsConfig(**cfg_kw(use_pallas="on")),
                   chunk_dim=128, panel_rows=64)
    vecs = [base.row(i) for i in range(base.n_rows)] + [
        v(DIM, [440 + i, 441 + i], [a, a]) for i in (0, 10)]
    csr = CSRMatrix.from_vectors(vecs, DIM)
    build_both(p, j, csr)
    assert p.all_pairs(0.3).pair_set() == j.all_pairs(0.3).pair_set()
    geom, key = p._panel_geom(), p._panel_state_cache[0]
    if step == "activation_only":
        # dims 440 and 450 were archived singletons of rows 200 and 201:
        # a row sharing one of each activates both, its other dims archive
        batch = [("act", v(DIM, [440, 450, 497], [0.6, 0.6, np.sqrt(0.28)]))]
    else:
        batch = [(f"x{i}", base.row(i)) for i in range(3)]
    dorm0 = p.stats["dormant_dims"]
    insert_both(p, j, batch, 0.3)
    assert p._panel_geom() == geom
    if step == "activation_only":
        assert p.stats["dormant_dims"] < dorm0 + 1
    got = p.all_pairs(0.3)
    assert p._panel_state_cache[0] != key
    want = brute_force_pairs(p.shadow_csr(), 0.3, p.ids)
    assert got.pair_set() == j.all_pairs(0.3).pair_set() == want
    assert len(want) > 10


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("flavor", ["chunked", "dense"])
def test_checkpoint_keeps_ext_df_and_router(corpus, flavor, tmp_path):
    """A JAX checkpoint of either flavor gives the port the JAX engine's
    document frequencies, so the router decides as JAX's does on the same
    batch, and streaming continues equal to the JAX engine restored from
    the same checkpoint."""
    ids = [f"doc{i}" for i in range(corpus.n_rows)]
    kw = cfg_kw(match_slab_budget_mb=0)
    if flavor == "dense":
        src = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**kw))
    else:
        src = JaxChunked(apsim_tpu.AllPairsConfig(**kw), chunk_dim=64)
    src.build([(d, corpus.row(i)) for i, d in enumerate(ids)])
    src.save(str(tmp_path))
    p = pt.ChunkedAllPairs.load(str(tmp_path), pt.AllPairsConfig(**kw),
                                device="cpu", chunk_dim=64)
    j = JaxChunked.load(str(tmp_path), apsim_tpu.AllPairsConfig(**kw),
                        chunk_dim=64)
    assert np.array_equal(p._ext_df, j._ext_df)
    assert int(p._ext_df.sum()) == int(corpus.indptr[-1])
    for q in (np.array([DIM - 1]), np.tile(corpus.indices, 8),
              corpus.indices[:200]):
        assert p._use_host_match(q) is j._use_host_match(q)
    for eng in (p, j):
        eng._rebuild_ns_per_nnz = INF  # the host route, on both
    insert_both(p, j, rows_of(corpus, 0, 12, "s"), 0.5)
    assert p.timer.counts["host_match"] == 1


def test_checkpoint_without_ext_df_stays_on_device(corpus, tmp_path):
    """A chunked checkpoint saved with an empty ``chunk_ext_df`` restores
    with no document frequencies, and the router then stays on the
    device, as JAX's does."""
    j = JaxChunked(apsim_tpu.AllPairsConfig(**cfg_kw(match_slab_budget_mb=0)),
                   chunk_dim=64)
    j.build(corpus)
    j._ext_df = np.empty(0, np.int64)
    j.save(str(tmp_path))
    p = pt.ChunkedAllPairs.load(
        str(tmp_path), pt.AllPairsConfig(**cfg_kw(match_slab_budget_mb=0)),
        device="cpu", chunk_dim=64)
    assert p._ext_df is None and not p._use_host_match(np.array([DIM - 1]))


def test_streamed_state_layout_equals_jax_and_ops(corpus):
    """The entry-buffer ops on their own: ``append_entries`` sets exactly
    the given slots, ``grow_entry_cap`` pads with the pad row, and
    ``append_match_slabs`` refuses a repeated target."""
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()), "cpu", chunk_dim=64)
    p.build(to_pt(corpus))
    ent = tuple(t.clone() for t in p._ent)
    g = chunked_ops.grow_entry_cap(*ent, 2 * p._chunk_cap, 1 << 30)
    cap = p._chunk_cap
    assert torch.equal(g[0][:, :cap], ent[0])
    assert bool((g[0][:, cap:] == (1 << 30)).all())
    assert not g[1][:, cap:].any() and not g[2][:, cap:].any()
    z = torch.zeros(2, dtype=torch.int32)
    chunked_ops.append_entries(*g, z, torch.tensor([cap, cap + 1]),
                               torch.tensor([7, 8], dtype=torch.int32),
                               torch.tensor([1, 2], dtype=torch.int32),
                               torch.tensor([0.5, 0.25]))
    assert g[0][0, cap:cap + 2].tolist() == [7, 8]
    assert g[2][0, cap:cap + 2].tolist() == [0.5, 0.25]
    stack = p._match_slabs()
    with pytest.raises(ValueError, match="repeated"):
        chunked_ops.append_match_slabs(stack, z, torch.tensor([3, 3]),
                                       torch.tensor([1, 1]),
                                       torch.tensor([1.0, 2.0]))
