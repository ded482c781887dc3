"""The port's streaming path on the CPU (``Engine.insert`` matched online,
admission, dormant activation, rollback, freeze, ``defer``; the 1-shard
``MeshEngine``; ``OutputBatcher``, ``cross_pair_dots``; the static
max-weight map of a JAX checkpoint) against the JAX package's ``Engine`` on
the same seeded stream, and against the fp64 brute-force oracle.

Tolerances: every insert's output equals the JAX engine's as a
``{query: {candidate}}`` map, with fp64 similarities within 1e-12; after
every batch the index ``x`` equals the JAX index exactly, with equal
``row_cap`` / ``dim_cap``, and the stats the JAX tests read are equal.
"""

import time

import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu.ops.score as jax_score
import apsim_tpu_torch as pt
import apsim_tpu_torch.ops.score as pt_score
from apsim_tpu.engine.chunked import ChunkedAllPairs as JaxChunked
from apsim_tpu.engine.output import OutputBatcher as JaxOutputBatcher
from apsim_tpu.ops import rescore as jax_rescore
from apsim_tpu.vector.batch import CSRMatrix
from apsim_tpu.vector.sparse import Vectors
from apsim_tpu_torch.ops import rescore as pt_rescore

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 700
STATS = ("insert_batches", "vectors_dropped_admission", "vectors_indexed",
         "pairs_emitted", "dormant_dims")


def cfg_kw(**kw):
    base = dict(vector_dim=DIM, row_bucket=256, dim_bucket=2048,
                query_tile=256)
    base.update(kw)
    return base


def engines(**kw):
    """(port engine on the CPU, JAX engine) of one configuration."""
    return (pt.Engine(pt.AllPairsConfig(**cfg_kw(**kw)), "cpu"),
            apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**cfg_kw(**kw))))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(41)
    base = random_sparse_corpus(rng, 290, DIM, n_hot_dims=12)
    rows = [base.row(i) for i in range(base.n_rows)]
    rows += [base.row(i) for i in range(0, 40, 4)]  # exact duplicates
    return CSRMatrix.from_vectors(rows, DIM).normalized()


def pv(v):
    """The port's SparseVector of a JAX-package vector."""
    return pt.SparseVector(v.size, v.indices, v.values)


def to_pt(csr):
    return pt.CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                        csr.data)


def rows_of(csr, lo, hi, prefix=""):
    return [(f"{prefix}{i}", csr.row(i)) for i in range(lo, hi)]


def assert_same_output(op, oj):
    assert {q: set(c) for q, c in op.output.items()} == {
        q: set(c) for q, c in oj.output.items()}
    for q, cands in op.output.items():
        for c, s in cands.items():
            assert abs(s - oj.output[q][c]) <= 1e-12


def assert_same_state(p, j):
    assert (p.row_cap, p.dim_cap, p.n_rows) == (j.row_cap, j.dim_cap, j.n_rows)
    assert np.array_equal(p.x.float().numpy(),
                          np.asarray(j.x).astype(np.float32))
    assert p.ids == j.ids and p.id_to_row == j.id_to_row
    assert {k: p.stats[k] for k in STATS} == {k: j.stats[k] for k in STATS}


def insert_both(p, j, batch, tau, **kw):
    """One insert into both engines; outputs and state must agree."""
    op = p.insert([(i, pv(v)) for i, v in batch], tau=tau, **kw)
    oj = j.insert(batch, tau=tau, **kw)
    assert_same_output(op, oj)
    assert_same_state(p, j)
    return op


def emitted_pairs(out, into: set) -> None:
    for q, cands in out.output.items():
        for c in cands:
            into.add((q, c) if q <= c else (c, q))


# ------------------------------------------------------------ streaming
@pytest.mark.parametrize("case", ["default", "highest", "bfloat16"])
def test_streaming_equals_batch_and_jax(corpus, case):
    """Every vector streamed in batches of 23 (the tail included): each
    batch's output and the index equal the JAX engine's, and the union of
    the outputs is the batch join's pair set."""
    kw = {"default": {}, "highest": {"matmul_precision": "highest"},
          "bfloat16": {"dtype": "bfloat16"}}[case]
    tau = 0.4
    p, j = engines(**kw)
    emitted = set()
    for s in range(0, corpus.n_rows, 23):
        out = insert_both(p, j, rows_of(corpus, s, min(s + 23,
                                                       corpus.n_rows)), tau)
        emitted_pairs(out, emitted)
    assert p.n_rows == corpus.n_rows and p.row_cap == 512
    want = brute_force_pairs(corpus, tau)
    assert emitted == want and len(want) > 50
    assert p.all_pairs(tau).pair_set() == want


def test_intra_batch_pairs_both_ways():
    p, j = engines()
    v = Vectors.sparse(DIM, [3, 9], [0.6, 0.8])
    out = insert_both(p, j, [("a", v), ("b", v)], 0.9)
    assert out.output["a"]["b"] == pytest.approx(1.0)
    assert out.output["b"]["a"] == pytest.approx(1.0)


def test_streaming_grows_capacity():
    """Rows and brand-new dims grow both capacities by the JAX law."""
    kw = dict(row_bucket=64, dim_bucket=64, query_tile=64)
    p, j = engines(**kw)
    rng = np.random.default_rng(3)
    caps = []
    for step in range(4):
        batch = []
        for i in range(40):
            dims = np.sort(rng.choice(np.arange(step * 150, step * 150 + 150),
                                      5, replace=False)).astype(np.int32)
            vals = rng.random(5) + 0.1
            batch.append((f"{step}:{i}",
                          Vectors.sparse(DIM, dims, vals / np.linalg.norm(vals))))
        insert_both(p, j, batch, 0.95)
        caps.append((p.row_cap, p.dim_cap))
    assert p.n_rows == 160
    assert caps[0][0] < caps[-1][0] and caps[0][1] < caps[-1][1]
    want = brute_force_pairs(p.shadow_csr(), 0.95, p.ids)
    assert p.all_pairs(0.95).pair_set() == j.all_pairs(0.95).pair_set() == want


def test_insert_after_build_crosses_tiles(corpus):
    """A build, then batches of 1, 32 and 100 rows: windows that cross a
    query tile and a row growth."""
    p, j = engines()
    head = CSRMatrix(150, DIM, corpus.indptr[:151],
                     corpus.indices[: corpus.indptr[150]],
                     corpus.data[: corpus.indptr[150]])
    p.build(to_pt(head))
    j.build(head)
    assert_same_state(p, j)
    emitted = p.all_pairs(0.5).pair_set()
    assert emitted == j.all_pairs(0.5).pair_set()
    s = 150
    for bs in (1, 32, 100, 17):
        out = insert_both(p, j, rows_of(corpus, s, s + bs), 0.5)
        emitted_pairs(out, emitted)
        s += bs
    sub = CSRMatrix(s, DIM, corpus.indptr[: s + 1],
                    corpus.indices[: corpus.indptr[s]],
                    corpus.data[: corpus.indptr[s]])
    assert emitted == brute_force_pairs(sub, 0.5)


# ------------------------------------------------------------ admission
@pytest.mark.parametrize("mode", ["ones", "real", "real_static", "off"])
def test_admission_equals_jax(corpus, mode):
    """The same stream, weak and empty vectors among it: both engines
    admit and drop the same vectors and emit the same outputs."""
    tau = 0.6
    p, j = engines(admission=mode.replace("_static", ""))
    if mode == "real_static":
        p.set_max_weight_map(corpus.max_weights())
        j.set_max_weight_map(corpus.max_weights())
    weak = [("w0", Vectors.sparse(DIM, [0, 1], [1e-4, 1e-4])),
            ("w1", Vectors.sparse(DIM, [5], [0.3])),
            ("e", Vectors.sparse(DIM, [], []))]
    for s in range(0, corpus.n_rows, 31):
        batch = rows_of(corpus, s, min(s + 31, corpus.n_rows))
        insert_both(p, j, batch + weak[: 1 + (s // 31) % 3], tau)
    dropped = p.stats["vectors_dropped_admission"]
    # 10 batches carry 19 weak or empty vectors; "off" drops the 3 empty
    assert dropped == (3 if mode == "off" else 19)
    kept = [i for i in p.ids if not i.startswith(("w", "e"))]
    assert len(kept) == corpus.n_rows
    assert np.array_equal(p.max_weights, j.max_weights)


def test_index_threshold_and_bulk():
    p, j = engines(index_threshold=0.5)
    v = Vectors.sparse(DIM, [1, 2], [0.4, 0.9])
    insert_both(p, j, [("a", v)], 0.1)
    np.testing.assert_array_equal(p.shadow_csr().row(0).indices, [2])
    # bulk=True skips the component filter and the admission test
    insert_both(p, j, [("b", v)], 0.1, bulk=True)
    assert p.shadow_csr().row(1).nnz == 2


# ------------------------------------------------------------- dormant
def dormant_corpus():
    # rows 0 and 1 share dim 5; row 2 has the unique dims {100, 101}
    # (df == 1: dormant, kept off the device and archived on the host)
    a = 1 / np.sqrt(2)
    v = Vectors.sparse
    return CSRMatrix.from_vectors(
        [v(DIM, [5, 7], [a, a]), v(DIM, [5, 8], [a, a]),
         v(DIM, [100, 101], [a, a])], DIM)


def built_dormant():
    p, j = engines()
    p.build(to_pt(dormant_corpus()))
    j.build(dormant_corpus())
    assert_same_state(p, j)
    assert p.stats["dormant_dims"] >= 2
    return p, j


def test_dormant_activation_on_insert():
    p, j = built_dormant()
    a = 1 / np.sqrt(2)
    out = insert_both(p, j, [("new", Vectors.sparse(DIM, [100, 300],
                                                      [a, a]))], 0.4)
    assert out.output["new"]["2"] == pytest.approx(0.5)
    assert p._dormant_of_ext[100] == -1
    want = brute_force_pairs(p.shadow_csr(), 0.4, p.ids)
    assert p.all_pairs(0.4).pair_set() == want


def test_streaming_singletons_archived_then_promoted():
    a = 1 / np.sqrt(2)
    v = Vectors.sparse
    p, j = engines()
    head = CSRMatrix.from_vectors([v(DIM, [5, 7], [a, a]),
                                   v(DIM, [5, 8], [a, a])], DIM)
    p.build(to_pt(head))
    j.build(head)
    n_active0 = p.compact.n_active
    out = insert_both(p, j, [("s1", v(DIM, [200, 201], [a, a]))], 0.4)
    assert out.output == {} and p.compact.n_active == n_active0
    out = insert_both(p, j, [("s2", v(DIM, [200, 300], [a, a]))], 0.4)
    assert out.output["s2"]["s1"] == pytest.approx(0.5)
    out = insert_both(p, j, [("t1", v(DIM, [250, 251], [a, a])),
                             ("t2", v(DIM, [250, 252], [a, a]))], 0.4)
    assert out.output["t1"]["t2"] == out.output["t2"]["t1"]
    assert np.array_equal(p._dorm_rows, j._dorm_rows)
    assert np.array_equal(p._dormant_of_ext, j._dormant_of_ext)
    assert p.all_pairs(0.4).pair_set() == brute_force_pairs(
        p.shadow_csr(), 0.4, p.ids)


def test_scatter_entries_refuses_repeats():
    x = torch.zeros((4, 4))
    pt_score.scatter_entries(x, np.array([0, 1]), np.array([2, 2]),
                             np.array([0.5, 0.25]))
    assert x[0, 2] == 0.5 and x[1, 2] == 0.25 and x.sum() == 0.75
    with pytest.raises(ValueError, match="repeated"):
        pt_score.scatter_entries(x, np.array([3, 3]), np.array([1, 1]),
                                 np.array([1.0, 1.0]))


def test_append_rows_and_grow():
    """``append_rows`` adds into the rows from ``s0`` on and drops the
    padding; ``grow`` keeps the old matrix in its corner."""
    from apsim_tpu_torch.vector.batch import pack_coo_i32

    x = torch.zeros((8, 6))
    x[0, 0] = 1.0
    coo = pack_coo_i32(np.array([0, 1, 1]), np.array([1, 0, 5]),
                       np.array([0.5, 0.25, 2.0]), 8 - 3)
    assert coo.shape[1] > 3  # padding entries present
    v0 = x._version
    assert pt_score.append_rows(x, coo, 3) is x and x._version > v0
    want = torch.zeros((8, 6))
    want[0, 0], want[3, 1], want[4, 0], want[4, 5] = 1.0, 0.5, 0.25, 2.0
    assert torch.equal(x, want)
    g = pt_score.grow(x, 16, 12)
    assert g.shape == (16, 12) and torch.equal(g[:8, :6], x)
    assert float(g.sum()) == float(x.sum())


# ------------------------------------------------------------ rollback
def boom(*a, **k):
    raise RuntimeError("injected device failure")


def fail_both(p, j, batch, tau, monkeypatch):
    """Insert ``batch`` into both engines with their device step failing;
    both must roll back to the same state."""
    with monkeypatch.context() as m:
        m.setattr(pt_score, "match_rows_extract", boom)
        m.setattr(jax_score, "insert_match_fused", boom)
        with pytest.raises(RuntimeError, match="injected"):
            p.insert([(i, pv(v)) for i, v in batch], tau=tau)
        with pytest.raises(RuntimeError, match="injected"):
            j.insert(batch, tau=tau)
    assert_same_state(p, j)


def test_insert_device_failure_rolls_back(corpus, monkeypatch):
    tau = 0.4
    p, j = engines()
    insert_both(p, j, rows_of(corpus, 0, 50), tau)
    fail_both(p, j, rows_of(corpus, 50, 60, "x"), tau, monkeypatch)
    assert p.n_rows == 50 and "x50" not in p.id_to_row
    head = CSRMatrix(50, DIM, corpus.indptr[:51],
                     corpus.indices[: corpus.indptr[50]],
                     corpus.data[: corpus.indptr[50]])
    assert p.all_pairs(tau).pair_set() == j.all_pairs(tau).pair_set() == (
        brute_force_pairs(head, tau))
    insert_both(p, j, rows_of(corpus, 50, 60, "x"), tau)
    assert p.n_rows == 60


def test_rollback_undoes_dormant_archive(monkeypatch):
    p, j = built_dormant()
    arch0 = p._dorm_rows.size
    a = 1 / np.sqrt(2)
    fresh = Vectors.sparse(DIM, [5, 399], [a, a])  # dim 399: new singleton
    fail_both(p, j, [("gone", fresh)], 0.4, monkeypatch)
    assert p._dorm_rows.size == arch0 and p._dormant_of_ext[399] == -1
    insert_both(p, j, [("kept", Vectors.sparse(DIM, [5, 7], [a, a]))], 0.4)
    got = p.topk([("q", pv(fresh))], 3)["q"]
    assert got == j.topk([("q", fresh)], 3)["q"]
    assert all(cid in p.id_to_row for cid, _ in got)
    assert p.all_pairs(0.3).pair_set() == brute_force_pairs(
        p.shadow_csr(), 0.3, p.ids)


def test_rollback_commits_promoted_marks(monkeypatch):
    p, j = built_dormant()
    assert p._dormant_of_ext[100] >= 0
    a = 1 / np.sqrt(2)
    sharer = Vectors.sparse(DIM, [100, 300], [a, a])  # promotes dim 100
    fail_both(p, j, [("gone", sharer)], 0.4, monkeypatch)
    assert p.compact.cols_of(np.array([100]))[0] >= 0
    assert p._dormant_of_ext[100] == -1
    out = insert_both(p, j, [("new", sharer)], 0.4)
    assert out.output["new"]["2"] == pytest.approx(0.5)
    got = dict(p.topk([("q", pv(sharer))], 2)["q"])
    assert got["new"] == pytest.approx(1.0) and got["2"] == pytest.approx(0.5)


# -------------------------------------------------------- freeze, defer
def test_freeze_semantics(corpus):
    tau = 0.4
    p, j = engines()
    p.build(to_pt(corpus))
    j.build(corpus)
    p.freeze()
    j.freeze()
    assert p.frozen
    out = insert_both(p, j, [("new", corpus.row(0))], tau)
    assert "0" in out.output["new"] and p.n_rows == corpus.n_rows
    p.unfreeze()
    j.unfreeze()
    assert not p.frozen
    insert_both(p, j, [("new", corpus.row(0))], tau)
    assert p.n_rows == corpus.n_rows + 1


def test_defer_equals_immediate(corpus):
    """``defer=True``: ``result()`` equals the immediate output, also when
    it is called after later inserts; frozen and empty batches defer
    too."""
    tau = 0.4
    p, j = engines()
    p.build(to_pt(corpus))
    j.build(corpus)
    pending = []
    for s, bs in ((0, 7), (7, 30), (37, 1)):
        batch = rows_of(corpus, s, s + bs, "d")
        pending.append((p.insert([(i, pv(v)) for i, v in batch], tau=tau,
                                 defer=True), j.insert(batch, tau=tau)))
    for pend, oj in pending:
        assert isinstance(pend, pt.PendingInsert)
        op = pend.result()
        assert pend.result() is op
        assert_same_output(op, oj)
    p.freeze()
    j.freeze()
    got = p.insert([("f", pv(corpus.row(3)))], tau=tau, defer=True).result()
    assert_same_output(got, j.insert([("f", corpus.row(3))], tau=tau))
    empty = p.insert([], tau=tau, defer=True).result()
    assert empty.output == {}


# ---------------------------------------------------------------- edges
def test_insert_before_build():
    p, j = engines(query_tile=64, row_bucket=64, dim_bucket=64)
    out = insert_both(p, j, [("a", Vectors.sparse(DIM, [7], [1.0])),
                             ("b", Vectors.sparse(DIM, [7], [1.0]))], 0.9)
    assert out.output["a"]["b"] == pytest.approx(1.0)
    assert p.all_pairs(0.9).pair_set() == {("a", "b")}


def test_duplicate_ids_and_empty_vector():
    p, j = engines()
    v = Vectors.sparse(DIM, [2], [1.0])
    p.build([("x", pv(v))])
    j.build([("x", v)])
    insert_both(p, j, [("x", v)], 0.9)
    assert p.n_rows == 2 and p.id_to_row["x"] == 1
    out = insert_both(p, j, [("e2", Vectors.sparse(DIM, [], []))], 0.5,
                      bulk=True)
    assert "e2" not in out.output and p.n_rows == 3


# ------------------------------------------------------ 1-shard mesh
def test_one_shard_mesh_streams_and_joins(corpus):
    """A 1-shard ``MeshEngine`` streams like ``Engine`` (its blocks follow
    ``x`` through growth) and then joins to the same pair set."""
    tau = 0.5
    m = pt.MeshEngine(pt.AllPairsConfig(**cfg_kw(shard_axis="rows")),
                      mesh=pt.make_mesh(1, devices=["cpu"]))
    e, _ = engines(row_bucket=m.cfg.row_bucket, dim_bucket=m.cfg.dim_bucket)
    for s in range(0, corpus.n_rows, 60):
        batch = [(i, pv(v)) for i, v in rows_of(corpus, s, min(
            s + 60, corpus.n_rows))]
        om, oe = m.insert(batch, tau=tau), e.insert(batch, tau=tau)
        assert_same_output(om, oe)
        assert len(m.x_blocks) == 1 and m.x_blocks[0] is m.x
        assert torch.equal(m.x, e.x)
        assert (m.row_cap, m.dim_cap) == (e.row_cap, e.dim_cap)
    assert m.row_cap == 512
    assert m.all_pairs(tau).pair_set() == e.all_pairs(tau).pair_set() == (
        brute_force_pairs(corpus, tau))
    q = [("q", pv(corpus.row(5)))]
    assert m.topk(q, 4) == e.topk(q, 4)


# ------------------------------------------------------- host modules
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_cross_pair_dots_equals_jax(corpus, path, monkeypatch):
    """The native fp64 dots, and the numpy fallback taken when the native
    library is unavailable, against the JAX package's dots."""
    if path == "numpy":
        import apsim_tpu_torch.native as pt_native
        monkeypatch.setattr(pt_native, "native_pair_dots",
                            lambda *a, **k: None)
    rng = np.random.default_rng(8)
    qcsr = random_sparse_corpus(rng, 40, DIM, n_hot_dims=12)
    qrows = rng.integers(0, qcsr.n_rows, 500)
    crows = rng.integers(0, corpus.n_rows, 500)
    args = (corpus.indptr, corpus.indices, corpus.data, DIM, qcsr.indptr,
            qcsr.indices, qcsr.data, qrows, crows)
    got = pt_rescore.cross_pair_dots(*args)
    want = jax_rescore.cross_pair_dots(*args)
    if path == "native":
        assert np.array_equal(got, want)
    else:
        assert np.allclose(got, want, rtol=0, atol=1e-12)
    dense = qcsr.to_dense()[qrows] * corpus.to_dense()[crows]
    assert np.allclose(got, dense.sum(axis=1), rtol=0, atol=1e-12)


@pytest.mark.parametrize("duration_ms", [0, 50])
def test_output_batcher_equals_jax(duration_ms):
    """Immediate emission forwards non-empty outputs one by one; timed
    emission coalesces them; both as the JAX package's batcher."""
    outs = [{"q": {"x": 1.0}}, {}, {"q": {"y": 0.5}, "r": {"z": 0.4}}]
    got = {}
    for name, batcher, so in (
            ("port", pt.OutputBatcher, pt.SimilarityOutput),
            ("jax", JaxOutputBatcher, apsim_tpu.engine.output.SimilarityOutput)):
        sink = []
        b = batcher(sink.append, duration_ms=duration_ms)
        for o in outs:
            b.emit(so(o, time.time()))
        deadline = time.time() + 2.0
        while duration_ms and not sink and time.time() < deadline:
            time.sleep(0.01)
        b.close()
        merged = {}
        for s in sink:
            s.merge_into(merged)
        got[name] = (len(sink) if not duration_ms else None, merged)
    assert got["port"] == got["jax"]
    assert got["port"][1] == {"q": {"x": 1.0, "y": 0.5}, "r": {"z": 0.4}}


# ------------------------------------------- checkpoint static map
@pytest.mark.parametrize("flavor", ["dense", "chunked"])
def test_load_keeps_static_map(corpus, flavor, tmp_path):
    """A JAX checkpoint written with ``admission="real"`` and a static
    max-weight map: the port's load keeps the map (and the chunked
    ``id_to_row``), and the dense port engine then admits and drops the
    same stream as the JAX engine."""
    kw = cfg_kw(admission="real")
    cfg = apsim_tpu.AllPairsConfig(**kw)
    head = CSRMatrix(100, DIM, corpus.indptr[:101],
                     corpus.indices[: corpus.indptr[100]],
                     corpus.data[: corpus.indptr[100]])
    j = (apsim_tpu.Engine(cfg) if flavor == "dense"
         else JaxChunked(cfg, chunk_dim=128))
    j.build(head)
    smap = corpus.max_weights() * 0.5
    j.set_max_weight_map(smap)
    j.save(str(tmp_path))
    pcfg = pt.AllPairsConfig(**kw)
    if flavor == "chunked":
        p = pt.ChunkedAllPairs.load(str(tmp_path), pcfg, device="cpu",
                                    chunk_dim=128)
        assert p.id_to_row == j.id_to_row and len(p.id_to_row) == 100
        assert np.array_equal(p._static_max_weights, j._static_max_weights)
        built = pt.ChunkedAllPairs(pcfg, "cpu", chunk_dim=128)
        built.build(to_pt(head))
        assert built.id_to_row == j.id_to_row
        return
    p = pt.Engine.load(str(tmp_path), pcfg, device="cpu")
    j2 = apsim_tpu.Engine.load(str(tmp_path), cfg)
    assert np.array_equal(p._static_max_weights, j2._static_max_weights)
    assert np.array_equal(p._static_max_weights, smap)
    weak = [(f"w{i}", Vectors.sparse(DIM, [int(d)], [0.3]))
            for i, d in enumerate(corpus.indices[:40:4])]
    for s in range(100, corpus.n_rows, 50):
        batch = rows_of(corpus, s, min(s + 50, corpus.n_rows)) + weak[:3]
        insert_both(p, j2, batch, 0.6)
    assert p.stats["vectors_dropped_admission"] > 0
