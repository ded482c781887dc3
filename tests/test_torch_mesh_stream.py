"""The port's mesh engines streaming on the CPU (``MeshChunkedAllPairs`` at
1, 2 and 8 shards, ``MeshEngine`` in the rows, dims and 2-D layouts at 8
shards, all on ``make_mesh(n, devices=["cpu"] * 8)``): insert with and
without ``defer``, admission, dormant activation, growth, rollback,
``topk``, ``freeze`` and frozen matching, a JAX checkpoint streamed on, and
a server over a mesh, against the JAX package's mesh engines on the
conftest's virtual devices (the same shard counts and the same seeded
streams) and the fp64 brute-force oracle.  The cases mirror the streaming
legs of ``tests/test_chunked_mesh.py``, ``tests/test_mesh.py`` and the
mesh flavors of ``tests/test_engine.py``.

Tolerances, stated per check: pair sets and every insert's output (as a
``{query: {candidate}}`` map) are exact; fp64 similarities agree within
1e-12; top-k lists are equal id for id with scores within 1e-12; after
every batch each shard's entry buffers (and counts) equal the matching
slice of the JAX engine's sharded arrays bit for bit, and the assembled
``x_blocks`` equal ``np.asarray(jax_engine.x)`` bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu.ops.score as jax_score
import apsim_tpu_torch as pt
import apsim_tpu_torch.ops.score as pt_score
from apsim_tpu.parallel import MeshChunkedAllPairs as JaxMeshChunked
from apsim_tpu.parallel import MeshEngine as JaxMeshEngine
from apsim_tpu.parallel import make_mesh as jax_make_mesh
from apsim_tpu.vector.batch import CSRMatrix
from apsim_tpu.vector.sparse import Vectors
from apsim_tpu_torch.ops import chunked as chunked_ops
from apsim_tpu_torch.ops import chunked_mesh as cm_ops
from apsim_tpu_torch.ops import panel as panel_ops
from apsim_tpu_torch.serve import (ClientConnection, RpcServer,
                                   SimilarityServer)

from oracle import brute_force_pairs, brute_force_sims, random_sparse_corpus

DIM = 500
SHARDS = (1, 2, 8)
STATS = ("insert_batches", "vectors_dropped_admission", "vectors_indexed",
         "pairs_emitted", "dormant_dims")
# MeshEngine layouts: name -> (mesh shape, shard_axis)
LAYOUTS = {"rows": (8, "rows"), "dims": (8, "dims"), "2d": ((2, 4), "dims")}


def cfg_kw(**kw):
    base = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64)
    base.update(kw)
    return base


def pv(v):
    """The port's SparseVector of a JAX-package vector."""
    return pt.SparseVector(v.size, v.indices, v.values)


def to_pt(csr):
    return pt.CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                        csr.data)


def rows_of(csr, lo, hi, prefix=""):
    return [(f"{prefix}{i}", csr.row(i)) for i in range(lo, hi)]


def head(csr, n):
    return CSRMatrix(n, csr.n_cols, csr.indptr[:n + 1],
                     csr.indices[:csr.indptr[n]], csr.data[:csr.indptr[n]])


def cpu_mesh(shape):
    return pt.make_mesh(shape, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    return random_sparse_corpus(rng, 220, DIM)


def chunked_engines(n, chunk_dim=32, **kw):
    """(port MeshChunkedAllPairs, JAX MeshChunkedAllPairs) over n shards."""
    return (pt.MeshChunkedAllPairs(pt.AllPairsConfig(**cfg_kw(**kw)),
                                   mesh=cpu_mesh(n), chunk_dim=chunk_dim),
            JaxMeshChunked(apsim_tpu.AllPairsConfig(**cfg_kw(**kw)),
                           mesh=jax_make_mesh(n), chunk_dim=chunk_dim))


def dense_engines(layout, **kw):
    """(port MeshEngine, JAX MeshEngine) of one layout over 8 shards.
    ``dim_bucket=128`` keeps the two packages' column capacities equal in
    the rows layout (the port rounds it to the kernels' 128-byte K stage)."""
    shape, axis = LAYOUTS[layout]
    kw = cfg_kw(**{"shard_axis": axis, "dim_bucket": 128, **kw})
    return (pt.MeshEngine(pt.AllPairsConfig(**kw), mesh=cpu_mesh(shape)),
            JaxMeshEngine(apsim_tpu.AllPairsConfig(**kw),
                          mesh=jax_make_mesh(shape)))


def assert_same_output(op, oj):
    """Exact ``{query: {candidate}}`` maps; similarities within 1e-12."""
    assert {q: set(c) for q, c in op.output.items()} == {
        q: set(c) for q, c in oj.output.items()}
    for q, cands in op.output.items():
        for c, s in cands.items():
            assert abs(s - oj.output[q][c]) <= 1e-12


def assert_same_topk(tp, tj):
    """Equal id for id, scores within 1e-12."""
    assert list(tp) == list(tj)
    for q in tp:
        assert [c for c, _ in tp[q]] == [c for c, _ in tj[q]]
        for (_, a), (_, b) in zip(tp[q], tj[q]):
            assert abs(a - b) <= 1e-12


def assert_same_common(p, j):
    assert p.n_rows == j.n_rows and p.ids == j.ids
    assert p.id_to_row == j.id_to_row
    assert {k: p.stats[k] for k in STATS} == {k: j.stats[k] for k in STATS}


def assert_same_chunked(p, j):
    """Each shard's entry buffers and counts equal the matching slice of
    JAX's sharded arrays bit for bit; the host mirror and the geometry are
    equal."""
    assert_same_common(p, j)
    assert (p._n_chunks, p._chunk_cap, p._chunk_width) == (
        j._n_chunks, j._chunk_cap, j._chunk_width)
    assert np.array_equal(p._counts, j._counts)
    n_local = p._n_chunks // p.n_shards
    for mine, theirs in zip(p._ent + (p._counts_dev,),
                            tuple(j._ent) + (j._counts_dev,)):
        whole = np.asarray(theirs)
        assert len(mine) == p.n_shards
        for s, t in enumerate(mine):
            assert t.device == p.mesh.devices[s]
            assert np.array_equal(t.numpy(),
                                  whole[s * n_local:(s + 1) * n_local])
    for a, b in zip(p._ent_host, j._ent_host):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def assembled(p):
    """The port mesh's blocks as one host array (fp32 values)."""
    nr, nd = p.grid
    return np.concatenate([
        np.concatenate([p.x_blocks[r * nd + d].float().numpy()
                        for d in range(nd)], axis=1)
        for r in range(nr)])


def assert_same_dense(p, j):
    """Capacities equal and the assembled blocks equal JAX's index bit for
    bit; each block on its shard's device."""
    assert_same_common(p, j)
    assert p.x is None and len(p.x_blocks) == p.n_shards
    assert (p.row_cap, p.dim_cap) == (j.row_cap, j.dim_cap)
    assert all(b.device == d for b, d in zip(p.x_blocks, p.mesh.devices))
    assert np.array_equal(assembled(p), np.asarray(j.x).astype(np.float32))


def insert_both(p, j, batch, tau, same_state, **kw):
    op = p.insert([(i, pv(v)) for i, v in batch], tau=tau, **kw)
    oj = j.insert(batch, tau=tau, **kw)
    if kw.get("defer"):
        op, oj = op.result(), oj.result()
    assert_same_output(op, oj)
    same_state(p, j)
    return op


def emitted_pairs(out, into: set) -> None:
    for q, cands in out.output.items():
        for c in cands:
            into.add((q, c) if q <= c else (c, q))


# -------------------------------------------- the chunked mesh's streaming ops
def test_mesh_append_and_grow_split_by_chunk_block():
    """``mesh_append_entries`` gives each shard exactly the entries of its
    chunk block, localized; ``mesh_grow_entry_cap`` pads every shard with
    the pad row; together they equal the single-device ops on the whole
    buffers, cut into blocks (exact)."""
    mesh = cpu_mesh(4)
    rng = np.random.default_rng(3)
    n_chunks, cap = 8, 16
    whole = chunked_ops.grow_entry_cap(
        torch.full((n_chunks, 4), panel_ops.PAD_ROW, dtype=torch.int32),
        torch.zeros((n_chunks, 4), dtype=torch.int32),
        torch.zeros((n_chunks, 4), dtype=torch.float32), cap,
        panel_ops.PAD_ROW)
    shards = cm_ops.mesh_grow_entry_cap(
        *([t[s * 2:(s + 1) * 2, :4] for s in range(4)] for t in (
            torch.full((n_chunks, 4), panel_ops.PAD_ROW, dtype=torch.int32),
            torch.zeros((n_chunks, 4), dtype=torch.int32),
            torch.zeros((n_chunks, 4), dtype=torch.float32))),
        cap, panel_ops.PAD_ROW)
    chunk = np.sort(rng.integers(0, n_chunks, 40)).astype(np.int32)
    slot = np.concatenate([np.arange((chunk == c).sum())
                           for c in range(n_chunks)]).astype(np.int32)
    coo5 = np.stack([chunk, slot, rng.integers(0, 100, 40).astype(np.int32),
                     rng.integers(0, 32, 40).astype(np.int32),
                     rng.random(40).astype(np.float32).view(np.int32)])
    t = torch.from_numpy(coo5)
    chunked_ops.append_entries(*whole, t[0], t[1], t[2], t[3],
                               t[4].view(torch.float32))
    cm_ops.mesh_append_entries(mesh, *shards, coo5)
    for a, parts in zip(whole, shards):
        assert all(p.shape == (2, cap) for p in parts)
        assert torch.equal(torch.cat(parts), a)


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_match_and_topk_equal_single_device(corpus, n):
    """The mesh's match and top-k ops over n shards score like the
    single-device rebuild route: the candidate set of a streamed batch
    holds every oracle pair at tau_eff (and the same set as one device's
    for one shard), and the top-k rows carry the same fp64 similarities."""
    p, _ = chunked_engines(n)
    p.build(to_pt(corpus))
    one = pt.ChunkedAllPairs(p.cfg, "cpu", chunk_dim=32)
    one.build(to_pt(corpus))
    ccsr = p.compact.map_csr(p._drop_unmapped(to_pt(head(corpus, 40))),
                             extend=False)
    tau_eff = p._tau_eff(0.5)
    got = cm_ops.mesh_match_extract(
        p.mesh, *p._ent, p._local_counts(), p._bucket_queries(ccsr, 40), 0,
        tau_eff, p.row_cap, p._chunk_width, 40, "default")
    ref = chunked_ops.chunked_match_extract(
        *one._ent, one._counts, one._bucket_queries(ccsr, 40), 0, tau_eff,
        one.row_cap, one._chunk_width, 40, "default")
    cand = set(zip(got[0].tolist(), got[1].tolist()))
    sims = brute_force_sims(corpus)[:, :40]
    want = {(r, q) for r, q in zip(*np.nonzero(sims >= 0.5)) if r != q}
    assert cand >= want and all(r != q for r, q in cand)
    if n == 1:
        assert cand == set(zip(ref[0].tolist(), ref[1].tolist()))
    q = p._bucket_queries(ccsr, 40)
    s, r = cm_ops.mesh_topk(p.mesh, *p._ent, p._local_counts(), q,
                            p.n_rows, p.row_cap, p._chunk_width, 40, 5)
    full = brute_force_sims(corpus)[:40]
    top = np.sort(full, axis=1)[:, ::-1][:, :5]
    assert np.allclose(np.take_along_axis(full, r.numpy(), 1), top,
                       atol=1e-5)
    assert s.dtype == torch.float32 and (r < p.n_rows).all()


# ------------------------------------------ MeshChunkedAllPairs (1, 2, 8)
@pytest.mark.parametrize("n", SHARDS)
def test_chunked_mesh_topk(corpus, n):
    """``tests/test_chunked_mesh.py::test_mesh_chunked_topk``: k = 4 for
    five corpus rows: equal to JAX id for id (scores within 1e-12) and to
    the fp64 top scores (1e-9)."""
    p, j = chunked_engines(n)
    p.build(to_pt(corpus))
    j.build(corpus)
    queries = [(f"q{i}", corpus.row(i)) for i in range(5)]
    tp = p.topk([(i, pv(v)) for i, v in queries], 4)
    assert_same_topk(tp, j.topk(queries, 4))
    sims = brute_force_sims(corpus)
    for qi in range(5):
        got = np.array([s for _, s in tp[f"q{qi}"]])
        np.testing.assert_allclose(got, np.sort(sims[qi])[::-1][:4],
                                   atol=1e-9)
    assert p.last_route is None  # top-k is no match


@pytest.mark.parametrize("n", SHARDS)
def test_chunked_mesh_streaming_equals_batch(n):
    """``test_mesh_chunked_streaming_equals_batch``: 150 rows in batches of
    37 (every other one deferred) from an empty engine: every output equals
    JAX's, the buffers equal JAX's shards after every batch, the union and
    the join equal the oracle; every match took the rebuild route."""
    rng = np.random.default_rng(11)
    corpus = random_sparse_corpus(rng, 150, DIM)
    tau = 0.4
    p, j = chunked_engines(n)
    emitted = set()
    for k, s in enumerate(range(0, corpus.n_rows, 37)):
        out = insert_both(p, j, rows_of(corpus, s, min(s + 37, corpus.n_rows)),
                          tau, assert_same_chunked, defer=bool(k % 2))
        emitted_pairs(out, emitted)
        assert p.last_route == "device_rebuild"
    want = brute_force_pairs(corpus, tau)
    assert emitted == want and len(want) > 10
    assert p.all_pairs(tau).pair_set() == j.all_pairs(tau).pair_set() == want


@pytest.mark.parametrize("n", SHARDS)
def test_chunked_mesh_streaming_grows_capacity_and_dims(n):
    """``test_mesh_chunked_streaming_grows_capacity_and_dims``: new dims in
    every step (columns minted, chunk width doubled) and the per-chunk
    capacity doubled on every shard; buffers equal JAX's after every
    batch, the union and the join equal the oracle."""
    rng = np.random.default_rng(3)
    p, j = chunked_engines(n, chunk_dim=16)
    seen = set()
    caps, widths = [], []
    for step in range(4):
        vecs = []
        for i in range(30):
            dims = np.sort(rng.choice(np.arange(step * 90, step * 90 + 90), 5,
                                      replace=False)).astype(np.int32)
            vals = rng.random(5) + 0.1
            vals /= np.linalg.norm(vals)
            vecs.append((f"{step}:{i}", Vectors.sparse(DIM, dims, vals)))
        emitted_pairs(insert_both(p, j, vecs, 0.9, assert_same_chunked), seen)
        caps.append(p._chunk_cap)
        widths.append(p._chunk_width)
    assert p.n_rows == 120
    assert widths[-1] > widths[0]
    want = brute_force_pairs(j._shadow.view(), 0.9, j.ids)
    assert seen == want
    assert p.all_pairs(0.9).pair_set() == want


@pytest.mark.parametrize("n", SHARDS)
def test_chunked_mesh_entry_capacity_grows(n):
    """Per-chunk capacity growth on every shard: rows of 24 entries over
    32 dims fill the chunks past their 1,024 slots; the buffers (padded
    with the pad row on every shard) equal JAX's after every batch, the
    union and the join equal the oracle."""
    rng = np.random.default_rng(17)
    vecs = []
    for i in range(500):
        if i % 10 == 9:  # a copy of the row before: a pair at 1.0
            vecs.append(vecs[-1])
            continue
        dims = np.sort(rng.choice(32, 24, replace=False)).astype(np.int32)
        vals = rng.random(24) + 0.05
        vecs.append(Vectors.sparse(DIM, dims, vals / np.linalg.norm(vals)))
    corpus = CSRMatrix.from_vectors(vecs, DIM)
    p, j = chunked_engines(n, chunk_dim=64)
    p.build(to_pt(head(corpus, 100)))
    j.build(head(corpus, 100))
    cap0, tau = p._chunk_cap, 0.97
    emitted = p.all_pairs(tau).pair_set()
    assert j.all_pairs(tau).pair_set() == emitted
    for s in range(100, 500, 100):
        emitted_pairs(insert_both(p, j, rows_of(corpus, s, s + 100), tau,
                                  assert_same_chunked), emitted)
    assert p._chunk_cap > cap0 and p._n_chunks == n
    assert all(t.shape == (1, p._chunk_cap) for t in p._ent[0])
    want = brute_force_pairs(corpus, tau)
    assert emitted == want and len(want) > 10
    assert p.all_pairs(tau).pair_set() == want


@pytest.mark.parametrize("n", SHARDS)
def test_chunked_mesh_dormant_roundtrip(n):
    """``test_mesh_chunked_dormant_roundtrip``: archived df == 1 dims, an
    insert that activates one (its entry goes to the shard of its chunk),
    and a top-k through it, each equal to JAX."""
    a = 1 / np.sqrt(2)
    v = Vectors.sparse
    corpus = CSRMatrix.from_vectors(
        [v(DIM, [5, 7], [a, a]), v(DIM, [5, 8], [a, a]),
         v(DIM, [100, 101], [a, a])], DIM)
    p, j = chunked_engines(n, chunk_dim=16)
    p.build(to_pt(corpus))
    j.build(corpus)
    assert_same_chunked(p, j)
    assert p.stats["dormant_dims"] >= 2
    assert p.all_pairs(0.3).pair_set() == j.all_pairs(0.3).pair_set() == (
        brute_force_pairs(corpus, 0.3))
    out = insert_both(p, j, [("new", v(DIM, [100, 300], [a, a]))], 0.4,
                      assert_same_chunked)
    assert out.output.get("new", {}).get("2") == pytest.approx(0.5)
    q = [("q", v(DIM, [100, 101], [a, a]))]
    res = p.topk([(i, pv(x)) for i, x in q], 2)
    assert_same_topk(res, j.topk(q, 2))
    assert res["q"][0][0] == "2" and res["q"][0][1] == pytest.approx(1.0)


@pytest.mark.parametrize("n", SHARDS)
def test_chunked_mesh_freeze_external_match(n):
    """``test_mesh_chunked_freeze_external_match``: frozen inserts match
    (equal to JAX) and index nothing; after ``unfreeze`` they index."""
    rng = np.random.default_rng(5)
    corpus = random_sparse_corpus(rng, 80, DIM)
    p, j = chunked_engines(n)
    p.build(to_pt(corpus))
    j.build(corpus)
    p.freeze()
    j.freeze()
    assert p.frozen
    out = insert_both(p, j, [("probe", corpus.row(0)),
                             ("other", corpus.row(9))], 0.9,
                      assert_same_chunked)
    assert out.output.get("probe", {}).get("0") == pytest.approx(1.0)
    assert p.n_rows == corpus.n_rows
    p.unfreeze()
    j.unfreeze()
    out = insert_both(p, j, [("probe", corpus.row(0))], 0.9,
                      assert_same_chunked)
    assert p.n_rows == corpus.n_rows + 1 and "0" in out.output["probe"]


# --------------------------------------------------- MeshEngine (8 shards)
def test_mesh_rows_kernel_path_exact_under_insert(corpus):
    """``tests/test_mesh.py::test_mesh_rows_pallas_fast_path``: the rows
    kernel path joins exactly before and after streamed inserts, also
    once the row capacity has grown (the geometry of the grown index)."""
    p, j = dense_engines("rows", use_pallas="on", row_bucket=512)
    p.build(to_pt(corpus))
    j.build(corpus)
    assert p._kernel_ok() and p._mesh_rows_geom() is not None
    for tau in (0.4, 0.7):
        assert p.all_pairs(tau).pair_set() == j.all_pairs(
            tau).pair_set() == brute_force_pairs(corpus, tau)
    out = insert_both(p, j, [("z0", corpus.row(0))], 0.6, assert_same_dense)
    assert out.output  # a duplicate of row 0 must match
    assert p._kernel_ok()
    vecs = [corpus.row(i) for i in range(corpus.n_rows)] + [corpus.row(0)]
    ids = [str(i) for i in range(corpus.n_rows)] + ["z0"]
    allcsr = CSRMatrix.from_vectors(vecs, DIM)
    assert p.all_pairs(0.6).pair_set() == j.all_pairs(0.6).pair_set() == (
        brute_force_pairs(allcsr, 0.6, ids))
    # past the row capacity: the grid doubles, rows move between blocks
    extra = [(f"w{i}", corpus.row(i % corpus.n_rows)) for i in range(300)]
    for s in range(0, 300, 100):
        insert_both(p, j, extra[s:s + 100], 0.6, assert_same_dense)
    assert p.row_cap == 1024 and p._kernel_ok()
    vecs += [v for _, v in extra]
    ids += [i for i, _ in extra]
    got = p.all_pairs(0.6).pair_set()
    assert got == brute_force_pairs(CSRMatrix.from_vectors(vecs, DIM), 0.6,
                                    ids)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_streaming_parity(corpus, layout):
    """``tests/test_mesh.py::test_mesh_streaming_parity`` (rows, dims) and
    the 2-D mesh: the corpus in batches of 37 from an empty engine, every
    other deferred; every output and the assembled blocks equal JAX's
    after every batch; the union equals the oracle, and so does the join."""
    tau = 0.5
    p, j = dense_engines(layout)
    emitted = set()
    for k, s in enumerate(range(0, corpus.n_rows, 37)):
        out = insert_both(p, j, rows_of(corpus, s, min(s + 37, corpus.n_rows)),
                          tau, assert_same_dense, defer=bool(k % 2))
        emitted_pairs(out, emitted)
    want = brute_force_pairs(corpus, tau)
    assert emitted == want and len(want) > 10
    assert p.row_cap == 256  # grown from 64 by doubling
    assert p.all_pairs(tau).pair_set() == want


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_topk(corpus, layout):
    """``tests/test_mesh.py::test_mesh_topk`` in every layout: k = 4 for
    corpus rows and rows of another seed, equal to JAX id for id (scores
    within 1e-12); a row finds itself first."""
    p, j = dense_engines(layout)
    p.build(to_pt(corpus))
    j.build(corpus)
    other = random_sparse_corpus(np.random.default_rng(99), 6, DIM)
    queries = rows_of(corpus, 3, 9, "q") + rows_of(other, 0, 6, "o")
    tp = p.topk([(i, pv(v)) for i, v in queries], 4)
    assert_same_topk(tp, j.topk(queries, 4))
    assert tp["q5"][0][0] == "5"
    assert tp["q5"][0][1] == pytest.approx(1.0, abs=1e-12)
    assert p.topk([(i, pv(v)) for i, v in queries[:2]], 500) == (
        j.topk(queries[:2], 500))  # k past n_rows: every row


def test_mesh_2d_rows_by_dims_insert(corpus):
    """``tests/test_mesh.py::test_mesh_2d_rows_by_dims``: a probe streamed
    into the built 2-D mesh finds its original; every block equals JAX's."""
    p, j = dense_engines("2d")
    p.build(to_pt(corpus))
    j.build(corpus)
    assert p.cfg.shard_axis == "both"
    out = insert_both(p, j, [("probe", corpus.row(0))], 0.5,
                      assert_same_dense)
    assert "0" in out.output.get("probe", {})
    layout = p.shard_layout()
    assert len(layout) == 8
    assert all("row_block" in v and "dim_block" in v
               for v in layout.values())


def shifted(csr, rows, offset):
    """Corpus rows with their dims moved by ``offset`` (new dims)."""
    out = []
    for r in rows:
        v = csr.row(int(r))
        out.append(Vectors.sparse(DIM, v.indices + offset, v.values))
    return out


def windows(n, start, rng):
    """``n`` unit rows over dims ``[start + 8i, start + 8i + 16)``: each dim
    but the first and last eight is shared by two neighbours."""
    out = []
    for i in range(n):
        dims = np.arange(start + 8 * i, start + 8 * i + 16, dtype=np.int32)
        vals = rng.random(16) + 0.05
        out.append(Vectors.sparse(WIDE, dims, vals / np.linalg.norm(vals)))
    return out


WIDE = 4096


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_columns_grow_and_dormant_activate(layout):
    """Column growth and dormant activation on a built mesh: the build's
    976 columns nearly fill the first 1,024; a batch over dims the build
    never saw mints ~250 columns (``dim_cap`` grows past 1,024, so columns
    move between column blocks) and archives its singletons; copies of
    two of its rows activate those entries into older rows of their
    blocks.  Every output and the blocks equal JAX's after each batch; the
    join of the grown index equals the oracle."""
    rng = np.random.default_rng(31)
    corpus = CSRMatrix.from_vectors(windows(120, 0, rng), WIDE)
    p, j = dense_engines(layout, vector_dim=WIDE)
    p.build(to_pt(corpus))
    j.build(corpus)
    assert_same_dense(p, j)
    cap0, dorm0 = p.dim_cap, p.stats["dormant_dims"]
    new = windows(30, 1200, rng)
    insert_both(p, j, [(f"n{k}", v) for k, v in enumerate(new)], 0.4,
                assert_same_dense)
    dorm1 = p.stats["dormant_dims"]
    assert cap0 == 1024 < p.dim_cap and dorm1 > dorm0
    insert_both(p, j, [("c0", new[0]), ("c29", new[29])], 0.4,
                assert_same_dense)
    assert p.stats["dormant_dims"] < dorm1
    assert p.all_pairs(0.4).pair_set() == j.all_pairs(0.4).pair_set() == (
        brute_force_pairs(p.shadow_csr(), 0.4, p.ids))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_freeze_and_frozen_match(corpus, layout):
    """Frozen inserts are matched (equal to JAX and to the oracle at tau),
    not indexed; after ``unfreeze`` they index again."""
    p, j = dense_engines(layout)
    p.build(to_pt(corpus))
    j.build(corpus)
    p.freeze()
    j.freeze()
    batch = rows_of(corpus, 0, 6, "f") + [
        ("far", Vectors.sparse(DIM, [DIM - 1], [1.0]))]
    out = insert_both(p, j, batch, 0.5, assert_same_dense)
    assert p.n_rows == corpus.n_rows
    sims = brute_force_sims(corpus)
    for k in range(6):
        want = {str(c) for c in np.nonzero(sims[k] >= 0.5)[0]}
        assert set(out.output.get(f"f{k}", {})) == want
    p.unfreeze()
    j.unfreeze()
    insert_both(p, j, rows_of(corpus, 0, 3, "u"), 0.5, assert_same_dense)
    assert p.n_rows == corpus.n_rows + 3


def boom(*a, **k):
    raise RuntimeError("injected device failure")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_failed_block_append_rolls_back(corpus, layout, monkeypatch):
    """A block append that fails after the first block was written rolls
    the engine back: the blocks equal a fresh build from the shadow, bit
    for bit: JAX's index after its own failed insert rolled back, and the
    port's single-device ``Engine`` after the same history (its failure at
    the match); no row of the batch is left, and the next insert of the
    same rows matches as JAX's does."""
    tau = 0.4
    p, j = dense_engines(layout)
    insert_both(p, j, rows_of(corpus, 0, 100), tau, assert_same_dense)
    calls = []
    real = pt_score.append_rows

    def fail_after_first(x, coo, s0):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("injected device failure")
        return real(x, coo, s0)

    batch = rows_of(corpus, 100, 140, "x")  # spans several blocks
    with monkeypatch.context() as m:
        m.setattr(pt_score, "append_rows", fail_after_first)
        m.setattr(jax_score, "insert_match_fused", boom)
        m.setattr(jax_score, "match_tile_extract", boom)
        with pytest.raises(RuntimeError, match="injected"):
            p.insert([(i, pv(v)) for i, v in batch], tau=tau)
        with pytest.raises(RuntimeError, match="injected"):
            j.insert(batch, tau=tau)
    assert len(calls) == 2
    assert_same_dense(p, j)
    assert p.n_rows == 100 and "x100" not in p.id_to_row
    one = pt.Engine(p.cfg, "cpu")
    one.insert([(i, pv(v)) for i, v in rows_of(corpus, 0, 100)], tau=tau)
    with monkeypatch.context() as m:
        m.setattr(pt_score, "match_rows_extract", boom)
        with pytest.raises(RuntimeError, match="injected"):
            one.insert([(i, pv(v)) for i, v in batch], tau=tau)
    assert (one.row_cap, one.dim_cap) == (p.row_cap, p.dim_cap)
    assert np.array_equal(assembled(p), one.x.numpy())
    insert_both(p, j, batch, tau, assert_same_dense)
    assert p.all_pairs(tau).pair_set() == brute_force_pairs(
        p.shadow_csr(), tau, p.ids)


# ------------------------------------------ the flavors of test_engine.py
def _flavors():
    """(port, JAX) factories of the mesh flavors of
    ``tests/test_engine.py::_engine_flavors``: the dims mesh and the
    chunked mesh on two shards, and the rows mesh on eight."""
    return [
        pytest.param(lambda kw: (
            pt.MeshEngine(pt.AllPairsConfig(**kw), mesh=cpu_mesh(2)),
            JaxMeshEngine(apsim_tpu.AllPairsConfig(**kw),
                          mesh=jax_make_mesh(2))), id="mesh"),
        pytest.param(lambda kw: (
            pt.MeshEngine(pt.AllPairsConfig(**{**kw, "shard_axis": "rows"}),
                          mesh=cpu_mesh(8)),
            JaxMeshEngine(apsim_tpu.AllPairsConfig(**{
                **kw, "shard_axis": "rows"}), mesh=jax_make_mesh(8))),
            id="mesh-rows"),
        pytest.param(lambda kw: (
            pt.MeshChunkedAllPairs(pt.AllPairsConfig(**kw),
                                   mesh=cpu_mesh(2), chunk_dim=64),
            JaxMeshChunked(apsim_tpu.AllPairsConfig(**kw),
                           mesh=jax_make_mesh(2), chunk_dim=64)),
            id="chunked-mesh"),
    ]


def admission_kw(**kw):
    return cfg_kw(dim_bucket=128, **kw)


def same_flavor_state(p, j):
    if isinstance(p, pt.MeshChunkedAllPairs):
        assert_same_chunked(p, j)
    else:
        assert_same_dense(p, j)


@pytest.mark.parametrize("make", _flavors())
def test_admission_pruning_ones(make):
    """The reference's all-1.0 stub: ``sum(values) >= tau`` admits."""
    p, j = make(admission_kw(admission="ones"))
    weak = Vectors.sparse(DIM, [0], [0.3])
    strong = Vectors.sparse(DIM, [0], [0.9])
    insert_both(p, j, [("w", weak), ("s", strong)], 0.5, same_flavor_state)
    assert p.n_rows == 1 and p.ids == ["s"]
    assert p.stats["vectors_dropped_admission"] == 1


@pytest.mark.parametrize("make", _flavors())
def test_admission_real_running(corpus, make):
    """The self-inclusive running bound admits a normalized corpus whole."""
    tau = 0.6
    p, j = make(admission_kw(admission="real"))
    for s in range(0, corpus.n_rows, 31):
        insert_both(p, j, rows_of(corpus, s, min(s + 31, corpus.n_rows)),
                    tau, same_flavor_state)
    assert p.n_rows == corpus.n_rows
    assert p.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


@pytest.mark.parametrize("make", _flavors())
def test_admission_real_static_map(corpus, make):
    """A static corpus map prunes a vector that cannot reach tau and loses
    no pair."""
    tau = 0.6
    p, j = make(admission_kw(admission="real"))
    p.set_max_weight_map(corpus.max_weights())
    j.set_max_weight_map(corpus.max_weights())
    for s in range(0, corpus.n_rows, 31):
        insert_both(p, j, rows_of(corpus, s, min(s + 31, corpus.n_rows)),
                    tau, same_flavor_state)
    weak = Vectors.sparse(DIM, [0, 1], [1e-4, 1e-4])
    insert_both(p, j, [("weak", weak)], tau, same_flavor_state)
    assert "weak" not in p.ids
    assert p.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)
    assert p.stats["vectors_dropped_admission"] == 1


# ---------------------------------------- checkpoints and the server
@pytest.mark.parametrize("flavor", ["mesh", "chunked-mesh"])
def test_jax_mesh_checkpoint_streams_on(corpus, flavor, tmp_path):
    """A JAX mesh engine streams, saves; the port's mesh of the same shard
    count loads the checkpoint and both stream on with the same batches:
    every output and the blocks / entry buffers equal JAX's."""
    tau = 0.5
    if flavor == "mesh":
        p0, j = dense_engines("dims")
        same, load = assert_same_dense, lambda path: pt.MeshEngine.load(
            path, p0.cfg, mesh=cpu_mesh(8))
    else:
        p0, j = chunked_engines(8)
        same, load = assert_same_chunked, lambda path: (
            pt.MeshChunkedAllPairs.load(path, p0.cfg, mesh=cpu_mesh(8),
                                        chunk_dim=32))
    j.build(head(corpus, 120))
    j.insert(rows_of(corpus, 120, 160), tau=tau)
    j.save(str(tmp_path))
    p = load(str(tmp_path))
    assert p.ids == j.ids and p.n_shards == 8
    j2 = (JaxMeshEngine(j.cfg, mesh=jax_make_mesh(8)) if flavor == "mesh"
          else JaxMeshChunked(j.cfg, mesh=jax_make_mesh(8), chunk_dim=32))
    j2.restore(str(tmp_path))
    same(p, j2)
    emitted = set()
    for s in range(160, corpus.n_rows, 30):
        emitted_pairs(insert_both(
            p, j2, rows_of(corpus, s, min(s + 30, corpus.n_rows)), tau, same),
            emitted)
    assert p.all_pairs(tau).pair_set() == brute_force_pairs(corpus, tau)


@pytest.mark.parametrize("flavor", ["mesh", "chunked-mesh"])
def test_server_over_mesh_pushes_oracle_pairs(corpus, flavor):
    """A ``SimilarityServer`` over an 8-shard CPU mesh engine behind the
    TCP RPC: four clients stream the corpus one vector at a time, a
    subscriber collects the pushed outputs; the pushed pairs and the join
    equal the oracle."""
    cfg = pt.AllPairsConfig(**cfg_kw(similarity_threshold=0.5,
                                     io_trigger_period_ms=5, dim_bucket=128))
    eng = (pt.MeshEngine(cfg, mesh=cpu_mesh(8)) if flavor == "mesh" else
           pt.MeshChunkedAllPairs(cfg, mesh=cpu_mesh(8), chunk_dim=32))
    sim = SimilarityServer(eng, cfg, device="cpu")
    pushed, lock = set(), threading.Lock()

    def on_output(out, moment):
        with lock:
            for q, cands in out.items():
                for c in cands:
                    pushed.add((q, c) if q <= c else (c, q))

    n = corpus.n_rows
    with RpcServer(sim, port=0) as rpc:
        addr = f"{rpc.host}:{rpc.port}"
        sub = ClientConnection([addr])
        sub.subscribe_outputs(on_output)

        def worker(lo, hi):
            cc = ClientConnection([addr])
            for i in range(lo, hi):
                cc.insert_new_vector([(str(i), corpus.row(i))])
            cc.flush()
            cc.close()

        threads = [threading.Thread(target=worker,
                                    args=(k * n // 4, (k + 1) * n // 4))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        want = brute_force_pairs(corpus, 0.5)
        deadline = time.time() + 30
        while time.time() < deadline:
            with lock:
                if sim.stats()["n_rows"] == n and pushed == want:
                    break
            time.sleep(0.05)
        sub.close()
        assert sim.engine is eng and eng.n_shards == 8
        with lock:
            assert pushed == want and len(want) > 10
        assert sim.all_pairs(0.5).pair_set() == want


@pytest.mark.parametrize("flags", [[], ["--chunked"]])
def test_cli_serve_mesh_shape_streams(corpus, flags, tmp_path):
    """``serve --mesh-shape 4 --device cpu`` (a 4-shard ``MeshEngine``, or
    ``MeshChunkedAllPairs`` with ``--chunked``) in its own process: a
    client streams the corpus in batches of 20 while a subscriber collects
    the pushed outputs, which equal the oracle; SIGINT stops it (exit 0)."""
    import json
    import os
    import signal
    import subprocess
    import sys

    cfgfile = str(tmp_path / "cfg.json")
    with open(cfgfile, "w") as f:
        json.dump({"vectorDim": DIM, "query_tile": 64, "row_bucket": 64,
                   "dim_bucket": 128, "similarity_threshold": 0.5,
                   "io_trigger_period_ms": 5}, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    srv = subprocess.Popen(
        [sys.executable, "-m", "apsim_tpu_torch.cli", "serve", "--device",
         "cpu", "--mesh-shape", "4", "--port", "0", "--config", cfgfile]
        + flags, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = srv.stdout.readline()
        assert line.startswith("serving on "), (line, srv.stderr.read())
        addr = line.split()[-1]
        pushed, lock = set(), threading.Lock()

        def on_output(out, moment):
            with lock:
                for q, cands in out.items():
                    for c in cands:
                        pushed.add((q, c) if q <= c else (c, q))

        sub = ClientConnection([addr])
        sub.subscribe_outputs(on_output)
        cc = ClientConnection([addr])
        for s in range(0, corpus.n_rows, 20):
            cc.insert_new_vector(rows_of(corpus, s, min(s + 20,
                                                         corpus.n_rows)))
        cc.flush()
        want = brute_force_pairs(corpus, 0.5)
        deadline = time.time() + 30
        while time.time() < deadline:
            with lock:
                if pushed == want:
                    break
            time.sleep(0.05)
        assert cc.stats()["n_rows"] == corpus.n_rows
        cc.close()
        sub.close()
        with lock:
            assert pushed == want and len(want) > 10
        srv.send_signal(signal.SIGINT)
        assert srv.wait(timeout=60) == 0
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
