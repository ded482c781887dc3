"""The port's dense join end to end on the CPU, against the JAX package's
``Engine(use_pallas="on")`` (Pallas in interpret mode) and the fp64
brute-force oracle, on the same seeded corpus.

The full-rectangle join (``use_pallas="off"``, ``matmul_precision="highest"``,
a bf16 index, capacities the kernels do not tile, the edge corpora of
``tests/test_edge.py`` that do not insert) is held against the JAX engine's
XLA rectangle in the same way.

Tolerances: the index ``x`` equals the JAX index exactly; pair sets are
equal; similarities agree to 1e-12 in the kernel-path tests and exactly
(``rtol = 0``) in the rectangle tests (both are fp64 rescores of the same
entries by the same native routine)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu_torch as pt
from apsim_tpu.vector.sparse import Vectors
from apsim_tpu_torch.ops import tri_score as ts
from apsim_tpu_torch.vector.batch import pack_coo_i32

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 700
TAUS = [0.5, 0.7, 0.8, 0.9]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cfg_kw(**kw):
    base = dict(vector_dim=DIM, row_bucket=256, dim_bucket=2048,
                query_tile=256)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(33)
    base = random_sparse_corpus(rng, 290, DIM, n_hot_dims=12)
    rows = [base.row(i) for i in range(base.n_rows)]
    rows += [base.row(i) for i in range(10)]  # exact duplicates
    return apsim_tpu.vector.batch.CSRMatrix.from_vectors(rows, DIM).normalized()


def to_pt(csr):
    return pt.CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                        csr.data)


@pytest.fixture(scope="module")
def engines(corpus):
    """(port engine, JAX engine) per ``pallas_int8`` setting."""
    out = {}
    for int8 in (True, False):
        p = pt.Engine(pt.AllPairsConfig(**cfg_kw(pallas_int8=int8)), "cpu")
        p.build(to_pt(corpus))
        j = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(
            **cfg_kw(pallas_int8=int8, use_pallas="on")))
        j.build(corpus)
        out[int8] = (p, j)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_equals_jax(corpus, dtype):
    p = pt.Engine(pt.AllPairsConfig(**cfg_kw(dtype=dtype)), "cpu")
    p.build(to_pt(corpus))
    j = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**cfg_kw(dtype=dtype)))
    j.build(corpus)
    assert p.x.dtype == getattr(torch, dtype)
    assert np.array_equal(p.x.float().numpy(),
                          np.asarray(j.x).astype(np.float32))
    assert (p.row_cap, p.dim_cap, p.stats["dormant_dims"]) == (
        j.row_cap, j.dim_cap, j.stats["dormant_dims"])


def test_build_scatter_entries_unique(corpus):
    """The build's assignment-scatter equals the JAX scatter-add only for
    unique (row, col) entries: assert that they are."""
    p = pt.Engine(pt.AllPairsConfig(**cfg_kw()), "cpu")
    p.build(to_pt(corpus))
    ccsr = p.compact.map_csr(p._drop_unmapped(to_pt(corpus)))
    rows = np.repeat(np.arange(ccsr.n_rows), np.diff(ccsr.indptr))
    coo = pack_coo_i32(rows, ccsr.indices, ccsr.data, p.row_cap)
    live = coo[0] < p.row_cap
    keys = coo[0][live].astype(np.int64) * p.dim_cap + coo[1][live]
    assert np.unique(keys).size == keys.size == ccsr.indices.size
    assert int((p.x != 0).sum()) == keys.size


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("int8", [True, False])
def test_all_pairs_equals_jax_and_oracle(corpus, engines, int8, tau):
    p, j = engines[int8]
    before = dict(ts.LAUNCHES)
    rp, rj = p.all_pairs(tau), j.all_pairs(tau)
    assert ts.LAUNCHES == before  # CPU tensors: plain versions, no launch
    assert p._used_int8 is int8
    want = brute_force_pairs(corpus, tau)
    assert rp.pair_set() == rj.pair_set() == want
    assert len(want) >= 10
    sj = dict(zip(zip(rj.i.tolist(), rj.j.tolist()), rj.sims.tolist()))
    for a, b, s in zip(rp.i.tolist(), rp.j.tolist(), rp.sims.tolist()):
        assert abs(s - sj[(a, b)]) <= 1e-12


def test_load_jax_checkpoint(corpus, engines, tmp_path):
    _, j = engines[True]
    j.save(str(tmp_path))
    p = pt.Engine.load(str(tmp_path), device="cpu")
    assert p.ids == j.ids and p.cfg.vector_dim == DIM
    assert np.array_equal(p.max_weights, j.max_weights)
    assert p.all_pairs(0.7).pair_set() == j.all_pairs(0.7).pair_set()


def test_from_numpy_equals_build(corpus, engines):
    p0, _ = engines[True]
    ids = [f"doc{i}" for i in range(corpus.n_rows)]
    p = pt.Engine.from_numpy(
        corpus.indptr, corpus.indices, corpus.data, DIM, ids,
        corpus.max_weights(), pt.AllPairsConfig(**cfg_kw()), device="cpu",
    )
    assert torch.equal(p.x, p0.x)
    r0, r = p0.all_pairs(0.5), p.all_pairs(0.5)
    assert np.array_equal(r.i, r0.i) and np.array_equal(r.j, r0.j)
    assert r.ids == ids


def assert_same_result(rp, rj, want):
    """Pair sets equal each other and the oracle; sims equal, rtol = 0."""
    assert rp.pair_set() == rj.pair_set() == want
    sj = dict(zip(zip(rj.i.tolist(), rj.j.tolist()), rj.sims.tolist()))
    sp = dict(zip(zip(rp.i.tolist(), rp.j.tolist()), rp.sims.tolist()))
    assert sp == sj


# case -> config overrides under which the JAX engine and the port both
# take the full rectangle (``_kernel_ok`` / ``_pallas_ok`` false)
RECT_CASES = {
    "use_pallas_off": dict(use_pallas="off"),
    "highest": dict(matmul_precision="highest"),
    "high": dict(matmul_precision="high", use_pallas="off"),
    "bfloat16": dict(dtype="bfloat16", dim_bucket=64),
    "bfloat16_highest": dict(dtype="bfloat16", matmul_precision="highest"),
    # row_bucket not a multiple of query_tile: the capacity quantum rounds
    # up, so the last tile is never scored at a wrong offset
    "unaligned_row_bucket": dict(row_bucket=96, query_tile=64, dim_bucket=64),
    "untiled_dims": dict(dim_bucket=64, query_tile=64, row_bucket=64),
}


@pytest.mark.parametrize("case", list(RECT_CASES))
def test_rectangle_join_equals_jax_and_oracle(corpus, case):
    kw = cfg_kw(**RECT_CASES[case])
    p = pt.Engine(pt.AllPairsConfig(**kw), "cpu")
    p.build(to_pt(corpus))
    j = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**kw))
    j.build(corpus)
    assert not p._kernel_ok() and not j._pallas_ok()
    assert (p.row_cap, p.dim_cap) == (j.row_cap, j.dim_cap)
    assert p.row_cap % p.cfg.query_tile == 0
    before = dict(ts.LAUNCHES)
    for tau in (0.5, 0.8):
        assert p._tau_eff(tau) == j._tau_eff(tau)
        assert_same_result(p.all_pairs(tau), j.all_pairs(tau),
                           brute_force_pairs(corpus, tau))
        assert p._used_int8 is False and not p._int8_off
    assert ts.LAUNCHES == before
    counts = p.timer.counts
    n_tiles = p.row_cap // p.cfg.query_tile
    assert counts["kernel"] == counts["compact"] == 2 * n_tiles
    assert counts["d2h"] == counts["score_extract"] == 2


def _edge_corpora():
    d = 300
    rng = np.random.default_rng(5)
    unnorm = []
    for _ in range(50):
        dims = np.sort(rng.choice(d, 6, replace=False)).astype(np.int32)
        unnorm.append(Vectors.sparse(d, dims, rng.random(6) * 40.0))
    rng = np.random.default_rng(9)
    big = Vectors.sparse(d, np.arange(d, dtype=np.int32),
                         rng.random(d)).normalized()
    a, b = (Vectors.sparse(d, [0, 1], v) for v in ([0.6, 0.8], [0.8, 0.6]))
    tie = a.dot(b)
    return d, {
        # sim(a, b) == tau exactly: >= keeps it, the next float drops it
        "exact_tie": ([a, b], [tie, np.nextafter(tie, 2.0)]),
        # large-norm rows: the margin must scale with the norms
        "unnormalized": (unnorm, [400.0]),
        "empty_and_singleton": ([Vectors.sparse(d, [], []),
                                 Vectors.sparse(d, [1], [1.0]),
                                 Vectors.sparse(d, [1], [1.0])], [0.5]),
        "giant_row": ([big, Vectors.sparse(d, [0, 1], [0.6, 0.8])],
                      [0.1, 0.5]),
        "single_vector": ([Vectors.sparse(d, [0], [1.0])], [0.1]),
        # tau tiny: every overlapping pair, never a disjoint one
        "tiny_tau": ([Vectors.sparse(d, [0], [1.0]),
                      Vectors.sparse(d, [1], [1.0]),
                      Vectors.sparse(d, [0], [0.1])], [1e-6]),
    }


@pytest.mark.parametrize("case", ["exact_tie", "unnormalized",
                                  "empty_and_singleton", "giant_row",
                                  "single_vector", "tiny_tau"])
def test_rectangle_join_edge_corpora(case):
    d, corpora = _edge_corpora()
    rows, taus = corpora[case]
    csr = apsim_tpu.vector.batch.CSRMatrix.from_vectors(rows, d)
    kw = dict(vector_dim=d, query_tile=64, row_bucket=64, dim_bucket=64)
    p = pt.Engine(pt.AllPairsConfig(**kw), "cpu")
    p.build(to_pt(csr))
    j = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**kw))
    j.build(csr)
    assert not p._kernel_ok()
    n = 0
    for tau in taus:
        rp = p.all_pairs(tau)
        assert_same_result(rp, j.all_pairs(tau), brute_force_pairs(csr, tau))
        n += rp.n_pairs
    assert n == {"exact_tie": 1, "empty_and_singleton": 1,
                 "single_vector": 0, "tiny_tau": 1}.get(case, n)


def test_rectangle_join_of_a_loaded_checkpoint(corpus, tmp_path):
    """A JAX checkpoint restores into an engine that joins through the
    rectangle."""
    j = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**cfg_kw()))
    j.build(corpus)
    j.save(str(tmp_path))
    p = pt.Engine.load(
        str(tmp_path),
        pt.AllPairsConfig(**cfg_kw(matmul_precision="highest")), device="cpu")
    assert not p._kernel_ok()
    assert_same_result(p.all_pairs(0.7), j.all_pairs(0.7),
                       brute_force_pairs(corpus, 0.7))


@pytest.mark.parametrize("what", [
    "insert", "topk", "freeze", "save", "use_pallas_off", "highest",
    "profile_dir",
])
def test_unported_paths_raise(corpus, what, tmp_path):
    kw = {"use_pallas_off": {"use_pallas": "off"},
          "highest": {"matmul_precision": "highest"},
          "profile_dir": {"profile_dir": str(tmp_path / "trace")}}.get(
              what, {})
    if what in ("save", "profile_dir"):
        # ported: checkpoints (item C, the JAX package restores them) and
        # the torch.profiler trace of every join (item I)
        e = pt.Engine(pt.AllPairsConfig(**cfg_kw(**kw)), "cpu")
        e.build(to_pt(corpus))
        want = brute_force_pairs(corpus, 0.7)
        assert e.all_pairs(0.7).pair_set() == want
        if what == "profile_dir":
            assert len(os.listdir(tmp_path / "trace")) == 1
            return
        e.save(str(tmp_path / "ck"))
        j = apsim_tpu.Engine.load(str(tmp_path / "ck"))
        assert j.all_pairs(0.7).pair_set() == want
        return
    if what in ("use_pallas_off", "highest"):
        # ported: these configurations join through the full rectangle
        e = pt.Engine(pt.AllPairsConfig(**cfg_kw(**kw)), "cpu")
        e.build(to_pt(corpus))
        assert not e._kernel_ok()
        assert e.all_pairs(0.7).pair_set() == brute_force_pairs(corpus, 0.7)
        return
    if what in ("insert", "topk", "freeze"):
        # ported: the streaming path (item B1)
        e = pt.Engine(pt.AllPairsConfig(**cfg_kw()), "cpu")
        e.build(to_pt(corpus))
        q = corpus.row(0)
        if what == "insert":
            out = e.insert([("q", q)], tau=0.7).output["q"]
            sims = corpus.to_dense() @ q.to_array()
            assert set(out) == {str(i) for i in np.nonzero(sims >= 0.7)[0]}
            assert e.n_rows == corpus.n_rows + 1
        elif what == "topk":
            top = e.topk([("q", q)], 3)["q"]
            assert top[0] == ("0", pytest.approx(1.0)) and len(top) == 3
        else:
            e.freeze()
            assert e.frozen
            e.insert([("q", q)], tau=0.7)
            assert e.n_rows == corpus.n_rows
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        e = pt.Engine(pt.AllPairsConfig(**cfg_kw(**kw)), "cpu")
        e.build(to_pt(corpus))
        e.all_pairs()


def test_device_must_be_explicit():
    """The default device is the card; without CUDA that raises, and the
    engine never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        assert pt.Engine(pt.AllPairsConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA"):
            pt.Engine(pt.AllPairsConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        pt.Engine(pt.AllPairsConfig(), "meta")


def test_import_leaves_jax_out():
    code = ("import sys, apsim_tpu_torch, apsim_tpu_torch.bench; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'apsim_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
