"""The port's dense join end to end on the CPU, against the JAX package's
``Engine(use_pallas="on")`` (Pallas in interpret mode) and the fp64
brute-force oracle, on the same seeded corpus.

Tolerances: the index ``x`` equals the JAX index exactly; pair sets are
equal; similarities agree to 1e-12 (both are fp64 rescores of the same
entries)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu_torch as pt
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


@pytest.mark.parametrize("what", [
    "insert", "topk", "freeze", "save", "use_pallas_off", "highest",
    "profile_dir",
])
def test_unported_paths_raise(corpus, what):
    kw = {"use_pallas_off": {"use_pallas": "off"},
          "highest": {"matmul_precision": "highest"},
          "profile_dir": {"profile_dir": "/nonexistent"}}.get(what, {})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        e = pt.Engine(pt.AllPairsConfig(**cfg_kw(**kw)), "cpu")
        e.build(to_pt(corpus))
        {"insert": lambda: e.insert([("q", corpus.row(0))]),
         "topk": lambda: e.topk([("q", corpus.row(0))], 3),
         "freeze": e.freeze,
         "save": lambda: e.save("/nonexistent")}.get(what, e.all_pairs)()


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
