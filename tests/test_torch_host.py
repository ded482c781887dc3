"""The port's host-only modules (copies, not imports) agree exactly with the
JAX package's on the same seeded inputs: compact column space, packed COO,
fp64 pair rescore, synthetic corpora, config loading."""

import os

import numpy as np
import pytest

from apsim_tpu.bench import scale as jax_scale
from apsim_tpu.config import load_config as jax_load_config
from apsim_tpu.index.compact import CompactSpace as JaxCompactSpace
from apsim_tpu.ops import rescore as jax_rescore
from apsim_tpu.vector.batch import pack_coo_i32 as jax_pack_coo
from apsim_tpu_torch.bench import scale as pt_scale
from apsim_tpu_torch.config import load_config as pt_load_config
from apsim_tpu_torch.index.compact import CompactSpace as PtCompactSpace
from apsim_tpu_torch.ops import rescore as pt_rescore
from apsim_tpu_torch.vector.batch import CSRMatrix as PtCSR
from apsim_tpu_torch.vector.batch import pack_coo_i32 as pt_pack_coo

from oracle import random_sparse_corpus

DIM = 3000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus():
    return random_sparse_corpus(np.random.default_rng(11), 240, DIM)


def as_pt(csr):
    return PtCSR(csr.n_rows, csr.n_cols, csr.indptr, csr.indices, csr.data)


@pytest.mark.parametrize("min_df", [1, 2])
def test_compact_space_identical(corpus, min_df):
    j = JaxCompactSpace.from_csr(corpus, 2048, min_df=min_df)
    p = PtCompactSpace.from_csr(as_pt(corpus), 2048, min_df=min_df)
    assert np.array_equal(j.ext_of_col, p.ext_of_col)
    assert j.capacity == p.capacity
    assert np.array_equal(j.cols_of(np.arange(DIM)), p.cols_of(np.arange(DIM)))
    if min_df == 1:  # every dim mapped: the remapped CSRs must match
        jm, pm = j.map_csr(corpus), p.map_csr(as_pt(corpus))
        assert np.array_equal(jm.indices, pm.indices)
        assert np.array_equal(jm.data, pm.data)
        assert jm.n_cols == pm.n_cols


@pytest.mark.parametrize("n", [0, 5, 1024, 1500])
def test_pack_coo_identical(n):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 300, n)
    cols = rng.integers(0, 2048, n)
    vals = rng.random(n)
    a = jax_pack_coo(rows, cols, vals, 512)
    b = pt_pack_coo(rows, cols, vals, 512)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("path", ["grouped", "merge", "numpy"])
def test_pair_dots_identical(corpus, path, monkeypatch):
    """Exact (bit-equal) fp64 rescores through each rescore path."""
    rng = np.random.default_rng(5)
    i = rng.integers(0, corpus.n_rows, 3000)
    j = rng.integers(0, corpus.n_rows, 3000)
    args = (corpus.indptr, corpus.indices, corpus.data, i, j, DIM)
    if path == "numpy":
        import apsim_tpu.native as jn
        import apsim_tpu_torch.native as pn

        for mod in (jn, pn):
            monkeypatch.setattr(mod, "get_lib", lambda: None)
        a = jax_rescore.pair_dots(*args)
        b = pt_rescore.pair_dots(*args)
    elif path == "grouped":
        a = jax_rescore.pair_dots(
            *args, compact=jax_rescore.build_compact(corpus.indices, DIM)
        )
        b = pt_rescore.pair_dots(
            *args, compact=pt_rescore.build_compact(corpus.indices, DIM)
        )
    else:
        a = jax_rescore.pair_dots(*args)
        b = pt_rescore.pair_dots(*args)
    assert np.array_equal(a, b)
    dense = corpus.to_dense()
    assert np.allclose(b, np.einsum("pd,pd->p", dense[i], dense[j]),
                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("gen", ["synthetic_corpus", "rcv1_like_corpus"])
def test_corpus_generators_identical(gen):
    a = getattr(jax_scale, gen)(700, seed=3)
    b = getattr(pt_scale, gen)(700, seed=3)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)


def test_config_loads_identically():
    paths = [os.path.join(REPO, "conf", "app.json")]
    over = {"pallas_int8": False, "mesh_shape": [2]}
    assert (jax_load_config(*paths, overrides=over).__dict__
            == pt_load_config(*paths, overrides=over).__dict__)
