"""The port's mesh and its rows-sharded ``MeshEngine`` (``parallel/mesh.py``,
``ops/mesh_pallas.py``) on the CPU, against the JAX package's
``MeshEngine(shard_axis="rows", use_pallas="on")`` on the conftest's 8
virtual devices, the port's ``Engine`` and the fp64 brute-force oracle.
The port's meshes put 8 shards on the CPU
(``make_mesh(8, devices=["cpu"] * 8)``).

Tolerances: the block schedules equal the JAX ones exactly; pair sets and
candidate sets are equal; similarities agree to 1e-12 (both are fp64
rescores of the same entries).
"""

import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu_torch as pt
from apsim_tpu.ops import mesh_pallas as jax_mesh_pallas
from apsim_tpu.parallel import MeshEngine as JaxMeshEngine
from apsim_tpu.parallel import make_mesh as jax_make_mesh
from apsim_tpu_torch.ops import mesh_pallas
from apsim_tpu_torch.ops import tri_score as ts

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 500


def cfg_kw(**kw):
    base = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
                shard_axis="rows", use_pallas="on")
    base.update(kw)
    return base


def to_pt(csr):
    return pt.CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                        csr.data)


def cpu_mesh(n):
    return pt.make_mesh(n, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    return random_sparse_corpus(rng, 220, DIM)


@pytest.fixture(scope="module")
def corpus330():
    rng = np.random.default_rng(13)
    return random_sparse_corpus(rng, 330, DIM)


# --------------------------------------------------------------- the mesh
def test_make_mesh_semantics():
    m = cpu_mesh(8)
    assert m.size == 8 and m.devices == (torch.device("cpu"),) * 8
    assert pt.make_mesh((2,), devices=["cpu", "cpu"]).size == 2
    assert pt.make_mesh(None, devices=["cpu"] * 3).size == 3
    assert pt.make_mesh((), devices=["cpu"] * 3).size == 3
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        pt.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="1-D"):
        pt.make_mesh((2, 2, 2), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="unsupported device"):
        pt.make_mesh(1, devices=["meta"])
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in pt.make_mesh().devices)
    else:  # the default is the cards, never a fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA"):
            pt.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA"):
            pt.MeshEngine(pt.AllPairsConfig(**cfg_kw()))
        with pytest.raises(RuntimeError, match="no CUDA"):
            pt.MeshChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()))


@pytest.mark.parametrize("shape", [(1024, 8, 64, 128), (384, 8, 64, 128),
                                   (4096, 3, 1024, 512), (512, 8, 512, 512)])
def test_rows_schedule_equals_jax(shape):
    row_cap, n_dev, tm, tn = shape
    ours = mesh_pallas.rows_schedule(row_cap, n_dev, tm, tn)
    theirs = jax_mesh_pallas.rows_schedule(row_cap, n_dev, tm, tn)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    live = ours[2].sum(axis=1)
    assert live.max() - live.min() <= 1 and live.sum() == ts.upper_blocks_rect(
        row_cap, tm, tn)[0].size


# ---------------------------------------------------------- MeshEngine
# case -> (corpus fixture, config overrides, expected (row_cap, tiles))
CASES = {
    # the JAX test's configuration: one (512, 512) block
    "row_bucket_512": ("corpus", dict(row_bucket=512), (512, (512, 512))),
    # a 384-row index: the (64, 128) rung, 15 blocks striped over 8 shards
    "striped": ("corpus330", {}, (384, (64, 128))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rows_join_equals_jax_oracle_and_engine(case, request):
    fixture, over, (row_cap, tiles) = CASES[case]
    csr = request.getfixturevalue(fixture)
    p = pt.MeshEngine(pt.AllPairsConfig(**cfg_kw(**over)), mesh=cpu_mesh(8))
    p.build(to_pt(csr))
    j = JaxMeshEngine(apsim_tpu.AllPairsConfig(**cfg_kw(**over)),
                      mesh=jax_make_mesh(8))
    j.build(csr)
    assert (p.row_cap, p._mesh_rows_geom()) == (row_cap, tiles)
    assert p._kernel_ok() and p.dim_cap % ts.K_QUANTUM == 0
    ref = pt.Engine(p.cfg, "cpu")  # same index width, one device
    ref.build(to_pt(csr))
    # the index exists only as its row blocks, built shard by shard
    assert p.x is None and len(p.x_blocks) == 8
    assert (p.row_cap, p.dim_cap) == (ref.row_cap, ref.dim_cap)
    for s, blk in enumerate(p.x_blocks):
        assert torch.equal(blk, ref.x[s * row_cap // 8:(s + 1) * row_cap // 8])
    # Engine's ladder has no (64, 128) rung; the candidate set is decided
    # per cell, so it does not depend on the tiles
    ref._tiles = lambda: tiles
    for tau in (0.4, 0.7):
        before = dict(ts.LAUNCHES)
        rp, rj = p.all_pairs(tau), j.all_pairs(tau)
        assert ts.LAUNCHES == before  # CPU tensors: plain versions
        assert rp.pair_set() == rj.pair_set() == brute_force_pairs(csr, tau)
        sj = dict(zip(zip(rj.i.tolist(), rj.j.tolist()), rj.sims.tolist()))
        for a, b, s in zip(rp.i.tolist(), rp.j.tolist(), rp.sims.tolist()):
            assert abs(s - sj[(a, b)]) <= 1e-12
        tau_eff = p._tau_eff(tau)
        cand = set(zip(*(a.tolist() for a in p._all_pairs_kernel(tau_eff))))
        want = set(zip(*(a.tolist() for a in ref._all_pairs_kernel(tau_eff))))
        assert cand == want and len(cand) >= len(rp.pair_set())
    assert len(brute_force_pairs(csr, 0.4)) > 20
    layout = p.shard_layout()
    assert list(layout) == [(i, "cpu") for i in range(8)]
    assert [v["row_block"] for v in layout.values()] == [
        (s * row_cap // 8, (s + 1) * row_cap // 8) for s in range(8)]


def test_one_shard_takes_engine_path(corpus, monkeypatch):
    """With one shard the mesh engine is ``Engine``: its kernel test, its
    tiles and its operand cache; the rows path is never entered."""
    kw = dict(vector_dim=DIM, row_bucket=256, dim_bucket=2048,
              query_tile=256, shard_axis="rows", use_pallas="on")

    def refuse(*a, **k):
        raise AssertionError("the rows path ran with one shard")

    monkeypatch.setattr(mesh_pallas, "mesh_rows_extract_int8", refuse)
    p = pt.MeshEngine(pt.AllPairsConfig(**kw), mesh=cpu_mesh(1))
    p.build(to_pt(corpus))
    ref = pt.Engine(pt.AllPairsConfig(**kw), "cpu")
    ref.build(to_pt(corpus))
    assert torch.equal(p.x, ref.x) and p.x_blocks[0] is p.x
    got = p.all_pairs(0.5)
    assert p._int8_cache is not None  # Engine's operand cache
    want = ref.all_pairs(0.5)
    assert np.array_equal(got.i, want.i) and np.array_equal(got.j, want.j)
    assert got.pair_set() == brute_force_pairs(corpus, 0.5)


def test_load_jax_checkpoint(corpus, tmp_path):
    j = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**cfg_kw(
        shard_axis="dims", use_pallas="auto")))
    j.build(corpus)
    j.save(str(tmp_path))
    p = pt.MeshEngine.load(str(tmp_path), pt.AllPairsConfig(**cfg_kw()),
                           mesh=cpu_mesh(8))
    assert p.ids == j.ids and len(p.x_blocks) == 8
    assert p.all_pairs(0.5).pair_set() == j.all_pairs(0.5).pair_set() == (
        brute_force_pairs(corpus, 0.5))


@pytest.mark.parametrize("what", [
    "dims", "both", "use_pallas_off", "no_int8", "highest", "insert",
    "topk", "save", "2d_mesh",
])
def test_unported_paths_raise(corpus, what):
    kw = {"dims": {"shard_axis": "dims"}, "both": {"shard_axis": "both"},
          "use_pallas_off": {"use_pallas": "off"},
          "no_int8": {"pallas_int8": False},
          "highest": {"matmul_precision": "highest"}}.get(what, {})
    item = {"insert": "item B", "topk": "item B",
            "save": "item C"}.get(what, "item A")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        if what == "2d_mesh":
            pt.make_mesh((2, 4), devices=["cpu"] * 8)
        e = pt.MeshEngine(pt.AllPairsConfig(**cfg_kw(**kw)),
                          mesh=cpu_mesh(8))
        e.build(to_pt(corpus))
        {"insert": lambda: e.insert([("q", corpus.row(0))]),
         "topk": lambda: e.topk([("q", corpus.row(0))], 3),
         "save": lambda: e.save("/nonexistent")}.get(what, e.all_pairs)()


def test_unknown_shard_axis_raises():
    with pytest.raises(ValueError, match="unknown shard_axis"):
        pt.MeshEngine(pt.AllPairsConfig(**cfg_kw(shard_axis="cols")),
                      mesh=cpu_mesh(8))
