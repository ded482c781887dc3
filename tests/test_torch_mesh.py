"""The port's mesh and its ``MeshEngine`` (``parallel/mesh.py``,
``ops/mesh_pallas.py``, ``ops/mesh_score.py``) on the CPU, against the JAX
package's ``MeshEngine`` on the conftest's 8 virtual devices, the port's
``Engine`` and the fp64 brute-force oracle: the rows-sharded kernel path
(``use_pallas="on"``), then every layout and configuration whose join is
the rectangle over the mesh (``"dims"``, a 2-D mesh, rows after int8
demotion or with the kernel path refused).  The port's meshes put 8 shards
on the CPU (``make_mesh(8, devices=["cpu"] * 8)``).

Tolerances: the block schedules equal the JAX ones exactly; pair sets and
candidate sets are equal; similarities agree to 1e-12 on the kernel path
and exactly (``rtol = 0``) on the rectangle (both are fp64 rescores of the
same entries by the same native routine).
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
from apsim_tpu_torch.ops import mesh_score
from apsim_tpu_torch.ops import score as score_ops
from apsim_tpu_torch.ops import tri_score as ts
from apsim_tpu_torch.parallel import Mesh

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
    m2 = pt.make_mesh((2, 3), devices=["cpu"] * 8)
    assert m2.shape == (2, 3) and m2.size == 6 and m.shape == (8,)
    with pytest.raises(ValueError, match="needs 12 devices, have 8"):
        pt.make_mesh((3, 4), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="does not hold"):
        Mesh((torch.device("cpu"),) * 3, (2, 2))
    with pytest.raises(ValueError, match="needs a 1-D mesh"):
        pt.MeshChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()), mesh=m2)
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


# ------------------------------------------- the rectangle over the mesh
# case -> (mesh shape, config overrides): layouts and configurations whose
# join is the full rectangle
RECT_CASES = {
    "dims": (8, dict(shard_axis="dims", use_pallas="auto")),
    "dims_2_shards": (2, dict(shard_axis="dims", use_pallas="auto")),
    "mesh_2x4": ((2, 4), dict(shard_axis="dims", use_pallas="auto")),
    "mesh_4x2_highest": ((4, 2), dict(matmul_precision="highest")),
    "rows_use_pallas_off": (8, dict(use_pallas="off")),
    "rows_no_int8": (8, dict(pallas_int8=False)),
    "rows_highest": (8, dict(matmul_precision="highest")),
    "dims_bfloat16": (8, dict(shard_axis="dims", dtype="bfloat16")),
}


def assert_same_result(rp, rj, want):
    assert rp.pair_set() == rj.pair_set() == want
    sj = dict(zip(zip(rj.i.tolist(), rj.j.tolist()), rj.sims.tolist()))
    assert sj == dict(zip(zip(rp.i.tolist(), rp.j.tolist()),
                          rp.sims.tolist()))


@pytest.mark.parametrize("case", list(RECT_CASES))
def test_rectangle_layouts_equal_jax_and_oracle(corpus330, case):
    shape, over = RECT_CASES[case]
    csr = corpus330
    p = pt.MeshEngine(pt.AllPairsConfig(**cfg_kw(**over)),
                      mesh=pt.make_mesh(shape, devices=["cpu"] * 8))
    p.build(to_pt(csr))
    j = JaxMeshEngine(apsim_tpu.AllPairsConfig(**cfg_kw(**over)),
                      mesh=jax_make_mesh(shape))
    j.build(csr)
    assert not p._kernel_ok() and not j._pallas_ok()
    assert p.cfg.shard_axis == j.cfg.shard_axis
    assert (p.row_cap, p.dim_cap) == (j.row_cap, j.dim_cap)
    # the index exists only as its grid of blocks, built shard by shard
    nr, nd = p.grid
    assert p.x is None and len(p.x_blocks) == nr * nd == p.n_shards
    hb, wb = p.row_cap // nr, p.dim_cap // nd
    jx = np.asarray(j.x).astype(np.float32)
    for s, blk in enumerate(p.x_blocks):
        r, d = divmod(s, nd)
        assert np.array_equal(
            blk.float().numpy(), jx[r * hb:(r + 1) * hb, d * wb:(d + 1) * wb])
    before = dict(ts.LAUNCHES)
    for tau in (0.4, 0.7):
        assert_same_result(p.all_pairs(tau), j.all_pairs(tau),
                           brute_force_pairs(csr, tau))
    assert ts.LAUNCHES == before and p._used_int8 is False
    # layout, keyed by (shard, device)
    layout = p.shard_layout()
    assert list(layout) == [(i, "cpu") for i in range(p.n_shards)]
    jl = list(j.shard_layout().values())
    assert list(layout.values()) == jl
    axis = p.cfg.shard_axis
    assert all(("row_block" in v) is (axis != "dims")
               and ("dim_block" in v) is (axis != "rows")
               for v in layout.values())
    assert len(brute_force_pairs(csr, 0.4)) > 20


def test_rows_mesh_joins_after_int8_demotion(corpus330):
    """A demoted multi-shard rows engine falls to the rectangle over the
    mesh, as the JAX engine falls to the XLA rectangle: same pairs before
    and after."""
    p = pt.MeshEngine(pt.AllPairsConfig(**cfg_kw()), mesh=cpu_mesh(8))
    p.build(to_pt(corpus330))
    j = JaxMeshEngine(apsim_tpu.AllPairsConfig(**cfg_kw()),
                      mesh=jax_make_mesh(8))
    j.build(corpus330)
    want = brute_force_pairs(corpus330, 0.5)
    assert p._kernel_ok() and p.all_pairs(0.5).pair_set() == want
    assert p._used_int8 is True
    p._int8_off = j._int8_off = True
    assert not p._kernel_ok() and not j._pallas_ok()
    assert_same_result(p.all_pairs(0.5), j.all_pairs(0.5), want)
    assert p._used_int8 is False and p.timer.counts["reduce"] > 0


@pytest.mark.parametrize("grid", [(8, 1), (1, 8), (2, 4), (4, 2)])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_mesh_rectangle_candidates_equal_single_device(corpus330, grid,
                                                       precision):
    """``mesh_allpairs_extract`` over any grid gives ``allpairs_extract``'s
    candidates at thresholds 1e-4 away from every fp64 score (the partial
    sums only reorder fp32 additions)."""
    ref = pt.Engine(pt.AllPairsConfig(**cfg_kw(
        dim_bucket=512, matmul_precision=precision)), "cpu")
    ref.build(to_pt(corpus330.normalized()))
    x = ref.x
    s64 = x.double().numpy() @ x.double().numpy().T
    taus = [t for t in np.arange(0.3, 0.9, 0.0731)
            if np.abs(s64 - t).min() >= 1e-4][:2]
    assert len(taus) == 2
    nr, nd = grid
    hb, wb = ref.row_cap // nr, ref.dim_cap // nd
    blocks = [x[r * hb:(r + 1) * hb, d * wb:(d + 1) * wb].contiguous()
              for r in range(nr) for d in range(nd)]
    devices = (torch.device("cpu"),) * (nr * nd)
    for tau in taus:
        want = score_ops.allpairs_extract(x, tau, 64, "upper", precision)
        want = sorted(zip(want[0].tolist(), want[1].tolist()))
        found = mesh_score.mesh_allpairs_extract(
            blocks, grid, devices, tau, 64, precision)
        got = sorted((a, b) for r, c in found
                     for a, b in zip(r.tolist(), c.tolist()))
        assert got == want and len(got) >= 3
        # only row blocks below a tile's bucket prefix are scored
        n_tiles = ref.row_cap // 64
        live = sum(min(nr, -(-(b1 * 64) // hb)) * (b1 - b0)
                   for b0, b1 in score_ops.upper_buckets(n_tiles))
        assert len(found) == live
    with pytest.raises(ValueError, match="not a multiple of tile"):
        mesh_score.mesh_allpairs_extract(blocks, grid, devices, 0.5, 100)


@pytest.mark.parametrize("layout", ["dims", "mesh_2x4"])
def test_load_jax_checkpoint_into_rectangle_layouts(corpus, layout, tmp_path):
    j = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**cfg_kw(
        shard_axis="dims", use_pallas="auto")))
    j.build(corpus)
    j.save(str(tmp_path))
    shape = 8 if layout == "dims" else (2, 4)
    p = pt.MeshEngine.load(
        str(tmp_path),
        pt.AllPairsConfig(**cfg_kw(shard_axis="dims", use_pallas="auto")),
        mesh=pt.make_mesh(shape, devices=["cpu"] * 8))
    assert p.ids == j.ids and len(p.x_blocks) == 8 and p.x is None
    assert p.cfg.shard_axis == ("dims" if layout == "dims" else "both")
    assert_same_result(p.all_pairs(0.5), j.all_pairs(0.5),
                       brute_force_pairs(corpus, 0.5))


@pytest.mark.parametrize("what", [
    "dims", "both", "use_pallas_off", "no_int8", "highest", "insert",
    "topk", "save", "2d_mesh",
])
def test_unported_paths_raise(corpus, what, tmp_path):
    kw = {"dims": {"shard_axis": "dims"}, "both": {"shard_axis": "both"},
          "use_pallas_off": {"use_pallas": "off"},
          "no_int8": {"pallas_int8": False},
          "highest": {"matmul_precision": "highest"}}.get(what, {})
    if what == "both":
        # only a 2-D mesh sets "both"; on a 1-D mesh it is no shard axis
        with pytest.raises(ValueError, match="unknown shard_axis"):
            pt.MeshEngine(pt.AllPairsConfig(**cfg_kw(**kw)), mesh=cpu_mesh(8))
        return
    if what in ("dims", "use_pallas_off", "no_int8", "highest", "2d_mesh"):
        # ported: these layouts and configurations join through the
        # rectangle over the mesh
        mesh = (pt.make_mesh((2, 4), devices=["cpu"] * 8)
                if what == "2d_mesh" else cpu_mesh(8))
        e = pt.MeshEngine(pt.AllPairsConfig(**cfg_kw(**kw)), mesh=mesh)
        e.build(to_pt(corpus))
        assert not e._kernel_ok() and e.x is None
        assert e.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)
        return
    if what == "save":
        # ported (item C): a mesh engine's checkpoint is the dense one
        e = pt.MeshEngine(pt.AllPairsConfig(**cfg_kw()), mesh=cpu_mesh(8))
        e.build(to_pt(corpus))
        e.save(str(tmp_path))
        j = apsim_tpu.Engine.load(str(tmp_path))
        assert j.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)
        return
    item = {"insert": "item G.2", "topk": "item G.2"}[what]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        e = pt.MeshEngine(pt.AllPairsConfig(**cfg_kw(**kw)),
                          mesh=cpu_mesh(8))
        e.build(to_pt(corpus))
        {"insert": lambda: e.insert([("q", corpus.row(0))]),
         "topk": lambda: e.topk([("q", corpus.row(0))], 3)}[what]()


def test_unknown_shard_axis_raises():
    with pytest.raises(ValueError, match="unknown shard_axis"):
        pt.MeshEngine(pt.AllPairsConfig(**cfg_kw(shard_axis="cols")),
                      mesh=cpu_mesh(8))
