"""The port's out-of-core ``ChunkedAllPairs`` join end to end on the CPU,
against the JAX package's ``ChunkedAllPairs(use_pallas="on")`` (Pallas in
interpret mode) and the fp64 brute-force oracle, case by case as
``tests/test_chunked.py`` runs them: multi-panel sweep, rolling sweep,
single panel, all-dormant corpus, single-slab tier; then the stripe join
(every configuration the panel kernels refuse), checkpoints saved by the JAX
package, the cost model, and the paths not ported yet.

Tolerances: entry buffers equal the JAX ones exactly; pair sets and
candidate sets are equal; similarities agree to 1e-12 (both are fp64
rescores of the same entries).

The port's kernel tiles are (64, 128) where the JAX package's CPU tiles
are (64, 64) (the CUDA kernel needs ``tn % 128``), so its panel heights are
multiples of 128; the candidate set is decided per cell and does not
depend on the tiles, which ``test_candidates_equal_jax_under_jax_tiles``
shows.
"""

import os

import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu_torch as pt
from apsim_tpu.engine import ChunkedAllPairs as JaxChunked
from apsim_tpu.vector.sparse import Vectors
from apsim_tpu_torch.bench import ooc as pt_ooc
from apsim_tpu_torch.engine import chunked as pt_chunked
from apsim_tpu_torch.ops import tri_score as ts
from apsim_tpu_torch.vector.batch import round_up

from oracle import brute_force_pairs, brute_force_sims, random_sparse_corpus

DIM = 500


def cfg_kw(**kw):
    base = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64)
    base.update(kw)
    return base


def to_pt(csr):
    return pt.CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                        csr.data)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    return random_sparse_corpus(rng, 220, DIM)


@pytest.fixture(scope="module")
def big_corpus():
    """Enough rows for 4 panels of 128 (the rolling sweep's I-blocks)."""
    rng = np.random.default_rng(29)
    base = random_sparse_corpus(rng, 400, DIM)
    rows = [base.row(i) for i in range(base.n_rows)]
    rows += [base.row(i) for i in range(0, 40, 4)]  # cross-panel duplicates
    return apsim_tpu.vector.batch.CSRMatrix.from_vectors(rows, DIM)


# case -> (corpus fixture, port kwargs, JAX kwargs, engine attributes)
CASES = {
    "multi_panel": ("corpus", dict(panel_rows=128), dict(panel_rows=64), {}),
    "rolling": ("big_corpus", dict(panel_rows=128), dict(panel_rows=128),
                {"_panel_resident_bytes": 0}),
    "single_panel": ("corpus", {}, {}, {}),
    "single_slab": ("corpus", {}, {}, {"_use_single_slab": True}),
}


def make_pair(csr, case, **cfg):
    _, pkw, jkw, attrs = CASES[case]
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw(**cfg)), "cpu",
                           chunk_dim=128, **pkw)
    j = JaxChunked(apsim_tpu.AllPairsConfig(**cfg_kw(use_pallas="on",
                                                     **cfg)),
                   chunk_dim=128, **jkw)
    for eng in (p, j):
        for k, v in attrs.items():
            setattr(eng, k, v)
        eng.build(to_pt(csr) if eng is p else csr)
    return p, j


@pytest.mark.parametrize("case", list(CASES))
def test_join_equals_jax_and_oracle(case, request):
    csr = request.getfixturevalue(CASES[case][0])
    p, j = make_pair(csr, case)
    rb, tm, tn, n_panels, d_cap = p._panel_geom()
    assert p._panel_ok() and (tm, tn, d_cap) == (64, 128, 512)
    state = p._panel_state()
    if case == "multi_panel":
        assert n_panels >= 2
    if case == "rolling":
        assert n_panels >= 3
        # S = 4 slabs in flight -> B = 2 row panels per column scan
        p._panel_sweep_bytes = 4 * rb * d_cap
        j._panel_sweep_bytes = 4 * rb * d_cap
        assert n_panels * rb * d_cap > p._panel_resident_bytes
    if case == "single_panel":
        assert n_panels == 1
    assert p._single_slab_ok(state) is (case == "single_slab")
    for tau in (0.3, 0.6):
        before = dict(ts.LAUNCHES)
        slabs0 = p.timer.counts.get("slabs", 0)
        rp, rj = p.all_pairs(tau), j.all_pairs(tau)
        assert ts.LAUNCHES == before  # CPU tensors: plain versions
        want = brute_force_pairs(csr, tau)
        assert rp.pair_set() == rj.pair_set() == want
        sj = dict(zip(zip(rj.i.tolist(), rj.j.tolist()), rj.sims.tolist()))
        for a, b, s in zip(rp.i.tolist(), rp.j.tolist(), rp.sims.tolist()):
            assert abs(s - sj[(a, b)]) <= 1e-12
        if case == "rolling":
            # I-blocks {0,1} and {2,3}: 4 + 2 I-slabs, 2 J-slabs
            assert p.timer.counts["slabs"] - slabs0 == 6
    assert len(brute_force_pairs(csr, 0.3)) > 100


def test_build_layout_equals_jax(corpus):
    p, j = make_pair(corpus, "multi_panel")
    for a, b in zip(j._ent_host, p._ent_host):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(j._counts, p._counts)
    assert (j._n_chunks, j._chunk_cap, j._chunk_width, j.row_cap) == (
        p._n_chunks, p._chunk_cap, p._chunk_width, p.row_cap)
    assert np.array_equal(j.compact.ext_of_col, p.compact.ext_of_col)
    assert np.array_equal(j._dorm_dims, p._dorm_dims)
    assert np.array_equal(j.max_weights, p.max_weights)
    assert j._max_norm == p._max_norm


def test_candidates_equal_jax_under_jax_tiles(corpus):
    """Same panel height (128): the JAX sweep at its CPU tiles (64, 64)
    and the port's at (64, 128) produce the same candidate set."""
    p, j = make_pair(corpus, "multi_panel")
    j.panel_rows = 128
    j._panel_geom_cache = None
    assert j._panel_geom()[1:3] == (64, 64) and j._panel_geom()[4] == 2
    assert p._panel_geom()[1:4] == (64, 128, 2)
    for tau in (0.2, 0.5):
        tau_eff = p._tau_eff(tau)
        assert tau_eff == j._tau_eff(tau)
        pr, pc = p._all_pairs_panel(tau_eff)
        jr, jc = j._all_pairs_panel(tau_eff)
        got = sorted(zip(pr.tolist(), pc.tolist()))
        assert got == sorted(zip(jr.tolist(), jc.tolist()))
        assert len(got) > (100 if tau == 0.2 else 10)


def test_all_dormant_corpus():
    """Every dim df==1 -> zero device entries: the panel join still runs
    (empty slabs) and finds 0 pairs.  The insert half of the JAX test waits
    for the chunked insert."""
    vecs = [(f"v{i}", Vectors.sparse(300, [i * 3, i * 3 + 1], [0.6, 0.8]))
            for i in range(40)]
    kw = dict(vector_dim=300, query_tile=64, row_bucket=64, dim_bucket=64)
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**kw), "cpu", chunk_dim=64,
                           panel_rows=128)
    j = JaxChunked(apsim_tpu.AllPairsConfig(use_pallas="on", **kw),
                   chunk_dim=64, panel_rows=64)
    p.build(vecs)
    j.build(vecs)
    assert p._panel_ok() and int(p._counts.sum()) == 0
    assert p.stats["dormant_dims"] == j.stats["dormant_dims"] == 80
    assert p.all_pairs(0.5).n_pairs == j.all_pairs(0.5).n_pairs == 0
    assert p.stats["candidates_scored"] == 0


@pytest.mark.parametrize("flavor", ["chunked", "dense", "other_chunk_dim"])
def test_load_jax_checkpoint(corpus, flavor, tmp_path):
    """A JAX-saved chunked checkpoint places its entry buffers (fast path);
    a dense-flavor one, or one of another chunk_dim, rebuilds from the CSR
    shadow.  Either way: the JAX engine's pairs."""
    ids = [f"doc{i}" for i in range(corpus.n_rows)]
    if flavor == "dense":
        j = apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**cfg_kw()))
    else:
        j = JaxChunked(apsim_tpu.AllPairsConfig(**cfg_kw()),
                       chunk_dim=256 if flavor == "other_chunk_dim" else 128)
    j.build([(d, corpus.row(i)) for i, d in enumerate(ids)])
    j.save(str(tmp_path))
    want = j.all_pairs(0.4).pair_set()
    p = pt.ChunkedAllPairs.load(str(tmp_path), pt.AllPairsConfig(**cfg_kw()),
                                device="cpu", chunk_dim=128)
    z = np.load(tmp_path / "index.npz")
    assert p._fast_restorable(z) is (flavor == "chunked")
    assert p.ids == ids and p.n_rows == corpus.n_rows
    assert np.array_equal(p.max_weights, j.max_weights)
    ref = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()), "cpu",
                             chunk_dim=128)
    ref.build(to_pt(corpus), ids)
    for a, b in zip(ref._ent_host, p._ent_host):
        assert np.array_equal(a, b)
    assert np.array_equal(ref.compact.ext_of_col, p.compact.ext_of_col)
    assert p._max_norm == ref._max_norm
    got = p.all_pairs(0.4)
    assert got.pair_set() == want == brute_force_pairs(corpus, 0.4, ids)


# (n_rows, rb, n_panels) worked by hand from the port's constants at d_cap
# 32,768 (16 chunks of 2,048; tiles (1024, 512), so rb doubles from 1,024 to
# 16,384, the tallest whose 512 MiB slab fits ``_panel_slab_budget``; every
# sweep stays under the 32 GiB resident budget), the cost of rb being
# padded^2 / 2 * 32,768 / 7.5e14 + pairs * 1.7e-3 s:
#    20,000: rb  4,096: 20,480 rows, 15 pairs: 0.0092 + 0.0255 = 0.0347
#            rb  8,192: 24,576 rows,  6 pairs: 0.0132 + 0.0102 = 0.0234 <-
#            rb 16,384: 32,768 rows,  3 pairs: 0.0235 + 0.0051 = 0.0286
#   100,000: rb  8,192: 106,496 rows, 91 pairs: 0.2478 + 0.1547 = 0.4025
#            rb 16,384: 114,688 rows, 28 pairs: 0.2873 + 0.0476 = 0.3349 <-
#   500,000: rb  8,192: 507,904 rows, 1,953 pairs: 5.6355 + 3.3201 = 8.9556
#            rb 16,384: 507,904 rows,   496 pairs: 5.6355 + 0.8432 = 6.4787 <-
COST_PICKS = {20_000: (8192, 3), 100_000: (16384, 7), 500_000: (16384, 31)}


def test_cost_model_matches_jax(corpus):
    """The panel height and count the port's cost model picks at 32,768
    compact columns (16 chunks of 2048) equal the values worked out by hand
    from its own constants (``COST_PICKS``); the tiles and ``d_cap`` equal
    the JAX package's (the same rule).  The results stay the JAX engine's:
    at 220 rows the port's automatic geometry gives the pair set of JAX's
    at its own, and the fp64 oracle's."""
    for n, pick in COST_PICKS.items():
        out = []
        for eng in (JaxChunked(apsim_tpu.AllPairsConfig()),
                    pt.ChunkedAllPairs(pt.AllPairsConfig(), "cpu")):
            eng.n_rows, eng._n_chunks = n, 16
            eng._compact._base = 32768
            g = eng._panel_geom()
            out.append((g[0], g[1], g[2], g[-2], g[-1]))
        (_, jtm, jtn, _, jd), (rb, tm, tn, n_panels, d_cap) = out
        assert (rb, n_panels) == pick
        assert (tm, tn, d_cap) == (jtm, jtn, jd) == (1024, 512, 32768)
        assert n_panels * rb >= n > (n_panels - 1) * rb
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()), "cpu")
    j = JaxChunked(apsim_tpu.AllPairsConfig(**cfg_kw(use_pallas="on")))
    p.build(to_pt(corpus))
    j.build(corpus)
    assert p._panel_ok() and p.panel_rows is None
    assert (p.all_pairs(0.4).pair_set() == j.all_pairs(0.4).pair_set()
            == brute_force_pairs(corpus, 0.4))


# case -> (config overrides, constructor overrides, engine attributes):
# every way the panel kernels refuse a join, which then takes the stripes
STRIPE_CASES = {
    "no_int8": (dict(pallas_int8=False), {}, {}),
    "use_pallas_off": (dict(use_pallas="off"), {}, {}),
    "highest": (dict(pallas_int8=False, matmul_precision="highest"), {}, {}),
    "int8_stripes": (dict(use_pallas="off"), {}, {"_int8_stripes": True}),
    "odd_panel_rows": ({}, dict(panel_rows=64), {}),
    "narrow_super_tile": (dict(pallas_int8=False), dict(super_tile=256), {}),
    # an override that is no power of two and does not divide row_cap
    "odd_super_tile": (dict(pallas_int8=False), dict(super_tile=400), {}),
    "int8_narrow_super_tile": (dict(use_pallas="off"), dict(super_tile=64),
                               {"_int8_stripes": True}),
}


@pytest.mark.parametrize("case", list(STRIPE_CASES))
def test_stripe_join_equals_jax_and_oracle(corpus, case):
    cfg, ckw, attrs = STRIPE_CASES[case]
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw(**cfg)), "cpu",
                           chunk_dim=128, **ckw)
    jkw = {k: v for k, v in ckw.items() if k != "panel_rows"}
    j = JaxChunked(apsim_tpu.AllPairsConfig(**cfg_kw(**cfg)), chunk_dim=128,
                   **jkw)
    if case == "odd_panel_rows":
        j._use_panels = False  # JAX's CPU tiles would accept 64 rows
    for eng in (p, j):
        for k, v in attrs.items():
            setattr(eng, k, v)
        eng.build(to_pt(corpus) if eng is p else corpus)
    assert not p._panel_ok()
    assert p._q_super() == j._q_super() and p.row_cap % p._q_super() == 0
    n_stripes = -(-p.n_rows // p._q_super())
    before = dict(ts.LAUNCHES)
    for tau in (0.3, 0.6):
        c0 = dict(p.timer.counts)
        rp, rj = p.all_pairs(tau), j.all_pairs(tau)
        want = brute_force_pairs(corpus, tau)
        assert rp.pair_set() == rj.pair_set() == want
        sj = dict(zip(zip(rj.i.tolist(), rj.j.tolist()), rj.sims.tolist()))
        assert sj == dict(zip(zip(rp.i.tolist(), rp.j.tolist()),
                              rp.sims.tolist()))
        done = {k: p.timer.counts[k] - c0.get(k, 0)
                for k in ("slabs", "kernel", "epilogue", "compact", "d2h")}
        assert done == {"slabs": n_stripes * p._n_chunks,
                        "kernel": n_stripes * p._n_chunks,
                        "epilogue": n_stripes, "compact": n_stripes,
                        "d2h": 1}
    assert ts.LAUNCHES == before  # CPU tensors: kernel 4's plain version
    assert (p._int8_slabs() is not None) is ("_int8_stripes" in attrs)
    assert (j._int8_slabs() is not None) is ("_int8_stripes" in attrs)
    if "_int8_stripes" in attrs:
        key = p._q8_cache[0]
        p.all_pairs(0.6)
        assert p._q8_cache[0] == key  # quantized once per entry state
        p._ent[2].mul_(1.0)  # an in-place update invalidates the cache
        assert p._ent_key() != key
    assert len(brute_force_pairs(corpus, 0.3)) > 100


@pytest.mark.parametrize("int8_stripes", [False, True])
def test_tripped_int32_gate_takes_the_stripes(corpus, monkeypatch,
                                              int8_stripes):
    """A row at the int32-accumulator gate refuses the panel kernels and
    the int8 stripes alike (the instance demotes itself); the bf16 stripes
    still give the oracle's set."""
    monkeypatch.setattr(pt_chunked, "INT8_NNZ_GATE", 2)
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()), "cpu",
                           chunk_dim=128, panel_rows=128)
    p._int8_stripes = int8_stripes
    p.build(to_pt(corpus))
    assert p._panel_ok() and p._panel_state() is None
    assert p.all_pairs(0.4).pair_set() == brute_force_pairs(corpus, 0.4)
    assert p.timer.counts["epilogue"] == 1 and "kernel" in p.timer.counts
    assert p._int8_stripes is False and p._int8_slabs() is None
    assert pt.ChunkedAllPairs._int8_stripes is False  # class default


# the automatic stripe width worked by hand from the port's 16 GiB
# accumulator budget: 16 GiB / (4 * round_up(n, 8192)) floored to a power
# of two in [1024, 8192], then clamped to row_cap (4,096 at 3,000 rows);
# at 300,000 rows 16 GiB / (4 * 303,104) = 14,169 -> 8,192, where JAX's
# budget gives 4,096
AUTO_STRIPE = {20000: 8192, 100000: 8192, 3000: 4096, 300000: 8192}


@pytest.mark.parametrize("n_rows,override", [
    (20000, 16384), (20000, None), (100000, None), (100000, 5000),
    (3000, 8192), (3000, None), (300000, None), (1, 7),
])
def test_super_tile_rule_equals_jax(n_rows, override):
    """The stripe width: an override rounds down to a power of two that
    divides row_cap (above 8,192 rows row_cap is no power of two), as
    JAX's does; the automatic width is the widest power of two under the
    port's accumulator budget (``AUTO_STRIPE``)."""
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(), "cpu", super_tile=override)
    j = JaxChunked(apsim_tpu.AllPairsConfig(), super_tile=override)
    p.n_rows = j.n_rows = n_rows
    assert p.row_cap == j.row_cap
    st = p._q_super()
    assert st == (j._q_super() if override else AUTO_STRIPE[n_rows])
    assert p.row_cap % st == 0
    assert st & (st - 1) == 0 and (override is None or st <= override)
    if (n_rows, override) == (20000, 16384):
        assert (p.row_cap, st) == (24576, 8192)
    if override is None:
        assert 4 * round_up(n_rows, 8192) * st <= p._stripe_acc_budget
    p._stripe_acc_budget = 1 << 20  # a small budget narrows the auto pick
    assert p._q_super() == (st if override else min(1024, p.row_cap))


@pytest.mark.parametrize("what", [
    "insert", "topk", "freeze", "save", "use_pallas_off", "no_int8",
    "profile_dir", "odd_panel_rows",
])
def test_unported_paths_raise(corpus, what, tmp_path):
    kw = {"use_pallas_off": {"use_pallas": "off"},
          "no_int8": {"pallas_int8": False},
          "profile_dir": {"profile_dir": str(tmp_path / "trace")}}.get(
              what, {})
    rows = 64 if what == "odd_panel_rows" else None
    if what in ("save", "profile_dir"):
        # ported: checkpoints (item C; the JAX package takes its fast path
        # on them) and the torch.profiler trace of every join (item I)
        e = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw(**kw)), "cpu",
                               chunk_dim=128)
        e.build(to_pt(corpus))
        want = brute_force_pairs(corpus, 0.5)
        assert e.all_pairs(0.5).pair_set() == want
        if what == "profile_dir":
            assert len(os.listdir(tmp_path / "trace")) == 1
            return
        e.save(str(tmp_path / "ck"))
        j = apsim_tpu.engine.ChunkedAllPairs(
            apsim_tpu.AllPairsConfig(**cfg_kw()), chunk_dim=128)
        assert j._fast_restorable(np.load(tmp_path / "ck" / "index.npz"))
        j.restore(str(tmp_path / "ck"))
        assert j.all_pairs(0.5).pair_set() == want
        return
    if what in ("insert", "topk", "freeze"):
        # ported: the streaming path, held against the fp64 oracle
        e = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()), "cpu",
                               chunk_dim=128)
        e.build(to_pt(corpus))
        q = corpus.row(0)
        qv = pt.SparseVector(q.size, q.indices, q.values)
        sims = brute_force_sims(corpus)[0]
        if what == "topk":
            got = e.topk([("q", qv)], 3)["q"]
            np.testing.assert_allclose([s for _, s in got],
                                       np.sort(sims)[::-1][:3], atol=1e-12)
            return
        if what == "freeze":
            e.freeze()
        out = e.insert([("q", qv)], tau=0.5).output["q"]
        want = {str(r) for r in np.flatnonzero(sims >= 0.5)}
        assert set(out) == want  # the insert's own row is not its pair
        assert e.n_rows == corpus.n_rows + (what == "insert")
        return
    if what in ("use_pallas_off", "no_int8", "odd_panel_rows"):
        # ported: these configurations join through the stripes
        e = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw(**kw)), "cpu",
                               chunk_dim=128, panel_rows=rows)
        e.build(to_pt(corpus))
        assert not e._panel_ok()
        assert e.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        e = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw(**kw)), "cpu",
                               chunk_dim=128, panel_rows=rows)
        e.build(to_pt(corpus))
        {"insert": lambda: e.insert([("q", corpus.row(0))]),
         "topk": lambda: e.topk([("q", corpus.row(0))], 3),
         "freeze": e.freeze}.get(what, e.all_pairs)()


def test_device_must_be_explicit():
    """The default device is the card; without CUDA that raises, and the
    engine never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        assert pt.ChunkedAllPairs(pt.AllPairsConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA"):
            pt.ChunkedAllPairs(pt.AllPairsConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        pt.ChunkedAllPairs(pt.AllPairsConfig(), "meta")


def test_ooc_bench_report_on_cpu():
    """The out-of-core bench's join runs end to end at a small size (its
    command line refuses a machine without CUDA), with the stripe join of
    ``--stripes`` beside it, and so does ``--stream`` with the router's
    A/B."""
    rep = pt_ooc.run_ooc(600, device="cpu", chunk_dim=1024,
                         compare_stripes=True)
    assert rep["device"] == "cpu" and rep["panel_path"]
    assert rep["sweep"] == "resident"
    assert rep["pairs"] > 0 and rep["join_seconds"] > 0
    assert set(rep["stages_s"]) >= {"quantize_sort", "slabs", "kernel",
                                    "compact", "d2h", "rescore"}
    st = rep["stripes"]
    assert rep["stripe_parity"] is True and st["pairs"] == rep["pairs"]
    assert rep["stripe_join_seconds"] == st["join_seconds"] > 0
    assert (st["super_tile"], st["stripes"]) == (1024, 1)
    assert st["densify_passes"] == rep["n_chunks"]
    assert set(st["stages_s"]) >= {"slabs", "kernel", "epilogue", "compact",
                                   "d2h", "rescore"}
    # --stream: streamed inserts on the resident route, then the router's
    # A/B beyond the slab budget, every output against the fp64 oracle
    rep = pt_ooc.run_ooc(400, device="cpu", chunk_dim=1024, stream_rows=96,
                         stream_batch=(32, 48), stream_only=True)
    assert rep["stream"]["48"]["batches"] == 2
    assert rep["stream"]["48"]["parity"] is True
    s = rep["stream"]["32"]
    assert "join_seconds" not in rep and "router_ab" not in rep
    assert (s["rows"], s["batch"], s["batches"]) == (96, 32, 3)
    assert s["routes"] == {"resident_slabs": 3} and s["parity"] is True
    assert s["median_batch_seconds"] > 0 and s["vectors_per_sec"] > 0
    assert set(s["stages_ms_per_batch"]) >= {"admit", "prepare", "append",
                                             "product", "compact", "d2h",
                                             "rescore"}
    rep = pt_ooc.run_ooc(400, device="cpu", chunk_dim=1024, stream_rows=64,
                         stream_batch=(32,), stream_only=True,
                         router_ab=True, slab_budget_mb=0)
    assert rep["stream"]["32"]["parity"] is True
    assert rep["stream"]["32"]["match_path"] in ("host_spgemm",
                                                 "device_paneled")
    ab = rep["router_ab"]["32"]
    assert ab["router_choice"] in ("host_spgemm", "device_paneled")
    assert ab["host_spgemm_batch_seconds"] > 0
    assert ab["device_paneled_batch_seconds"] > 0
    assert ab["parity"] is True and isinstance(ab["router_correct"], bool)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            pt_ooc.main(["600", "--stripes"])
