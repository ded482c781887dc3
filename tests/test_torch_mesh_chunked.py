"""The port's mesh out-of-core join (``MeshChunkedAllPairs`` and
``ops/panel_mesh.py``) on the CPU, against the JAX package's
``MeshChunkedAllPairs(use_pallas="on")`` on the conftest's 8 virtual
devices, the port's single-device ``ChunkedAllPairs`` and the fp64
brute-force oracle.  The port's meshes put 1, 2 or 8 shards on the CPU
(``make_mesh(n, devices=["cpu"] * 8)``).

The stripe join over the mesh (``ops/chunked_mesh.py``: every
configuration the panel kernels refuse) is held against the JAX mesh's
stripes and the single-device stripes in the same way.

Tolerances: kernel 4's plain version equals the Pallas interpreter's int32
product exactly; the join state, the slabs and the entry buffers equal the
JAX arrays exactly; pair sets and candidate sets are equal (the int8
stripes' candidates for any shard count, their int32 sums being exact);
similarities agree to 1e-12 on the panel path and exactly (``rtol = 0``) on
the stripes (both are fp64 rescores of the same entries).
"""

import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu_torch as pt
from apsim_tpu.engine import ChunkedAllPairs as JaxChunked
from apsim_tpu.ops import panel_mesh as jax_panel_mesh
from apsim_tpu.parallel import MeshChunkedAllPairs as JaxMeshChunked
from apsim_tpu.parallel import make_mesh as jax_make_mesh
from apsim_tpu_torch.engine import chunked as pt_chunked
from apsim_tpu_torch.ops import chunked as chunked_ops
from apsim_tpu_torch.ops import panel_mesh
from apsim_tpu_torch.ops import tri_score as ts
from apsim_tpu_torch.parallel.collectives import gather_rows
from apsim_tpu_torch.parallel.mesh import Mesh
from apsim_tpu_torch.vector.batch import round_up

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 500
TAUS = (0.3, 0.5, 0.7)
CPU = torch.device("cpu")


def cfg_kw(**kw):
    base = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64)
    base.update(kw)
    return base


def to_pt(csr):
    return pt.CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                        csr.data)


def cpu_mesh(n):
    return pt.make_mesh(n, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    return random_sparse_corpus(rng, 220, DIM)


@pytest.fixture(scope="module")
def big_corpus():
    """Four panels of 128 rows, for the rolling sweep's I-blocks."""
    rng = np.random.default_rng(29)
    base = random_sparse_corpus(rng, 400, DIM)
    rows = [base.row(i) for i in range(base.n_rows)]
    rows += [base.row(i) for i in range(0, 40, 4)]  # cross-panel duplicates
    return apsim_tpu.vector.batch.CSRMatrix.from_vectors(rows, DIM)


def port_engine(csr, n_shards, attrs=None, **kw):
    e = pt.MeshChunkedAllPairs(pt.AllPairsConfig(**cfg_kw(**kw)),
                               mesh=cpu_mesh(n_shards), chunk_dim=32,
                               panel_rows=128)
    for k, v in (attrs or {}).items():
        setattr(e, k, v)
    e.build(to_pt(csr))
    return e


def jax_engine(csr, n_shards, panel_rows=64):
    e = JaxMeshChunked(apsim_tpu.AllPairsConfig(**cfg_kw(use_pallas="on")),
                       mesh=jax_make_mesh(n_shards), chunk_dim=32,
                       panel_rows=panel_rows)
    e.build(csr)
    return e


# ------------------------------------------------------------- kernel 4
@pytest.mark.parametrize("shape", [
    (128, 256, 256, 64, 128, 128),
    (192, 384, 384, 64, 128, 128),
    (64, 128, 96, 64, 128, 32),  # d not a multiple of 128: port pads
])
def test_int8_matmul_plain_equals_pallas_interpreter(shape):
    """Kernel 4's plain version against ``_int8_matmul`` itself, run by
    the Pallas interpreter at tiles (tm, tn, tk)."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    m, n, d, tm, tn, tk = shape
    rng = np.random.default_rng(m + n + d)
    a = rng.integers(-127, 128, (m, d), dtype=np.int8)
    b = rng.integers(-127, 128, (n, d), dtype=np.int8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(jax_panel_mesh._int8_matmul,
                                  static_argnums=(2, 3, 4))(a, b, tm, tn, tk))
    pad = -d % ts.K_QUANTUM
    ta = torch.from_numpy(np.pad(a, ((0, 0), (0, pad))))
    tb = torch.from_numpy(np.pad(b, ((0, 0), (0, pad))))
    before = ts.LAUNCHES["int8_matmul"]
    got = panel_mesh.int8_matmul(ta, tb)
    assert ts.LAUNCHES["int8_matmul"] == before  # CPU: the plain version
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, a.astype(np.int64) @ b.astype(np.int64).T)
    assert torch.equal(panel_mesh.int8_matmul_plain(ta, tb), got)


@pytest.mark.parametrize("bad", ["m", "n", "d", "dtype", "width"])
def test_int8_matmul_refuses_untiled_operands(bad):
    m, n, d = {"m": (96, 128, 128), "n": (64, 64, 128),
               "d": (64, 128, 96)}.get(bad, (64, 128, 128))
    a = torch.zeros((m, d), dtype=torch.int8)
    b = torch.zeros((n, d + (128 if bad == "width" else 0)),
                    dtype=torch.int16 if bad == "dtype" else torch.int8)
    with pytest.raises(ValueError):
        panel_mesh.int8_matmul(a, b)


# -------------------------------------------------- join state and slabs
@pytest.fixture(scope="module")
def pair8(corpus):
    """(port engine, JAX engine) over 8 shards, both at rb = 128."""
    return port_engine(corpus, 8), jax_engine(corpus, 8, panel_rows=128)


def jax_shards(arr):
    """The per-device blocks of a chunk-sharded JAX array, in shard
    order."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
    return [np.asarray(s.data) for s in shards]


def test_entry_buffers_equal_jax_shards(pair8, corpus):
    p, j = pair8
    assert p._n_chunks == j._n_chunks == 16
    for ours, theirs in zip(p._ent, j._ent):
        for a, b in zip(ours, jax_shards(theirs)):
            assert a.numpy().dtype == b.dtype
            assert np.array_equal(a.numpy(), b)
    for a, b in zip(p._counts_dev, jax_shards(j._counts_dev)):
        assert np.array_equal(a.numpy(), b)
    layout = p.shard_layout()
    assert list(layout) == [(i, "cpu") for i in range(8)]
    assert sum(v["n_entries"] for v in layout.values()) + p.stats[
        "dormant_dims"] == int(corpus.indptr[-1])


def test_panel_state_equals_jax(pair8):
    p, j = pair8
    rb, _, _, n_panels, _ = p._panel_geom()
    assert (rb, n_panels) == (128, 2) and p.row_cap == j.row_cap
    r_s, c_s, q_s, pcounts, aux, max_nnz = panel_mesh.mesh_panel_state(
        p.mesh, p.row_cap, rb, n_panels, *p._ent, p._counts_dev)
    fn = jax_panel_mesh.mesh_panel_state(j.mesh, "shards", j.row_cap, rb,
                                         n_panels)
    jr, jc, jq, jaux, jpc, jmax = (np.asarray(a) for a in fn(
        j._ent[0], j._ent[1], j._ent[2], j._counts_dev))
    for s in range(8):
        assert np.array_equal(r_s[s].numpy(), jr[s])
        assert np.array_equal(c_s[s].numpy(), jc[s])
        assert np.array_equal(q_s[s].numpy(), jq[s])
        assert np.array_equal(pcounts[s].numpy(), jpc[s])
    assert np.array_equal(aux.numpy(), jaux)
    assert max_nnz == int(jmax) > 0


def test_panel_slabs_equal_jax_column_blocks(pair8):
    p, j = pair8
    sp, sj = p._panel_state(), j._panel_state()
    d_local = sj["d_local"]
    assert sp["d_local"] == panel_mesh.slab_width(d_local * 8, 8) == 128
    for panel in range(p._panel_geom()[3]):
        ours = p._build_slab(sp, panel)
        theirs = np.asarray(j._build_slab(sj, panel))
        assert len(ours) == 8
        for s, slab in enumerate(ours):
            block = theirs[:, s * d_local:(s + 1) * d_local]
            assert np.array_equal(slab[:, :d_local].numpy(), block)
            assert not slab[:, d_local:].any()  # K-stage padding


# ------------------------------------------------------------- the join
SWEEPS = {"resident": "corpus", "rolling": "big_corpus"}


@pytest.mark.parametrize("sweep", list(SWEEPS))
@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_join_equals_jax_oracle_and_single_device(n_shards, sweep, request):
    csr = request.getfixturevalue(SWEEPS[sweep])
    p = port_engine(csr, n_shards)
    j = jax_engine(csr, n_shards, panel_rows=128 if sweep == "rolling"
                   else 64)
    single = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()), "cpu",
                                chunk_dim=32, panel_rows=128)
    single.build(to_pt(csr))
    rb, tm, tn, n_panels, d_cap = p._panel_geom()
    assert p._panel_ok() and (rb, tm, tn) == (128, 64, 128)
    assert p._n_chunks % n_shards == 0 and d_cap % (128 * n_shards) == 0
    if sweep == "rolling":
        assert n_panels == 4
        for e in (p, j):
            e._panel_resident_bytes = 0
        p._panel_sweep_bytes = 4 * p._slab_bytes(rb, d_cap)  # B = 2
    else:
        assert n_panels == 2
    for tau in TAUS:
        before = dict(ts.LAUNCHES)
        slabs0 = p.timer.counts.get("slabs", 0)
        rp, rj = p.all_pairs(tau), j.all_pairs(tau)
        assert ts.LAUNCHES == before  # CPU tensors: plain versions
        assert rp.pair_set() == rj.pair_set() == brute_force_pairs(csr, tau)
        sj = dict(zip(zip(rj.i.tolist(), rj.j.tolist()), rj.sims.tolist()))
        for a, b, s in zip(rp.i.tolist(), rp.j.tolist(), rp.sims.tolist()):
            assert abs(s - sj[(a, b)]) <= 1e-12
        if sweep == "rolling":
            # I-blocks {0,1} and {2,3}: 4 + 2 I-slabs, 2 J-slabs
            assert p.timer.counts["slabs"] - slabs0 == 6
        tau_eff = p._tau_eff(tau)
        assert tau_eff == single._tau_eff(tau)
        cand = set(zip(*(a.tolist() for a in p._all_pairs_panel(tau_eff))))
        want = set(zip(*(a.tolist()
                         for a in single._all_pairs_panel(tau_eff))))
        assert cand == want and len(cand) >= len(rp.pair_set())
    assert len(brute_force_pairs(csr, 0.3)) > 100


def test_stage_split_has_reduce_and_epilogue(pair8):
    """Each panel pair times its kernel launches, the int32 sum, the bound
    epilogue and the compaction as stages of their own."""
    p, _ = pair8
    stages = ("kernel", "reduce", "epilogue", "compact")
    before = {k: p.timer.counts.get(k, 0) for k in stages}
    p.all_pairs(0.5)
    for k in stages:  # two panels: pairs (0, 0), (0, 1), (1, 1)
        assert p.timer.counts[k] - before[k] == 3


def finished_pair(mesh, xi, xj, aux, row0, col0, tau_eff, bounds, devices):
    """A panel pair end to end, stage by stage: kernel 4 on every shard,
    ``gather_rows`` with its stream waits, then on each row slice kernel
    5 and ``compact_bits`` (its counts read and checked there), the lists
    moved to the lead device in slice order."""
    rb = xi[0].shape[0]
    parts = [panel_mesh.int8_matmul(a, b) for a, b in zip(xi, xj)]
    placed = gather_rows(parts, bounds, devices)
    found = []
    for ps, (a, b), dev in zip(placed, bounds, devices):
        gb, g64, cnt = panel_mesh.pair_bits_int8(
            ps, aux[:, row0 + a:row0 + b].to(dev),
            aux[:, col0:col0 + rb].to(dev), row0 + a, col0, tau_eff)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        r, c = ts.compact_bits(gb, g64, cnt, zero, zero, b - a, rb,
                               pre_level=rb % ts.SUPER2 == 0)
        found.append(((r + row0 + a).to(mesh.lead), (c + col0).to(mesh.lead)))
    return tuple(torch.cat(lists) for lists in zip(*found))


@pytest.mark.parametrize("pair", [(0, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pending_pair_equals_finished_pair(big_corpus, n_shards, pair):
    """``mesh_panel_pair`` launches a pending pair; its lists equal those
    of the same pair finished stage by stage, value and order, over the
    mesh's own slices and over one row slice per shard (the cut of a mesh
    with one shard a card), on 256-row panels."""
    p = pt.MeshChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()),
                               mesh=cpu_mesh(n_shards), chunk_dim=32,
                               panel_rows=256)
    p.build(to_pt(big_corpus))
    state = p._panel_state()
    rb = state["geom"][0]
    assert (rb, state["geom"][3]) == (256, 2)
    pi, pj = pair
    xi, xj = p._build_slab(state, pi), p._build_slab(state, pj)
    aux = state["aux_on"][p.mesh.lead]
    tau_eff = p._tau_eff(0.3)
    tally = ts.CountTally("cpu")
    pending = panel_mesh.mesh_panel_pair(
        p.mesh, xi, xj, state["aux_on"], pi * rb, pj * rb, tau_eff,
        tally=tally)
    assert isinstance(pending, panel_mesh.MeshPendingPair)
    assert not pending.done
    got = pending.result()
    assert pending.done
    tally.check()
    bounds, devices = panel_mesh.card_slices(p.mesh.devices, rb)
    want = finished_pair(p.mesh, xi, xj, aux, pi * rb, pj * rb, tau_eff,
                         bounds, devices)
    assert tally.want[0] == want[0].numel() > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # one row slice per shard, as over n_shards cards
    bounds = panel_mesh.row_slices(rb, n_shards)
    assert all(b > a for a, b in bounds)
    parts = [panel_mesh.int8_matmul(a, b) for a, b in zip(xi, xj)]
    placed, copied = gather_rows(parts, bounds, [CPU] * n_shards,
                                 wait=False)
    assert copied == [[]] * n_shards
    sliced = panel_mesh.MeshPendingPair(
        placed, copied, bounds, [CPU] * n_shards,
        {CPU: aux[:, pi * rb:(pi + 1) * rb]},
        {CPU: aux[:, pj * rb:(pj + 1) * rb]}, pi * rb, pj * rb, rb, tau_eff,
        CPU).result()
    for a, b in zip(sliced, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sweep", list(SWEEPS))
@pytest.mark.parametrize("n_shards", [2, 4])
def test_join_with_pairs_pending_counts_them(n_shards, sweep, request):
    """The sweep takes pair k's lists after it has launched pair k+1, so
    every pair of a join but the last is still pending at the next
    launch (``stats["mesh_pairs_overlapped"]``), join after join; the
    pair sets are the JAX mesh's and the oracle's."""
    csr = request.getfixturevalue(SWEEPS[sweep])
    p = port_engine(csr, n_shards)
    if sweep == "rolling":
        rb, _, _, _, d_cap = p._panel_geom()
        p._panel_resident_bytes = 0
        p._panel_sweep_bytes = 4 * p._slab_bytes(rb, d_cap)
    j = jax_engine(csr, n_shards, panel_rows=128)
    n_panels = p._panel_geom()[3]
    n_pairs = n_panels * (n_panels + 1) // 2
    assert p.stats["mesh_pairs_overlapped"] == 0
    for k, tau in enumerate(TAUS):
        rp = p.all_pairs(tau)
        assert rp.pair_set() == j.all_pairs(tau).pair_set() == (
            brute_force_pairs(csr, tau))
        assert p.stats["mesh_pairs_overlapped"] == (k + 1) * (n_pairs - 1)
    assert n_pairs > 1


def test_mesh_planted_count_raises_at_the_end(corpus, monkeypatch):
    """The pending pairs leave their count check to the join's tally: a
    count planted wrong in the first pair's kernel 5 raises once every
    pair is compacted."""
    p = port_engine(corpus, 2)
    want = p.all_pairs(0.5).pair_set()
    bits = panel_mesh.pair_bits_int8
    planted = []

    def plant(*a, **k):
        gb, g64, cnt = bits(*a, **k)
        if not planted:
            cnt[0, 0] += 1
        planted.append(1)
        return gb, g64, cnt

    monkeypatch.setattr(panel_mesh, "pair_bits_int8", plant)
    compacted = []
    compact = ts.PendingPair.compact
    monkeypatch.setattr(ts.PendingPair, "compact", lambda self, n: (
        compacted.append(1), compact(self, n))[1])
    with pytest.raises(RuntimeError, match="kernel counted"):
        p.all_pairs(0.5)
    assert len(planted) == len(compacted) == 3  # every pair, one slice
    monkeypatch.setattr(panel_mesh, "pair_bits_int8", bits)
    assert p.all_pairs(0.5).pair_set() == want and want


def test_epilogue_chunking_is_invisible(corpus, monkeypatch):
    """The epilogue's row chunks bound its temporaries; the candidate
    lists come out identical at one chunk per rectangle and at one
    super-group (64 rows) per chunk."""
    p = port_engine(corpus, 2)
    tau_eff = p._tau_eff(0.3)
    whole = p._all_pairs_panel(tau_eff)
    monkeypatch.setattr(panel_mesh, "EPILOGUE_CELLS", 1)
    assert panel_mesh._epilogue_rows(128) == ts.SUPER
    split = p._all_pairs_panel(tau_eff)
    for a, b in zip(whole, split):
        assert np.array_equal(a, b)
    assert whole[0].size > 100


# ---------------------------------------------------------- checkpoints
@pytest.mark.parametrize("flavor", ["mesh_16_chunks", "single_15_chunks"])
def test_load_jax_checkpoint(corpus, flavor, tmp_path):
    """A JAX checkpoint with 16 chunks places its entry buffers over 8
    shards (fast path); one with 15 (not a multiple of 8) rebuilds from
    its CSR shadow."""
    ids = [f"doc{i}" for i in range(corpus.n_rows)]
    cfg = apsim_tpu.AllPairsConfig(**cfg_kw())
    if flavor == "mesh_16_chunks":
        j = JaxMeshChunked(cfg, mesh=jax_make_mesh(8), chunk_dim=32)
    else:
        j = JaxChunked(cfg, chunk_dim=32)
    j.build([(d, corpus.row(i)) for i, d in enumerate(ids)])
    j.save(str(tmp_path))
    want = j.all_pairs(0.4).pair_set()
    p = pt.MeshChunkedAllPairs.load(
        str(tmp_path), pt.AllPairsConfig(**cfg_kw()), mesh=cpu_mesh(8),
        chunk_dim=32, panel_rows=128)
    z = np.load(tmp_path / "index.npz")
    assert int(z["chunk_geom"][0]) == (16 if flavor == "mesh_16_chunks"
                                       else 15)
    assert p._fast_restorable(z) is (flavor == "mesh_16_chunks")
    assert p.ids == ids and p._n_chunks == 16
    ref = port_engine(corpus, 8)
    for a, b in zip(ref._ent_host, p._ent_host):
        assert np.array_equal(a, b)
    got = p.all_pairs(0.4)
    assert got.pair_set() == want == brute_force_pairs(corpus, 0.4, ids)


# ------------------------------------------------- the mesh's stripe join
# case -> (config overrides, engine attributes)
STRIPE_CASES = {
    "no_int8": (dict(pallas_int8=False), {}),
    "use_pallas_off": (dict(use_pallas="off"), {}),
    "highest": (dict(pallas_int8=False, matmul_precision="highest"), {}),
    "int8_stripes": (dict(use_pallas="off"), {"_int8_stripes": True}),
}


@pytest.mark.parametrize("case", list(STRIPE_CASES))
@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_stripe_join_equals_jax_oracle_and_single_device(corpus, n_shards,
                                                         case):
    cfg, attrs = STRIPE_CASES[case]
    p = port_engine(corpus, n_shards, attrs, **cfg)
    j = JaxMeshChunked(apsim_tpu.AllPairsConfig(**cfg_kw(**cfg)),
                       mesh=jax_make_mesh(n_shards), chunk_dim=32)
    for k, v in attrs.items():
        setattr(j, k, v)
    j.build(corpus)
    single = pt.ChunkedAllPairs(pt.AllPairsConfig(**cfg_kw(**cfg)), "cpu",
                                chunk_dim=32)
    for k, v in attrs.items():
        setattr(single, k, v)
    single.build(to_pt(corpus))
    assert not p._panel_ok() and p._q_super() == j._q_super() == 1024
    assert (p._int8_slabs() is not None) is (case == "int8_stripes")
    before = dict(ts.LAUNCHES)
    for tau in (0.3, 0.6):
        c0 = dict(p.timer.counts)
        rp, rj = p.all_pairs(tau), j.all_pairs(tau)
        want = brute_force_pairs(corpus, tau)
        assert rp.pair_set() == rj.pair_set() == want
        assert single.all_pairs(tau).pair_set() == want
        sj = dict(zip(zip(rj.i.tolist(), rj.j.tolist()), rj.sims.tolist()))
        assert sj == dict(zip(zip(rp.i.tolist(), rp.j.tolist()),
                              rp.sims.tolist()))
        done = {k: p.timer.counts[k] - c0.get(k, 0)
                for k in ("slabs", "kernel", "reduce", "epilogue", "compact")}
        assert done == {"slabs": p._n_chunks, "kernel": p._n_chunks,
                        "reduce": 1, "epilogue": 1, "compact": 1}
        if case == "int8_stripes":
            # exact int32 sums: the single-device stripes' candidates
            tau_eff = p._tau_eff(tau)
            cand = p._all_pairs_stripes(tau_eff)
            ref = single._all_pairs_stripes(tau_eff)
            assert sorted(zip(*(a.tolist() for a in cand))) == sorted(
                zip(*(a.tolist() for a in ref)))
            assert cand[0].size >= len(want)
    assert ts.LAUNCHES == before  # CPU tensors: plain versions


def test_mesh_quantize_entries_equals_single_device(pair8):
    """The sharded quantization (``pmax`` / ``psum`` of the per-row maxima
    and sums) gives the single-device ``quantize_chunk_entries`` values,
    the JAX mesh function's too."""
    from apsim_tpu.ops import chunked_mesh as jax_cm

    p, j = pair8
    qs, aux, max_nnz = p._quantize_entries()
    host = [torch.from_numpy(a) for a in p._ent_host]
    q1, aux1, max1 = chunked_ops.quantize_chunk_entries(host[0], host[2],
                                                        p.row_cap)
    assert torch.equal(torch.cat(qs), q1) and torch.equal(aux, aux1)
    assert max_nnz == max1 > 0
    jq, jaux, jmax = jax_cm.mesh_quantize_chunk_entries(
        j.mesh, "shards", j.row_cap)(j._ent[0], j._ent[2])
    assert np.array_equal(torch.cat(qs).numpy(), np.asarray(jq))
    assert np.array_equal(aux.numpy(), np.asarray(jaux))
    assert int(jmax) == max_nnz


def test_tripped_gate_takes_the_mesh_stripes(corpus, monkeypatch):
    import apsim_tpu_torch.parallel.chunked_mesh as pt_cm

    monkeypatch.setattr(pt_cm, "INT8_NNZ_GATE", 2)
    monkeypatch.setattr(pt_chunked, "INT8_NNZ_GATE", 2)
    p = port_engine(corpus, 8, {"_int8_stripes": True})
    assert p._panel_ok() and p._panel_state() is None
    assert p.all_pairs(0.4).pair_set() == brute_force_pairs(corpus, 0.4)
    assert p._int8_stripes is False and p.timer.counts["reduce"] == 1


def test_load_jax_checkpoint_into_stripe_engine(corpus, tmp_path):
    """A checkpoint restores into an engine with a ``super_tile`` and no
    int8 kernels, and joins through the mesh's stripes."""
    ids = [f"doc{i}" for i in range(corpus.n_rows)]
    j = JaxMeshChunked(apsim_tpu.AllPairsConfig(**cfg_kw()),
                       mesh=jax_make_mesh(8), chunk_dim=32)
    j.build([(d, corpus.row(i)) for i, d in enumerate(ids)])
    j.save(str(tmp_path))
    p = pt.MeshChunkedAllPairs.load(
        str(tmp_path), pt.AllPairsConfig(**cfg_kw(pallas_int8=False)),
        mesh=cpu_mesh(8), chunk_dim=32, super_tile=256)
    assert p._q_super() == 256 and not p._panel_ok()
    got = p.all_pairs(0.4)
    assert got.pair_set() == j.all_pairs(0.4).pair_set() == (
        brute_force_pairs(corpus, 0.4, ids))
    assert p.timer.counts["epilogue"] == 1  # 220 rows: one 256-wide stripe


# ---------------------------------------------------------- the refusals
@pytest.mark.parametrize("what", [
    "insert", "topk", "freeze", "save", "use_pallas_off", "no_int8",
    "odd_panel_rows",
])
def test_unported_paths_raise(corpus, what, tmp_path):
    kw = {"use_pallas_off": {"use_pallas": "off"},
          "no_int8": {"pallas_int8": False}}.get(what, {})
    if what in ("use_pallas_off", "no_int8", "odd_panel_rows"):
        # ported: these configurations join through the mesh's stripes
        e = pt.MeshChunkedAllPairs(
            pt.AllPairsConfig(**cfg_kw(**kw)), mesh=cpu_mesh(8),
            chunk_dim=32, panel_rows=64 if what == "odd_panel_rows" else 128)
        e.build(to_pt(corpus))
        assert not e._single_slab_ok(None) and not e._panel_ok()
        assert e.all_pairs(0.5).pair_set() == brute_force_pairs(corpus, 0.5)
        return
    if what == "save":
        # ported (item C): the chunked checkpoint of the whole entry
        # buffers; the port's mesh and the JAX package's restore it
        e = pt.MeshChunkedAllPairs(pt.AllPairsConfig(**cfg_kw()),
                                   mesh=cpu_mesh(8), chunk_dim=32,
                                   panel_rows=128)
        e.build(to_pt(corpus))
        e.save(str(tmp_path))
        want = brute_force_pairs(corpus, 0.5)
        back = pt.MeshChunkedAllPairs.load(
            str(tmp_path), pt.AllPairsConfig(**cfg_kw()), mesh=cpu_mesh(8),
            chunk_dim=32, panel_rows=128)
        assert back._n_chunks == e._n_chunks
        assert back.all_pairs(0.5).pair_set() == want
        assert apsim_tpu.Engine.load(str(tmp_path)).all_pairs(
            0.5).pair_set() == want
        return
    # ported (item G.1): insert, top-k and freeze over the 8 chunk blocks
    e = pt.MeshChunkedAllPairs(
        pt.AllPairsConfig(**cfg_kw(**kw)), mesh=cpu_mesh(8),
        chunk_dim=32, panel_rows=128)
    e.build(to_pt(corpus))
    assert not e._single_slab_ok(None)
    sims = corpus.to_dense() @ corpus.to_dense()[0]
    near = {str(i) for i in np.nonzero(sims >= 0.5)[0]}
    if what == "topk":
        got = e.topk([("q", corpus.row(0))], 3)["q"]
        assert [c for c, _ in got][0] == "0" and len(got) == 3
        assert np.allclose([s for _, s in got], np.sort(sims)[::-1][:3],
                           atol=1e-12)
        return
    if what == "freeze":
        e.freeze()
    out = e.insert([("q", corpus.row(0))], tau=0.5).output["q"]
    assert set(out) == near and e.last_route == "device_rebuild"
    assert e.n_rows == corpus.n_rows + (what == "insert")
    assert e.all_pairs(0.5).pair_set() == brute_force_pairs(
        e.shadow_csr(), 0.5, e.ids)


# the chunked mesh's rb worked by hand: ``ChunkedAllPairs._pick_panel_rows``
# from 512 rows over d_cap 32,768 with the mesh's own rate (6.2e14) and pair
# budget (a shard's int32 [rb, rb] partial, 4 * rb^2 bytes, within 1 GiB:
# rb <= 16,384), cost = padded^2 / 2 * 32,768 / 6.2e14 + pairs * 1.7e-3 s:
#    20,000: rb  8,192: 24,576 rows, 6 pairs: 0.0160 + 0.0102 = 0.0262 <-
#            rb  4,096: 20,480 rows, 15 pairs: 0.0111 + 0.0255 = 0.0366
#            rb 16,384: 32,768 rows, 3 pairs: 0.0284 + 0.0051 = 0.0335
#   100,000: rb  8,192: 106,496 rows, 91 pairs: 0.2997 + 0.1547 = 0.4544
#            rb 16,384: 114,688 rows, 28 pairs: 0.3476 + 0.0476 = 0.3952 <-
#   500,000: rb  8,192: 507,904 rows, 1,953 pairs: 6.817 + 3.320 = 10.137
#            rb 16,384: 507,904 rows,   496 pairs: 6.817 + 0.843 = 7.660 <-
MESH_PICKS = {20_000: (8192, 3), 100_000: (16384, 7), 500_000: (16384, 31)}
# the single engine's (``tests/test_torch_chunked.py``, ``COST_PICKS``)
SINGLE_PICKS = {20_000: (8192, 3), 100_000: (16384, 7), 500_000: (16384, 31)}


@pytest.mark.parametrize("n", sorted(MESH_PICKS))
def test_panel_rows_from_one_helper(n, monkeypatch):
    """``ChunkedAllPairs`` and ``MeshChunkedAllPairs`` (1, 4 and 8 shards)
    take rb from the one cost helper, ``ChunkedAllPairs._pick_panel_rows``,
    once each, with their own width, first height and per-pair bytes; given
    the same inputs it gives the same rb for either engine."""
    real = pt.ChunkedAllPairs._pick_panel_rows
    calls = []

    def spy(self, n_rows, d_cap, rb0):
        rb = real(self, n_rows, d_cap, rb0)
        calls.append((self, n_rows, d_cap, rb0, rb))
        return rb

    monkeypatch.setattr(pt.ChunkedAllPairs, "_pick_panel_rows", spy)
    single = pt.ChunkedAllPairs(pt.AllPairsConfig(), "cpu")
    meshes = [pt.MeshChunkedAllPairs(pt.AllPairsConfig(), mesh=cpu_mesh(s))
              for s in (1, 4, 8)]
    for e in [single] + meshes:
        e.n_rows, e._n_chunks = n, 16
        e._compact._base = 32768
        geom = e._panel_geom()
        (who, n_rows, d_cap, rb0, rb), = [c for c in calls if c[0] is e]
        assert (n_rows, d_cap, geom[0], geom[-1]) == (n, 32768, rb, 32768)
        assert rb0 == (1024 if e is single else 512)
        assert e._panel_geom() == geom  # cached: no second call
    assert len(calls) == 4
    assert (single._panel_geom()[0], single._panel_geom()[3]) == (
        SINGLE_PICKS[n])
    for m in meshes:
        assert (m._panel_geom()[0], m._panel_geom()[3]) == MESH_PICKS[n]
        assert m._panel_geom()[1:3] == (panel_mesh.MM_TM, panel_mesh.MM_TN)
    # the same inputs (first height, constants, per-pair bytes) give the
    # same rb for either engine
    one = meshes[0]
    for k in ("_panel_int8_rate", "_panel_slab_budget", "_pair_bytes"):
        setattr(one, k, getattr(single, k))
    for rb0 in (512, 1024):
        assert real(one, n, 32768, rb0) == real(single, n, 32768, rb0)


# the mesh's automatic stripe width worked by hand: its 32 GiB budget over
# every fp32 [padded, stripe] accumulator live on the busiest card at once
# (``_stripe_accs``).  On one process no sum is formed (each card sums its
# own row slice of the partials): n shards on one card hold their n
# partials (n); one shard a card, a card holds its partial and its slices
# of the 3 others, 3/4 of a partial (1 + 1 = 2).  Over processes the sum
# still forms: two processes with two shards each on one card, 2 + the
# sum + the running sum crossing in (4).  32 GiB / (4 * padded * accs)
# floored to a power of two in [1,024, 8,192]:
#   100,000 rows (padded 106,496): 1: 80,659; 4 on one card: 20,164; 8 on
#     one: 10,082; 4 cards: 40,329; 2 processes: 20,164: all 8,192
#   499,712 rows (padded 499,712): 1: 17,189 -> 8,192; 4 on one card:
#     4,297 -> 4,096; 8 on one: 2,148 -> 2,048; 4 cards: 8,594 -> 8,192;
#     2 processes: 4,297 -> 4,096
# (the single engine's 16 GiB over its one accumulator: 8,192 at both).
# When the lead card formed the sum, n on one card counted n + 1 and one a
# card 3: 2,048, 1,024 and 4,096 at 499,712 rows.
MESH_STRIPES = {"1": (1, 8192, 8192), "4 on one card": (4, 8192, 4096),
                "8 on one card": (8, 8192, 2048), "4 cards": (2, 8192, 8192),
                "2 processes": (4, 8192, 4096)}


@pytest.mark.parametrize("layout", list(MESH_STRIPES))
def test_mesh_stripe_width_counts_live_partials(layout):
    """The stripe width of the mesh's stripe join counts every fp32
    accumulator the busiest card holds at once (``MESH_STRIPES``), so the
    partials and their sum stay within the mesh's budget."""
    accs, st100k, st500k = MESH_STRIPES[layout]
    n = {"1": 1, "2 processes": 4}.get(layout, int(layout[0]))
    e = pt.MeshChunkedAllPairs(pt.AllPairsConfig(), mesh=cpu_mesh(n))
    if layout == "4 cards":  # the layout alone decides: no card is touched
        e.mesh = Mesh(devices=tuple(torch.device("cuda", i)
                                    for i in range(4)))
    if layout == "2 processes":
        e.mesh = Mesh(devices=(torch.device("cpu"),) * 4,
                      ranks=(0, 0, 1, 1), rank=1)
    single = pt.ChunkedAllPairs(pt.AllPairsConfig(), "cpu")
    assert e._stripe_accs() == accs and single._stripe_accs() == 1
    assert e._stripe_acc_budget == 2 * single._stripe_acc_budget == 1 << 35
    for n_rows, st in ((100_000, st100k), (499_712, st500k)):
        e.n_rows = single.n_rows = n_rows
        assert e._q_super() == st and single._q_super() == 8192
        assert accs * 4 * round_up(n_rows, 8192) * st <= 1 << 35
