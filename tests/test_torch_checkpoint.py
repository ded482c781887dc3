"""Checkpoints across the two packages on the CPU: the port's ``save``
against the JAX package's ``save`` of the same state, and each package's
``load`` of the other's checkpoint, for the dense ``Engine`` and the
out-of-core ``ChunkedAllPairs``, after streamed inserts, dormant-dim
activation and a static max-weight map; the atomic write; and
``bench/restore_probe.py --device cpu``.

Tolerances: none.  Every npz key, dtype and array of the port's checkpoint
equals the JAX package's; pair sets, insert outputs and the placed entry
buffers are equal; similarities agree to 1e-12 (fp64 rescores of the same
entries).
"""

import json
import os

import numpy as np
import pytest

import apsim_tpu
import apsim_tpu_torch as pt
import apsim_tpu_torch.engine.engine as pt_engine_mod
from apsim_tpu.engine import ChunkedAllPairs as JaxChunked
from apsim_tpu.vector.batch import CSRMatrix
from apsim_tpu.vector.sparse import SparseVector as JaxVector
from apsim_tpu_torch.bench import restore_probe

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 500
TAU = 0.5
STATS = ("insert_batches", "vectors_dropped_admission", "vectors_indexed",
         "pairs_emitted", "dormant_dims")
FLAVORS = ("dense", "chunked")


def cfg_kw(flavor, **kw):
    base = (dict(vector_dim=DIM, row_bucket=256, dim_bucket=2048,
                 query_tile=256) if flavor == "dense" else
            dict(vector_dim=DIM, query_tile=64, row_bucket=64,
                 dim_bucket=64))
    base.update(kw)
    return base


def make(flavor, pkg, **kw):
    """An empty engine of ``flavor`` from package ``pkg`` ("pt"/"jax")."""
    if pkg == "pt":
        cfg = pt.AllPairsConfig(**cfg_kw(flavor, **kw))
        return (pt.Engine(cfg, "cpu") if flavor == "dense"
                else pt.ChunkedAllPairs(cfg, "cpu", chunk_dim=64))
    cfg = apsim_tpu.AllPairsConfig(**cfg_kw(flavor, **kw))
    return (apsim_tpu.Engine(cfg) if flavor == "dense"
            else JaxChunked(cfg, chunk_dim=64))


def load(flavor, pkg, path, **kw):
    if pkg == "pt":
        cls = pt.Engine if flavor == "dense" else pt.ChunkedAllPairs
        extra = {} if flavor == "dense" else {"chunk_dim": 64}
        return cls.load(path, pt.AllPairsConfig(**cfg_kw(flavor, **kw)),
                        device="cpu", **extra)
    eng = make(flavor, "jax", **kw)
    eng.restore(path)
    return eng


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(52)
    base = random_sparse_corpus(rng, 200, DIM, n_hot_dims=10)
    rows = [base.row(i) for i in range(base.n_rows)]
    rows += [base.row(i) for i in range(0, 30, 3)]  # exact duplicates
    return CSRMatrix.from_vectors(rows, DIM).normalized()


def head(csr, n):
    return CSRMatrix(n, csr.n_cols, csr.indptr[:n + 1],
                     csr.indices[:csr.indptr[n]], csr.data[:csr.indptr[n]])


def pv(v):
    return pt.SparseVector(v.size, v.indices, v.values)


def stream_batches(corpus):
    """The stream after the build on the first 150 rows: the rest of the
    corpus in batches of 8 and 32, then 6 rows with dims shifted past the
    corpus's (fresh singletons archived), then copies of them (the
    archived entries activate)."""
    n0 = 150
    out = []
    s = n0
    for bs in (8, 8, 32):
        out.append([(f"v{i}", corpus.row(i))
                    for i in range(s, min(s + bs, corpus.n_rows))])
        s += bs
    out.append([(f"v{i}", corpus.row(i)) for i in range(s, corpus.n_rows)])
    shifted = []
    for i in range(6):
        v = corpus.row(3 * i)
        dims = (v.indices + 53) % DIM
        order = np.argsort(dims)
        shifted.append(JaxVector(DIM, dims[order], v.values[order]))
    out.append([(f"n{i}", v) for i, v in enumerate(shifted)])
    out.append([(f"m{i}", v) for i, v in enumerate(shifted)])
    return n0, out


def streamed(flavor, pkg, corpus, **kw):
    """An engine of ``flavor``, built on the head of ``corpus`` with a
    static max-weight map and admission on, then streamed."""
    eng = make(flavor, pkg, admission="real", **kw)
    n0, batches = stream_batches(corpus)
    ids = [f"v{i}" for i in range(n0)]
    if pkg == "pt":
        eng.build(pt.CSRMatrix(n0, DIM, corpus.indptr[:n0 + 1],
                               corpus.indices[:corpus.indptr[n0]],
                               corpus.data[:corpus.indptr[n0]]), ids)
    else:
        eng.build(head(corpus, n0), ids)
    eng.set_max_weight_map(np.maximum(corpus.max_weights(), 0.5))
    for b in batches:
        if pkg == "pt":
            b = [(k, pv(v)) for k, v in b]
        eng.insert(b, tau=TAU)
    return eng


@pytest.fixture(scope="module")
def saved(corpus, tmp_path_factory):
    """{(flavor, pkg): (engine, checkpoint path)} of the same stream."""
    out = {}
    for flavor in FLAVORS:
        for pkg in ("pt", "jax"):
            eng = streamed(flavor, pkg, corpus)
            path = str(tmp_path_factory.mktemp(f"{flavor}_{pkg}"))
            eng.save(path)
            out[flavor, pkg] = (eng, path)
    return out


def npz(path):
    return np.load(os.path.join(path, "index.npz"))


def pairs(res):
    return res.pair_set()


@pytest.mark.parametrize("flavor", FLAVORS)
def test_save_equals_jax_save(saved, flavor):
    """Every npz key, dtype and array of the port's checkpoint equals the
    JAX package's after the same stream; ``meta_json`` and ``meta.json``
    carry the same ids, config and stats, as plain JSON numbers."""
    p_eng, p_path = saved[flavor, "pt"]
    j_eng, j_path = saved[flavor, "jax"]
    zp, zj = npz(p_path), npz(j_path)
    assert set(zp.files) == set(zj.files)
    if flavor == "chunked":
        assert {k for k in zp.files if k.startswith("chunk_")} >= {
            "chunk_rows2d", "chunk_geom", "chunk_ext_df", "chunk_dorm_map_idx"}
        assert zp["chunk_ext_df"].size  # the router's df came along
        assert int(zp["chunk_dorm_has_map"][0]) == 1
    assert zp["static_max_weights"].size == DIM
    assert p_eng.stats["dormant_dims"] > 0
    for k in zj.files:
        if k == "meta_json":
            continue
        assert zp[k].dtype == zj[k].dtype, k
        assert zp[k].shape == zj[k].shape, k
        assert np.array_equal(zp[k], zj[k]), k
    mp, mj = (json.loads(str(z["meta_json"])) for z in (zp, zj))
    assert (mp["ids"], mp["n_rows"], mp["config"]) == (
        mj["ids"], mj["n_rows"], mj["config"])
    assert {k: mp["stats"][k] for k in STATS} == {
        k: mj["stats"][k] for k in STATS}
    assert all(type(v) in (int, float) for v in mp["stats"].values())
    with open(os.path.join(p_path, "meta.json")) as f:
        assert json.load(f) == mp


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("direction", ["pt_to_jax", "jax_to_pt"])
def test_cross_package_restore(saved, corpus, flavor, direction):
    """Each package restores the other's checkpoint: the same ids, maxima
    and static map, the same join, and the same output for a further
    insert (dormant and static-map state included)."""
    src, dst = direction.split("_to_")
    want_eng, path = saved[flavor, src]
    got = load(flavor, dst, path, admission="real")
    ref = load(flavor, src, path, admission="real")
    assert got.n_rows == want_eng.n_rows and got.ids == want_eng.ids
    assert np.array_equal(got.max_weights, want_eng.max_weights)
    assert np.array_equal(got._static_max_weights,
                          want_eng._static_max_weights)
    assert got.stats["dormant_dims"] == want_eng.stats["dormant_dims"]
    gp, rp = pairs(got.all_pairs(TAU)), pairs(ref.all_pairs(TAU))
    assert gp == rp
    assert gp == pairs(want_eng.all_pairs(TAU))
    probe = [("probe", corpus.row(1)), ("probe2", corpus.row(7))]
    og = got.insert(probe if dst == "jax" else
                    [(k, pv(v)) for k, v in probe], tau=TAU)
    orf = ref.insert(probe if src == "jax" else
                     [(k, pv(v)) for k, v in probe], tau=TAU)
    assert og.output.keys() == orf.output.keys()
    for q, c in og.output.items():
        assert c.keys() == orf.output[q].keys()
        for k, s in c.items():
            assert abs(s - orf.output[q][k]) <= 1e-12


@pytest.mark.parametrize("writer", ["pt", "jax"])
def test_chunked_restore_takes_the_fast_path(saved, monkeypatch, writer):
    """A chunked checkpoint from either package takes the reader's fast
    path (entry buffers placed as saved, no build pass) in both packages,
    and the placed layout equals the writer's."""
    eng, path = saved["chunked", writer]
    calls = []
    for cls in (JaxChunked, pt.ChunkedAllPairs):
        real = cls._fast_restore

        def spy(self, *a, _real=real, **k):
            calls.append(type(self).__module__.split(".")[0])
            return _real(self, *a, **k)

        monkeypatch.setattr(cls, "_fast_restore", spy)
        monkeypatch.setattr(cls, "build", lambda *a, **k: pytest.fail(
            "restore fell back to a build"))
    for reader in ("pt", "jax"):
        got = load("chunked", reader, path)
        assert (got._n_chunks, got._chunk_cap) == (eng._n_chunks,
                                                   eng._chunk_cap)
        assert np.array_equal(got._counts, eng._counts)
        for a, b in zip(got._ent_host, eng._ent_host):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(got._ext_df, eng._ext_df)
        assert np.array_equal(got._dormant_of_ext, eng._dormant_of_ext)
        assert got._max_norm == eng._max_norm
    assert calls == ["apsim_tpu_torch", "apsim_tpu"]


def test_host_mirror_in_step_after_stream(corpus):
    """After streamed inserts (dormant activation and a doubling of the
    per-chunk capacity included) the host mirror that ``save`` writes
    equals the device entry buffers, and the counts cover the live
    entries."""
    eng = streamed("chunked", "pt", corpus)
    cap0 = eng._chunk_cap
    for k in range(3):
        for s in range(0, corpus.n_rows, 64):
            eng.insert([(f"r{k}_{i}", pv(corpus.row(i)))
                        for i in range(s, min(s + 64, corpus.n_rows))],
                       tau=TAU)
    assert eng._chunk_cap > cap0
    for host, dev in zip(eng._ent_host, eng._ent):
        assert host.dtype == dev.numpy().dtype
        assert np.array_equal(host, dev.numpy())
    rows = eng._ent_host[0]
    live = rows[np.arange(rows.shape[1]) < eng._counts[:, None]]
    assert live.size == int(eng._counts.sum())
    assert int(live.max()) < eng.n_rows


@pytest.mark.parametrize("src,dst", [("dense", "chunked"),
                                     ("chunked", "dense")])
def test_cross_flavor_restore(saved, corpus, src, dst):
    """A dense checkpoint rebuilds into a chunked engine and the reverse,
    with the writer's join."""
    eng, path = saved[src, "pt"]
    got = load(dst, "pt", path)
    assert got.ids == eng.ids
    assert pairs(got.all_pairs(TAU)) == pairs(eng.all_pairs(TAU))


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("crash_at", ["npz", "meta"])
def test_crash_during_save_leaves_a_loadable_snapshot(corpus, tmp_path,
                                                      monkeypatch, flavor,
                                                      crash_at):
    """A save that fails before the npz swap leaves the old snapshot; one
    that fails between the npz swap and the ``meta.json`` swap leaves the
    new one (the npz is self-contained).  Either loads, in both
    packages."""
    path = str(tmp_path / "ck")
    eng = make(flavor, "pt")
    eng.build(pt.CSRMatrix(120, DIM, corpus.indptr[:121],
                           corpus.indices[:corpus.indptr[120]],
                           corpus.data[:corpus.indptr[120]]),
              [f"v{i}" for i in range(120)])
    eng.save(path)
    eng.insert([(f"v{i}", pv(corpus.row(i))) for i in range(120, 160)],
               tau=TAU)
    real = os.replace

    def failing(a, b):
        if os.path.basename(b) == ("index.npz" if crash_at == "npz"
                                   else "meta.json"):
            raise OSError("disk went away")
        return real(a, b)

    monkeypatch.setattr(pt_engine_mod.os, "replace", failing)
    with pytest.raises(OSError, match="disk went away"):
        eng.save(path)
    monkeypatch.setattr(pt_engine_mod.os, "replace", real)
    n_want = 120 if crash_at == "npz" else 160
    for pkg in ("pt", "jax"):
        got = load(flavor, pkg, path)
        assert got.n_rows == n_want and got.ids == eng.ids[:n_want]
        sub = head(corpus, n_want)
        assert pairs(got.all_pairs(TAU)) == brute_force_pairs(
            sub, TAU, ids=[f"v{i}" for i in range(n_want)])


def test_stats_survive_json(saved):
    for flavor in FLAVORS:
        eng, _ = saved[flavor, "pt"]
        eng.all_pairs(TAU)
        json.dumps(pt_engine_mod.plain_stats(eng.stats))
        json.dumps(eng.stats)


def test_restore_probe_on_cpu(capsys):
    """``bench/restore_probe.py --device cpu`` at 3,000 rows: the fast path
    ran and the spot query answers as the built engine did."""
    rep = restore_probe.main(["3000", "--device", "cpu"])
    assert rep["n_rows"] == 3000 and rep["fast_path"] and rep["spot_parity"]
    assert set(rep["stages_s"]) == {"gen", "build", "save", "restore",
                                    "spot_topk"}
    assert rep["npz_bytes"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
