"""The port's serving stack on the CPU (``apsim_tpu_torch.serve``: the
async ingest queue and flusher, the LoadData path, the TCP RPC, output
subscription, checkpoints, auth and TLS, ``profile_dir`` tracing): the 21
cases of ``tests/test_serve.py`` with ``device="cpu"``, then the same
stream through a JAX-package server and a port server side by side.

Tolerances: none on pair sets (every pushed or joined pair set equals the
fp64 brute-force oracle and the JAX server's); similarities agree to 1e-12.
"""

import io
import json
import os
import socket as socklib
import subprocess
import threading
import time

import numpy as np
import pytest

import apsim_tpu
import apsim_tpu.serve as jserve
import apsim_tpu_torch as pt
from apsim_tpu.etl.store import VectorStore as JaxStore
from apsim_tpu_torch.engine import ChunkedAllPairs
from apsim_tpu_torch.etl.store import VectorStore
from apsim_tpu_torch.parallel import MeshChunkedAllPairs, MeshEngine
from apsim_tpu_torch.serve import (ClientConnection, InteractiveClient,
                                   RpcServer, SimilarityServer)
from apsim_tpu_torch.utils.logging import Timer, get_logger
from apsim_tpu_torch.vector.batch import CSRMatrix
from apsim_tpu_torch.vector.sparse import SparseVector

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 300


def to_pt(csr):
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                     csr.data)


@pytest.fixture
def corpus():
    rng = np.random.default_rng(21)
    return to_pt(random_sparse_corpus(rng, 100, DIM))


def make_cfg(**kw):
    base = dict(
        vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
        similarity_threshold=0.5, io_trigger_period_ms=5,
    )
    base.update(kw)
    return pt.AllPairsConfig(**base)


def cpu_engine(cfg):
    return pt.Engine(cfg, "cpu")


def server(cfg, engine=None, **kw):
    """A port server on the CPU (the engine it builds or restores too)."""
    return SimilarityServer(engine, cfg, device="cpu", **kw)


def cpu_mesh(n):
    return pt.make_mesh(n, devices=["cpu"] * n)


def wait_until(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def emitted_pairs(outputs):
    out = set()
    for o in outputs:
        for q, sims in (o.output if hasattr(o, "output") else o).items():
            for c in sims:
                out.add((q, c) if q <= c else (c, q))
    return out


def CSRSlice(csr, n):
    return CSRMatrix(
        n, csr.n_cols, csr.indptr[: n + 1],
        csr.indices[: int(csr.indptr[n])], csr.data[: int(csr.indptr[n])],
    )


# ------------------------------------------ the cases of tests/test_serve.py
def test_server_async_ingest(corpus):
    cfg = make_cfg()
    with server(cfg, cpu_engine(cfg)) as srv:
        outputs = []
        srv.add_output_sink(lambda o: outputs.append(o))
        for i in range(corpus.n_rows):
            srv.insert_new_vectors([(str(i), corpus.row(i))])
        assert wait_until(lambda: srv.stats()["n_rows"] == corpus.n_rows)
    assert emitted_pairs(outputs) == brute_force_pairs(corpus, 0.5)


def test_server_bulk_load_skips_admission(tmp_path, corpus):
    store = VectorStore(str(tmp_path))
    weak = corpus.normalized()
    weak.data[:] *= 0.01  # sums far below tau -> "ones" admission would drop
    store.write("T", weak)
    cfg = make_cfg(admission="ones")
    with server(cfg, cpu_engine(cfg), store=store) as srv:
        srv.load_data("T", 0, weak.n_rows - 1)
        assert wait_until(lambda: srv.stats()["n_rows"] == weak.n_rows)
        assert srv.stats()["vectors_dropped_admission"] == 0


def test_disconnected_subscriber_is_unregistered(corpus):
    cfg = make_cfg()
    sim = server(cfg, cpu_engine(cfg))
    with RpcServer(sim, port=0) as rpc:
        addr = f"{rpc.host}:{rpc.port}"
        sub = ClientConnection([addr])
        sub.subscribe_outputs(lambda o, t: None)
        assert wait_until(lambda: len(sim._sinks) == 1)
        sub.close()
        cc = ClientConnection([addr])
        for k in range(5):
            cc.insert_new_vector(
                [(f"a{k}", corpus.row(0)), (f"b{k}", corpus.row(0))]
            )
            cc.flush()
            if wait_until(lambda: len(sim._sinks) == 0, timeout=2):
                break
        assert len(sim._sinks) == 0
        cc.close()


def test_rpc_roundtrip(tmp_path, corpus):
    store = VectorStore(str(tmp_path))
    ids = [f"v{i}" for i in range(corpus.n_rows)]
    store.write("SMALL_DATA", corpus, ids=ids)
    cfg = make_cfg()
    sim = server(cfg, cpu_engine(cfg), store=store)
    with RpcServer(sim, port=0) as rpc:
        addr = f"{rpc.host}:{rpc.port}"
        outputs = []
        sub = ClientConnection([addr])
        sub.subscribe_outputs(lambda o, t: outputs.append(o))
        cc = ClientConnection([addr])
        assert cc.test("x")["test"] == "x"
        cc.load_data("SMALL_DATA", 0, 49)
        cc.flush()
        assert wait_until(lambda: cc.stats()["n_rows"] == 50)
        for i in range(50, corpus.n_rows):
            cc.insert_new_vector([(f"v{i}", corpus.row(i))])
        cc.flush()
        assert wait_until(lambda: cc.stats()["n_rows"] == corpus.n_rows)
        pairs = cc.all_pairs(0.5)
        got = {tuple(sorted((a, b))) for a, b, _ in pairs}
        assert got == brute_force_pairs(corpus, 0.5, ids=ids)
        assert wait_until(lambda: len(outputs) > 0)
        tk = cc.topk([("q", corpus.row(3))], 2)
        assert tk["q"][0][0] == "v3"
        cc.freeze()
        assert cc.stats()["frozen"]
        cc._send({"op": "nope"})
        rsp = json.loads(cc._rfile.readline())
        assert not rsp["ok"]
        assert cc.test("still-alive")["test"] == "still-alive"
        cc.close()
        sub.close()


def test_server_checkpoint_restore(tmp_path, corpus):
    ckpt = str(tmp_path / "ckpt")
    cfg = make_cfg(checkpoint_dir=ckpt, checkpoint_interval_s=0.0)
    with server(cfg) as srv:
        srv.insert_new_vectors([(str(i), corpus.row(i)) for i in range(40)])
        assert wait_until(lambda: srv.stats()["n_rows"] == 40)
    with server(cfg) as srv2:
        assert srv2.engine.device.type == "cpu"
        assert srv2.stats()["n_rows"] == 40
        res = srv2.all_pairs(0.5)
        want = brute_force_pairs(
            CSRSlice(corpus, 40), 0.5, [str(i) for i in range(40)]
        )
        assert res.pair_set() == want


def test_mesh_server_checkpoint_restore(tmp_path, corpus):
    ckpt = str(tmp_path / "ckpt")
    cfg = make_cfg(checkpoint_dir=ckpt)
    with server(cfg) as srv:
        srv.insert_new_vectors([(str(i), corpus.row(i)) for i in range(30)])
        assert wait_until(lambda: srv.stats()["n_rows"] == 30)
    mesh_engine = MeshEngine(cfg, mesh=cpu_mesh(8))
    with server(cfg, mesh_engine) as srv2:
        assert srv2.stats()["n_rows"] == 30
        assert srv2.engine.n_shards == 8
        assert srv2.all_pairs(0.5).pair_set() == brute_force_pairs(
            CSRSlice(corpus, 30), 0.5, [str(i) for i in range(30)])


def test_chunked_server_async_ingest(corpus):
    cfg = make_cfg()
    with server(cfg, ChunkedAllPairs(cfg, "cpu", chunk_dim=64)) as srv:
        outputs = []
        srv.add_output_sink(lambda o: outputs.append(o))
        for s in range(0, corpus.n_rows, 10):
            srv.insert_new_vectors(
                [(str(i), corpus.row(i))
                 for i in range(s, min(s + 10, corpus.n_rows))]
            )
        assert wait_until(lambda: srv.stats()["n_rows"] == corpus.n_rows)
        st = srv.stats()
        assert st["vectors_indexed"] == corpus.n_rows
        assert "insert" in st["timings"]
    assert emitted_pairs(outputs) == brute_force_pairs(corpus, 0.5)


def test_chunked_server_checkpoint_cross_flavor(tmp_path, corpus):
    """A chunked server's checkpoint restores into the port's dense
    engine, its chunked mesh (a rebuild: other chunk geometry) and the JAX
    package's dense engine, each with the same join."""
    ckpt = str(tmp_path / "ckpt")
    cfg = make_cfg(checkpoint_dir=ckpt, checkpoint_interval_s=0.0)
    with server(cfg, ChunkedAllPairs(cfg, "cpu", chunk_dim=64)) as srv:
        srv.insert_new_vectors([(str(i), corpus.row(i)) for i in range(40)])
        assert wait_until(lambda: srv.stats()["n_rows"] == 40)
    want = brute_force_pairs(
        CSRSlice(corpus, 40), 0.5, [str(i) for i in range(40)]
    )
    dense = pt.Engine.load(ckpt, config=cfg, device="cpu")
    assert dense.all_pairs(0.5).pair_set() == want
    mce = MeshChunkedAllPairs(cfg, mesh=cpu_mesh(8), chunk_dim=32)
    with server(cfg, mce) as srv2:
        assert srv2.stats()["n_rows"] == 40
        assert srv2.all_pairs(0.5).pair_set() == want
    jcfg = apsim_tpu.AllPairsConfig(**{
        k: getattr(cfg, k) for k in ("vector_dim", "query_tile",
                                     "row_bucket", "dim_bucket")})
    assert apsim_tpu.Engine.load(ckpt, jcfg).all_pairs(0.5).pair_set() == want


def test_profiling_utils(tmp_path):
    log = get_logger("apsim.test")
    log.info("structured %s", "record")
    t = Timer()
    with t.section("a"):
        pass
    with t.section("a"):
        pass
    assert t.counts["a"] == 2 and t.totals["a"] >= 0


def test_concurrent_clients(corpus):
    cfg = make_cfg(output_io_duration_ms=20)  # exercise coalesced emission
    sim = server(cfg, cpu_engine(cfg))
    with RpcServer(sim, port=0) as rpc:
        addr = f"{rpc.host}:{rpc.port}"
        outputs = []
        sub = ClientConnection([addr])
        sub.subscribe_outputs(lambda o, t: outputs.append(o))

        def worker(lo, hi):
            cc = ClientConnection([addr])
            for i in range(lo, hi):
                cc.insert_new_vector([(str(i), corpus.row(i))])
            cc.flush()
            cc.close()

        n = corpus.n_rows
        bounds = [(k * n // 4, (k + 1) * n // 4) for k in range(4)]
        threads = [threading.Thread(target=worker, args=b) for b in bounds]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert wait_until(lambda: sim.stats()["n_rows"] == n, timeout=20)
        res = sim.all_pairs(0.5)
        assert res.pair_set() == brute_force_pairs(
            corpus, 0.5, ids=[str(i) for i in range(n)]
        )
        assert sorted(sim.engine.ids, key=int) == [str(i) for i in range(n)]
        sub.close()


def test_interactive_client(tmp_path, corpus):
    store = VectorStore(str(tmp_path))
    store.write("T", corpus)
    cfg = make_cfg()
    sim = server(cfg, cpu_engine(cfg), store=store)
    with RpcServer(sim, port=0) as rpc:
        cc = ClientConnection([f"{rpc.host}:{rpc.port}"])
        out = io.StringIO()
        term = InteractiveClient(cc, out=out)
        term.run(input_lines=["start", "T", "0", "9", "test", "ping", "quit"])
        assert "test reply" in out.getvalue()
        cc.flush()
        assert wait_until(lambda: cc.stats()["n_rows"] == 10)
        cc.close()


def test_flusher_survives_poisoned_batch(corpus):
    cfg = make_cfg()
    with server(cfg, cpu_engine(cfg)) as srv:
        outputs = []
        srv.add_output_sink(lambda o: outputs.append(o))
        srv.insert_new_vectors([("a", corpus.row(0))])
        assert wait_until(lambda: srv.stats()["n_rows"] == 1)
        bad = SparseVector(DIM * 4, np.array([DIM * 2], np.int32), [1.0])
        srv._queue.put((False, [("bad", bad)]))
        assert wait_until(lambda: srv.stats()["errors"] >= 1)
        srv.insert_new_vectors([("b", corpus.row(1))])
        assert wait_until(lambda: srv.stats()["n_rows"] == 2)
        assert srv._flusher.is_alive()


def test_insert_validates_dimensionality(corpus):
    cfg = make_cfg()
    with server(cfg, cpu_engine(cfg)) as srv:
        bad = SparseVector(DIM * 4, np.array([DIM * 2], np.int32), [1.0])
        with pytest.raises(ValueError, match="vector_dim"):
            srv.insert_new_vectors([("bad", bad)])
        assert srv.stats()["n_rows"] == 0


def test_rpc_bad_insert_never_desyncs(corpus):
    cfg = make_cfg()
    with RpcServer(server(cfg, cpu_engine(cfg))) as rpc:
        conn = ClientConnection([f"127.0.0.1:{rpc.port}"], timeout=10.0)
        conn._send(
            {"op": "insert", "vectors": [["bad", DIM * 4, [DIM * 2], [1.0]]]}
        )
        conn._send({"op": "insert", "vectors": [["oops"]]})
        rsp = conn.test("ping")
        assert rsp == {"ok": True, "test": "ping"}
        conn.insert_new_vector([("ok", corpus.row(0))])
        conn.flush()
        stats = conn.stats()
        assert stats["n_rows"] == 1
        assert stats["errors"] >= 2
        conn.close()


def test_stats_expose_stage_timings(corpus):
    cfg = make_cfg()
    with server(cfg, cpu_engine(cfg)) as srv:
        srv.insert_new_vectors([("a", corpus.row(0))])
        srv.all_pairs(0.5)
        st = srv.stats()
        t = st["timings"]
        assert t["all_pairs"]["count"] >= 1
        assert t["insert"]["count"] >= 1
        assert t["score_extract"]["seconds"] >= 0
        assert t["rescore"]["count"] >= 1
        json.dumps(st)  # every value is a plain JSON value


@pytest.mark.parametrize("flavor", ["dense", "chunked"])
def test_profile_dir_captures_trace(tmp_path, corpus, flavor):
    """torch.profiler hook: every all_pairs and insert writes a Chrome
    trace into profile_dir."""
    trace = tmp_path / "trace"
    cfg = make_cfg(profile_dir=str(trace))
    eng = (cpu_engine(cfg) if flavor == "dense"
           else ChunkedAllPairs(cfg, "cpu", chunk_dim=64))
    eng.build(corpus)
    eng.all_pairs(0.5)
    eng.insert([("q", corpus.row(0))], tau=0.5)
    found = sorted(os.listdir(trace))
    assert len(found) == 2, found
    for name in found:
        with open(trace / name) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("ph") == "X" for e in events)


def test_auth_token_gate(corpus):
    cfg = make_cfg(auth_token="sekrit")
    with RpcServer(server(cfg, cpu_engine(cfg))) as rpc:
        addr = [f"127.0.0.1:{rpc.port}"]
        with pytest.raises(PermissionError):
            ClientConnection(addr, timeout=10.0, auth_token="wrong")
        c = ClientConnection(addr, timeout=10.0)
        rsp = c._request({"op": "stats"})
        assert rsp == {"ok": False, "error": "unauthorized"}
        c.close()
        c = ClientConnection(addr, timeout=10.0, auth_token="sekrit")
        c.insert_new_vector([("a", corpus.row(0))])
        c.flush()
        assert c.stats()["n_rows"] == 1
        c.close()


def test_tls_roundtrip(tmp_path, corpus):
    cert = str(tmp_path / "cert.pem")
    key = str(tmp_path / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1", "-subj", "/CN=localhost"],
        check=True, capture_output=True,
    )
    cfg = make_cfg(tls_cert=cert, tls_key=key, auth_token="t0k3n")
    with RpcServer(server(cfg, cpu_engine(cfg))) as rpc:
        addr = [f"127.0.0.1:{rpc.port}"]
        raw = socklib.create_connection(("127.0.0.1", rpc.port), timeout=5)
        raw.sendall(b'{"op": "stats"}\n')
        raw.settimeout(5)
        try:
            data = raw.recv(100)
        except OSError:
            data = b""
        raw.close()
        assert b'"ok": true' not in data.lower()
        c = ClientConnection(
            addr, timeout=30.0, ca_file=cert, auth_token="t0k3n"
        )
        events = []
        c.subscribe_outputs(lambda out, moment: events.append(out))
        c.insert_new_vector([("a", corpus.row(0)), ("b", corpus.row(0))])
        c.flush()
        assert c.stats()["n_rows"] == 2
        assert wait_until(lambda: any("a" in e for e in events))
        c.close()


def test_bulk_load_auto_installs_static_max_weights(tmp_path, corpus):
    store = VectorStore(str(tmp_path))
    base = corpus.normalized()
    store.write("T", base)
    cfg = make_cfg(admission="real")
    rng = np.random.default_rng(33)
    extra = to_pt(random_sparse_corpus(rng, 40, DIM))
    with server(cfg, cpu_engine(cfg), store=store) as srv:
        outputs = []
        srv.add_output_sink(lambda o: outputs.append(o))
        srv.load_data("T", 0, base.n_rows - 1)
        assert wait_until(lambda: srv.stats()["n_rows"] == base.n_rows)
        installed = srv.engine._static_max_weights
        assert installed is not None
        np.testing.assert_allclose(installed, store.max_weights("T"))
        for i in range(extra.n_rows):
            srv.insert_new_vectors([(f"s{i}", extra.row(i))])
        assert wait_until(
            lambda: srv.stats()["n_rows"]
            == base.n_rows + extra.n_rows
            - srv.stats()["vectors_dropped_admission"]
        )
        srv.flush()
    union = CSRMatrix.from_vectors(
        [base.row(i) for i in range(base.n_rows)]
        + [extra.row(i) for i in range(extra.n_rows)],
        DIM,
    )
    ids = [str(i) for i in range(base.n_rows)] + [
        f"s{i}" for i in range(extra.n_rows)
    ]
    want = set()
    for a, b in brute_force_pairs(union, 0.5):
        qa, qb = ids[int(a)], ids[int(b)]
        want.add((qa, qb) if qa <= qb else (qb, qa))
    assert want == emitted_pairs(outputs)


def spy_sizes(srv):
    sizes = []
    real_insert = srv.engine.insert

    def spy(batch, **kw):
        sizes.append(len(batch))
        return real_insert(batch, **kw)

    srv.engine.insert = spy
    return sizes


def test_flush_batch_cap_bounds_coalescing(corpus):
    cfg = make_cfg(max_flush_batch=8)
    with server(cfg, cpu_engine(cfg)) as srv:
        sizes = spy_sizes(srv)
        srv.insert_new_vectors([(f"c{i}", corpus.row(i)) for i in range(20)])
        srv.flush()
        assert sizes and max(sizes) <= 8, sizes
        assert sum(sizes) == 20
        assert srv.engine.n_rows == 20
    cfg = make_cfg(max_flush_batch=0)  # reference semantics: one batch
    with server(cfg, cpu_engine(cfg)) as srv:
        sizes = spy_sizes(srv)
        srv.insert_new_vectors([(f"d{i}", corpus.row(i)) for i in range(20)])
        srv.flush()
        assert sizes == [20], sizes


def test_drain_defers_subcap_tail_under_backlog(corpus):
    cfg = make_cfg(max_flush_batch=8, io_trigger_period_ms=10_000)
    with server(cfg, cpu_engine(cfg)) as srv:
        sizes = spy_sizes(srv)
        srv.insert_new_vectors([(f"t{i}", corpus.row(i)) for i in range(21)])
        srv._drain()  # one periodic tick: 2 full chunks, tail deferred
        assert sizes == [8, 8], sizes
        assert srv._queue.qsize() == 1
        srv._drain()
        assert sizes == [8, 8, 5], sizes
        srv.insert_new_vectors([(f"u{i}", corpus.row(i)) for i in range(9)])
        srv.flush()
        assert sizes == [8, 8, 5, 8, 1], sizes
        assert srv.engine.n_rows == 30


# ------------------------------------------- the port against the JAX server
def drive(mod, store_cls, tmp, corpus, ids, engine):
    """Bulk-load half of ``corpus`` from a store table, stream the rest
    over TCP in batches of 1, 4 and 16 from two clients, flush; returns
    (pushed outputs, stats, all_pairs over RPC, topk over RPC)."""
    store = store_cls(tmp)
    store.write("T", corpus, ids)
    cfg = engine.cfg
    sim = mod.SimilarityServer(engine, cfg, store=store)
    with mod.RpcServer(sim, port=0) as rpc:
        addr = [f"{rpc.host}:{rpc.port}"]
        outputs = []
        sub = mod.ClientConnection(addr)
        sub.subscribe_outputs(lambda o, t: outputs.append(o))
        cc = mod.ClientConnection(addr)
        cc.load_data("T", 0, 49)
        cc.flush()
        half = list(range(50, corpus.n_rows))

        def worker(rows):
            c = mod.ClientConnection(addr)
            s = 0
            for bs in (1, 4, 16) * 10:
                part = rows[s:s + bs]
                if not part:
                    break
                c.insert_new_vector([(ids[i], corpus.row(i)) for i in part])
                s += bs
            c.flush()
            c.close()

        threads = [threading.Thread(target=worker, args=(half[k::2],))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        cc.flush()
        assert wait_until(lambda: cc.stats()["n_rows"] == corpus.n_rows)
        stats = cc.stats()
        pairs = cc.all_pairs(0.5)
        topk = cc.topk([(f"q{i}", corpus.row(i)) for i in range(0, 100, 7)],
                       5)
        assert wait_until(lambda: len(emitted_pairs(outputs)) >= 1)
        cc.close()
        sub.close()
    return outputs, stats, pairs, topk


def test_port_server_equals_jax_server(tmp_path, corpus):
    """The same stream through a JAX-package server and a port server
    gives the same pushed pair set, n_rows, stats, all_pairs and top-k."""
    ids = [f"v{i}" for i in range(corpus.n_rows)]
    kw = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
              similarity_threshold=0.5, io_trigger_period_ms=5)
    jcsr = apsim_tpu.vector.batch.CSRMatrix(
        corpus.n_rows, corpus.n_cols, corpus.indptr, corpus.indices,
        corpus.data)
    jo, js, jp, jt = drive(jserve, JaxStore, str(tmp_path / "j"), jcsr, ids,
                           apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**kw)))
    po, ps, pp, ptk = drive(
        __import__("apsim_tpu_torch.serve", fromlist=["x"]), VectorStore,
        str(tmp_path / "p"), corpus, ids,
        pt.Engine(pt.AllPairsConfig(**kw), "cpu"))
    want = brute_force_pairs(corpus, 0.5, ids=ids)
    assert emitted_pairs(po) == emitted_pairs(jo) == want
    # every stats key of the JAX server (a JSON round trip each), and the
    # port's device-candidate count and kernel launch counts beside them;
    # pairs_emitted and the batch counts depend on how the flusher cut the
    # concurrent stream into micro-batches (intra-batch pairs come out both
    # ways)
    assert set(ps) - set(js) == {"candidate_pairs", "launches"}
    assert set(js) <= set(ps)
    assert ps["timings"]["insert"]["count"] >= 1
    assert js["timings"]["insert"]["count"] >= 1
    for k in ("n_rows", "vectors_indexed", "vectors_dropped_admission",
              "errors", "frozen"):
        assert ps[k] == js[k], k
    assert {tuple(sorted(p[:2])) for p in pp} == {
        tuple(sorted(p[:2])) for p in jp} == want
    assert ptk.keys() == jt.keys()
    for q in ptk:
        assert [c for c, _ in ptk[q]] == [c for c, _ in jt[q]]
        np.testing.assert_allclose([s for _, s in ptk[q]],
                                   [s for _, s in jt[q]], atol=1e-12, rtol=0)


def test_server_refuses_the_cpu_without_asking(tmp_path, corpus,
                                               monkeypatch):
    """``SimilarityServer()`` builds or restores its engine on the card:
    without CUDA it raises instead of running on the CPU, and so does
    ``Engine.load`` / ``ChunkedAllPairs.load`` of a checkpoint without
    ``device``."""
    cfg = make_cfg()
    eng = cpu_engine(cfg)
    eng.build(corpus)
    eng.save(str(tmp_path))
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        SimilarityServer(None, make_cfg())
    with pytest.raises(RuntimeError, match="no CUDA"):
        SimilarityServer()
    with pytest.raises(RuntimeError, match="no CUDA"):
        SimilarityServer(None, make_cfg(checkpoint_dir=str(tmp_path)))
    for cls in (pt.Engine, ChunkedAllPairs):
        with pytest.raises(RuntimeError, match="no CUDA"):
            cls.load(str(tmp_path), cfg)
