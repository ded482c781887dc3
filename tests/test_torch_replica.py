"""The replicated op log on the PyTorch port (``apsim_tpu_torch/serve/
replica.py``), on the CPU: the in-process op-log tests of
``tests/test_multihost.py`` with the port's engines as leader and
follower, each on its own thread.  Where a JAX engine gives the expected
state, the port's replica is held against it on the same seeded corpus:
the pair set, ``n_rows`` and the frozen flag.
"""

import json
import socket as socklib
import threading

import numpy as np
import pytest

import apsim_tpu
from apsim_tpu_torch import AllPairsConfig, Engine
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.etl.store import VectorStore
from apsim_tpu_torch.serve import replica
from apsim_tpu_torch.serve.replica import (_JSON_NNZ_LIMIT, OpLogLeader,
                                           follow)
from apsim_tpu_torch.vector.sparse import Vectors

CFG = dict(vector_dim=200, query_tile=32, row_bucket=32, dim_bucket=64)


def port_engine() -> Engine:
    return Engine(AllPairsConfig(**CFG), "cpu")


def jax_engine():
    return apsim_tpu.Engine(apsim_tpu.AllPairsConfig(**CFG))


def jax_vectors(vecs):
    return [(vid, apsim_tpu.Vectors.sparse(v.size, v.indices.tolist(),
                                           v.values.tolist()))
            for vid, v in vecs]


VECS = [
    ("a", Vectors.sparse(200, [1, 2], [0.6, 0.8])),
    ("b", Vectors.sparse(200, [1, 2], [0.6, 0.8])),
    ("c", Vectors.sparse(200, [7], [1.0])),
]


def run_follower(engine, leader, **kw):
    """``follow`` on a daemon thread; its ``(n_ops, clean)`` lands in the
    returned list."""
    done = []
    t = threading.Thread(
        target=lambda: done.append(
            follow(engine, leader.host, leader.port, **kw)),
        daemon=True)
    t.start()
    return t, done


class Freezer:
    """An engine stand-in that records ``freeze``."""

    def freeze(self):
        self.froze = True


def test_oplog_auth_token_gate():
    """The replication socket honors the shared secret: a wrong token is
    rejected, the right one joins."""
    leader = OpLogLeader(Freezer(), port=0, n_followers=1,
                         auth_token="s3cret")
    accepted = threading.Event()

    def acceptor():
        leader.wait_followers()
        accepted.set()

    threading.Thread(target=acceptor, daemon=True).start()
    bad = socklib.create_connection((leader.host, leader.port))
    bad.sendall(b'{"token": "wrong"}\n')
    assert not accepted.wait(0.5)  # rejected, still waiting
    eng = Freezer()
    ft, done = run_follower(eng, leader, auth_token="s3cret")
    assert accepted.wait(5)
    leader.freeze()
    leader.close()
    ft.join(5)
    bad.close()
    assert done == [(1, True)] and getattr(eng, "froze", False)


def test_oplog_stray_connection_rejected_without_token():
    """With no token configured, a bare TCP connect that sends no JSON
    hello never occupies a follower slot."""
    leader = OpLogLeader(Freezer(), port=0, n_followers=1)
    accepted = threading.Event()

    def acceptor():
        leader.wait_followers()
        accepted.set()

    threading.Thread(target=acceptor, daemon=True).start()
    stray = socklib.create_connection((leader.host, leader.port))
    stray.sendall(b"GET / HTTP/1.0\r\n\r\n")
    assert not accepted.wait(0.5)  # not counted as a follower
    eng = Freezer()
    ft, done = run_follower(eng, leader)
    assert accepted.wait(5)
    leader.freeze()
    leader.close()
    ft.join(5)
    stray.close()
    assert done == [(1, True)] and getattr(eng, "froze", False)


def test_leader_restore_replicates_state(tmp_path):
    """``restore`` ships the checkpoint's corpus AND its stored maxima:
    the follower converges to the same rows and admission state.  The
    checkpoint is the JAX engine's (the port reads its format)."""
    src = jax_engine()
    src.build(jax_vectors(VECS[:2]))
    np.maximum.at(src.max_weights, [5], [0.9])  # an admission-dropped record
    ckpt = str(tmp_path / "ck")
    src.save(ckpt)
    leader_eng, follower_eng = port_engine(), port_engine()
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    t, done = run_follower(follower_eng, leader)
    leader.wait_followers()
    leader.restore(ckpt)
    leader.close()
    t.join(30)
    assert done and done[0][1], "follower did not finish cleanly"
    assert follower_eng.n_rows == leader_eng.n_rows == src.n_rows == 2
    np.testing.assert_array_equal(follower_eng.max_weights,
                                  leader_eng.max_weights)
    np.testing.assert_array_equal(follower_eng.max_weights, src.max_weights)
    assert follower_eng.max_weights[5] == 0.9  # dropped-record maxima too
    assert (follower_eng.all_pairs(0.5).pair_set()
            == src.all_pairs(0.5).pair_set())


def test_leader_fails_fast_on_dead_follower():
    """Losing a follower raises BEFORE the op runs, naming the recovery
    path."""
    leader = OpLogLeader(Freezer(), port=0, n_followers=1)
    client = socklib.create_connection((leader.host, leader.port))
    client.sendall(b'{"token": ""}\n')  # the mandatory follower hello
    leader.wait_followers()
    client.close()
    leader.freeze()  # may land in the dead socket's buffer
    with pytest.raises(RuntimeError, match="checkpoint"):
        for _ in range(64):  # a broken pipe surfaces within a few writes
            leader.freeze()
    leader.close()


def test_follower_promotion_on_leader_loss():
    """Leader crash (EOF, no shutdown op): ``follow`` reports clean=False,
    the replica holds the leader's pre-crash state (equal to a JAX engine
    fed the same ops), and wrapping it in a new leader resumes service: a
    fresh follower converges and new inserts match."""
    leader_eng, replica_eng = port_engine(), port_engine()
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    t, done = run_follower(replica_eng, leader)
    leader.wait_followers()
    leader.build(VECS)
    d = [("d", Vectors.sparse(200, [7], [1.0]))]
    leader.insert(d, tau=0.5)
    pre_crash = leader_eng.all_pairs(0.5).pair_set()
    ref = jax_engine()
    ref.build(jax_vectors(VECS))
    ref.insert(jax_vectors(d), tau=0.5)
    assert pre_crash and pre_crash == ref.all_pairs(0.5).pair_set()
    for f in leader._files:  # crash: the sockets die, no shutdown op
        f.close()
    for c in leader._conns:
        c.close()
    leader._srv.close()
    t.join(30)
    assert done, "follower replay loop did not return"
    n_ops, clean = done[0]
    assert not clean and n_ops == 2  # build + insert
    assert replica_eng.all_pairs(0.5).pair_set() == pre_crash
    assert replica_eng.n_rows == ref.n_rows == 4
    # PROMOTE: the replica leads; a fresh follower joins and catches up
    new_leader = OpLogLeader(replica_eng, port=0, n_followers=1)
    replica2 = port_engine()
    t2, done2 = run_follower(replica2, new_leader)
    new_leader.wait_followers()
    new_leader.restore_from_engine()
    e = [("e", Vectors.sparse(200, [1, 2], [0.6, 0.8]))]
    out = new_leader.insert(e, tau=0.5)
    assert "a" in out.output.get("e", {})
    ref.insert(jax_vectors(e), tau=0.5)
    post = replica_eng.all_pairs(0.5).pair_set()
    assert post > pre_crash and post == ref.all_pairs(0.5).pair_set()
    new_leader.close()
    t2.join(30)
    assert done2 and done2[0][1]
    assert replica2.all_pairs(0.5).pair_set() == post


def test_follow_torn_final_line_is_promotable():
    """The leader dies mid-write of an op line: the torn tail was never
    executed anywhere (ship precedes execute), so ``follow`` reports the
    replica promotable (clean=False) instead of failing on the decode."""
    srv = socklib.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    host, port = srv.getsockname()

    def leader():
        conn, _ = srv.accept()
        # read the follower's hello first: closing with unread inbound
        # data sends a reset, which can destroy the sent op lines
        conn.makefile("r", encoding="utf-8").readline()
        conn.sendall((json.dumps({"op": "freeze"}) + "\n").encode())
        conn.sendall(b'{"op": "insert", "vecto')  # torn: died mid-write
        conn.close()

    threading.Thread(target=leader, daemon=True).start()
    eng = Freezer()
    n_ops, clean = follow(eng, host, port)
    srv.close()
    assert (n_ops, clean) == (1, False) and eng.froze


def test_restore_from_engine_replicates_frozen_flag():
    """A promoted FROZEN leader ships freeze to catch-up followers, as the
    JAX engine's replica would hold it."""
    promoted = port_engine()
    promoted.build(VECS[:1])
    promoted.freeze()
    leader = OpLogLeader(promoted, port=0, n_followers=1)
    fresh = port_engine()
    t, done = run_follower(fresh, leader)
    leader.wait_followers()
    leader.restore_from_engine()
    leader.close()
    t.join(30)
    ref = jax_engine()
    ref.build(jax_vectors(VECS[:1]))
    ref.freeze()
    assert done and done[0][1]
    assert fresh.n_rows == ref.n_rows == 1
    assert fresh.frozen and ref.frozen, "freeze flag was not replicated"


def test_oplog_bulk_build_framed_50k():
    """A bulk corpus replicates as bounded binary frames (build_begin /
    build_chunk / build_end), never as JSON lists, and arrives bit-exact:
    50k rows, > 1M nnz."""
    csr = synthetic_corpus(50_000, nnz_mean=30, seed=3)
    assert int(csr.indptr[-1]) > _JSON_NNZ_LIMIT  # the framed path

    class Cfg:
        vector_dim = csr.n_cols

    class Recorder:
        cfg = Cfg()

        def build(self, got, ids):
            self.got, self.got_ids = got, list(ids)

    leader_eng, follower_eng = Recorder(), Recorder()
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    t, done = run_follower(follower_eng, leader)
    leader.wait_followers()
    ids = [f"d{i}" for i in range(csr.n_rows)]
    leader.build(csr, ids)
    leader.close()
    t.join(120)
    assert done and done[0][1], "follower did not finish cleanly"
    got = follower_eng.got
    np.testing.assert_array_equal(got.indptr, csr.indptr)
    np.testing.assert_array_equal(got.indices, csr.indices)
    np.testing.assert_array_equal(got.data, csr.data)  # bit-exact fp64
    assert follower_eng.got_ids == ids
    assert leader_eng.got is csr and leader_eng.got_ids == ids


def test_oplog_framed_build_engine_parity(monkeypatch):
    """The framed wire form feeds a real engine on both sides; the
    replicas answer ``all_pairs`` alike, and as the JAX engine does."""
    monkeypatch.setattr(replica, "_JSON_NNZ_LIMIT", 0)  # force framing
    leader_eng, follower_eng = port_engine(), port_engine()
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    t, done = run_follower(follower_eng, leader)
    leader.wait_followers()
    leader.build(VECS)
    res = leader.all_pairs(0.5)
    leader.close()
    t.join(60)
    ref = jax_engine()
    ref.build(jax_vectors(VECS))
    assert done and done[0][1]
    assert follower_eng.n_rows == ref.n_rows == 3
    assert (follower_eng.all_pairs(0.5).pair_set() == res.pair_set()
            == ref.all_pairs(0.5).pair_set())


def test_oplog_load_table_ships_reference_not_corpus(tmp_path):
    """Replicated bulk load through a shared ``VectorStore``: the log
    carries the table name and a content hash; leader and follower ingest
    the identical batch sequence from their own store reads."""
    csr = synthetic_corpus(50_000, nnz_mean=8, seed=5)
    store = VectorStore(str(tmp_path / "store"), run_mode="PRODUCT")
    store.write("corpus", csr)

    class Cfg:
        vector_dim = csr.n_cols

    class Recorder:
        cfg = Cfg()

        def __init__(self):
            self.batches = []

        def insert(self, batch, tau=None, bulk=False):
            assert bulk
            self.batches.append([vid for vid, _ in batch])

    leader_eng, follower_eng = Recorder(), Recorder()
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    t, done = run_follower(follower_eng, leader, store=store)
    leader.wait_followers()
    outs = leader.load_table(store, "corpus", 0, csr.n_rows - 1,
                             io_range_num=4, max_io_workers=4)
    leader.close()
    t.join(120)
    assert done and done[0][1]
    assert leader_eng.batches == follower_eng.batches
    assert sum(len(b) for b in leader_eng.batches) == csr.n_rows
    assert len(outs) == len(leader_eng.batches)


def test_oplog_load_table_hash_mismatch_fails_fast(tmp_path):
    """Two store copies that drifted stop the replay loudly instead of
    bulk-loading different corpora into one lockstep mesh."""
    a = VectorStore(str(tmp_path / "a"), run_mode="PRODUCT")
    b = VectorStore(str(tmp_path / "b"), run_mode="PRODUCT")
    a.write("corpus", synthetic_corpus(64, nnz_mean=4, seed=1))
    b.write("corpus", synthetic_corpus(64, nnz_mean=4, seed=2))  # drifted

    class Cfg:
        vector_dim = 1 << 20

    class Recorder:
        cfg = Cfg()

        def insert(self, batch, tau=None, bulk=False):
            pass

    leader = OpLogLeader(Recorder(), port=0, n_followers=1)
    err = []

    def follower():
        try:
            follow(Recorder(), leader.host, leader.port, store=b)
        except RuntimeError as e:
            err.append(str(e))

    t = threading.Thread(target=follower, daemon=True)
    t.start()
    leader.wait_followers()
    leader.load_table(a, "corpus", 0, 63, io_range_num=1, max_io_workers=1)
    leader.close()
    t.join(60)
    assert err and "hash mismatch" in err[0]


def test_server_load_goes_through_the_op_log(tmp_path):
    """``SimilarityServer.load_data`` over a leader: the load is one
    ``load_table`` op (not queued inserts), the follower replica ends with
    the same rows, and the server emits each batch's output."""
    from apsim_tpu_torch.serve import SimilarityServer

    csr = synthetic_corpus(300, nnz_mean=8, active_dims=256, seed=4)
    store = VectorStore(str(tmp_path / "store"), run_mode="PRODUCT")
    store.write("T", csr)
    cfg = AllPairsConfig(vector_dim=csr.n_cols, query_tile=32, row_bucket=32,
                         dim_bucket=64, io_range_num=2, max_io_workers=2)
    leader_eng, follower_eng = Engine(cfg, "cpu"), Engine(cfg, "cpu")
    leader = OpLogLeader(leader_eng, port=0, n_followers=1)
    t, done = run_follower(follower_eng, leader, store=store)
    leader.wait_followers()
    sim = SimilarityServer(leader, cfg, store=store, device="cpu")
    emitted = []
    sim._batcher.emit = emitted.append
    sim.load_data("T", 0, csr.n_rows - 1)
    leader.close()
    t.join(60)
    assert done and done[0] == (1, True)
    assert leader_eng.n_rows == follower_eng.n_rows == csr.n_rows
    assert len(emitted) == 4  # 2 x 2 ranges, one output each
    assert (follower_eng.all_pairs(0.5).pair_set()
            == leader_eng.all_pairs(0.5).pair_set())
