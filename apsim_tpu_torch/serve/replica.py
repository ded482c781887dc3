"""Multi-process serving: a replicated op log in front of the mesh
engines (the PyTorch port's copy of ``apsim_tpu/serve/replica.py``).

The reference routes client inserts through a cluster-aware round-robin
router (SimilaritySearchService.scala:28-32) onto independent actor state.
A mesh over several processes (``parallel/multihost.py``) is NOT
independent state: every device step on it enters collectives that all
processes must enter in the same order with the same operands.  So
multi-process serving is a replicated state machine:

  - the COORDINATOR (rank 0) runs the public ``RpcServer`` and wraps its
    engine in :class:`OpLogLeader` — every state-bearing or collective-
    entering engine call (insert / all_pairs / topk / freeze / …) is first
    shipped as one JSON line to every follower, then executed locally;
  - each FOLLOWER runs :func:`follow`, replaying the log against its own
    engine replica — the replay IS the matching collective entry, so the
    mesh advances in lockstep.  The TCP log gives total order, the
    collectives give the barrier.

Deferred-insert pipelining is disabled under replication: a leader-side
``PendingInsert`` completed at ``result()`` time would move device work
out of the log's order on the leader while followers run it inline.
Inserts complete synchronously instead.

Followers need no dial-back channel: queries are answered by the leader
(results already live there), mirroring the reference's single
``outputActor`` sink (conf/app_server_template.conf:8).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import threading
from typing import List

from ..engine.engine import _CompletedInsert
from .rpc import vectors_to_wire, wire_to_vectors

__all__ = ["OpLogLeader", "follow"]

# Bulk-path framing: a corpus shipped as JSON lists
# boxes every nonzero into a Python object on BOTH ends (~60 B + ~20 B of
# text per entry) — at 50M entries that is gigabytes of allocator churn for
# a 600 MB corpus.  Above this nnz the op log switches to chunked
# base64-raw-ndarray frames: bounded memory (one frame at a time), ~1.33x
# the raw bytes on the wire, zero per-element boxing.
_JSON_NNZ_LIMIT = 1 << 16
_FRAME_BYTES = 8 << 20  # raw bytes per build_chunk frame (~10.7 MB b64 line)
_IDS_PER_FRAME = 1 << 16


def _iter_csr_frames(csr, ids):
    """Yield the framed-op sequence for one corpus: begin header, bounded
    array/id chunks, end marker.  Frames carry (field, offset) so the
    receiver writes straight into preallocated arrays — no quadratic
    concatenation, no full-corpus JSON materialization on either side."""
    import numpy as np

    yield {
        "op": "build_begin",
        "n_rows": int(csr.n_rows),
        "nnz": int(np.asarray(csr.indices).size),
    }
    for field, arr, dt in (
        ("indptr", csr.indptr, np.int64),
        ("indices", csr.indices, np.int32),
        ("data", csr.data, np.float64),
    ):
        a = np.ascontiguousarray(np.asarray(arr, dtype=dt))
        step = max(_FRAME_BYTES // a.itemsize, 1)
        for off in range(0, a.size, step):
            yield {
                "op": "build_chunk",
                "field": field,
                "off": int(off),
                "b64": base64.b64encode(
                    a[off : off + step].tobytes()
                ).decode("ascii"),
            }
    ids = list(ids)
    for off in range(0, len(ids), _IDS_PER_FRAME):
        yield {
            "op": "build_chunk",
            "field": "ids",
            "off": off,
            "ids": ids[off : off + _IDS_PER_FRAME],
        }
    yield {"op": "build_end"}


def _table_content_hash(store, table: str) -> str:
    """sha256 of the table's binary snapshot — leader and follower verify
    they bulk-load the SAME corpus before entering lockstep collectives
    (two store copies that drifted would desync the device programs)."""
    p = os.path.join(store._table_dir(table), "vectors.npz")
    h = hashlib.sha256()
    with open(p, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _bulk_load_from_store(engine, store, table: str,
                          start_row: int, end_row: int,
                          io_range_num: int, max_io_workers: int) -> list:
    """The deterministic bulk-ingest routine BOTH leader and followers run
    for a ``load_table`` op: the reference's two-level range split
    (Client.scala:49-59 then EntryProxyActor.scala:59-79) driving
    ``insert(bulk=True)`` micro-batches in identical order — identical data
    (hash-checked by the caller) + identical order = identical collective
    entry on every process.  Returns the per-batch similarity outputs so
    the leader's server can emit them to subscribers (followers have no
    sinks; their copies are dropped)."""
    from ..etl.store import split_load_range

    outs = []
    for s0, e0 in split_load_range(start_row, end_row, io_range_num):
        for s, e in split_load_range(s0, e0, max_io_workers):
            csr, ids = store.load_range(table, s, e)
            batch = [(ids[i], csr.row(i)) for i in range(csr.n_rows)]
            if batch:
                outs.append(engine.insert(batch, bulk=True))
    return outs


class OpLogLeader:
    """Engine wrapper: ships every replicated op to followers, then runs it.

    Duck-types the engine surface ``SimilarityServer`` uses; everything not
    explicitly wrapped (stats, ids, cfg, save, …) delegates to the inner
    engine — those are host-local reads or leader-only persistence.
    Replication is defined by exactly the methods written on this class:
    adding a new collective-entering engine method means adding a wrapper
    here, or ``__getattr__`` will silently run it leader-only and desync
    the followers.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 n_followers: int = 1, auth_token: str = ""):
        self.engine = engine
        self._lock = threading.Lock()
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._conns: List[socket.socket] = []
        self._files = []
        self._n = n_followers
        # same shared-secret story as the RPC surface (config.auth_token):
        # the op log carries the whole corpus, so an unauthenticated join
        # would leak it AND let a rogue process stall the mesh
        self._token = auth_token

    def wait_followers(self) -> None:
        """Block until every follower has dialed in (seed-node join).
        EVERY connection must present the JSON hello line — token matching
        when one is configured, ``""`` otherwise — so a stray TCP connect
        (port scan, health probe) can never occupy a follower slot and
        later receive the whole op log.  The handshake is bounded (10 s
        read timeout, 64 KB line cap) so a client that connects and goes
        silent cannot wedge the serial accept loop."""
        while len(self._conns) < self._n:
            c, _ = self._srv.accept()
            try:
                c.settimeout(10.0)
                r = c.makefile("r", encoding="utf-8")
                hello = json.loads(r.readline(65536))
                if not isinstance(hello, dict):
                    hello = None
            except (ValueError, OSError):
                hello = None
            if hello is None or hello.get("token", "") != self._token:
                c.close()
                continue
            c.settimeout(None)
            self._conns.append(c)
            self._files.append(c.makefile("w", encoding="utf-8"))

    def _ship(self, op: dict) -> None:
        line = json.dumps(op)
        for f in self._files:
            try:
                f.write(line + "\n")
                f.flush()
            except OSError as e:
                # Failure story (SURVEY §5 A3): losing a follower is fatal
                # for the CURRENT mesh — its collectives cannot proceed
                # minus a process, so executing this op would hang every
                # surviving process.  Fail fast BEFORE entering the
                # collective, with the recovery path spelled out (the server
                # auto-checkpoints; state is rebuildable on a fresh
                # cluster).  The reference's Akka failure detector could
                # only down the node — its in-memory index died with it
                # (SURVEY.md §5: unreplicated state lost on relocation).
                raise RuntimeError(
                    "op-log follower lost mid-stream; a mesh over several "
                    "processes cannot continue without it. Restart the cluster "
                    "and restore from the latest checkpoint "
                    "(checkpoint_dir), then replay ingest."
                ) from e

    # ------------------------------------------------------- replicated ops
    def _ship_csr(self, csr, ids) -> None:
        """Ship one corpus: JSON lists below ``_JSON_NNZ_LIMIT`` (readable,
        back-compatible), chunked binary frames above it (see module
        constants) — never a full-corpus JSON materialization."""
        import numpy as np

        if int(np.asarray(csr.indices).size) <= _JSON_NNZ_LIMIT:
            self._ship({
                "op": "build",
                "indptr": np.asarray(csr.indptr).tolist(),
                "indices": np.asarray(csr.indices).tolist(),
                "data": np.asarray(csr.data).tolist(),
                "ids": list(ids),
            })
        else:
            for frame in _iter_csr_frames(csr, ids):
                self._ship(frame)

    def build(self, vectors, ids=None):
        from ..engine.engine import _as_csr

        csr, out_ids = _as_csr(vectors, ids, self.engine.cfg.vector_dim)
        with self._lock:
            self._ship_csr(csr, out_ids)
            return self.engine.build(csr, out_ids)

    def load_table(self, store, table: str, start_row: int, end_row: int,
                   io_range_num: int, max_io_workers: int) -> list:
        """Replicated bulk load through a SHARED VectorStore: the op log
        carries a table NAME + content hash,
        not the corpus — every process reads its own store copy (shared
        volume / filesystem, the docker deployment's layout) and runs the
        identical deterministic ingest routine.  Followers without a store
        fail fast in replay (misconfiguration, not silent desync)."""
        digest = _table_content_hash(store, table)
        with self._lock:
            self._ship({
                "op": "load_table",
                "table": table,
                "start_row": int(start_row),
                "end_row": int(end_row),
                "io_range_num": int(io_range_num),
                "max_io_workers": int(max_io_workers),
                "sha256": digest,
            })
            return _bulk_load_from_store(
                self.engine, store, table, start_row, end_row,
                io_range_num, max_io_workers,
            )

    def insert(self, vectors, tau=None, bulk=False, defer=False):
        with self._lock:
            self._ship({
                "op": "insert",
                "vectors": vectors_to_wire(vectors),
                "tau": tau,
                "bulk": bulk,
            })
            out = self.engine.insert(vectors, tau=tau, bulk=bulk)
        # synchronous under replication (see module docstring); keep the
        # defer-shaped return so the server's pipelining code runs unchanged
        return _CompletedInsert(out) if defer else out

    def all_pairs(self, tau=None):
        with self._lock:
            self._ship({"op": "all_pairs", "tau": tau})
            return self.engine.all_pairs(tau)

    def topk(self, queries, k: int):
        with self._lock:
            self._ship({
                "op": "topk", "queries": vectors_to_wire(queries), "k": k,
            })
            return self.engine.topk(queries, k)

    def freeze(self) -> None:
        with self._lock:
            self._ship({"op": "freeze"})
            self.engine.freeze()

    def unfreeze(self) -> None:
        with self._lock:
            self._ship({"op": "unfreeze"})
            self.engine.unfreeze()

    @staticmethod
    def _sparse_weights(weights):
        import numpy as np

        w = np.asarray(weights, dtype=np.float64)
        (idx,) = np.nonzero(w)
        return {
            "size": int(w.size),
            "idx": idx.tolist(),
            "val": w[idx].tolist(),
        }

    def set_max_weight_map(self, weights) -> None:
        with self._lock:
            # sparse encoding: the map covers vector_dim (2^20) but only
            # active dims are nonzero — dense JSON would be ~8 MB per call
            self._ship({
                "op": "set_max_weight_map",
                **self._sparse_weights(weights),
            })
            self.engine.set_max_weight_map(weights)

    def restore(self, path: str) -> None:
        """Leader-side checkpoint restore: followers may not share the
        filesystem, so the checkpoint is read HOST-ONLY, shipped as a build
        op, and only then built locally — shipping first matters, because
        the build enters mesh collectives that block until every follower
        replays the same op."""
        import numpy as np

        from ..engine.engine import Engine

        csr, ids, max_weights, _ = Engine.read_checkpoint(path)
        with self._lock:
            # ship-iff-execute: every shipped op must be executed on the
            # leader too, or leader and followers enter different device
            # programs and the global mesh desyncs (an all-admission-dropped
            # checkpoint has 0 rows — nothing to build on either side)
            if csr.n_rows:
                self._ship_csr(csr, ids)
            # replicate the stored maxima too: running-maxima admission is
            # history-dependent, and a leader/follower divergence would make
            # them admit DIFFERENT corpora on a later insert — desyncing the
            # collective shapes (sparse encoding; merged via np.maximum)
            self._ship({
                "op": "merge_max_weights",
                **self._sparse_weights(max_weights),
            })
            if csr.n_rows:
                self.engine.build(csr, ids)
            self.engine.max_weights = np.maximum(
                self.engine.max_weights, max_weights
            )
            Engine._restore_static_map(self.engine, path)
            static = getattr(self.engine, "_static_max_weights", None)
            if static is not None:
                self._ship({
                    "op": "set_max_weight_map",
                    **self._sparse_weights(static),
                })
            if self.engine.frozen:
                # freeze is replicated state too: an unfrozen follower
                # would index the next insert the frozen leader only
                # matches, desyncing the corpora
                self._ship({"op": "freeze"})

    def restore_from_engine(self) -> None:
        """Promotion catch-up: ship THIS engine's live state (host CSR
        shadow + ids + admission maxima) to followers that joined empty —
        the new-leader bring-up after a failover, where the promoted
        replica already holds the state so, unlike :meth:`restore`,
        nothing executes locally.  For independent-replica deployments
        (each process its own mesh — the reference's actual topology);
        under ONE mesh over several processes a dead process kills the
        mesh itself, so there is no surviving replica to promote."""
        shadow = self.engine.shadow_csr()
        with self._lock:
            if shadow.n_rows:
                self._ship_csr(shadow, self.engine.ids)
            self._ship({
                "op": "merge_max_weights",
                **self._sparse_weights(self.engine.max_weights),
            })
            static = getattr(self.engine, "_static_max_weights", None)
            if static is not None:
                self._ship({
                    "op": "set_max_weight_map",
                    **self._sparse_weights(static),
                })
            if self.engine.frozen:
                self._ship({"op": "freeze"})  # see restore()

    def close(self) -> None:
        """End the log: followers' replay loops return.  Best-effort — a
        follower that already died must not make close() raise (it runs in
        finally blocks, where a second exception would mask the first and
        leak the listening socket)."""
        with self._lock:
            try:
                self._ship({"op": "shutdown"})
            except (OSError, RuntimeError):
                pass
        for f in self._files:
            try:
                f.close()
            except OSError:
                pass
        for c in self._conns:
            c.close()
        self._srv.close()

    def __getattr__(self, name):
        return getattr(self.engine, name)


def follow(engine, leader_host: str, leader_port: int,
           auth_token: str = "", connect_timeout: float = 60.0,
           store=None):
    """Follower replay loop: apply the leader's op log to ``engine`` until
    the log ends; returns ``(n_ops, clean)``.  ``clean=True`` means the
    leader shipped an explicit shutdown; ``clean=False`` means the socket
    hit EOF without one — the leader DIED, and since replay already
    converged this replica to the leader's exact state, the caller may
    promote it (serve from ``engine``, or wrap it in a new
    :class:`OpLogLeader`) — the failover analog of the reference's Akka
    failure detector + entity relocation (conf/akka.conf:13,
    CommonUtils.scala:41-46), except state actually survives because every
    follower IS a full replica.  Every replicated op enters the same mesh
    collectives the leader's execution does — this call IS the follower's
    participation in them."""
    import numpy as np

    from ..vector.batch import CSRMatrix

    # retry the dial: nothing orders this connect after the leader's bind
    # (the leader still constructs its engine before listening), so the
    # first attempts may be refused
    import time

    deadline = time.time() + connect_timeout
    while True:
        try:
            sock = socket.create_connection((leader_host, leader_port))
            break
        except OSError:
            if time.time() >= deadline:
                raise
            time.sleep(0.5)
    # hello is mandatory (token "" when unauthenticated): the leader rejects
    # any connection that does not identify itself as a follower
    sock.sendall(
        (json.dumps({"token": auth_token}) + "\n").encode("utf-8")
    )
    n_ops = 0
    clean = False
    pend = None  # in-flight framed build: preallocated arrays + ids
    with sock, sock.makefile("r", encoding="utf-8") as f:
        for line in f:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                # torn final line: the leader died mid-write.  Ship happens
                # BEFORE the leader executes, so a torn op was never applied
                # anywhere — the replica state is still exactly the log
                # prefix, i.e. promotable.  Same semantics as bare EOF.
                break
            op = msg["op"]
            if op == "shutdown":
                clean = True
                break
            n_ops += 1
            if op == "build":
                csr = CSRMatrix(
                    len(msg["indptr"]) - 1, engine.cfg.vector_dim,
                    np.asarray(msg["indptr"], np.int64),
                    np.asarray(msg["indices"], np.int32),
                    np.asarray(msg["data"], np.float64),
                )
                engine.build(csr, msg["ids"])
            elif op == "build_begin":
                # preallocate once from the header; chunks write in place
                pend = {
                    "indptr": np.empty(msg["n_rows"] + 1, np.int64),
                    "indices": np.empty(msg["nnz"], np.int32),
                    "data": np.empty(msg["nnz"], np.float64),
                    "ids": [],
                }
            elif op == "build_chunk":
                field, off = msg["field"], msg["off"]
                if field == "ids":
                    # frames arrive in order; assert instead of extending
                    # blindly so a dropped frame is loud, not a corrupt corpus
                    assert off == len(pend["ids"]), (off, len(pend["ids"]))
                    pend["ids"].extend(msg["ids"])
                else:
                    dst = pend[field]
                    raw = np.frombuffer(
                        base64.b64decode(msg["b64"]), dst.dtype
                    )
                    dst[off : off + raw.size] = raw
            elif op == "build_end":
                csr = CSRMatrix(
                    pend["indptr"].size - 1, engine.cfg.vector_dim,
                    pend["indptr"], pend["indices"], pend["data"],
                )
                ids, pend = pend["ids"], None
                engine.build(csr, ids)
            elif op == "load_table":
                if store is None:
                    raise RuntimeError(
                        "op log carries load_table but this follower has no "
                        "VectorStore — configure the shared store on every "
                        "process (vector_database_root / --store)"
                    )
                digest = _table_content_hash(store, msg["table"])
                if digest != msg["sha256"]:
                    raise RuntimeError(
                        f"store table {msg['table']!r} content hash mismatch "
                        f"(leader {msg['sha256'][:12]}…, follower "
                        f"{digest[:12]}…) — replicas would bulk-load "
                        "DIFFERENT corpora and desync the mesh"
                    )
                _bulk_load_from_store(
                    engine, store, msg["table"],
                    msg["start_row"], msg["end_row"],
                    msg["io_range_num"], msg["max_io_workers"],
                )
            elif op == "insert":
                engine.insert(
                    wire_to_vectors(msg["vectors"]),
                    tau=msg["tau"], bulk=msg["bulk"],
                )
            elif op == "all_pairs":
                engine.all_pairs(msg["tau"])
            elif op == "topk":
                engine.topk(wire_to_vectors(msg["queries"]), msg["k"])
            elif op == "freeze":
                engine.freeze()
            elif op == "unfreeze":
                engine.unfreeze()
            elif op == "set_max_weight_map":
                engine.set_max_weight_map(_dense_weights(msg))
            elif op == "merge_max_weights":
                engine.max_weights = np.maximum(
                    engine.max_weights, _dense_weights(msg)
                )
    return n_ops, clean


def _dense_weights(msg):
    import numpy as np

    w = np.zeros(msg["size"], np.float64)
    w[np.asarray(msg["idx"], np.int64)] = np.asarray(msg["val"], np.float64)
    return w
