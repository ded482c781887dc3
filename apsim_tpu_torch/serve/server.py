"""In-process similarity service: asynchronous ingest + online matching.

This is the rebuild's collapse of the reference's server runtime
(SimilaritySearchService → EntryProxyActor → WriteWorkerActor →
IndexingWorkerActor): the actor mailboxes and the periodic ``IOTrigger``
flush (WriteWorkerActor.scala:52-57,164-183) become one host-side queue
drained by a flusher thread every ``io_trigger_period_ms``, feeding
micro-batches into the (optionally mesh-sharded) engine; results flow through
an :class:`OutputBatcher` (immediate or time-coalesced,
IndexingWorkerActor.scala:122-141) to registered sinks — the ``outputActor``
equivalent (conf/app_server_template.conf:8).

Delivery semantics parity: inserts are fire-and-forget and unordered across
callers (the reference's at-most-once ``!`` sends); within one caller,
batches preserve enqueue order.

The PyTorch port of ``apsim_tpu/serve/server.py``.  The engine it builds or
restores lives on ``device`` (the card unless the caller names the CPU).
Engine calls come from the flusher thread and the RPC handler threads, all
under one lock and each inside the engine's CUDA device scope, so a thread
that never set a device still launches on the engine's card.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Callable, List, Sequence, Tuple

import torch

from ..config import AllPairsConfig
from ..engine.engine import Engine, plain_stats
from ..engine.output import OutputBatcher, SimilarityOutput
from ..etl.store import VectorStore, split_load_range
from ..ops.tri_score import LAUNCHES
from ..utils.logging import get_logger
from ..vector.sparse import SparseVector

__all__ = ["SimilarityServer"]


class SimilarityServer:
    def __init__(
        self,
        engine: Engine | None = None,
        config: AllPairsConfig | None = None,
        store: VectorStore | None = None,
        device: torch.device | str = "cuda",
    ):
        self.cfg = config or (engine.cfg if engine else AllPairsConfig())
        if self._has_checkpoint():
            if engine is None:
                engine = Engine.load(self.cfg.checkpoint_dir, config=self.cfg,
                                     device=device)
            elif engine.n_rows == 0:
                # restore INTO a caller-provided (e.g. mesh-sharded) engine
                engine.restore(self.cfg.checkpoint_dir)
            if engine is not None and engine.n_rows:
                get_logger().info(
                    "restored %d vectors from checkpoint %s",
                    engine.n_rows, self.cfg.checkpoint_dir,
                )
        self.engine = engine or Engine(self.cfg, device)
        self.store = store
        # the card every engine call runs on, fixed here: "cuda" without an
        # index means this (constructing) thread's current device
        dev = getattr(self.engine, "device", None)
        self._cuda_index = (
            (dev.index if dev.index is not None
             else torch.cuda.current_device())
            if isinstance(dev, torch.device) and dev.type == "cuda" else None
        )
        self._last_ckpt = time.time()
        self._dirty = False
        self._sinks: List[Callable[[SimilarityOutput], None]] = []
        self._batcher = OutputBatcher(
            self._fanout, self.cfg.output_io_duration_ms
        )
        self._queue: "queue.Queue[tuple[bool, list]]" = queue.Queue()
        self._pending: list = []  # one-tick-deep ingest pipeline
        self._pending_lock = threading.Lock()  # single completer, in order
        self._lock = threading.Lock()  # engine mutations are serialized
        self._drain_lock = threading.Lock()  # one drainer at a time, in order
        self._errors = 0  # poisoned batches dropped by the flusher
        self._stop = threading.Event()
        self._flusher = threading.Thread(target=self._flush_loop, daemon=True)
        self._started = False

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "SimilarityServer":
        if not self._started:
            self._started = True
            self._flusher.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._started:
            self._flusher.join(timeout=5.0)
        self.flush()
        self._complete_pending()
        self._batcher.close()
        self._maybe_checkpoint(force=True)

    def _engine_scope(self):
        """The engine lock, inside the engine's CUDA device scope."""
        stack = contextlib.ExitStack()
        if self._cuda_index is not None:
            stack.enter_context(torch.cuda.device(self._cuda_index))
        stack.enter_context(self._lock)
        return stack

    # ------------------------------------------------------------ checkpoint
    def _has_checkpoint(self) -> bool:
        # key on index.npz, the authoritative self-contained snapshot
        # (Engine.save replaces it FIRST; keying on the meta.json mirror
        # would orphan a valid snapshot if a crash lands between the two
        # replaces on the first-ever checkpoint)
        return bool(self.cfg.checkpoint_dir) and os.path.exists(
            os.path.join(self.cfg.checkpoint_dir, "index.npz")
        )

    def _maybe_checkpoint(self, force: bool = False) -> None:
        """Periodic index checkpoint (recovery story the reference lacks —
        its in-memory index is lost on actor relocation, SURVEY.md §5)."""
        if not self.cfg.checkpoint_dir or not self._dirty:
            return
        interval = self.cfg.checkpoint_interval_s
        due = force or (interval > 0 and time.time() - self._last_ckpt >= interval)
        if not due:
            return
        with self._engine_scope():
            self.engine.save(self.cfg.checkpoint_dir)
            self._dirty = False
        self._last_ckpt = time.time()
        get_logger().info(
            "checkpointed %d vectors to %s",
            self.engine.n_rows, self.cfg.checkpoint_dir,
        )

    def __enter__(self) -> "SimilarityServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- ingest
    def insert_new_vectors(
        self, vectors: Sequence[Tuple[str, SparseVector]]
    ) -> None:
        """Fire-and-forget streaming insert — the ``VectorIOMsg`` path
        (ClientConnection.scala:31-33).  Queued; matched at the next
        micro-batch flush.

        Dimensionality is validated HERE, at the ingest boundary, so a
        misconfigured client raises in its own call instead of poisoning the
        shared flush batch (the reference crashes the IndexingWorker instead
        and relies on Akka supervision to restart it)."""
        vectors = list(vectors)
        want = self.cfg.vector_dim
        for vid, v in vectors:
            if v.size != want:
                raise ValueError(
                    f"vector {vid!r} has size {v.size}, engine vector_dim is "
                    f"{want}"
                )
        self._queue.put((False, vectors))

    def load_data(self, table: str, start_row: int, end_row: int) -> None:
        """Bulk load a row range from the vector store — the ``LoadData``
        path (Client.scala:49-59 → WriteWorkerActor.scala:132-161).  The range
        is split like parseLoadDataRequest and enqueued as bulk batches (no
        admission pruning / component filter)."""
        if self.store is None:
            raise RuntimeError("no VectorStore attached")
        if self.cfg.admission == "real":
            # close the loop the reference left open: it computes the
            # <table>_MAX statistic but never loads it
            # (EntryProxyActor.readMaxWeight stub); we install it so
            # admission pruning uses the true corpus bound
            try:
                with self._engine_scope():
                    self.engine.set_max_weight_map(
                        self.store.max_weights(table)
                    )
            except FileNotFoundError:
                pass  # no _MAX statistic for this table: running bound
            except ValueError as e:
                # a wrong-dimension map silently downgrading "exactly
                # lossless" admission to the running bound must be VISIBLE
                get_logger().warning(
                    "max-weight map for %r rejected (%s); admission falls "
                    "back to the running-maxima bound", table, e,
                )
        # replicated serving: ship a table NAME + content hash through the
        # op log and let every process bulk-load from its own copy of the
        # shared store (a shared volume or filesystem) — never the corpus
        # itself as JSON.  Requires the store on every process; a follower
        # without one fails fast in replay.
        if hasattr(self.engine, "load_table"):
            with self._engine_scope():
                outs = self.engine.load_table(
                    self.store, table, start_row, end_row,
                    self.cfg.io_range_num, self.cfg.max_io_workers,
                )
            for out in outs:  # same emission contract as the queue path
                self._batcher.emit(out)
            return
        # two-level split, like the reference: the client-side ioRangeNum
        # split (Client.scala:49-59) then the entry-side re-split into
        # maxIOEntryActorNum sub-ranges (EntryProxyActor.scala:59-79) —
        # here the second level sets the ingest micro-batch granularity
        for s0, e0 in split_load_range(
            start_row, end_row, self.cfg.io_range_num
        ):
            for s, e in split_load_range(s0, e0, self.cfg.max_io_workers):
                csr, ids = self.store.load_range(table, s, e)
                batch = [(ids[i], csr.row(i)) for i in range(csr.n_rows)]
                if batch:
                    self._queue.put((True, batch))

    def flush(self) -> None:
        """Drain the ingest queue synchronously (one IOTrigger turn),
        completing any pipelined insert as well."""
        self._drain(full=True)
        self._complete_pending()

    def reject(self, reason: str) -> None:
        """Record a rejected fire-and-forget request (visible in stats)."""
        self._errors += 1
        get_logger().warning("rejected ingest: %s", reason)

    # ---------------------------------------------------------------- output
    def add_output_sink(
        self, sink: Callable[[SimilarityOutput], None]
    ) -> None:
        """Register an output consumer — the ``cpslab.allpair.outputActor``
        equivalent (IndexingWorkerActor.scala:44-46)."""
        self._sinks.append(sink)

    def remove_output_sink(
        self, sink: Callable[[SimilarityOutput], None]
    ) -> None:
        try:
            self._sinks.remove(sink)
        except ValueError:
            pass

    def _fanout(self, out: SimilarityOutput) -> None:
        dead = []
        for sink in self._sinks:
            try:
                sink(out)
            except BrokenPipeError:
                dead.append(sink)  # disconnected subscriber: unregister
            except Exception:  # sink failures never kill the server
                import traceback

                traceback.print_exc()
        for sink in dead:
            self.remove_output_sink(sink)

    # ----------------------------------------------------------------- query
    def all_pairs(self, tau: float | None = None):
        self.flush()
        with self._engine_scope():
            return self.engine.all_pairs(tau)

    def topk(self, queries, k: int):
        self.flush()
        with self._engine_scope():
            return self.engine.topk(queries, k)

    def freeze(self) -> None:
        with self._engine_scope():
            self.engine.freeze()

    def stats(self) -> dict:
        with self._engine_scope():
            return {
                **plain_stats(self.engine.stats),
                "n_rows": self.engine.n_rows,
                "n_active_dims": self.engine.compact.n_active,
                "queue_depth": self._queue.qsize(),
                "frozen": self.engine.frozen,
                "errors": self._errors,
                # this process's kernel launches, per wrapper: how a client
                # sees that the served joins ran on the card's kernels
                "launches": dict(LAUNCHES),
                "timings": {
                    name: {
                        "seconds": self.engine.timer.totals[name],
                        "count": self.engine.timer.counts[name],
                    }
                    for name in getattr(self.engine, "timer", None).totals
                } if getattr(self.engine, "timer", None) else {},
            }

    # --------------------------------------------------------------- flusher
    def _flush_loop(self) -> None:
        # keep-alive: the flusher must survive ANY batch failure, mirroring
        # the reference's deliberate worker-level try/catch
        # (IndexingWorkerActor.scala:124-137) — a dead flusher would leave
        # the queue growing with nobody draining it
        period = max(self.cfg.io_trigger_period_ms, 1) / 1000.0
        while not self._stop.wait(period):
            try:
                self._drain()
            except Exception:
                self._errors += 1
                get_logger().exception("flush tick failed; flusher continues")

    def _drain(self, full: bool = False) -> None:
        """Coalesce everything queued into at most two engine micro-batches
        (bulk + streaming), preserving the reference's semantics that a flush
        tick indexes the accumulated buffer at once
        (WriteWorkerActor.handleIOTrigger).  ``full=False`` (the periodic
        tick) defers a sub-cap streaming TAIL back to the queue whenever a
        full ``max_flush_batch`` chunk was drained this tick: under backlog
        the tail merges with the next tick's arrivals, so sustained load
        runs entirely in the one warmed cap-sized shape bucket instead of
        minting an arbitrary pow2 bucket (a fresh multi-second compile) per
        tick.  ``full=True`` (explicit :meth:`flush`) never defers.

        Ingest is pipelined one tick deep: each insert is submitted with
        deferred completion and finished at the NEXT drain, so the previous
        batch's host-side result fetch/rescore overlaps this batch's device
        work.  Results are therefore emitted at most one flush period later
        than fully-synchronous operation.

        A poisoned micro-batch (an engine exception) is logged, counted in
        ``stats()["errors"]`` and dropped; later batches keep flowing.
        """
        with self._drain_lock:  # queue pop → insert → pending-append, atomic
            bulk: list = []
            stream: list = []
            while True:
                try:
                    is_bulk, batch = self._queue.get_nowait()
                except queue.Empty:
                    break
                (bulk if is_bulk else stream).append(batch)
            # double-buffered ingest: submit THIS tick's batches first, THEN
            # complete the PREVIOUS tick's — the device scatters/scores batch
            # N while the host fetches + fp64-rescores batch N-1.  Emission
            # order is preserved (prior pendings complete before the new
            # ones, which wait for the next tick or an explicit flush()).
            with self._pending_lock:
                prior = list(self._pending)
                self._pending.clear()
            cap = int(self.cfg.max_flush_batch)
            for is_bulk, batches in ((True, bulk), (False, stream)):
                if not batches:
                    continue
                flat = [v for b in batches for v in b]
                # bound each engine micro-batch at the throughput-optimal
                # size (config.max_flush_batch): a backlog drains as several
                # capped batches instead of one mega-batch that is slower
                # per vector AND compiles a fresh pow2 shape bucket
                if (
                    not full and not is_bulk and cap > 0
                    and len(flat) > cap and len(flat) % cap
                ):
                    tail = flat[len(flat) - len(flat) % cap :]
                    flat = flat[: len(flat) - len(tail)]
                    self._queue.put((is_bulk, tail))
                chunks = (
                    [flat] if cap <= 0 else
                    [flat[s : s + cap] for s in range(0, len(flat), cap)]
                )
                for chunk in chunks:
                    try:
                        with self._engine_scope():
                            pending = self.engine.insert(
                                chunk, bulk=is_bulk, defer=True
                            )
                    except Exception:
                        self._errors += 1
                        get_logger().exception(
                            "dropped poisoned %s batch of %d vectors",
                            "bulk" if is_bulk else "stream", len(chunk),
                        )
                        continue
                    with self._pending_lock:
                        self._pending.append(pending)
                    self._dirty = True
            for pending in prior:
                try:
                    with self._engine_scope():
                        out = pending.result()
                except Exception:
                    self._errors += 1
                    get_logger().exception(
                        "dropped result of poisoned pending batch"
                    )
                    continue
                self._batcher.emit(out)
        self._maybe_checkpoint()

    def _complete_pending(self) -> None:
        # the completion lock makes one thread drain the whole backlog in
        # order, and makes flush() WAIT for an in-flight completion instead
        # of returning while results are still unemitted
        with self._pending_lock:
            while self._pending:
                pending = self._pending.pop(0)
                try:
                    with self._engine_scope():
                        out = pending.result()
                except Exception:
                    self._errors += 1
                    get_logger().exception(
                        "dropped result of poisoned pending batch"
                    )
                    continue
                self._batcher.emit(out)
