"""What a stream kind and the sweep share: the served index, the
open-loop generator and the output sink.

The server is the port's ``SimilarityServer`` over ``ChunkedAllPairs``:
the ingest queue, the ``io_trigger_period_ms`` flush tick, the
``max_flush_batch`` cap and the output sinks.  Traffic follows the
upstream's ``LoadGenerator`` (``childrenNum`` children, each sending one
vector every ``writeBatchingDuration``), as one open-loop schedule of due
times with the children's phases spread evenly: each send is timed from
its due time, whether or not the server has kept up, unless a hold on the
backlog is given.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark import corpus as corpus_mod
from benchmark.harness import log, now

__all__ = ["TRACE_MARGIN_S", "Served", "OpenLoop", "FirstOutput",
           "schedule", "sleep_until", "seeded_rows", "snapshot"]

# the schedule runs on this long past the traced stretch, so that the
# profiler's start-up never leaves the stretch without traffic
TRACE_MARGIN_S = 10.0


def sleep_until(t: float) -> None:
    while True:
        left = t - now()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def schedule(children: int, period_ms: float, t0: float,
             seconds: float) -> np.ndarray:
    """Due times from ``t0`` for ``seconds``: child ``c`` sends its ``m``-th
    vector at ``t0 + (m * children + c) * period / children``."""
    step = period_ms / 1e3 / children
    return t0 + np.arange(int(np.ceil(seconds / step))) * step


class FirstOutput:
    """An output sink: the answer of the first ``SimilarityOutput`` that
    carries each query id, and every output's size."""

    def __init__(self):
        self.first: dict = {}
        self.sizes: list = []

    def __call__(self, out) -> None:
        self.sizes.append(len(out.output))
        first = self.first
        for qid, answer in out.output.items():
            if qid not in first:
                first[qid] = answer


class OpenLoop(threading.Thread):
    """Sends ``make(i, j)`` (the sends ``i .. j - 1``) through ``send`` once
    they are due; ``sent_at[k]`` is when send ``k`` left.  With ``room``
    (how many more sends may leave now), sends wait while it is 0: a send
    is then ready when the hold ends, and its lateness is counted from
    then."""

    def __init__(self, due: np.ndarray, make, send, room=None):
        super().__init__(daemon=True)
        self.due, self.make, self.send, self.room = due, make, send, room
        self.sent_at = np.full(due.size, np.nan)
        self.ready_at = due.copy()
        self.sent = 0
        self.holds = 0
        self.stop = threading.Event()

    def run(self) -> None:
        due, i, held = self.due, 0, False
        while i < due.size and not self.stop.is_set():
            t = now()
            j = int(np.searchsorted(due, t, side="right"))
            if j > i and self.room is not None:
                free = self.room()
                if free <= 0:
                    self.holds += not held
                    held = True
                    time.sleep(0.001)
                    continue
                if held:
                    np.maximum(self.ready_at[i:], t, out=self.ready_at[i:])
                    held = False
                j = min(j, i + free)
            if j > i:
                self.send(self.make(i, j))
                self.sent_at[i:j] = now()
                self.sent = i = j
            else:
                time.sleep(min(max(due[i] - t, 0.0), 0.002))

    def lateness(self, lo: int, hi: int) -> np.ndarray:
        return self.sent_at[lo:hi] - self.ready_at[lo:hi]


class Served:
    """The served index: the corpus's first ``index_rows`` rows built into
    ``ChunkedAllPairs``, under a started ``SimilarityServer`` with a
    ``FirstOutput`` sink; ``n_total`` rows are made (the stream's rows
    follow the index's)."""

    def __init__(self, ctx, n_total: int):
        from apsim_tpu_torch.config import AllPairsConfig
        from apsim_tpu_torch.engine.chunked import ChunkedAllPairs
        from apsim_tpu_torch.serve.server import SimilarityServer
        from apsim_tpu_torch.vector.batch import CSRMatrix

        cfg = ctx.config
        self.tau = float(cfg["tau"])
        self.n_index = int(cfg["index_rows"])
        self.corpus = corpus_mod.make_corpus(cfg["corpus"], n_total,
                                             ctx.seed, ctx.device)
        indptr, indices, data = self.corpus.host()
        self.csr = CSRMatrix(n_total, self.corpus.vector_dim, indptr,
                             indices, data)
        head = CSRMatrix(self.n_index, self.corpus.vector_dim,
                         indptr[:self.n_index + 1], indices[:indptr[
                             self.n_index]], data[:indptr[self.n_index]])
        acfg = AllPairsConfig(
            vector_dim=self.corpus.vector_dim, similarity_threshold=self.tau,
            io_trigger_period_ms=int(cfg["io_trigger_period_ms"]),
            max_flush_batch=int(cfg["max_flush_batch"]),
            output_io_duration_ms=0)
        self.eng = ChunkedAllPairs(acfg, ctx.device,
                                   chunk_dim=int(cfg["chunk_dim"]))
        t = now()
        self.eng.build(head)
        log(f"{ctx.name}: built {self.n_index} rows in {now() - t:.1f} s")
        self.sink = FirstOutput()
        self.srv = SimilarityServer(self.eng, acfg, device=ctx.device)
        self.srv.add_output_sink(self.sink)
        self.srv.start()

    def vectors(self, rows) -> list:
        """The rows as the ``SparseVector`` objects a client sends."""
        return [self.csr.row(int(r)) for r in rows]

    def warm(self, ids, vecs, cap: int) -> int:
        """One batch of each power of two up to ``cap`` through the queue
        and the flush, so that every batch shape the tick can make has run
        once; returns the number of vectors sent."""
        k, size = 0, 1
        while size <= cap:
            batch = [(ids(k + x), vecs[(k + x) % len(vecs)])
                     for x in range(size)]
            self.srv.insert_new_vectors(batch)
            self.srv.flush()
            k += size
            size *= 2
        return k

    def close(self) -> None:
        self.srv.close()


def seeded_rows(seed: int, salt: int, n: int, k: int, device) -> np.ndarray:
    """``k`` distinct rows of ``n``, in an order drawn from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + salt) % (1 << 63))
    return torch.randperm(n, generator=g, device=device)[:k].cpu().numpy()


def snapshot(eng) -> dict:
    """The engine's counters and section totals at one moment."""
    while True:
        try:
            return {"stats": dict(eng.stats), "n_rows": int(eng.n_rows),
                    "sections": dict(eng.timer.totals), "t": now()}
        except RuntimeError:  # a section was added while copying
            continue
