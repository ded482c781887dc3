"""Insert→first-result latency harness.

Port of the reference's load generator (LoadGenerator.scala):

  - ``childrenNum`` runner threads each stream one normalized vector every
    ``writeBatchingDuration`` ms to the server (LoadRunner, :31-74);
  - warmup phase: every corpus vector is sent once; after ``expDuration`` the
    test phase starts (ReceiveTimeout → StartTest, :161-166) and the server
    index is frozen (the IndexingWorker's own ReceiveTimeout,
    IndexingWorkerActor.scala:143-144) — queries keep flowing against the
    frozen index;
  - test phase: ``totalMessageCount`` messages per runner are re-sent with
    send-time stamps (StartTime, :67); the generator records the first
    SimilarityOutput containing each stamped id (:134-149) and reports
    avg/max/min insert→first-result latency (:112-132).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Sequence, Tuple

from ..vector.sparse import SparseVector

__all__ = ["LoadGenerator"]


class LoadGenerator:
    def __init__(
        self,
        connection,
        vectors: Sequence[Tuple[str, SparseVector]],
        total_message_count: int = 50,
        children_num: int = 1,
        write_batching_ms: int = 50,
        warmup: bool = True,
        freeze_before_test: bool = True,
        timeout_s: float = 60.0,
    ):
        self.conn = connection
        self.vectors = [(vid, v.normalized()) for vid, v in vectors]
        self.total = total_message_count
        self.children = children_num
        self.period = write_batching_ms / 1000.0
        self.warmup = warmup
        self.freeze_before_test = freeze_before_test
        self.timeout_s = timeout_s
        self._start_time: Dict[str, float] = {}
        self._end_time: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._done = threading.Event()

    # output-actor callback: record first result per stamped query id
    def _on_output(self, output: Dict[str, Dict[str, float]], moment: float) -> None:
        now = time.time()
        with self._lock:
            for qid in output:
                if qid in self._start_time and qid not in self._end_time:
                    self._end_time[qid] = now
            if len(self._end_time) >= self.total * self.children:
                self._done.set()

    def _runner(self, runner_id: int) -> None:
        n = len(self.vectors)
        for k in range(self.total):
            msg_idx = runner_id * self.total + k
            vid, vec = self.vectors[msg_idx % n]
            test_id = f"t{msg_idx}"
            with self._lock:
                self._start_time[test_id] = time.time()
            self.conn.insert_new_vector([(test_id, vec)])
            time.sleep(self.period)

    def run(self) -> dict:
        self.conn.subscribe_outputs(self._on_output)
        if self.warmup:
            # stream the corpus once so the index is populated (:58-66)
            for vid, vec in self.vectors:
                self.conn.insert_new_vector([(f"w:{vid}", vec)])
            self.conn.flush()
        if self.freeze_before_test:
            self.conn.freeze()
            # warm the frozen-match path so first-compile cost (minutes on a
            # cold cache) lands before the measured phase, not inside it
            vid, vec = self.vectors[0]
            self.conn.insert_new_vector([(f"warm:{vid}", vec)])
            self.conn.flush()
        threads = [
            threading.Thread(target=self._runner, args=(i,))
            for i in range(self.children)
        ]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.conn.flush()
        self._done.wait(
            timeout=max(0.0, self.timeout_s - (time.time() - t0))
        )
        with self._lock:
            durations = [
                self._end_time[k] - self._start_time[k]
                for k in self._start_time
                if k in self._end_time
            ]
        if not durations:
            return {"messages": 0}
        return {
            "messages": len(durations),
            "sent": self.total * self.children,
            "avg_latency_ms": 1000 * sum(durations) / len(durations),
            "max_latency_ms": 1000 * max(durations),
            "min_latency_ms": 1000 * min(durations),
        }
