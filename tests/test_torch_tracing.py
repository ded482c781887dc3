"""The port's tracing on the CPU: ``Timer`` sections as profiler ranges on
every thread of one ``profile_trace`` file, with the micro-batch id the
server sets; a join and a served ingest under a stand-in timer that has
only ``section(name)``, ``totals`` and ``counts`` (as a benchmark's
recorder has); the ``grow`` sections against the capacity steps of a
streamed insert; and the server's per-vector completion in ``stats()``.
"""

import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest

import apsim_tpu_torch as pt
from apsim_tpu_torch.engine.chunked import ChunkedAllPairs
from apsim_tpu_torch.serve import SimilarityServer
from apsim_tpu_torch.utils.logging import (SPAN_PREFIX, Timer, batch_id,
                                           profile_trace, span_of)
from apsim_tpu_torch.vector.batch import CSRMatrix
from apsim_tpu_torch.vector.sparse import SparseVector

from oracle import brute_force_pairs, random_sparse_corpus

DIM = 300
TAU = 0.5


def to_pt(csr):
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                     csr.data)


def head(csr, n):
    return CSRMatrix(n, csr.n_cols, csr.indptr[:n + 1],
                     csr.indices[:csr.indptr[n]], csr.data[:csr.indptr[n]])


@pytest.fixture
def corpus():
    return to_pt(random_sparse_corpus(np.random.default_rng(22), 120, DIM))


def make_cfg(**kw):
    base = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
                similarity_threshold=TAU, io_trigger_period_ms=5)
    base.update(kw)
    return pt.AllPairsConfig(**base)


def rows(csr, lo, hi, prefix="r"):
    return [(f"{prefix}{i}", csr.row(i)) for i in range(lo, hi)]


def served_pairs(outputs, ids_row):
    """Unordered row pairs of the served outputs."""
    return {tuple(sorted((ids_row[q], ids_row[c])))
            for out in outputs for q, cands in out.output.items()
            for c in cands}


class BareTimer:
    """What a stand-in for ``engine.timer`` offers: ``section(name)``,
    ``totals`` and ``counts`` and nothing else."""

    __slots__ = ("totals", "counts", "names")

    def __init__(self):
        self.totals, self.counts, self.names = {}, {}, set()

    @contextlib.contextmanager
    def section(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)
            self.counts[name] = self.counts.get(name, 0) + 1
            self.names.add(name)


def test_span_names_round_trip():
    assert span_of(SPAN_PREFIX + "compact") == ("compact", None)
    assert span_of(SPAN_PREFIX + "insert#12") == ("insert", 12)
    assert span_of("aten::nonzero") is None


def test_served_profile_dir_traces_each_drain(tmp_path, corpus):
    """With ``profile_dir`` set, each drain with work writes one trace
    holding the flusher's drain and its batch's insert, the batch id in
    the insert's ``args``; an idle tick writes none."""
    cfg = make_cfg(io_trigger_period_ms=60_000, profile_dir=str(tmp_path))
    eng = ChunkedAllPairs(cfg, "cpu", chunk_dim=64)
    eng.build(head(corpus, 40))
    with SimilarityServer(eng, cfg, device="cpu") as srv:
        srv._drain()  # nothing queued: no trace
        assert os.listdir(tmp_path) == []
        srv.insert_new_vectors(rows(corpus, 40, 60))
        srv.flush()
    found = os.listdir(tmp_path)
    assert len(found) == 1, found
    with open(tmp_path / found[0]) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    names = {e["name"] for e in spans}
    assert {SPAN_PREFIX + n for n in ("drain", "insert", "compact")} <= names
    ins = [e for e in spans if e["name"] == SPAN_PREFIX + "insert"]
    assert len(ins) == 1 and isinstance(ins[0]["args"]["batch"], int)
    assert "batch" not in next(e for e in spans if e["name"]
                               == SPAN_PREFIX + "drain").get("args", {})


def test_sections_of_every_thread_in_one_trace(tmp_path, corpus):
    eng = ChunkedAllPairs(make_cfg(), "cpu", chunk_dim=64)
    eng.build(head(corpus, 100))
    tids = {}

    def flusher():
        tids["flusher"] = threading.get_native_id()
        token = batch_id.set(7)
        try:
            eng.insert(rows(corpus, 100, 120), tau=TAU)
        finally:
            batch_id.reset(token)

    with profile_trace(str(tmp_path)) as prof:
        assert prof is not None
        # a nested trace (the engine's own profile_dir hook) writes nothing
        with profile_trace(str(tmp_path / "nested")) as inner:
            assert inner is None
        eng.all_pairs(TAU)
        t = threading.Thread(target=flusher)
        t.start()
        t.join(timeout=120)
    assert not t.is_alive()
    assert not os.path.exists(tmp_path / "nested")
    found = os.listdir(tmp_path)
    assert len(found) == 1, found
    with open(tmp_path / found[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    main = threading.get_native_id()
    by_tid = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(e)
    assert {main, tids["flusher"]} <= set(by_tid)

    def nested(evs, inner, outer):
        return [i for i in evs if i["name"] == SPAN_PREFIX + inner
                and any(o["name"] == SPAN_PREFIX + outer
                        and o["ts"] <= i["ts"]
                        and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
                        for o in evs)]

    for tid in (main, tids["flusher"]):
        evs = by_tid[tid]
        syncs = [e for e in evs if e["name"] == SPAN_PREFIX + "compact_sync"]
        assert syncs and nested(evs, "compact_sync", "compact") == syncs
    assert any(e["name"] == SPAN_PREFIX + "all_pairs" for e in by_tid[main])
    assert all("batch" not in e.get("args", {}) for e in by_tid[main])
    flush = by_tid[tids["flusher"]]
    assert any(e["name"] == SPAN_PREFIX + "insert" for e in flush)
    assert {e["args"]["batch"] for e in flush} == {7}


def test_stand_in_timer_runs_join_and_served_ingest(corpus):
    want = {tuple(sorted((int(a), int(b))))
            for a, b in brute_force_pairs(corpus, TAU)}
    ref = ChunkedAllPairs(make_cfg(), "cpu", chunk_dim=64)
    ref.build(corpus)
    bare = BareTimer()
    eng = ChunkedAllPairs(make_cfg(), "cpu", chunk_dim=64)
    eng.build(corpus)
    eng.timer = bare
    got = eng.all_pairs(TAU)
    assert got.pair_set() == ref.all_pairs(TAU).pair_set()
    assert {(min(a, b), max(a, b)) for a, b in zip(got.i.tolist(),
                                                   got.j.tolist())} == want
    assert {"all_pairs", "compact", "compact_sync", "rescore"} <= bare.names

    def serve(timer):
        eng = ChunkedAllPairs(make_cfg(), "cpu", chunk_dim=64)
        eng.build(head(corpus, 40))
        outputs = []
        srv = SimilarityServer(eng, eng.cfg, device="cpu")
        srv.add_output_sink(outputs.append)
        with srv:
            if timer is not None:
                eng.timer = timer  # swapped in while the flusher runs
            for s in range(40, 120, 16):
                srv.insert_new_vectors(rows(corpus, s, s + 16))
                time.sleep(0.01)
            srv.flush()
        return outputs

    ids_row = {f"r{i}": i for i in range(120)}
    ids_row.update({str(i): i for i in range(40)})
    bare = BareTimer()
    plain, stood_in = serve(None), serve(bare)
    assert served_pairs(stood_in, ids_row) == served_pairs(plain, ids_row)
    assert served_pairs(stood_in, ids_row) == {
        p for p in want if p[1] >= 40}
    assert {"tick_wait", "drain", "coalesce", "insert", "emit"} <= bare.names


@pytest.mark.parametrize("n,row_steps", [(1000, 0), (1100, 1)])
def test_grow_counts_capacity_steps(n, row_steps):
    """``grow`` counts every doubling of ``_chunk_cap`` in a streamed
    insert, and the resident stack's rebuild when the row capacity steps
    (past 1,024 rows); one chunk wider than every dim keeps the stack's
    width fixed."""
    csr = to_pt(random_sparse_corpus(np.random.default_rng(5), n, DIM))
    eng = ChunkedAllPairs(make_cfg(), "cpu", chunk_dim=512)
    eng.build(head(csr, 40))
    doublings, steps, geom = 0, 0, None
    for s in range(40, n, 20):
        cap = eng._chunk_cap
        eng.insert(rows(csr, s, min(s + 20, n)), tau=0.9)
        doublings += int(np.log2(eng._chunk_cap // cap))
        assert eng._mslab is not None  # the resident route
        now = tuple(eng._mslab.shape[1:])
        steps += geom is not None and now != geom
        geom = now
    assert doublings >= 3 and steps == row_steps
    assert eng.timer.counts["grow"] == doublings + steps


def test_completion_counts_unanswered_vectors(corpus):
    cfg = make_cfg(io_trigger_period_ms=60_000)  # no tick: flush() drains
    eng = ChunkedAllPairs(cfg, "cpu", chunk_dim=64)
    eng.build(head(corpus, 40))
    outputs = []
    with SimilarityServer(eng, cfg, device="cpu") as srv:
        srv.add_output_sink(outputs.append)
        lone = SparseVector(DIM, np.array([DIM - 1], np.int32), [1.0])
        batch = rows(corpus, 0, 2, prefix="d") + [("lone", lone)]
        srv.insert_new_vectors(batch)
        st = srv.stats()
        assert (st["vectors_in_flight"], st["vectors_completed"]) == (3, 0)
        assert st["completion_ms"]["count"] == 0
        srv.flush()
        st = srv.stats()
    answered = {q for out in outputs for q in out.output}
    assert "lone" not in answered and {"d0", "d1"} <= answered
    assert st["vectors_completed"] == 3 and st["vectors_in_flight"] == 0
    c = st["completion_ms"]
    assert c["count"] == 3
    assert 0 < c["p50"] <= c["p95"] <= c["p99"] <= c["max"]
    json.dumps(st)


def test_timer_totals_survive_threads():
    t = Timer()

    def work():
        for _ in range(2000):
            with t.section("a"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert t.counts["a"] == 16000
