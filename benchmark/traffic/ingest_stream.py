"""Fresh vectors streamed into the live index, above what it sustains.

Set-up builds the configuration's index and starts the server; the
stream's rows are the corpus's rows after the index's, in order.  One
batch of each power of two up to ``max_flush_batch`` goes through the
queue first (those rows join the index).  Then ``children`` children each
send one fresh vector every ``period_ms``, open loop, ``warm_s`` before
the window and through it, while the backlog (sent, not yet indexed) is
under ``backlog_caps`` flush caps: above capacity sends wait there, so the
flushes keep to the cap and the drain after the window stays short.  The
rate is the growth of the index's row count over the window's seconds.

The check: ``check_vectors`` fresh vectors sent in the window, drawn from
the seed, against the float64 reference over every row sent.  A vector's
answer must hold every row before it at or above tau; a later row may
appear only where the two are a pair (a micro-batch is indexed before it
is matched, so its rows answer each other both ways); the vector itself
never.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import corpus as corpus_mod
from benchmark.harness import log, now
from benchmark.profile import profile_call
from benchmark.reference.compare import LIMITS, compare
from benchmark.reference.cosine import neighbours
from benchmark.stats import lateness, rate
from benchmark.traffic._stream import (TRACE_MARGIN_S, OpenLoop, Served,
                                       schedule, seeded_rows, sleep_until,
                                       snapshot)


__all__ = ["run", "reference_keys", "answer_keys"]

CAND_BAND = 1e-6


def reference_keys(c, g: np.ndarray, n_rows: int, tau: float, dtype):
    """The reference's entries of the fresh vectors at global rows ``g``
    against the first ``n_rows`` rows: key ``position * n_total + row``
    (the vector itself left out), the dot, and whether the row came before
    the vector."""
    qi, ci, s = neighbours(corpus_mod.take_rows(c, g), c, tau, CAND_BAND,
                           dtype=dtype, c_rows=n_rows)
    own = g[qi]
    keep = ci != own
    qi, ci, s, own = qi[keep], ci[keep], s[keep], own[keep]
    return qi * c.n_rows + ci, s, ci < own


def answer_keys(answers: list, n_index: int, n_total: int):
    """The answers (``{id: sim}`` or None a vector) as keys; the id of the
    stream's ``k``-th row is ``f<k>``, an index row's its number."""
    keys, sims = [], []
    for x, ans in enumerate(answers):
        for cid, s in (ans or {}).items():
            row = n_index + int(cid[1:]) if cid[0] == "f" else int(cid)
            keys.append(x * n_total + row)
            sims.append(s)
    return np.asarray(keys, np.int64), np.asarray(sims, np.float64)


def run(ctx) -> dict:
    cfg, p = ctx.config, ctx.params
    children, cap = int(p["children"]), int(cfg["max_flush_batch"])
    n_index, tau = int(cfg["index_rows"]), float(cfg["tau"])
    warm_s = float(p["warm_s"])
    span = warm_s + ctx.seconds + (float(p["trace_s"]) + TRACE_MARGIN_S
                                   if ctx.trace else 0.0)
    step = float(p["period_ms"]) / 1e3 / children
    n_warm = 2 * cap - 1
    n_total = n_index + n_warm + int(np.ceil(span / step)) + 1
    sv = Served(ctx, n_total)
    t = now()
    vecs = sv.vectors(range(n_index, n_total))
    log(f"{ctx.name}: {len(vecs)} stream vectors made in {now() - t:.1f} s")
    indexed0 = sv.eng.stats["vectors_indexed"]
    if sv.warm(lambda k: f"f{k}", vecs, cap) != n_warm:
        raise RuntimeError("the warm-up sent another number of rows")
    limit = int(p["backlog_caps"]) * cap
    stats = sv.eng.stats

    def room():
        return limit - (n_warm + gen.sent
                        - (stats["vectors_indexed"] - indexed0))

    t_sched = now() + 0.05
    due = schedule(children, float(p["period_ms"]), t_sched, span)
    w0 = t_sched + warm_s
    w1 = w0 + ctx.seconds
    gen = OpenLoop(due, lambda i, j: [(f"f{n_warm + k}", vecs[n_warm + k])
                                      for k in range(i, j)],
                   sv.srv.insert_new_vectors, room)
    ctx.settle()
    gen.start()
    sleep_until(w0)
    s0 = snapshot(sv.eng)
    lo = gen.sent
    sleep_until(w1)
    s1 = snapshot(sv.eng)
    hi = gen.sent
    prof = None
    if ctx.trace:
        prof = profile_call(sv.eng, lambda: time.sleep(float(p["trace_s"])))
    gen.stop.set()
    gen.join()
    n_sent = n_warm + gen.sent
    t = now()
    sv.srv.flush()
    log(f"{ctx.name}: backlog drained in {now() - t:.1f} s")
    errors = sv.srv.stats()["errors"]
    sv.close()
    late = lateness(gen.lateness(lo, hi))
    log(f"{ctx.name}: {hi - lo} sends in the window, generator late p95 "
        f"{late['p95_ms']:.3f} ms, max {late['max_ms']:.3f} ms, "
        f"{gen.holds} holds at a backlog of {limit}")
    window = s1["t"] - s0["t"]
    sections = {k: v - s0["sections"].get(k, 0.0)
                for k, v in s1["sections"].items()}
    records = {
        "window_s": window, "sections": sections, "profile": prof,
        "vectors": s1["stats"]["vectors_indexed"]
        - s0["stats"]["vectors_indexed"],
        "batches": s1["stats"]["insert_batches"]
        - s0["stats"]["insert_batches"],
    }
    indexed = s1["n_rows"] - s0["n_rows"]
    pick = np.sort(seeded_rows(ctx.seed, 2, hi - lo,
                               min(int(p["check_vectors"]), hi - lo),
                               ctx.device)) + lo
    first = sv.sink.first
    answers = [first.get(f"f{n_warm + k}") for k in pick]
    peak = ctx.memory_peak()
    c = sv.corpus
    del sv
    ctx.free()
    t2 = now()
    g = (n_index + n_warm + pick).astype(np.int64)
    rk, rs, before = reference_keys(c, g, n_index + n_sent, tau,
                                    torch.float64)
    gk, gs = answer_keys(answers, n_index, n_total)
    cmp = compare(gk, gs, rk, rs, tau, required=before)
    log(f"{ctx.name}: reference over {g.size} vectors in "
        f"{now() - t2:.1f} s")
    due_rows = np.unique(rk[before & (rs >= tau + LIMITS["sim_gap"])]
                         // c.n_rows)
    no_answer = int(sum(answers[int(x)] is None for x in due_rows))
    checks = {
        "no_answer": {"value": no_answer, "limit": 0},
        "pairs_missing": {"value": cmp["missing"], "limit": LIMITS["missing"]},
        "pairs_extra": {"value": cmp["extra"], "limit": LIMITS["extra"]},
        "sim_gap": {"value": cmp["sim_gap"], "limit": LIMITS["sim_gap"]},
    }
    return {
        "window_start": s0["t"],
        "metrics": {"insert_vectors_per_s": rate(indexed, window)},
        "records": records, "profile": prof, "memory_peak": peak,
        "attempted": hi - lo, "failed": no_answer + int(errors),
        "checks": checks,
    }
