"""Batch self-join, one client in a closed loop.

Set-up makes ``rows`` rows of the configuration's corpus on the card from
the seed, builds ``ChunkedAllPairs`` on them and runs ``warm_joins`` joins.
The window runs whole ``all_pairs(tau)`` calls back to back until
``--seconds`` have passed; the rate is every join's n(n-1)/2 decided pairs
over the time from the window's start to the last join's end.  With the
trace on, one more join runs under the profiler.

The check: every join of the window gives the same pair set; every pair
of the last one is a pair, given once, with its similarity, by the float64
dot of its two rows; and on ``check_rows`` rows drawn from the seed (all
their pairs, either side) it holds every pair the float64 reference finds.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from benchmark import corpus as corpus_mod
from benchmark.harness import log, now
from benchmark.peaks import card_peaks
from benchmark.profile import profile_call
from benchmark.reference.compare import LIMITS, compare
from benchmark.reference.cosine import neighbours, pair_dots

__all__ = ["run", "check_rows_of", "reference_keys", "program_keys",
           "answered_pairs"]

CAND_BAND = 1e-6  # the reference keeps every dot at or above tau - this


def _digest(res) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(res.i, np.int64).tobytes())
    h.update(np.ascontiguousarray(res.j, np.int64).tobytes())
    return h.hexdigest()


def check_rows_of(seed: int, n: int, k: int, device) -> np.ndarray:
    """``k`` distinct rows of ``n`` drawn from the seed, sorted."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2654435761 + 7) % (1 << 63))
    rows = torch.randperm(n, generator=g, device=device)[:min(k, n)]
    return np.sort(rows.cpu().numpy()).astype(np.int64)


def reference_keys(c, rows: np.ndarray, tau: float, dtype):
    """The reference's answers for ``rows``: keys ``row * n + col``
    (``col != row``) and dots, computed in ``dtype``."""
    n = c.n_rows
    qi, ci, s = neighbours(corpus_mod.take_rows(c, rows), c, tau, CAND_BAND,
                           dtype=dtype)
    r = rows[qi]
    keep = ci != r
    return r[keep] * n + ci[keep], s[keep]


def program_keys(i, j, sims, rows: np.ndarray, n: int):
    """The join's pairs that touch ``rows``, keyed from that side."""
    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    a, b = np.isin(i, rows), np.isin(j, rows)
    keys = np.concatenate([i[a] * n + j[a], j[b] * n + i[b]])
    return keys, np.concatenate([sims[a], sims[b]])


def answered_pairs(c, i, j, sims, tau: float) -> dict:
    """Every answered pair against its float64 dot: ``extra`` counts the
    pairs below ``tau`` by more than the band, a row paired with itself
    and a pair given twice; ``sim_gap`` is the widest gap between an
    answer's similarity and the dot."""
    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    sims = np.asarray(sims, np.float64)
    if i.size == 0:
        return {"extra": 0, "sim_gap": 0.0}
    dots = pair_dots(c, i, j)
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    twice = i.size - np.unique(lo * c.n_rows + hi).size
    extra = int((dots < tau - LIMITS["sim_gap"]).sum() + (i == j).sum()
                + twice)
    return {"extra": extra, "sim_gap": float(np.abs(sims - dots).max())}


def run(ctx) -> dict:
    from apsim_tpu_torch.config import AllPairsConfig
    from apsim_tpu_torch.engine.chunked import ChunkedAllPairs
    from apsim_tpu_torch.vector.batch import CSRMatrix

    cfg, p = ctx.config, ctx.params
    n, tau = int(cfg["rows"]), float(cfg["tau"])
    c = corpus_mod.make_corpus(cfg["corpus"], n, ctx.seed, ctx.device)
    indptr, indices, data = c.host()
    eng = ChunkedAllPairs(
        AllPairsConfig(vector_dim=c.vector_dim, similarity_threshold=tau),
        ctx.device, chunk_dim=int(cfg["chunk_dim"]))
    eng.build(CSRMatrix(n, c.vector_dim, indptr, indices, data))
    del indptr, indices, data
    for _ in range(int(p["warm_joins"])):
        eng.all_pairs(tau)
    ctx.settle()
    log(f"{ctx.name}: set-up done, {n} rows")
    stats0 = dict(eng.stats)
    digests = []
    t0 = now()
    while True:
        res = eng.all_pairs(tau)
        t1 = now()
        digests.append(_digest(res))
        if t1 - t0 >= ctx.seconds:
            break
    joins = len(digests)
    records = {
        "n_rows": n, "joins": joins, "window_s": t1 - t0,
        "pairs": int(eng.stats["pairs_emitted"] - stats0["pairs_emitted"]),
        "candidates": int(eng.stats["candidates_scored"]
                          - stats0["candidates_scored"]),
        "terms_used": c.distinct_terms(min_df=2),
    }
    log(f"{ctx.name}: {joins} joins in {t1 - t0:.3f} s, "
        f"{res.n_pairs} pairs a join")
    prof = None
    if ctx.trace:
        prof = profile_call(eng, lambda: eng.all_pairs(tau))
        records["profile"] = prof
        if ctx.device.type == "cuda":
            records["peaks"] = card_peaks(torch.cuda.get_device_name(
                ctx.device))
    peak = ctx.memory_peak()
    i, j, sims = res.i, res.j, res.sims
    del eng, res
    ctx.free()
    rows = check_rows_of(ctx.seed, n, int(p["check_rows"]), ctx.device)
    t2 = now()
    rk, rs = reference_keys(c, rows, tau, torch.float64)
    gk, gs = program_keys(i, j, sims, rows, n)
    cmp = compare(gk, gs, rk, rs, tau)
    every = answered_pairs(c, i, j, sims, tau)
    log(f"{ctx.name}: reference over {rows.size} rows and {len(i)} pairs in "
        f"{now() - t2:.1f} s, {cmp['reference']} entries, "
        f"{cmp['answers']} answers")
    differ = sum(d != digests[-1] for d in digests)
    checks = {
        "pairs_missing": {"value": cmp["missing"], "limit": LIMITS["missing"]},
        "pairs_extra": {"value": max(cmp["extra"], every["extra"]),
                        "limit": LIMITS["extra"]},
        "sim_gap": {"value": max(cmp["sim_gap"], every["sim_gap"]),
                    "limit": LIMITS["sim_gap"]},
        "joins_differ": {"value": differ, "limit": 0},
    }
    return {
        "window_start": t0,
        "metrics": {"join_pairs_per_s": joins * n * (n - 1) / 2 / (t1 - t0)},
        "records": records, "profile": prof, "memory_peak": peak,
        "attempted": joins, "failed": 0, "checks": checks,
    }
