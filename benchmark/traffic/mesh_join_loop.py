"""Batch self-join of a dimension-sharded index, one client in a closed
loop.

As ``join_loop``, on ``MeshChunkedAllPairs``: the configuration's
``shards`` shards over a 1-D mesh, one a card (``cuda:0`` onward), or as
many shards on the CPU when the run's device is the CPU.  Set-up makes
``rows`` rows of the corpus on the lead card from the seed, builds the
engine on them and runs ``warm_joins`` joins.  The window runs whole
``all_pairs(tau)`` calls back to back until ``--seconds`` have passed; the
rate is every join's n(n-1)/2 decided pairs over the time from the
window's start to the last join's end.  With the trace on, one more join
runs under the profiler, read card by card (``profile_cards``).

The records add the shards and cards, the panel height and pair count of
the join, each window join's seconds and the engine's stage seconds in it
(its ``Timer``), each card's launches a join
(``tri_score.LAUNCHES_BY_CARD``),
each card's memory peak and, where the program counts them, the bytes a
join copied between cards (``peer_copy_bytes``) and each shard's entries
(``shard_entries``).

The check is ``join_loop``'s, through its helpers, on the lead card after
the window with the engine freed from every card: every join of the
window gives the same pair set, every pair of the last one is held to its
float64 dot, and every pair touching ``check_rows`` seeded rows to the
dense reference.  The reference knows no shards.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import corpus as corpus_mod
from benchmark.harness import log, now
from benchmark.peaks import card_peaks
from benchmark.profile_cards import profile_call_cards
from benchmark.reference.compare import LIMITS, compare
from benchmark.traffic.join_loop import (_digest, answered_pairs,
                                         check_rows_of, program_keys,
                                         reference_keys)

__all__ = ["run", "mesh_devices"]


def mesh_devices(device: torch.device, shards: int) -> list:
    """One card a shard on CUDA; every shard on the CPU otherwise."""
    if device.type == "cuda":
        return [torch.device("cuda", k) for k in range(shards)]
    return [torch.device("cpu")] * shards


def _launches() -> dict:
    """A copy of the kernel launches by wrapper and card so far."""
    from apsim_tpu_torch.ops import tri_score as ts

    return {k: dict(v) for k, v in ts.LAUNCHES_BY_CARD.items()}


def _per_join(before: dict, after: dict, joins: int) -> dict:
    out = {}
    for name, cards in after.items():
        d = {str(c): (n - before.get(name, {}).get(c, 0)) / joins
             for c, n in cards.items()}
        d = {c: n for c, n in d.items() if n}
        if d:
            out[name] = d
    return out


def run(ctx) -> dict:
    from apsim_tpu_torch.config import AllPairsConfig
    from apsim_tpu_torch.parallel.chunked_mesh import MeshChunkedAllPairs
    from apsim_tpu_torch.parallel.mesh import make_mesh
    from apsim_tpu_torch.vector.batch import CSRMatrix

    cfg, p = ctx.config, ctx.params
    n, tau = int(cfg["rows"]), float(cfg["tau"])
    shards = int(cfg["shards"])
    devices = mesh_devices(ctx.device, shards)
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    c = corpus_mod.make_corpus(cfg["corpus"], n, ctx.seed, devices[0])
    indptr, indices, data = c.host()
    eng = MeshChunkedAllPairs(
        AllPairsConfig(vector_dim=c.vector_dim, similarity_threshold=tau),
        mesh=make_mesh(shards, devices=devices),
        chunk_dim=int(cfg["chunk_dim"]))
    eng.build(CSRMatrix(n, c.vector_dim, indptr, indices, data))
    del indptr, indices, data
    geom = eng._panel_geom()
    records = {
        "n_rows": n, "n_shards": shards, "n_cards": len(cards) or 1,
        "panel_rows": None if geom is None else geom[0],
        "panel_pairs": None if geom is None else geom[3] * (geom[3] + 1) // 2,
        "shard_entries": eng.stats.get("shard_entries"),
    }
    l0 = _launches()
    for _ in range(int(p["warm_joins"])):
        eng.all_pairs(tau)
    if p["warm_joins"]:
        records["launches_per_join"] = _per_join(l0, _launches(),
                                                 int(p["warm_joins"]))
    ctx.settle()
    log(f"{ctx.name}: set-up done, {n} rows over {shards} shards; "
        f"panel rows {records['panel_rows']}, {records['panel_pairs']} "
        f"pairs; shard entries {records['shard_entries']}; launches a "
        f"join {records.get('launches_per_join')}")
    stats0 = dict(eng.stats)
    digests, ends, stages = [], [], []
    totals = dict(eng.timer.totals)
    t0 = now()
    while True:
        res = eng.all_pairs(tau)
        t1 = now()
        digests.append(_digest(res))
        ends.append(t1 - t0)
        stages.append({k: v - totals.get(k, 0.0)
                       for k, v in eng.timer.totals.items()})
        totals = dict(eng.timer.totals)
        if t1 - t0 >= ctx.seconds:
            break
    joins = len(digests)
    copied = eng.stats.get("peer_copy_bytes")
    records.update({
        "joins": joins, "window_s": t1 - t0,
        "join_s": [round(float(d), 4) for d in np.diff([0.0] + ends)],
        "join_stages_s": {k: [round(st.get(k, 0.0), 4) for st in stages]
                          for k in stages[-1] if stages[-1][k]},
        "pairs": int(eng.stats["pairs_emitted"] - stats0["pairs_emitted"]),
        "candidates": int(eng.stats["candidates_scored"]
                          - stats0["candidates_scored"]),
        "peer_copy_bytes": (None if copied is None else
                            (copied - stats0["peer_copy_bytes"]) / joins),
        "terms_used": c.distinct_terms(min_df=2),
    })
    log(f"{ctx.name}: {joins} joins in {t1 - t0:.3f} s, "
        f"{res.n_pairs} pairs a join; join seconds {records['join_s']}; "
        f"peer copy bytes a join {records['peer_copy_bytes']}; each "
        f"stage's seconds a join {records['join_stages_s']}")
    prof = None
    if ctx.trace:
        prof = profile_call_cards(eng, lambda: eng.all_pairs(tau), cards)
        records["profile"] = prof
        if ctx.device.type == "cuda":
            records["peaks"] = card_peaks(torch.cuda.get_device_name(
                devices[0]))
        log(f"{ctx.name}: traced join {prof['window_s']:.3f} s, busy by "
            f"card {prof['busy_by_card_s']}, sections "
            f"{ {k: round(v, 4) for k, v in prof['sections_s'].items()} }")
    if cards:
        records["memory_peak_by_card"] = {
            str(k): int(torch.cuda.max_memory_allocated(k)) for k in cards}
        log(f"{ctx.name}: memory peak by card "
            f"{records['memory_peak_by_card']}")
    peak = ctx.memory_peak()
    i, j, sims = res.i, res.j, res.sims
    del eng, res
    ctx.free()
    rows = check_rows_of(ctx.seed, n, int(p["check_rows"]), devices[0])
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
