#!/usr/bin/env python3
"""The PyTorch port's benchmark: the exact all-pairs cosine join
and the streaming insert at tau = 0.8 on one CUDA card (the counterpart of
``bench.py``).

Usage, from the repository root on a machine with a CUDA card:

    python3 bench_torch.py [--seed N] [--device {cuda,cpu}]
    python3 bench_torch.py --spread RUN.json [RUN.json ...]

The cells (``CELLS``) run in order, each on ``synthetic_corpus(rows, seed)``
(default seed 0) with ``AllPairsConfig()`` (the bf16 cell with
``pallas_int8=False``) on card 0:

- A join cell generates its corpus, builds, runs two warm joins, rebuilds
  once on a fresh engine (``build_seconds``), then times joins on the host
  clock (each ends in host numpy results), at least ``REPEATS`` of them
  and until they have taken ``WINDOW_SECONDS`` in all.  Its metric,
  ``decided_pairs_per_sec``, is all their work over all their time
  (joins x n(n-1)/2 over the summed seconds), so a slow join counts in
  full; the median, min and max stand beside it, with the ``Timer``
  sections per join and the launches of its kernel (which must have
  launched).  One more join runs under
  ``torch.profiler`` (``ooc.profile_join``: the device's idle share, its
  top kernels, the longest idle gaps with the ``Timer`` section the host
  was in), out of the timed ones.  Last, the pair set of the last timed
  join is held against an fp64 oracle over the full corpus
  (``ooc.batch_oracle``: dense fp64 row blocks on the same device, no code
  shared with the engine).  The sparse product of ``suite._oracle_pairs``
  is no oracle here: on this corpus nearly every pair shares a dimension,
  so its result is dense (1e10 entries at 100,000 rows).
- The insert cell builds ``Engine`` on the first ``build`` rows and streams
  the rest in batches of ``batch`` through ``insert(..., tau=0.8)``, one
  client in a closed loop: one warm pass on a fresh engine, then timed
  passes, each on another fresh engine, until their batches have taken
  ``WINDOW_SECONDS`` in all (each batch on the host clock; an insert
  returns with its output; vectors/s is all the passes' vectors over
  their summed batch times, p50 and p95 over all their batches), then a
  traced pass on one more (``ooc.profile_insert``).  Every batch's
  pairs, in the warm pass and in every timed one, are held
  against ``ooc.batch_oracle``: the batch against the rows before it and
  against itself.  None of the four kernels may launch on this path.

After the headline cell the reference algorithm's CPU port
(``bench.baseline.measure_baseline``) runs on the first 1,200 rows of its
corpus, as ``bench.py`` does, and its pair set must equal the join's on
that prefix.

Progress goes to stderr; the last line of stdout is one JSON object with
``bench.py``'s headline fields from ``dense_int8_join_8586`` (``metric``,
``value``, ``unit``, ``vs_baseline``, ``parity``, ``seconds``,
``int8_ops``, ``mfu_pct``), the card (``nvidia-smi`` name and power
limit) and ``cells``.  ``parity`` is true only when every gate held; the
exit code is 1 otherwise.  Anything that raises ends the run with no line.
There is no CPU fallback: without CUDA the default ``--device cuda``
raises; ``--device cpu`` is for the tests.

``--spread`` runs nothing: it reads the last line of each saved run's
output and prints, for each metric of ``METRICS`` in each cell, the values,
their relative spread ((max - min) / median) and the bound that spread
sets: twice the spread, and no less than ``MIN_BOUND``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from apsim_tpu_torch import AllPairsConfig, ChunkedAllPairs, Engine
from apsim_tpu_torch.bench.baseline import measure_baseline
from apsim_tpu_torch.bench.mfu import card_peaks, int8_join_ops, mfu_pct
from apsim_tpu_torch.bench.ooc import (batch_oracle, csr_rows, join_ops,
                                       pairs_of, profile_insert,
                                       profile_join)
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import tri_score

TAU = 0.8
REPEATS = 9  # the fewest timed joins of a join cell (bench.py:47)
# the least time a cell's timed joins or insert passes take in all: a
# longer window than bench.py's 9 joins (~40 ms at 8,586 rows), so that
# a stall counts at its share of the time
WINDOW_SECONDS = 2.0
BASELINE_ROWS = 1200  # the reference port's prefix (bench.py:46)
HEADLINE = "dense_int8_join_8586"
# the end-to-end metrics and whether higher is better
METRICS = {"decided_pairs_per_sec": True, "insert_vectors_per_sec": True,
           "insert_p95_ms": False}
MIN_BOUND = 0.05  # a metric's bound is at least 5 %
# kind: "dense" (Engine), "chunked" (ChunkedAllPairs) or "insert"; kernel:
# the wrapper of ``tri_score.LAUNCHES`` the timed joins must launch
CELLS = {
    "dense_int8_join_8586": {"kind": "dense", "rows": 8586,
                             "kernel": "score_bits_int8"},
    "dense_int8_join_32768": {"kind": "dense", "rows": 32768,
                              "kernel": "score_bits_int8"},
    "dense_bf16_join_8586": {"kind": "dense", "rows": 8586,
                             "config": {"pallas_int8": False},
                             "kernel": "score_bits_bf16"},
    "ooc_join_100k": {"kind": "chunked", "rows": 100_000, "chunk_dim": 2048,
                      "kernel": "panel_score_bits_int8"},
    "dense_insert_bs32": {"kind": "insert", "rows": 32768, "build": 24576,
                          "batch": 32},
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _launches_since(before: dict) -> dict:
    """Kernel launches per wrapper since the snapshot ``before`` (the
    counters are left as they are for the caller's own count)."""
    return {k: v - before[k] for k, v in tri_score.LAUNCHES.items()}


def _stages_ms(timer, before: dict, calls: int) -> dict:
    """Mean ms per call of each ``Timer`` section since ``before``."""
    return {k: (v - before.get(k, 0.0)) / calls * 1e3
            for k, v in timer.totals.items() if v > before.get(k, 0.0)}


def _free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _peak_bytes(device: torch.device):
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else None)


def _log_profile(name: str, prof: dict) -> None:
    log(f"{name}: device idle {prof['device_idle_share']:.1%} of "
        f"{prof['wall_seconds'] * 1e3:.2f} ms traced; top device operations "
        f"(ms): {json.dumps(prof['top_kernels_ms'])}")
    log(f"{name}: longest idle gaps: {json.dumps(prof['idle_gaps'])}")


def join_cell(name: str, device: torch.device, seed: int = 0,
              repeats: int = REPEATS, window: float = WINDOW_SECONDS):
    """The join cell ``name`` of ``CELLS``, timing at least ``repeats``
    joins and at least ``window`` seconds of them: returns its record, its
    corpus and the pair set of its last timed join (row pairs ``i < j``)."""
    spec = CELLS[name]
    cfg = AllPairsConfig(**spec.get("config", {}))
    if spec["kind"] == "chunked":
        def make():
            return ChunkedAllPairs(cfg, device, chunk_dim=spec["chunk_dim"])
    else:
        def make():
            return Engine(cfg, device)
    t0 = time.perf_counter()
    csr = synthetic_corpus(spec["rows"], seed=seed)
    gen_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    eng = make()
    eng.build(csr)
    eng.all_pairs(TAU)  # two warm joins (bench.py:173-178)
    eng.all_pairs(TAU)
    fresh = make()
    t0 = time.perf_counter()
    fresh.build(csr)
    build_s = time.perf_counter() - t0
    del fresh
    _free(device)

    before = dict(eng.timer.totals)
    cand0 = eng.stats["candidates_scored"]
    launches0 = dict(tri_score.LAUNCHES)
    times = []
    while len(times) < repeats or sum(times) < window:
        t0 = time.perf_counter()
        res = eng.all_pairs(TAU)
        times.append(time.perf_counter() - t0)
    joins, total = len(times), float(np.sum(times))
    launches = _launches_since(launches0)
    kernel = spec["kernel"]
    if device.type == "cuda" and launches[kernel] < joins:
        raise AssertionError(f"{name}: {kernel} launched "
                             f"{launches[kernel]} times in {joins} joins")
    stages = _stages_ms(eng.timer, before, joins)
    n = csr.n_rows
    mean = total / joins
    if spec["kind"] == "chunked":
        geom = eng._panel_geom()
        ops, peak_of = join_ops(geom), "int8"
        shape = dict(zip(("rb", "tm", "tn", "n_panels", "d_cap"), geom))
    else:
        # the padded upper triangle's multiply-adds, 2 operations each
        ops = int8_join_ops(eng.row_cap, eng.dim_cap)
        peak_of = "int8" if eng._used_int8 else "bf16"
        shape = {"row_cap": eng.row_cap, "dim_cap": eng.dim_cap}
    peak = card_peaks(torch.cuda.get_device_name(device))[peak_of] if (
        device.type == "cuda") else None
    prof = profile_join(eng, TAU)
    _log_profile(name, prof)
    rec = {
        "rows": n, "corpus": f"synthetic_corpus({n}, seed={seed})",
        **shape, "gen_seconds": gen_s, "build_seconds": build_s,
        "repeats": joins, "seconds_total": total, "seconds_mean": mean,
        "seconds_median": float(np.median(times)),
        "seconds_min": min(times), "seconds_max": max(times),
        "decided_pairs_per_sec": joins * n * (n - 1) / 2 / total,
        "pairs": res.n_pairs,
        "candidates_per_join": (eng.stats["candidates_scored"] - cand0)
        / joins,
        "stages_ms": stages, "kernel": kernel, "launches": launches,
        "ops": ops, "peak": peak_of,
        "mfu_pct": None if peak is None else mfu_pct(ops, mean, peak),
        "max_memory_allocated": _peak_bytes(device), "profile": prof,
        # the traced join's device busy time over the untraced mean
        "device_idle_share_untraced": 1.0 - prof["device_busy_seconds"]
        / mean,
    }
    got = set(zip(res.i.tolist(), res.j.tolist()))
    finite = bool(np.all(np.isfinite(res.sims)))
    del eng, res
    _free(device)
    t0 = time.perf_counter()
    want = batch_oracle([], csr, 0, TAU, device)
    rec["oracle_seconds"] = time.perf_counter() - t0
    rec["parity"] = got == want and finite
    if not rec["parity"]:
        log(f"{name}: PARITY FAILURE: {len(got - want)} extra, "
            f"{len(want - got)} missing of {len(want)} oracle pairs")
    _free(device)
    return rec, csr, got


def insert_cell(name: str, device: torch.device, seed: int = 0,
                window: float = WINDOW_SECONDS):
    """The insert cell ``name`` of ``CELLS``, timing passes, each on a fresh
    engine, until their batches have taken ``window`` seconds in all (one
    pass at least): returns its record, its corpus and the union of the
    last timed pass's pairs."""
    spec = CELLS[name]
    n, n_build, bs = spec["rows"], spec["build"], spec["batch"]
    t0 = time.perf_counter()
    csr = synthetic_corpus(n, seed=seed)
    gen_s = time.perf_counter() - t0
    prefix = csr_rows(csr, 0, n_build)
    starts = list(range(n_build, n, bs))
    batches = [[(str(i), csr.row(i)) for i in range(s, min(s + bs, n))]
               for s in starts]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def fresh():
        eng = Engine(AllPairsConfig(), device)
        t0 = time.perf_counter()
        eng.build(prefix)
        return eng, time.perf_counter() - t0

    def stream(eng):
        times, outs = [], []
        for b in batches:
            t0 = time.perf_counter()
            outs.append(eng.insert(b, tau=TAU))
            times.append(time.perf_counter() - t0)
        return times, [pairs_of(o) for o in outs]

    eng, _ = fresh()
    _, warm_pairs = stream(eng)
    del eng
    _free(device)
    times, passes, stages, builds, pass_s = [], [], {}, [], []
    launches0 = dict(tri_score.LAUNCHES)
    while not passes or sum(pass_s) < window:
        eng, build_s = fresh()
        builds.append(build_s)
        before = dict(eng.timer.totals)
        t, pairs = stream(eng)
        times += t
        pass_s.append(float(np.sum(t)))
        passes.append(pairs)
        for k, v in _stages_ms(eng.timer, before, 1).items():
            stages[k] = stages.get(k, 0.0) + v
        row_cap = eng.row_cap
        del eng
        _free(device)
    launches = _launches_since(launches0)
    if device.type == "cuda" and any(launches.values()):
        raise AssertionError(f"{name}: the inserts launched a join kernel: "
                             f"{launches}")
    eng, _ = fresh()
    prof = profile_insert(eng, batches, TAU)
    _log_profile(name, prof)
    del eng
    _free(device)
    peak = _peak_bytes(device)

    t0 = time.perf_counter()
    want = [batch_oracle([csr_rows(csr, 0, s)],
                         csr_rows(csr, s, min(s + bs, n)), s, TAU, device)
            for s in starts]
    oracle_s = time.perf_counter() - t0
    bad = [k for k in range(len(starts))
           if any(p[k] != want[k] for p in (warm_pairs, *passes))]
    if bad:
        log(f"{name}: PARITY FAILURE in {len(bad)} of {len(starts)} "
            f"batches, first at rows {starts[bad[0]]}-")
    ms = np.asarray(times) * 1e3
    total = float(np.sum(times))
    union = set().union(*passes[-1])
    rec = {
        "rows": n, "corpus": f"synthetic_corpus({n}, seed={seed})",
        "rows_built": n_build, "rows_streamed": n - n_build, "batch": bs,
        "batches": len(batches), "passes": len(passes),
        "samples": len(times), "seconds_total": total,
        "pass_seconds": pass_s, "row_cap": row_cap,
        "gen_seconds": gen_s, "build_seconds": float(np.median(builds)),
        "insert_vectors_per_sec": len(passes) * (n - n_build) / total,
        "insert_p50_ms": float(np.percentile(ms, 50)),
        "insert_p95_ms": float(np.percentile(ms, 95)),
        "insert_min_ms": float(ms.min()), "insert_max_ms": float(ms.max()),
        "stages_ms_per_batch": {k: v / len(times) for k, v in
                                stages.items()},
        "launches": launches, "pairs": len(union),
        "max_memory_allocated": peak, "profile": prof,
        # the traced pass's device busy time over the untraced mean pass
        "device_idle_share_untraced": 1.0
        - prof["device_busy_seconds"] / (total / len(passes)),
        "oracle_seconds": oracle_s, "parity": not bad,
    }
    return rec, csr, union


def run_cell(name: str, device: torch.device, seed: int = 0,
             repeats: int = REPEATS, window: float = WINDOW_SECONDS):
    """Run the cell ``name``, timing at least ``window`` seconds of joins
    or insert passes (and at least ``repeats`` joins): ``(record, corpus,
    pair set)``."""
    if CELLS[name]["kind"] == "insert":
        return insert_cell(name, device, seed, window)
    return join_cell(name, device, seed, repeats, window)


def _summary(name: str, rec: dict) -> str:
    if "insert_p95_ms" in rec:
        return (f"{name}: {rec['passes']} passes of {rec['batches']} "
                f"batches, {rec['insert_vectors_per_sec']:.1f} vectors/s, "
                f"p50 {rec['insert_p50_ms']:.3f} ms, p95 "
                f"{rec['insert_p95_ms']:.3f} ms, {rec['pairs']} pairs, "
                f"parity {rec['parity']}")
    return (f"{name}: {rec['repeats']} joins, mean "
            f"{rec['seconds_mean'] * 1e3:.3f} ms, median "
            f"{rec['seconds_median'] * 1e3:.3f} ms (min "
            f"{rec['seconds_min'] * 1e3:.3f}, max "
            f"{rec['seconds_max'] * 1e3:.3f}), "
            f"{rec['decided_pairs_per_sec']:.4g} decided pairs/s, "
            f"{rec['pairs']} pairs, launches {rec['launches']}, "
            f"parity {rec['parity']}")


def spread(lines: list) -> dict:
    """Per cell and metric over the runs' last lines: the values, their
    relative spread and the bound it sets."""
    out = {}
    for name, rec in lines[0]["cells"].items():
        for metric, higher in METRICS.items():
            if metric not in rec:
                continue
            vals = [line["cells"][name][metric] for line in lines]
            rel = (max(vals) - min(vals)) / float(np.median(vals))
            out.setdefault(name, {})[metric] = {
                "values": vals, "higher_is_better": higher, "spread": rel,
                "bound": max(MIN_BOUND, 2 * rel)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_torch")
    ap.add_argument("--seed", type=int, default=0,
                    help="the corpora's seed (default 0)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--spread", nargs="+", metavar="RUN",
                    help="saved runs' output: print their spread, run "
                    "nothing")
    args = ap.parse_args(argv)
    if args.spread:
        lines = [json.loads(open(p).read().strip().splitlines()[-1])
                 for p in args.spread]
        print(json.dumps({"runs": args.spread, "card": lines[0]["device"],
                          "cells": spread(lines)}))
        return 0
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench_torch.py needs a CUDA device; there "
                               "is no CPU fallback")
        device = torch.device("cuda", 0)
        card = {"name": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count(), "smi": smi_line()}
        log(f"card: {card['smi']}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
    else:
        card = {"name": "cpu", "count": 0, "smi": None}
    t_run = time.perf_counter()
    cells, line = {}, {}
    for name in CELLS:
        t0 = time.perf_counter()
        rec, csr, got = run_cell(name, device, args.seed, REPEATS,
                                 WINDOW_SECONDS)
        rec["cell_seconds"] = time.perf_counter() - t0
        cells[name] = rec
        log(_summary(name, rec))
        if name != HEADLINE:
            continue
        bl = measure_baseline(csr, TAU, max_rows=BASELINE_ROWS)
        m = bl["n_rows"]
        # cross-check (bench.py:225-233): the reference port and the
        # engine agree on the prefix
        bl_pairs = {tuple(sorted((int(a), int(b)))) for a, b in
                    bl["pair_set"]}
        agree = {(a, b) for a, b in got if b < m} == bl_pairs
        log(f"baseline (reference-algorithm port, {m} rows, row-per-call "
            f"basis): {bl['seconds']:.1f} s, "
            f"{bl['decided_pairs_per_sec']:.1f} decided pairs/s, "
            f"{bl['pairs_found']} pairs; prefix agreement {agree}")
        line = {
            "metric": (f"synthetic_corpus_{rec['rows']}_allpairs_decided_"
                       f"pairs_per_sec_tau{TAU}"),
            "value": rec["decided_pairs_per_sec"],
            "unit": "pairs/s",
            "vs_baseline": rec["decided_pairs_per_sec"]
            / bl["decided_pairs_per_sec"],
            "seconds": rec["seconds_mean"],
            "int8_ops": rec["ops"],
            "mfu_pct": rec["mfu_pct"],
            "corpus": rec["corpus"],
            "baseline": {k: bl[k] for k in (
                "n_rows", "seconds", "pairs_found", "decided_pairs_per_sec",
                "timed_out")} | {"prefix_agreement": agree},
        }
        del csr, got
    parity = line["baseline"]["prefix_agreement"] and all(
        c["parity"] for c in cells.values())
    line.update(parity=parity, device=card, cells=cells,
                run_seconds=time.perf_counter() - t_run)
    print(json.dumps(line), flush=True)
    if not parity:
        log("PARITY FAILURE: the benchmark is invalid")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
