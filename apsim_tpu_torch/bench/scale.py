"""Synthetic scale benchmark: corpus sizes beyond Enron (the counterpart
of ``apsim_tpu/bench/scale.py``).

The corpora are copies of the JAX package's (NumPy only): TF-IDF-shaped
data, power-law dim popularity, L2-normalized, with a controllable
near-duplicate rate so thresholded joins have hits.  The same seed gives
the same corpus in both packages.  ``run_scale`` measures build + warm
all-pairs at increasing row counts on the card and reports decided
pairs/s and the int8 utilization per size.

Usage:  python -m apsim_tpu_torch.bench.scale [n_rows ...] [--device cpu]
        [--seed N]
"""

from __future__ import annotations

import json
import time
from typing import Dict, Sequence

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.engine import Engine
from ..vector.batch import CSRMatrix
from .mfu import card_peaks, int8_join_ops, mfu_pct

__all__ = ["synthetic_corpus", "rcv1_like_corpus", "run_scale"]


def synthetic_corpus(
    n_rows: int,
    n_dims: int = 1 << 20,
    active_dims: int = 32768,
    nnz_mean: int = 120,
    dup_rate: float = 0.02,
    seed: int | Sequence[int] = 0,
) -> CSRMatrix:
    """Power-law sparse corpus: dim d is sampled ∝ 1/(d+10); ``dup_rate`` of
    rows are exact copies of earlier rows (guaranteed tau≈1 pairs).
    ``seed`` is anything ``np.random.default_rng`` takes."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / (np.arange(active_dims) + 10.0)
    weights /= weights.sum()
    # vectorized draw: one flat power-law sample for the whole corpus
    # (inverse-CDF on uniform draws), then per-row unique-dim dedup via a
    # (row, dim) sort
    nnz_row = np.maximum(4, rng.poisson(nnz_mean, size=n_rows))
    total = int(nnz_row.sum())
    cdf = np.cumsum(weights)
    draws = np.searchsorted(cdf, rng.random(total)).astype(np.int64)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_row)
    key = row_of * active_dims + draws
    key = np.unique(key)  # sorts by (row, dim) and dedups within rows
    row_of = key // active_dims
    dims = (key % active_dims).astype(np.int32)
    vals = rng.random(dims.size) + 0.05
    counts = np.bincount(row_of, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    # L2-normalize per row
    sq = np.zeros(n_rows)
    np.add.at(sq, row_of, vals * vals)
    vals = vals / np.sqrt(sq)[row_of]
    csr = CSRMatrix(n_rows, n_dims, indptr, dims, vals.astype(np.float64))
    return _inject_dups(csr, dup_rate, rng)


def _inject_dups(csr: CSRMatrix, dup_rate: float, rng) -> CSRMatrix:
    """Overwrite ``dup_rate`` of rows with copies of earlier rows
    (guaranteed tau≈1 pairs for the parity legs), vectorized.

    Row r copies ``src_of[r]``; chains (a dup whose source is itself a dup)
    resolve by pointer-jumping, which terminates because sources are
    strictly smaller row ids."""
    n_rows, n_dims = csr.n_rows, csr.n_cols
    n_dup = int(n_rows * dup_rate)
    if n_dup == 0:
        return csr
    dup_dst = np.sort(rng.choice(np.arange(1, n_rows), size=n_dup, replace=False))
    dup_src = rng.integers(0, dup_dst)
    src_of = np.arange(n_rows, dtype=np.int64)
    src_of[dup_dst] = dup_src
    while True:
        nxt = src_of[src_of]
        if np.array_equal(nxt, src_of):
            break
        src_of = nxt
    counts = np.diff(csr.indptr)[src_of]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    pos = np.arange(indptr[-1]) - np.repeat(indptr[:-1], counts)
    src_flat = np.repeat(csr.indptr[src_of], counts) + pos
    return CSRMatrix(
        n_rows, n_dims, indptr, csr.indices[src_flat], csr.data[src_flat]
    )


def rcv1_like_corpus(
    n_rows: int,
    n_dims: int = 1 << 20,
    active_dims: int = 47_236,
    seed: int = 0,
    dup_rate: float = 0.01,
) -> CSRMatrix:
    """RCV1-shaped synthetic corpus: ~47k-term vocabulary, log-normal
    document lengths around ~75 terms, a FLATTER df curve than web text
    (Zipf s≈0.7, offset 25), ln-TF·IDF values, L2-normalized."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / (np.arange(active_dims) + 25.0) ** 0.7
    weights /= weights.sum()
    nnz_row = np.clip(
        rng.lognormal(np.log(60.0), 0.6, size=n_rows), 4, 600
    ).astype(np.int64)
    total = int(nnz_row.sum())
    cdf = np.cumsum(weights)
    draws = np.searchsorted(cdf, rng.random(total)).astype(np.int64)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_row)
    key = np.unique(row_of * active_dims + draws)
    row_of = key // active_dims
    dims = (key % active_dims).astype(np.int32)
    # ln-TF·IDF: tf ~ geometric-ish (most terms appear once), idf rises
    # with dim rank (rarer dim index => larger idf)
    tf = 1.0 + rng.standard_exponential(dims.size)
    idf = np.log(2.0 + dims.astype(np.float64))
    vals = (1.0 + np.log(tf)) * idf
    counts = np.bincount(row_of, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    sq = np.zeros(n_rows)
    np.add.at(sq, row_of, vals * vals)
    vals = vals / np.sqrt(sq)[row_of]
    csr = CSRMatrix(n_rows, n_dims, indptr, dims, vals.astype(np.float64))
    return _inject_dups(csr, dup_rate, rng)


def run_scale(sizes=(10_000, 25_000, 50_000), tau: float = 0.8,
              device: torch.device | str = "cuda", seed: int = 0) -> Dict:
    """Build + warm join of ``synthetic_corpus(n, seed)`` for each ``n``: the
    third ``all_pairs(tau)`` is timed (host clock; it ends in host numpy
    arrays).  On the card each record carries the end-to-end utilization
    of the card's int8 peak; a CPU run reports ``mfu_pct`` None."""
    dev = torch.device(device)
    peak = card_peaks(torch.cuda.get_device_name(dev))["int8"] if (
        dev.type == "cuda") else None
    report: Dict = {"device": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu")}
    for n in sizes:
        t0 = time.perf_counter()
        csr = synthetic_corpus(n, seed=seed)
        gen_s = time.perf_counter() - t0
        eng = Engine(AllPairsConfig(), dev)
        t0 = time.perf_counter()
        eng.build(csr)
        build_s = time.perf_counter() - t0
        eng.all_pairs(tau)  # two warm joins, then the timed third
        eng.all_pairs(tau)
        t0 = time.perf_counter()
        res = eng.all_pairs(tau)
        join_s = time.perf_counter() - t0
        decided = n * (n - 1) / 2
        ops = int8_join_ops(eng.row_cap, eng.dim_cap)
        report[str(n)] = {
            "gen_seconds": gen_s,
            "build_seconds": build_s,
            "join_seconds": join_s,
            "pairs": res.n_pairs,
            "decided_pairs_per_sec": decided / join_s,
            "row_cap": eng.row_cap,
            "dim_cap": eng.dim_cap,
            "index_gb": eng.row_cap * eng.dim_cap * 4 / 1e9,
            # efficiency-per-size curve: end-to-end utilization of the
            # card's int8 peak, compaction/D2H/rescore included
            "int8_ops": ops,
            "mfu_pct": None if peak is None else mfu_pct(ops, join_s, peak),
        }
        del eng, res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return report


if __name__ == "__main__":
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="scale")
    ap.add_argument("sizes", type=int, nargs="*",
                    default=[10_000, 25_000, 50_000])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    json.dump(run_scale(tuple(args.sizes), device=args.device,
                        seed=args.seed), sys.stdout, indent=2)
    print()
