"""Full benchmark suite — one entry per BASELINE.json config (the
counterpart of ``apsim_tpu/bench/suite.py``).

  1. batch build + all-pairs join, single device
  2. threshold sweep tau=0.5..0.9 with exact pair-set parity checks
  3. streaming mode: micro-batched inserts matched online
  4. top-k (k=10) queries over the static index
  5. sharded engine over a device mesh (every visible card by default)
  6. the CC_WEB-format load generator against a live server
  7. a second corpus shape (RCV1-like) through both engine flavors

Emits a JSON report; every config re-verifies exactness against the fp64
oracle (prefix-bounded where the full oracle would be too large).  A leg
that raises is recorded as ``{"error": ...}`` (the reference's report
format); ``failures`` lists every such leg and every parity flag that is
not true, and ``main`` exits non-zero when there is one.

Usage:  python -m apsim_tpu_torch.bench.suite [--enron ROOT]
        [--device {cuda,cpu}]

Without ``--enron`` the suite runs on ``synthetic_corpus(8586, seed=0)``
(the Enron slice's row count); ``report["corpus"]`` names the corpus.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.engine import Engine
from ..vector.batch import CSRMatrix

__all__ = ["run_suite", "failures", "main"]

# the report's exactness flags: each must be true
PARITY_FLAGS = ("parity_full", "parity_prefix", "dense_parity",
                "chunked_parity", "equals_batch_join",
                "matches_single_device")


def _oracle_pairs(csr: CSRMatrix, tau: float, limit: int | None = None):
    """fp64 brute-force pair set over the first ``m`` rows (all rows when
    ``limit`` is None).  Sparse×sparse fp64 spGEMM, so the parity gate
    covers the whole corpus, not a prefix.  scipy is optional for the
    package: without it a blocked pure-NumPy product gives the same set."""
    m = csr.n_rows if limit is None else min(csr.n_rows, limit)
    nnz_m = int(csr.indptr[m])
    try:
        import scipy.sparse as sp
    except ImportError:
        active = np.unique(csr.indices[:nnz_m])
        remap = np.full(csr.n_cols, -1, np.int64)
        remap[active] = np.arange(active.size)
        dense = np.zeros((m, active.size))
        for r in range(m):
            s, e = int(csr.indptr[r]), int(csr.indptr[r + 1])
            dense[r, remap[csr.indices[s:e]]] = csr.data[s:e]
        pairs = set()
        blk = 1024  # bound the fp64 score block to ~m*blk*8 bytes
        for r0 in range(0, m, blk):
            s_blk = dense[r0 : r0 + blk] @ dense.T
            oi, oj = np.nonzero(s_blk >= tau)
            for a, b in zip((oi + r0).tolist(), oj.tolist()):
                if a < b:
                    pairs.add((a, b))
        return pairs, m
    a = sp.csr_matrix(
        (csr.data[:nnz_m], csr.indices[:nnz_m], csr.indptr[: m + 1]),
        shape=(m, csr.n_cols),
    )
    s_mat = (a @ a.T).tocoo()
    keep = (s_mat.data >= tau) & (s_mat.row < s_mat.col)
    return (
        set(zip(s_mat.row[keep].tolist(), s_mat.col[keep].tolist())),
        m,
    )


def _ccweb_loadgen_leg(n_vectors: int = 64, dim: int = 512,
                       device: torch.device | str = "cuda") -> Dict:
    """Generate a synthetic CC_WEB-format fixture, serve it in-process and
    drive the LoadGenerator protocol over RPC.  Returns the loadgen latency
    report + fixture stats."""
    import os
    import tempfile

    from ..etl.ccweb import load_ccweb_file
    from ..serve import ClientConnection, RpcServer, SimilarityServer
    from .loadgen import LoadGenerator

    rng = np.random.default_rng(12)
    lines = []
    for i in range(n_vectors):
        dense = np.zeros(dim)
        if i % 4 == 3:  # every 4th vector repeats -> guaranteed pairs
            dense[:4] = [0.5, 0.25, 0.125, 0.0625]
        else:
            nz = rng.choice(dim, size=8, replace=False)
            dense[nz] = rng.uniform(0.2, 1.0, size=8)
        feats = ",".join(f"{x:.6f}" for x in dense)
        lines.append(f"(v{i},{dim},[{feats}])")
    fd, path = tempfile.mkstemp(suffix=".ccweb.txt")
    try:
        with os.fdopen(fd, "w") as f:
            f.write("\n".join(lines) + "\n")
        vectors = load_ccweb_file(path)
        cfg = AllPairsConfig(
            vector_dim=dim, query_tile=64, row_bucket=64, dim_bucket=512,
            similarity_threshold=0.9, io_trigger_period_ms=5,
        )
        sim = SimilarityServer(Engine(cfg, device), cfg, device=device)
        with RpcServer(sim, port=0) as rpc:
            cc = ClientConnection([f"{rpc.host}:{rpc.port}"])
            try:
                rep = LoadGenerator(
                    cc, vectors, total_message_count=16, children_num=2,
                    write_batching_ms=1, timeout_s=60.0,
                ).run()
            finally:
                cc.close()
        rep["fixture_vectors"] = n_vectors
        rep["indexed_after_warmup"] = sim.engine.n_rows
        return rep
    finally:
        os.unlink(path)


def _rcv1_shape_leg(n_rows: int = 4096, taus=(0.7, 0.8),
                    device: torch.device | str = "cuda") -> Dict:
    """Parity of both engine flavors on the RCV1-shaped corpus (flatter df
    curve, ln-TF·IDF values — scale.rcv1_like_corpus) vs the fp64 oracle."""
    from ..engine.chunked import ChunkedAllPairs
    from .scale import rcv1_like_corpus

    csr = rcv1_like_corpus(n_rows)
    out: Dict = {"n_rows": n_rows, "nnz": int(csr.indptr[-1])}
    eng = Engine(AllPairsConfig(), device)
    eng.build(csr)
    ch = ChunkedAllPairs(AllPairsConfig(), device)
    ch.build(csr)
    for tau in taus:
        want, _ = _oracle_pairs(csr, tau)
        t0 = time.perf_counter()
        res = eng.all_pairs(tau)
        dt = time.perf_counter() - t0
        cres = ch.all_pairs(tau)
        out[f"tau_{tau}"] = {
            "pairs": res.n_pairs,
            "dense_parity": {
                (int(a), int(b)) for a, b in zip(res.i, res.j)
            } == want,
            "chunked_parity": {
                (int(a), int(b)) for a, b in zip(cres.i, cres.j)
            } == want,
            "dense_join_seconds": dt,
        }
    return out


def run_suite(
    csr: CSRMatrix,
    ids: List[str],
    taus=(0.5, 0.6, 0.7, 0.8, 0.9),
    oracle_limit: int | None = None,
    stream_batch: int = 256,
    topk_queries: int = 1024,
    mesh: bool = True,
    device: torch.device | str = "cuda",
    mesh_devices=None,
) -> Dict:
    """Every leg on ``device`` (the card unless the caller names the CPU);
    the mesh leg over ``mesh_devices`` (default: every visible card through
    ``make_mesh()``, which raises without CUDA).  Times are host clock
    around calls that end in host arrays."""
    dev = torch.device(device)
    report: Dict = {
        "n_rows": csr.n_rows, "nnz": int(csr.indptr[-1]),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    n = csr.n_rows
    decided = n * (n - 1) / 2

    # ---- 1+2: batch build + join, threshold sweep with parity -------------
    eng = Engine(AllPairsConfig(), dev)
    t0 = time.perf_counter()
    eng.build(csr, ids)
    report["build_seconds"] = time.perf_counter() - t0
    sweep = {}
    batch_pairs = None
    for tau in taus:
        eng.all_pairs(tau)  # two warm joins, then the timed third
        eng.all_pairs(tau)
        t0 = time.perf_counter()
        res = eng.all_pairs(tau)
        dt = time.perf_counter() - t0
        if abs(tau - 0.8) < 1e-9:
            batch_pairs = res
        want, m = _oracle_pairs(csr, tau, oracle_limit)
        got = {
            (int(a), int(b)) for a, b in zip(res.i, res.j) if a < m and b < m
        }
        full = m == csr.n_rows
        sweep[str(tau)] = {
            "pairs": res.n_pairs,
            "seconds": dt,
            "decided_pairs_per_sec": decided / dt,
            ("parity_full" if full else "parity_prefix"): got == want,
        }
    report["threshold_sweep"] = sweep
    tau = 0.8
    if batch_pairs is None:
        batch_pairs = eng.all_pairs(tau)

    # ---- 4: top-k ----------------------------------------------------------
    k = 10
    nq = min(topk_queries, n)
    queries = [(f"q{i}", csr.row(i)) for i in range(nq)]
    eng.topk(queries, k)  # warm
    t0 = time.perf_counter()
    res = eng.topk(queries, k)
    dt = time.perf_counter() - t0
    self_ok = sum(1 for i in range(nq) if res[f"q{i}"][0][1] >= 0.999)
    report["topk"] = {
        "k": k,
        "queries": nq,
        "seconds": dt,
        "queries_per_sec": nq / dt,
        "self_match_rate": self_ok / nq,
    }
    # free this engine's index before the streaming phase: the setter drops
    # its cached int8 and bf16 operand copies with it, so the allocator can
    # hand their memory to the streaming engine's index
    eng.x = None

    # ---- 3: streaming ------------------------------------------------------
    eng_s = Engine(AllPairsConfig(), dev)
    emitted = 0
    emitted_set = set()
    t_batches: List[float] = []
    rates: List[float] = []
    for s in range(0, n, stream_batch):
        e = min(s + stream_batch, n)
        batch = [(ids[i], csr.row(i)) for i in range(s, e)]
        t0 = time.perf_counter()
        out = eng_s.insert(batch, tau=tau)
        dt = time.perf_counter() - t0
        t_batches.append(dt)
        rates.append((e - s) / dt)
        for q, sims in out.output.items():
            emitted += len(sims)
            for c in sims:
                emitted_set.add((q, c) if q <= c else (c, q))
    # EXACT unordered-pair-set equality with the batch join — a weak
    # `emitted >= n_pairs` would pass on spurious extra pairs
    stream_ok = emitted_set == batch_pairs.pair_set()
    t_total = float(sum(t_batches))
    report["streaming"] = {
        "batch_size": stream_batch,
        "vectors_per_sec": n / t_total,
        # the end-to-end average includes the batches that grow the index
        # (a new capacity re-allocates and re-copies it); the median
        # per-batch rate is the steady-state figure
        "median_batch_seconds": float(np.median(t_batches)),
        "steady_vectors_per_sec": float(np.median(rates)),
        "seconds_total": t_total,
        "results_emitted": emitted,
        "equals_batch_join": stream_ok,
    }
    eng_s.x = None

    # ---- 7: second corpus shape ----------------------------------------------
    # RCV1-shaped synthetic through BOTH engine flavors with full fp64
    # oracle parity — the margin/quantization machinery and the chunked
    # path verified beyond the power-law synthetic
    try:
        report["rcv1_shape"] = _rcv1_shape_leg(device=dev)
    except Exception as e:  # the suite must survive a leg failure
        report["rcv1_shape"] = {"error": repr(e)[:200]}

    # ---- 6: CC_WEB-format loadgen end-to-end --------------------------------
    # generate a synthetic CC_WEB fixture (the real dataset's line format,
    # CCWEBVideoLoadGenerator.scala:8-30), serve it, and run the stamped
    # warmup -> freeze -> replay benchmark against the live server
    try:
        report["ccweb_loadgen"] = _ccweb_loadgen_leg(device=dev)
    except Exception as e:  # the suite must survive a serving-leg failure
        report["ccweb_loadgen"] = {"error": repr(e)[:200]}

    # ---- 5: mesh-sharded ---------------------------------------------------
    if mesh:
        from ..parallel import MeshEngine, make_mesh

        m_eng = MeshEngine(AllPairsConfig(),
                           mesh=make_mesh(devices=mesh_devices))
        m_eng.build(csr, ids)
        m_eng.all_pairs(0.8)  # two warm joins, then the timed third
        m_eng.all_pairs(0.8)
        t0 = time.perf_counter()
        mres = m_eng.all_pairs(0.8)
        dt = time.perf_counter() - t0
        report["mesh"] = {
            "devices": m_eng.n_shards,
            "shard_axis": m_eng.cfg.shard_axis,
            "pairs": mres.n_pairs,
            "seconds": dt,
            "decided_pairs_per_sec": decided / dt,
            "matches_single_device": mres.pair_set() == batch_pairs.pair_set(),
        }
    return report


def failures(report: Dict) -> List[str]:
    """What of ``report`` is not right: every leg that holds ``"error"``,
    every parity flag that is not true (at any depth, by its path), and a
    top-k self-match rate below 1."""
    bad: List[str] = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        for key, val in node.items():
            where = f"{path}.{key}" if path else str(key)
            if key == "error":
                bad.append(f"{where}: {val}")
            elif key in PARITY_FLAGS and val is not True:
                bad.append(f"{where} is {val}")
            walk(val, where)

    walk(report, "")
    rate = report.get("topk", {}).get("self_match_rate")
    if rate is not None and rate != 1.0:
        bad.append(f"topk.self_match_rate is {rate}")
    return bad


def main(argv=None) -> int:
    """Run the suite, print its JSON report; 1 when ``failures`` finds
    anything, else 0."""
    import sys

    ap = argparse.ArgumentParser(prog="suite")
    ap.add_argument("--enron", default=None, metavar="ROOT",
                    help="the Enron maildir root (default: the synthetic "
                         "corpus of Enron's row count)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.enron:
        from .data import load_enron_tfidf

        csr, ids = load_enron_tfidf(args.enron)
        corpus = f"enron {args.enron}"
    else:
        from .scale import synthetic_corpus

        csr = synthetic_corpus(8586, seed=0)
        ids = [str(i) for i in range(csr.n_rows)]
        corpus = "synthetic_corpus(8586, seed=0)"
    mesh_devices = ["cpu"] if args.device == "cpu" else None
    report = run_suite(csr, ids, device=args.device,
                       mesh_devices=mesh_devices)
    report["corpus"] = corpus
    report["failures"] = failures(report)
    json.dump(report, sys.stdout, indent=2)
    print()
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
