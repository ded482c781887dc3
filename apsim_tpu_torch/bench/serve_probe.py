"""Server-level streaming-capacity probe at out-of-core scale on the card
(the counterpart of ``apsim_tpu/bench/serve_probe.py``).

Drives the real :class:`SimilarityServer` (ingest queue + IOTrigger
flusher, the WriteWorkerActor.scala:52-57 semantics) over a
``ChunkedAllPairs`` index (default 500k rows) under a Poisson arrival
process.  The mechanism under test: when the per-batch service cost has a
large fixed component, a backlog makes the flush tick flatten MORE queued
vectors into ONE insert, so the effective batch size — and with it
throughput — grows until the service rate meets the arrival rate.

Phases:
  1. build the synthetic index;
  2. warm the batch sizes the coalescing flusher will hit (256 doubling to
     ``max_flush_batch``);
  3. for each offered rate, replay a Poisson arrival schedule through
     ``insert_new_vectors`` and sample the queue depth every 5 s.

Output: one JSON record per offered rate with the sustained service rate
(vectors indexed per second over the phase), the queue-depth samples, the
flush batch sizes and every flush's ``(t_rel_s, n_rows, seconds)``; then
the whole report.  ``kept_up`` (the drain after the last arrival took
under 15 % of the phase) at >= 1000 vec/s is the done-criterion.

Usage: python -m apsim_tpu_torch.bench.serve_probe [n_rows]
       [--rates 500,1000,1500] [--duration 60] [--flush-cap N] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.chunked import ChunkedAllPairs
from ..serve.server import SimilarityServer
from .scale import synthetic_corpus

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="serve_probe")
    ap.add_argument("n_rows", type=int, nargs="?", default=500_000)
    ap.add_argument("--rates", default="1000,1500",
                    help="offered rates, vectors/s, comma separated")
    ap.add_argument("--duration", type=float, default=60.0,
                    help="seconds of arrivals per rate")
    ap.add_argument("--flush-cap", type=int, default=None,
                    help="max_flush_batch (default: the config's)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    n_rows, duration = args.n_rows, args.duration
    rates = [float(r) for r in args.rates.split(",")]

    csr = synthetic_corpus(n_rows)
    cfg = AllPairsConfig()
    if args.flush_cap is not None:
        cfg = cfg.replace(max_flush_batch=args.flush_cap)
    eng = ChunkedAllPairs(cfg, dev)
    t0 = time.perf_counter()
    eng.build(csr)
    print(f"build({n_rows}): {time.perf_counter() - t0:.1f}s", flush=True)

    # arrival material: enough rows for every phase, same distribution.
    # PRE-MATERIALIZED vector objects: building CSR-row slices inside the
    # arrival loop would steal interpreter time from the flusher thread and
    # read as server slowness.  A real client is a different machine; the
    # probe measures the SERVER.
    need = int(sum(rates) * duration * 1.2) + 20_000
    extra = synthetic_corpus(need, seed=11)
    t0 = time.perf_counter()
    material = [(f"s{i}", extra.row(i)) for i in range(need)]
    print(f"arrival materialization({need}): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    cursor = 0

    def take(k: int):
        nonlocal cursor
        batch = material[cursor : cursor + k]
        cursor += k
        return batch

    srv = SimilarityServer(eng, eng.cfg, device=dev)
    srv.start()

    # per-batch flush timeline: every engine.insert the flusher issues is
    # recorded as (t_rel_s, n_rows, dur_s) so a mid-phase stall (a
    # capacity growth, a route change) is attributable to its exact batch
    # instead of reading as generic queue collapse.  The chunked engine
    # completes deferred inserts synchronously, so the wrapper's duration
    # IS the full batch cost.
    timeline: list = []
    t_base = time.perf_counter()
    real_insert = eng.insert

    def timed_insert(batch, **kw):
        t0 = time.perf_counter()
        out = real_insert(batch, **kw)
        timeline.append((round(t0 - t_base, 2), len(batch),
                         round(time.perf_counter() - t0, 4)))
        return out

    eng.insert = timed_insert

    # phase 2: warm the batch sizes the coalescing flusher will hit: the
    # first insert of a size pays cuBLAS's heuristic choice and the caching
    # allocator's first allocations at that size, which would stall
    # service mid-run and read as collapse
    t0 = time.perf_counter()
    top = eng.cfg.max_flush_batch if eng.cfg.max_flush_batch > 0 else 8192
    bs = 256
    while bs <= top:
        srv.insert_new_vectors(take(bs))
        srv.flush()
        bs *= 2
    print(f"batch-size warm-up to {top}: {time.perf_counter() - t0:.1f}s",
          flush=True)
    print(json.dumps({"warmup_timeline": list(timeline)}), flush=True)

    report = {
        "n_rows": n_rows, "duration_s": duration,
        "max_flush_batch": eng.cfg.max_flush_batch, "phases": [],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    try:
        for rate in rates:
            rng = np.random.default_rng(int(rate))
            # Poisson process, replayed in 50 ms pulses (the generator must
            # not become the bottleneck: per-vector timing at 1500/s would
            # spend more time in sleep jitter than the server in service)
            pulse = 0.05
            n_total = int(rate * duration)
            arrivals = np.sort(rng.uniform(0.0, duration, size=n_total))
            stats0 = dict(eng.stats)
            tl0 = len(timeline)
            q_depth = []
            done = threading.Event()

            def sampler():
                while not done.wait(5.0):
                    q_depth.append(
                        sum(len(b) for _, b in list(srv._queue.queue))
                    )

            st = threading.Thread(target=sampler, daemon=True)
            st.start()
            t_start = time.perf_counter()
            sent = 0
            while sent < n_total:
                now = time.perf_counter() - t_start
                k = int(np.searchsorted(arrivals, now + pulse)) - sent
                if k > 0:
                    srv.insert_new_vectors(take(k))
                    sent += k
                time.sleep(pulse)
            # drain phase: let the server finish the backlog
            t_sent = time.perf_counter()
            srv.flush()
            t_end = time.perf_counter()
            done.set()
            st.join(6)
            indexed = (eng.stats["vectors_indexed"]
                       - stats0["vectors_indexed"])
            batches = eng.stats["insert_batches"] - stats0["insert_batches"]
            phase = {
                "offered_rate": rate,
                "offered_vectors": n_total,
                "indexed": int(indexed),
                "arrival_window_s": t_sent - t_start,
                "total_s": t_end - t_start,
                "drain_tail_s": t_end - t_sent,
                "sustained_vec_per_s": indexed / (t_end - t_start),
                "flush_batches": int(batches),
                "mean_flush_batch": indexed / max(batches, 1),
                "queue_depth_samples": q_depth,
                "kept_up": bool(t_end - t_sent < 0.15 * duration),
                "flush_timeline": timeline[tl0:],
            }
            report["phases"].append(phase)
            print(json.dumps(phase), flush=True)
    finally:
        srv.close()
    print(json.dumps({"serve_probe": report}), flush=True)
    return report


if __name__ == "__main__":
    main()
