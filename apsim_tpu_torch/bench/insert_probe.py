"""Streaming-insert latency attribution for the dense engine on the card
(the counterpart of ``apsim_tpu/bench/insert_probe.py``).

Decomposes one micro-batch insert (``Engine.insert(..., defer=True)``)
into:

  - enqueue:   the deferred insert call returning (host prepare, the H2D
    of the batch, the append and the match on the device; ``torch.nonzero``
    waits for the match, so the device work ends inside this call);
  - complete:  ``PendingInsert.result()`` (the D2H of the exact-length
    candidate lists + fp64 rescore + emission).

Then a one-deep pipeline (enqueue batch N+1 before completing batch N, the
server's ingest drain).  ``--stages`` splits ``complete`` into fetch (the
candidate lists' D2H) and emit (``_emit_query_results``); there is no
parse stage, since the candidate lists arrive exact-length (no packed head
to decode).  Last, the card's link floors: a 4-byte D2H and a 4-byte H2D,
each ending in a synchronize.  Host clock throughout: every timed call
ends with its device work finished.

Usage:  python -m apsim_tpu_torch.bench.insert_probe [n_index_rows]
        [--stages] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.engine import Engine
from .scale import synthetic_corpus

__all__ = ["main"]

REPS = 9  # timed batches per batch size (the pipelined run takes 8)


def _med_ms(v) -> float:
    return float(np.median(v)) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="insert_probe")
    ap.add_argument("n_rows", type=int, nargs="?", default=20_000)
    ap.add_argument("--stages", action="store_true",
                    help="split complete() into fetch and emit")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    tau = 0.8
    n_rows = args.n_rows
    report = {"n_rows": n_rows, "device": (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")}

    csr = synthetic_corpus(n_rows)
    eng = Engine(AllPairsConfig(), dev)
    t0 = time.perf_counter()
    eng.build(csr)
    report["build_s"] = time.perf_counter() - t0
    print(f"build({n_rows}): {report['build_s']:.1f}s", flush=True)

    extra = synthetic_corpus(8192, seed=7)
    cursor = 0

    def take(k):
        nonlocal cursor
        batch = [
            (f"p{cursor + i}", extra.row(cursor + i)) for i in range(k)
        ]
        cursor += k
        return batch

    report["unpipelined"] = {}
    for bs in (1, 32, 256):
        # the first batch of a size pays cuBLAS's heuristics and the
        # allocator's first allocations at that size: not timed
        eng.insert(take(bs), tau=tau, defer=True).result()
        enq, comp, tot = [], [], []
        for _ in range(REPS):
            batch = take(bs)
            t0 = time.perf_counter()
            pend = eng.insert(batch, tau=tau, defer=True)
            t1 = time.perf_counter()
            pend.result()
            t2 = time.perf_counter()
            enq.append(t1 - t0)
            comp.append(t2 - t1)
            tot.append(t2 - t0)
        rec = {"enqueue_ms": _med_ms(enq), "complete_ms": _med_ms(comp),
               "total_ms": _med_ms(tot)}
        rec["vectors_per_s"] = bs / (rec["total_ms"] / 1e3)
        report["unpipelined"][bs] = rec
        print(
            f"bs={bs:4d}: enqueue {rec['enqueue_ms']:6.2f} ms | complete "
            f"{rec['complete_ms']:6.2f} ms | total {rec['total_ms']:6.2f} ms "
            f"({rec['vectors_per_s']:.0f} vec/s)",
            flush=True,
        )
    # pipelined throughput: enqueue batch N+1 before completing batch N
    # (the server's one-tick-deep drain) — shows how much of the latency
    # the pipeline actually hides
    bs, n_b = 256, REPS - 1
    t0 = time.perf_counter()
    prev = None
    for _ in range(n_b):
        cur = eng.insert(take(bs), tau=tau, defer=True)
        if prev is not None:
            prev.result()
        prev = cur
    prev.result()
    dt = time.perf_counter() - t0
    report["pipelined"] = {"batch_size": bs, "ms_per_batch": dt / n_b * 1e3,
                           "vectors_per_s": bs * n_b / dt}
    print(
        f"pipelined bs={bs}: {dt / n_b * 1e3:.2f} ms/batch "
        f"({bs * n_b / dt:.0f} vec/s)",
        flush=True,
    )

    # ---- result() stage decomposition (--stages): where does `complete`
    # go?  Fetch (the candidate lists' D2H) and emit (fp64 rescore + output
    # shaping).  Uses PendingInsert internals — a probe, not API.
    if args.stages:
        report["stages"] = {}
        for sbs in (1, 256):
            eng.insert(take(sbs), tau=tau, defer=True).result()  # warm
            f_t, e_t, n_cand = [], [], []
            for _ in range(REPS):
                pend = eng.insert(take(sbs), tau=tau, defer=True)
                if getattr(pend, "_e", None) is None:
                    continue  # admission dropped the whole batch
                _, rows, cols, tau_ = pend._e
                t0 = time.perf_counter()
                rows_h, cols_h = rows.cpu().numpy(), cols.cpu().numpy()
                t1 = time.perf_counter()
                eng._emit_query_results(cols_h, rows_h, tau_)
                t2 = time.perf_counter()
                f_t.append(t1 - t0)
                e_t.append(t2 - t1)
                n_cand.append(rows_h.size)
            rec = {"fetch_ms": _med_ms(f_t), "emit_ms": _med_ms(e_t),
                   "candidates": int(np.median(n_cand))}
            report["stages"][sbs] = rec
            print(
                f"stages bs={sbs:4d}: fetch {rec['fetch_ms']:6.3f} ms | emit "
                f"{rec['emit_ms']:6.3f} ms ({rec['candidates']} candidates; "
                f"no parse stage: the lists arrive exact-length)",
                flush=True,
            )

    # ---- the card's link floors: the insert's serialized link legs are
    # the batch's H2D and the candidates' D2H; a 4-byte copy each way,
    # each ending in a synchronize, prices their fixed cost
    if dev.type == "cuda":
        one = torch.zeros(1, dtype=torch.int32, device=dev)
        host_one = torch.zeros(1, dtype=torch.int32)
        one.cpu()
        d2h, h2d = [], []
        for _ in range(REPS):
            t0 = time.perf_counter()
            one.cpu()
            d2h.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            host_one.to(dev)
            torch.cuda.synchronize(dev)
            h2d.append(time.perf_counter() - t0)
        report["link_floor_ms"] = {"d2h": _med_ms(d2h), "h2d": _med_ms(h2d)}
        print(
            f"card link floors: D2H {report['link_floor_ms']['d2h']:.4f} ms, "
            f"H2D {report['link_floor_ms']['h2d']:.4f} ms (4 bytes each)",
            flush=True,
        )
    print(json.dumps({"insert_probe": report}), flush=True)
    return report


if __name__ == "__main__":
    main()
