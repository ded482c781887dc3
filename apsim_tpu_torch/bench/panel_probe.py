"""Rolling-sweep attribution probe for the out-of-core panel join on the
card (the counterpart of ``apsim_tpu/bench/panel_probe.py``).

Builds one synthetic corpus, then (with the panel state cached in-process)
times the join's constituent device ops and re-runs the join under
different rolling-sweep shapes, so the sweep constants
(``ChunkedAllPairs._panel_B_cap``, ``_panel_sweep_bytes``,
``_panel_resident_bytes`` and the ``_panel_geom`` cost model) can be
calibrated on the card from measurement:

  - the join twice (warm-up, then timed; host clock, it ends in host
    arrays) beside its bound: the int8 operations of the padded join
    (``mfu.int8_join_ops``) over the card's int8 peak;
  - the slab build per panel and one off-diagonal panel pair (kernel 3 +
    the pair's compaction), each ending in a synchronize; then an
    off-diagonal and a diagonal pair end to end and their kernel alone
    (CUDA events, median of 5): the overhead a pair adds beyond its kernel
    and the kernel's rate in multiply-adds per second, the two figures of
    the ``_panel_geom`` cost model;
  - when the slabs exceed the resident budget (the rolling sweep), the join
    at several ``B`` (row panels resident for one scan over the column
    panels; the in-flight bound is raised to hold ``B`` + 1 slabs) and at
    panels twice as tall.  The sweep varies ``B`` only: the JAX package's
    fetch cadence (``_panel_jsync_cap``) has no counterpart here, since
    every panel pair's candidate lists come back exact-length.

Usage:  python -m apsim_tpu_torch.bench.panel_probe [n_rows] [--joins-only]
        [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.chunked import ChunkedAllPairs
from ..ops import panel as panel_ops
from .mfu import card_peaks, int8_join_ops
from .scale import synthetic_corpus

__all__ = ["main", "B_SWEEP"]

B_SWEEP = (1, 2, 4, 6, 8, 12, 16)  # capped at the panel count


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, dev, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs: CUDA events on
    the card, the host clock on the CPU."""
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def pair_split(eng, state, xi, xj, tau_eff, dev) -> dict:
    """Panel pairs (0, 1) and (0, 0) of the join state, each end to end
    (kernel 3 + its compaction, ``_op_panel_pair``) and the kernel
    alone, median ms of 5; the overhead a pair adds beyond its kernel
    (``_panel_pp_resident``) and the kernel's rate in multiply-adds per
    second (``_panel_int8_rate``), each pair's multiply-adds counted over
    its scheduled blocks."""
    rb, tm, tn, _, d_cap = state["geom"]
    diag, off = eng._panel_schedules(state)
    out = {}
    for name, (pi, pj), x2, (bi, bj) in (("off", (0, 1), xj, off),
                                        ("diag", (0, 0), xi, diag)):
        aux = state["aux_of"]
        pair = device_ms(lambda: eng._op_panel_pair(
            state, xi, x2, pi, pj, tau_eff).result(), dev)
        kern = device_ms(lambda: panel_ops.panel_score_bits_int8(
            xi, x2, aux[pi], aux[pj], bi, bj, (pi * rb, pj * rb), tau_eff,
            tm, tn), dev)
        macs = int(bi.numel()) * tm * tn * d_cap
        out[name] = {"pair_ms": pair, "kernel_ms": kern,
                     "overhead_ms": pair - kern, "macs": macs,
                     "kernel_macs_per_s": macs / kern * 1e3}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="panel_probe")
    ap.add_argument("n_rows", type=int, nargs="?", default=500_000)
    ap.add_argument("--joins-only", action="store_true",
                    help="skip the slab-build and panel-pair timings")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    peak = (card_peaks(torch.cuda.get_device_name(dev))["int8"]
            if dev.type == "cuda" else None)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n_rows, tau = args.n_rows, 0.8
    report = {"n_rows": n_rows, "device": (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "joins": {}}
    t0 = time.perf_counter()
    csr = synthetic_corpus(n_rows)
    report["gen_s"] = time.perf_counter() - t0
    log(f"gen: {report['gen_s']:.1f}s nnz={int(csr.indptr[-1])}")

    eng = ChunkedAllPairs(AllPairsConfig(), dev)
    t0 = time.perf_counter()
    eng.build(csr)
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f}s")

    rb, tm, tn, n_panels, d_cap = eng._panel_geom()
    slab_bytes = eng._slab_bytes(rb, d_cap)
    report["geom"] = {"rb": rb, "tm": tm, "tn": tn, "n_panels": n_panels,
                      "d_cap": d_cap, "slab_gib": slab_bytes / 2**30}
    log(f"geom: {json.dumps(report['geom'])}")
    decided = n_rows * (n_rows - 1) / 2
    ops = int8_join_ops(n_panels * rb, d_cap)
    report["int8_ops"] = ops
    report["bound_s"] = None if peak is None else ops / peak
    if peak is not None:
        log(f"int8 bound at the card's peak ({peak / 1e12:.0f} TOPS): "
            f"{ops / peak:.3f}s ({decided:.3g} decided pairs)")

    def timed_join(label):
        t0 = time.perf_counter()
        res = eng.all_pairs(tau)
        dt = time.perf_counter() - t0
        report["joins"][label] = {"seconds": dt, "pairs": res.n_pairs,
                                  "decided_pairs_per_s": decided / dt}
        log(f"join[{label}]: {dt:.3f}s pairs={res.n_pairs} "
            f"({decided / dt / 1e9:.2f} B pairs/s)")
        return dt

    timed_join("default warm-up")
    timed_join("default")
    if not args.joins_only:
        state = eng._panel_state()

        # -- slab build cost -------------------------------------------------
        sync()
        t0 = time.perf_counter()
        for p in range(n_panels):
            s = eng._build_slab(state, p)
        sync()
        del s
        per_build = (time.perf_counter() - t0) / n_panels
        report["slab_build_ms"] = per_build * 1e3
        log(f"slab build: {per_build * 1e3:.2f} ms/panel "
            f"(x{n_panels} = {per_build * n_panels:.3f}s if serialized)")

        # -- one off-diagonal pair: kernel 3 + the pair's compaction ---------
        if n_panels > 1:
            xi = eng._build_slab(state, 0)
            xj = eng._build_slab(state, 1)
            tau_eff = eng._tau_eff(tau)
            pair_ops = 2 * rb * rb * d_cap
            report["pair_ms"] = []
            for rep in range(3):
                sync()
                t0 = time.perf_counter()
                eng._op_panel_pair(state, xi, xj, 0, 1, tau_eff).result()
                sync()
                dt = time.perf_counter() - t0
                report["pair_ms"].append(dt * 1e3)
                bound = ("" if peak is None else
                         f"int8 bound {pair_ops / peak * 1e3:.2f} ms, ")
                log(f"pair(off-diag) rep{rep}: {dt * 1e3:.2f} ms "
                    f"({bound}{pair_ops / dt / 1e12:.1f} TOPS achieved)")
            report["pair_split"] = pair_split(eng, state, xi, xj, tau_eff,
                                              dev)
            log(f"pair split: {json.dumps(report['pair_split'])}")
            del xi, xj

    keep_all = eng._keeps_all(n_panels, rb, d_cap)
    report["mode"] = "resident" if keep_all else "rolling"
    log(f"mode: {report['mode']}")
    if not keep_all:
        b_cap0 = eng._panel_B_cap
        sweep0 = eng._panel_sweep_bytes
        for b in sorted({min(b, n_panels) for b in B_SWEEP}):
            # B row panels + the column slab in flight at once
            eng._panel_B_cap = b
            eng._panel_sweep_bytes = max(sweep0, 2 * b * slab_bytes)
            timed_join(f"B={b}")
        eng._panel_B_cap, eng._panel_sweep_bytes = b_cap0, sweep0
        # taller panels: fewer panel pairs and slab rebuilds per decided
        # pair, at twice the slab memory
        eng.panel_rows = 2 * rb
        eng._panel_geom_cache = None
        eng._panel_state_cache = None
        g2 = eng._panel_geom()
        report["tall_geom"] = list(g2)
        log(f"rb={2 * rb} geom: {g2}")
        timed_join(f"rb={2 * rb} warm-up")
        timed_join(f"rb={2 * rb}")
    # every sweep shape must find the same pairs
    report["pairs_agree"] = len({j["pairs"] for j in
                                 report["joins"].values()}) == 1
    print(json.dumps({"panel_probe": report}), flush=True)
    return report


if __name__ == "__main__":
    main()
