"""Dense-join stage attribution on the card: where does the time of one
warm ``Engine.all_pairs`` go? (the counterpart of
``apsim_tpu/bench/join_probe.py``).

The probe mirrors ``Engine._all_pairs_kernel`` (the block list of
``eng._tiles()``, the cached int8 operands of ``eng._operands(True)``)
and times its stages:

  - dispatch floor: an empty launch followed by a synchronize (host
    clock), the per-call tax every stage below also pays once;
  - kernel:   ``tri_score.score_bits_int8`` alone (kernel 1);
  - extract:  ``tri_score.allpairs_extract_int8`` (the kernel and the
    compaction to exact-length lists, kernel 7) plus the D2H of those
    lists, so "extract - kernel" = compaction + D2H;
  - rescore:  host fp64 rescore + emission (``all_pairs`` total minus
    extract), cross-checked against the engine Timer's sections.

Device stages are timed with CUDA events (median of ``reps``); the whole
join with the host clock (it ends in host numpy arrays).  Utilization is of
the card's int8 peak (``mfu.card_peaks``); a CPU run reports none.

Usage: python -m apsim_tpu_torch.bench.join_probe [size ...] [--geom]
       [--enron ROOT] [--cpu]
(default sizes: 8586 16384 32768 65536; 8586 = Enron-sized synthetic).
``--enron ROOT`` uses the Enron TF-IDF corpus for the first size instead;
``--geom`` sweeps the kernel's block tiles at the first size.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.engine import Engine
from ..ops import tri_score
from .mfu import card_peaks, int8_join_ops, mfu_pct

__all__ = ["probe_size", "geom_sweep", "main", "GEOMS"]

# the (tm, tn) block tiles the sweep tries, the engine's default first
GEOMS = ((1024, 512), (1024, 1024), (512, 512), (2048, 512), (256, 256))


def _host_med(f, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _device_med(f, reps: int, dev: torch.device) -> float:
    """Median seconds of ``f`` between two CUDA events (host clock on the
    CPU)."""
    if dev.type != "cuda":
        return _host_med(f, reps)
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        f()
        b.record()
        torch.cuda.synchronize(dev)
        ts.append(a.elapsed_time(b) / 1e3)
    return float(np.median(ts))


def _peak(dev: torch.device):
    return (card_peaks(torch.cuda.get_device_name(dev))["int8"]
            if dev.type == "cuda" else None)


def _blocks(row_cap: int, tm: int, tn: int, dev: torch.device):
    bi, bj = tri_score.upper_blocks_rect(row_cap, tm, tn)
    return torch.from_numpy(bi).to(dev), torch.from_numpy(bj).to(dev)


def probe_size(csr, ids=None, tau: float = 0.8, reps: int = 5,
               device: torch.device | str = "cuda",
               check_plain: bool = False) -> dict:
    """Stage split of one warm join of ``csr``.  ``check_plain`` holds the
    last timed kernel launch's ``(gb, g64, cnt)`` against
    ``score_bits_int8_plain`` on the same operands (``kernel_equals_plain``;
    bit for bit)."""
    dev = torch.device(device)
    eng = Engine(AllPairsConfig(), dev)
    t0 = time.perf_counter()
    eng.build(csr, ids)
    build_s = time.perf_counter() - t0
    eng.all_pairs(tau)  # two warm joins: operands cached, allocator warm
    eng.all_pairs(tau)

    out = {"n_rows": csr.n_rows, "row_cap": eng.row_cap,
           "dim_cap": eng.dim_cap, "build_seconds": build_s}
    if not eng._kernel_ok() or not eng._used_int8:
        out["note"] = "int8 kernel path inactive; stage split skipped"
    else:
        tm, tn = eng._tiles()
        bi, bj = _blocks(eng.row_cap, tm, tn, dev)
        xq, aux = eng._operands(True)
        tau_eff = eng._tau_eff(tau)
        out["tiles"] = [tm, tn]
        out["n_blocks"] = int(bi.numel())

        x0 = torch.zeros(8, dtype=torch.int32, device=dev)

        def empty_launch():
            x0.add_(1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        empty_launch()
        out["dispatch_floor_s"] = _host_med(empty_launch, reps)

        last = {}

        def kernel_only():
            last["bits"] = tri_score.score_bits_int8(
                xq, aux, bi, bj, tau_eff, tm, tn)

        out["kernel_s"] = _device_med(kernel_only, reps, dev)
        out["candidates"] = int(last["bits"][2][:, 0].sum())
        if check_plain:
            plain = tri_score.score_bits_int8_plain(xq, aux, bi, bj,
                                                    tau_eff, tm, tn)
            out["kernel_equals_plain"] = all(
                torch.equal(k, p) for k, p in zip(last["bits"], plain))
            del plain
        del last

        def extract_full():
            rows, cols = tri_score.allpairs_extract_int8(
                xq, aux, bi, bj, tau_eff, tm, tn)
            return rows.cpu().numpy(), cols.cpu().numpy()

        out["extract_s"] = _device_med(extract_full, reps, dev)
        out["compact_fetch_s"] = out["extract_s"] - out["kernel_s"]

    totals0, counts0 = dict(eng.timer.totals), dict(eng.timer.counts)
    out["all_pairs_s"] = _host_med(lambda: eng.all_pairs(tau), reps)
    if "extract_s" in out:
        out["rescore_emit_s"] = out["all_pairs_s"] - out["extract_s"]
    ops = int8_join_ops(eng.row_cap, eng.dim_cap)
    out["int8_ops"] = ops
    peak = _peak(dev)
    out["mfu_pct_e2e"] = (None if peak is None
                          else mfu_pct(ops, out["all_pairs_s"], peak))
    if "kernel_s" in out:
        out["mfu_pct_kernel"] = (None if peak is None
                                 else mfu_pct(ops, out["kernel_s"], peak))
    # the engine's own stage split over the timed joins (seconds a join)
    out["timer"] = {
        k: (v - totals0.get(k, 0.0)) / max(
            eng.timer.counts[k] - counts0.get(k, 0), 1)
        for k, v in eng.timer.totals.items()
        if k in ("all_pairs", "score_extract", "operands", "kernel",
                 "compact", "d2h", "rescore")
    }
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _tiles_fit(row_cap: int, dim_cap: int, tm: int, tn: int) -> bool:
    """Whether kernel 1's wrapper accepts block tiles ``(tm, tn)`` at this
    index: the tiles divide the operands, ``tm`` is a multiple of 64 and
    ``tn`` of 128, and a thread-block tile divides them (the wrapper's own
    checks, ``tri_score._check_operands``)."""
    if tm % tri_score.SUPER or tn % tri_score.COL_QUANTUM:
        return False
    try:
        tri_score.check_tiles(row_cap, row_cap, dim_cap, tm, tn,
                              tri_score.K_QUANTUM)
        tri_score.thread_block_tile(tm, tn)
    except ValueError:
        return False
    return True


def geom_sweep(csr, tau: float = 0.8, reps: int = 5,
               device: torch.device | str = "cuda") -> dict:
    """Kernel 1 alone over the block tiles of ``GEOMS`` that its wrapper
    accepts at this index (CUDA events, median of ``reps``).  Every tile
    must count the same candidates."""
    dev = torch.device(device)
    eng = Engine(AllPairsConfig(), dev)
    eng.build(csr)
    eng.all_pairs(tau)
    if not eng._used_int8:
        return {"note": "int8 path inactive"}
    xq, aux = eng._operands(True)
    tau_eff = eng._tau_eff(tau)
    ops = int8_join_ops(eng.row_cap, eng.dim_cap)
    peak = _peak(dev)
    out = {"row_cap": eng.row_cap, "dim_cap": eng.dim_cap}
    for tm, tn in GEOMS:
        key = f"{tm}x{tn}"
        if not _tiles_fit(eng.row_cap, eng.dim_cap, tm, tn):
            out[key] = {"note": "tiles do not fit this index"}
            continue
        bi, bj = _blocks(eng.row_cap, tm, tn, dev)
        last = {}

        def kern():
            last["cnt"] = tri_score.score_bits_int8(
                xq, aux, bi, bj, tau_eff, tm, tn)[2]

        kern()
        dt = _device_med(kern, reps, dev)
        out[key] = {
            "kernel_s": dt,
            "mfu_pct_kernel": None if peak is None else mfu_pct(ops, dt,
                                                                peak),
            "n_blocks": int(bi.numel()),
            "thread_block_tile": list(tri_score.thread_block_tile(tm, tn)),
            "candidates": int(last["cnt"][:, 0].sum()),
        }
        print(f"geom {key}: {json.dumps(out[key])}", flush=True)
    counted = {v["candidates"] for v in out.values()
               if isinstance(v, dict) and "candidates" in v}
    out["candidates_agree"] = len(counted) == 1
    del eng
    return out


def main(argv=None) -> dict:
    from .scale import synthetic_corpus

    ap = argparse.ArgumentParser(prog="join_probe")
    ap.add_argument("sizes", type=int, nargs="*",
                    default=[8586, 16384, 32768, 65536])
    ap.add_argument("--geom", action="store_true",
                    help="sweep the kernel's block tiles at the first size")
    ap.add_argument("--enron", default=None, metavar="ROOT",
                    help="the Enron maildir root, for the first size")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    if args.geom:
        n = args.sizes[0]
        rec = {"geom_sweep": geom_sweep(synthetic_corpus(n), device=dev),
               "n": n, "device": name}
        print(json.dumps(rec), flush=True)
        return rec

    report = {}
    for k, n in enumerate(args.sizes):
        if args.enron and k == 0:
            from .data import load_enron_tfidf

            csr, ids = load_enron_tfidf(args.enron)
            r = probe_size(csr, ids, device=dev)
            key = f"enron_{csr.n_rows}"
        else:
            r = probe_size(synthetic_corpus(n), device=dev)
            key = str(n)
        report[key] = r
        print(f"{key}: {json.dumps(r)}", flush=True)
    rec = {"join_probe": report, "device": name}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
