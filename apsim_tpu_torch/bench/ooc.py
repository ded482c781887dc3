"""Out-of-core (chunked) benchmark: build + all-pairs join of
``ChunkedAllPairs`` at row counts beyond the dense index (the counterpart of
the join part of ``apsim_tpu/bench/ooc.py``).

Usage, on a machine with one CUDA card:

    python -m apsim_tpu_torch.bench.ooc [n_rows ...] [--profile] [--stripes]

Each size builds the engine on ``synthetic_corpus(n_rows, seed=0)``, runs
``all_pairs(0.8)`` three times and reports the third: wall seconds, decided
pairs per second, the stage split, the panel geometry and sweep mode, the
int8 work and the rate it reached in the kernel stage, and device memory.
``--profile`` runs one more join under
``torch.profiler`` and reports the device's busy time, its idle share of
the join's wall time, and device time by kernel.  ``--stripes``
builds a second engine with ``pallas_int8=False`` (the stripe join, bf16
slabs), times its third join with its stage split and reports
``stripe_parity``: whether its pair set equals the panel join's.  One JSON
object per size goes to stderr as it finishes, all of them to stdout at the
end.  ``--stream`` (streaming inserts) is not ported yet.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.chunked import ChunkedAllPairs
from ..engine.engine import _not_ported
from ..ops import panel as panel_ops
from .scale import synthetic_corpus

__all__ = ["run_ooc", "join_ops", "profile_join", "main"]


def join_ops(geom) -> int:
    """int8 operations of one join from its panel geometry: scheduled
    blocks x tm x tn x d_cap x 2 (the diagonal schedule on each of the
    n_panels diagonal pairs, the full one on each off-diagonal pair)."""
    rb, tm, tn, n_panels, d_cap = geom
    diag = panel_ops.diag_grid(rb, tm, tn)[0].size
    full = panel_ops.full_grid(rb, rb, tm, tn)[0].size
    blocks = n_panels * diag + n_panels * (n_panels - 1) // 2 * full
    return blocks * tm * tn * d_cap * 2


def profile_join(eng, tau: float) -> Dict:
    """One join of an engine (dense or chunked) under ``torch.profiler``:
    device busy time (the union of the device activity intervals), its idle
    share of the join's wall time (profiler overhead included), and the
    five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.all_pairs(tau)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name: Dict[str, float] = {}
    for e in dev:
        name = e.name[:100]  # templated kernel names run to kilobytes
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {
        "wall_seconds": wall,
        "device_busy_seconds": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "top_kernels_ms": dict(top),
    }


def _memory(device: torch.device) -> Dict:
    if device.type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info(device)
    return {
        "max_allocated": int(torch.cuda.max_memory_allocated(device)),
        "allocated": int(torch.cuda.memory_allocated(device)),
        "device_free": int(free),
        "device_total": int(total),
    }


def run_ooc(
    n_rows: int,
    tau: float = 0.8,
    device: torch.device | str = "cuda",
    chunk_dim: int = 2048,
    profile: bool = False,
    compare_stripes: bool = False,
) -> Dict:
    device = torch.device(device)
    t0 = time.perf_counter()
    csr = synthetic_corpus(n_rows, seed=0)
    gen_s = time.perf_counter() - t0
    eng = ChunkedAllPairs(AllPairsConfig(), device, chunk_dim=chunk_dim)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    st = eng.build(csr)
    geom = eng._panel_geom()
    report: Dict = {
        "n_rows": n_rows,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "nnz": int(csr.indptr[-1]),
        "gen_seconds": gen_s,
        "build_seconds": st["build_seconds"],
        "n_chunks": st["n_chunks"],
        "panel_geom": dict(zip(("rb", "tm", "tn", "n_panels", "d_cap"),
                               geom)) if geom else None,
        "panel_path": eng._panel_ok(),
        "sweep": "resident" if geom and geom[3] * geom[0] * geom[4]
        <= eng._panel_resident_bytes else "rolling",
    }
    eng.all_pairs(tau)
    eng.all_pairs(tau)
    before = dict(eng.timer.totals)
    counts0 = dict(eng.timer.counts)
    cand0 = eng.stats["candidates_scored"]
    t0 = time.perf_counter()
    res = eng.all_pairs(tau)
    join_s = time.perf_counter() - t0
    stages = {k: v - before.get(k, 0.0) for k, v in eng.timer.totals.items()
              if k != "all_pairs"}
    ops = join_ops(geom)
    report.update(
        join_seconds=join_s,
        pairs=res.n_pairs,
        candidates=eng.stats["candidates_scored"] - cand0,
        decided_pairs_per_sec=n_rows * (n_rows - 1) / 2 / join_s,
        stages_s=stages,
        slab_builds=eng.timer.counts.get("slabs", 0)
        - counts0.get("slabs", 0),
        int8_ops=ops,
        kernel_tops=ops / stages["kernel"] / 1e12 if stages.get("kernel")
        else None,
        memory=_memory(device),
    )
    report["sims_finite"] = bool(np.all(np.isfinite(res.sims)))
    if profile:
        report["profile"] = profile_join(eng, tau)
    if compare_stripes:
        del eng
        report["stripes"] = _stripe_join(csr, tau, device, chunk_dim, res)
        report["stripe_join_seconds"] = report["stripes"]["join_seconds"]
        report["stripe_parity"] = report["stripes"]["parity"]
    return report


def _stripe_join(csr, tau: float, device, chunk_dim: int, panel_res) -> Dict:
    """The same corpus through the stripe join (a second engine with
    ``pallas_int8=False``): the third join's seconds and stage split, the
    stripe geometry, and parity with the panel join's pair set."""
    eng = ChunkedAllPairs(AllPairsConfig(pallas_int8=False), device,
                          chunk_dim=chunk_dim)
    eng.build(csr)
    eng.all_pairs(tau)
    eng.all_pairs(tau)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = dict(eng.timer.totals)
    counts0 = dict(eng.timer.counts)
    t0 = time.perf_counter()
    res = eng.all_pairs(tau)
    join_s = time.perf_counter() - t0
    st = eng._q_super()
    return {
        "join_seconds": join_s,
        "pairs": res.n_pairs,
        "parity": res.pair_set() == panel_res.pair_set(),
        "super_tile": st,
        "stripes": -(-eng.n_rows // st),
        "densify_passes": eng.timer.counts.get("slabs", 0)
        - counts0.get("slabs", 0),
        "stages_s": {k: v - before.get(k, 0.0)
                     for k, v in eng.timer.totals.items() if k != "all_pairs"},
        "memory": _memory(device),
    }


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--stream" in args or "--stream-only" in args:
        raise _not_ported("--stream (chunked streaming inserts)", "item B")
    if not torch.cuda.is_available():
        raise SystemExit("apsim_tpu_torch.bench.ooc needs a CUDA device")
    prof = "--profile" in args
    stripes = "--stripes" in args
    sizes = [int(a) for a in args if not a.startswith("-")] or [100_000]
    out = {}
    for n in sizes:
        out[str(n)] = run_ooc(n, device="cuda", profile=prof,
                              compare_stripes=stripes)
        json.dump(out[str(n)], sys.stderr, indent=1)
        print(file=sys.stderr, flush=True)
    json.dump(out, sys.stdout, indent=2)
    print()


if __name__ == "__main__":
    main()
