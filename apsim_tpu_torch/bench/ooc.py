"""Out-of-core (chunked) benchmark: build, all-pairs join and streaming
inserts of ``ChunkedAllPairs`` at row counts beyond the dense index (the
counterpart of ``apsim_tpu/bench/ooc.py``).

Usage, on a machine with one CUDA card:

    python -m apsim_tpu_torch.bench.ooc [n_rows ...] [--profile] [--stripes]
        [--stream N] [--stream-batch B] [--stream-only] [--router-ab]
        [--slab-budget-mb MB] [--seed N]

Each size builds the engine on ``synthetic_corpus(n_rows, seed)``
(``--seed``, default 0), runs ``all_pairs(0.8)`` three times and reports
the third: wall seconds, decided pairs per second, the stage split, the
panel geometry and sweep mode, the int8 work and the rate it reached in
the kernel stage, and device memory.  ``--profile`` runs one more join
under ``torch.profiler`` and reports the device's busy time, its idle
share of the join's wall time, device time by kernel, and the longest
idle gaps with the engine's ``Timer`` section at each (``profile_call``).
``--stripes`` builds a second engine with ``pallas_int8=False`` (the
stripe join, bf16 slabs), times its third join with its stage split and
reports ``stripe_parity``: whether its pair set equals the panel join's.

``--stream N`` then, for each batch size B of ``--stream-batch`` (256, or
a comma list, the k-th on ``synthetic_corpus(N, [99 + k, seed])``), inserts
``N`` rows in batches of B at tau = 0.8 into the same engine and reports,
under ``stream[B]``: the median batch seconds (host clock; an insert
returns with its output), vectors per second, the stage split per batch,
the route each batch took (``resident_slabs``, ``host_spgemm``,
``device_paneled`` or ``device_rebuild``) and ``parity``: whether the
union of the outputs equals an fp64 oracle computed in dense row blocks on
the same device.  Beyond the resident stack's budget (``--slab-budget-mb``
overrides the config's ``match_slab_budget_mb``) two more batches of B
rows (``synthetic_corpus(2 B, [201 + k, seed])``) run with the router forced
to the host route and to the device route, each against the oracle:
``router_ab[B]`` says which the router picks for such a batch and whether
that one was the faster (for B above 512 only with ``--router-ab``: the
host route's cost grows with the batch's document-frequency mass), with
each forced batch's stage split and the router's inputs (the index's nnz
and the batch's document-frequency mass).
``--stream-only`` skips the joins.  One JSON object per size goes to
stderr as it finishes, all of them to stdout at the end.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.chunked import ChunkedAllPairs
from ..ops import panel as panel_ops
from ..utils.logging import Timer
from ..vector.batch import CSRMatrix
from .scale import synthetic_corpus

__all__ = ["run_ooc", "join_ops", "profile_call", "profile_join",
           "profile_insert", "pairs_of", "csr_rows", "dense_rows",
           "batch_oracle", "main"]


def join_ops(geom) -> int:
    """int8 operations of one join from its panel geometry: scheduled
    blocks x tm x tn x d_cap x 2 (the diagonal schedule on each of the
    n_panels diagonal pairs, the full one on each off-diagonal pair)."""
    rb, tm, tn, n_panels, d_cap = geom
    diag = panel_ops.diag_grid(rb, tm, tn)[0].size
    full = panel_ops.full_grid(rb, rb, tm, tn)[0].size
    blocks = n_panels * diag + n_panels * (n_panels - 1) // 2 * full
    return blocks * tm * tn * d_cap * 2


_CALL = "profiled call"  # the annotation around the whole profiled call
_SECTION = "section "  # the prefix of an annotated Timer section


class _AnnotatedTimer(Timer):
    """A ``Timer`` that also marks each section as a ``torch.profiler``
    range, sharing the totals and counts of the timer it stands in for."""

    def __init__(self, timer: Timer):
        self.totals, self.counts = timer.totals, timer.counts

    @contextlib.contextmanager
    def section(self, name: str):
        with torch.profiler.record_function(_SECTION + name), \
                super().section(name):
            yield


def profile_call(eng, fn, top: int = 5) -> Dict:
    """``fn()`` (calls on the engine ``eng``, dense or chunked) once under
    ``torch.profiler``, with the engine's ``Timer`` sections marked as
    ranges: device busy time (the union of the device activity intervals),
    its idle share of the call's time (profiler overhead included), the
    ``top`` kernels with the most device time, the ``top`` longest idle
    gaps with the innermost section the host was in at each gap's middle
    (None between sections), and the idle time by that section."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if eng.device.type == "cuda" else [])
    timer, eng.timer = eng.timer, _AnnotatedTimer(eng.timer)
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with record_function(_CALL):
                fn()
            wall = time.perf_counter() - t0
    finally:
        eng.timer = timer
    events = prof.events()
    (w0, w1), = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == _CALL
                 and e.device_type == torch.autograd.DeviceType.CPU]
    sections = [(e.time_range.start, e.time_range.end,
                 e.name[len(_SECTION):]) for e in events
                if e.name.startswith(_SECTION)
                and e.device_type == torch.autograd.DeviceType.CPU]
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith((_SECTION, _CALL))]
    busy_us, end, gaps = 0.0, w0, []
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        s, e = max(s, w0), min(e, w1)
        if e <= s:  # outside the call
            continue
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy_us += e - max(s, end)
            end = e
    if w1 > end:
        gaps.append((end, w1))

    def section_at(t: float):
        inside = [(b - a, name) for a, b, name in sections if a <= t <= b]
        return min(inside)[1] if inside else None

    idle_by: Dict[str, float] = {}
    longest = []
    for a, b in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True):
        name = section_at((a + b) / 2)
        idle_by[str(name)] = idle_by.get(str(name), 0.0) + (b - a) / 1e3
        if len(longest) < top:
            longest.append({"ms": (b - a) / 1e3, "at_ms": (a - w0) / 1e3,
                            "section": name})
    by_name: Dict[str, float] = {}
    for e in dev:
        name = e.name[:100]  # templated kernel names run to kilobytes
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    return {
        "wall_seconds": wall,
        "device_busy_seconds": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / (w1 - w0),
        "top_kernels_ms": dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]),
        "idle_gaps": longest,
        "idle_ms_by_section": dict(sorted(idle_by.items(),
                                          key=lambda kv: -kv[1])),
    }


def profile_join(eng, tau: float) -> Dict:
    """One join of ``eng`` under ``profile_call``."""
    return profile_call(eng, lambda: eng.all_pairs(tau))


def profile_insert(eng, batches, tau: float) -> Dict:
    """One insert pass of ``eng`` (each of ``batches`` inserted in turn)
    under ``profile_call``."""
    return profile_call(eng, lambda: [eng.insert(b, tau=tau)
                                      for b in batches])


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
    stream_rows: int = 0,
    stream_batch=(256,),
    stream_only: bool = False,
    router_ab: bool = False,
    slab_budget_mb: int | None = None,
    seed: int = 0,
) -> Dict:
    device = torch.device(device)
    t0 = time.perf_counter()
    csr = synthetic_corpus(n_rows, seed=seed)
    gen_s = time.perf_counter() - t0
    cfg = AllPairsConfig()
    if slab_budget_mb is not None:
        cfg = cfg.replace(match_slab_budget_mb=int(slab_budget_mb))
    eng = ChunkedAllPairs(cfg, device, chunk_dim=chunk_dim)
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
        "sweep": "resident" if geom and eng._keeps_all(
            geom[3], geom[0], geom[4]) else "rolling",
    }
    if stream_rows:
        report["stream_budget_mb"] = eng.cfg.match_slab_budget_mb
    if not stream_only:
        _join(eng, report, tau, device, chunk_dim, csr, profile,
              compare_stripes)
    if stream_rows:
        index = [csr]
        for k, bs in enumerate(stream_batch):
            _stream(eng, report, index, tau, stream_rows, int(bs), seed,
                    k, router_ab)
        report["memory_after_stream"] = _memory(device)
    return report


def _join(eng, report: Dict, tau: float, device, chunk_dim: int, csr,
          profile: bool, compare_stripes: bool) -> None:
    """Three joins, the third timed, into ``report``."""
    n_rows = eng.n_rows
    geom = eng._panel_geom()
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
        report["stripes"] = _stripe_join(csr, tau, device, chunk_dim, res)
        report["stripe_join_seconds"] = report["stripes"]["join_seconds"]
        report["stripe_parity"] = report["stripes"]["parity"]


STREAM_STAGES = ("admit", "prepare", "append", "match_slabs", "sort_entries",
                 "product", "compact", "host_match", "d2h", "rescore")


def csr_rows(csr: CSRMatrix, lo: int, hi: int) -> CSRMatrix:
    """Rows ``[lo, hi)`` of ``csr`` as a CSR of their own."""
    a, b = int(csr.indptr[lo]), int(csr.indptr[hi])
    return CSRMatrix(hi - lo, csr.n_cols, csr.indptr[lo:hi + 1] - a,
                     csr.indices[a:b], csr.data[a:b])


def dense_rows(csr: CSRMatrix, lo: int, hi: int, width: int, device):
    """fp64 ``[hi - lo, width]`` of rows ``[lo, hi)`` on ``device``."""
    a, b = int(csr.indptr[lo]), int(csr.indptr[hi])
    rows = np.repeat(np.arange(hi - lo), np.diff(csr.indptr[lo:hi + 1]))
    d = torch.zeros((hi - lo, width), dtype=torch.float64, device=device)
    d[torch.from_numpy(rows).to(device),
      torch.from_numpy(csr.indices[a:b].astype(np.int64)).to(device)] = (
        torch.from_numpy(csr.data[a:b]).to(device))
    return d


def batch_oracle(index: list, batch: CSRMatrix, n0: int, tau: float,
                 device, block: int = 16384) -> set:
    """Unordered fp64 pairs ``(a, b)`` with dot >= tau between the rows of
    ``batch`` (global rows from ``n0``) and every row of the CSRs in
    ``index`` (global rows from 0, in order) or of the batch itself: what
    the batch's insert must emit.  Dense row blocks on ``device``; shares
    no code with the engine."""
    width = 1 + max(int(c.indices.max()) for c in index + [batch]
                    if c.indptr[-1])
    q = dense_rows(batch, 0, batch.n_rows, width, device)
    out, base = set(), 0
    for c in index + [batch]:
        for r0 in range(0, c.n_rows, block):
            r1 = min(r0 + block, c.n_rows)
            qi, ri = torch.nonzero(
                q @ dense_rows(c, r0, r1, width, device).T >= tau,
                as_tuple=True)
            for a, b in zip((ri + base + r0).tolist(), (qi + n0).tolist()):
                if a != b:
                    out.add((min(a, b), max(a, b)))
        base += c.n_rows
    return out


def pairs_of(out) -> set:
    """The row pairs ``(i, j)``, ``i < j``, of an insert's output (ids are
    row numbers)."""
    return {(min(int(q), int(c)), max(int(q), int(c)))
            for q, cands in out.output.items() for c in cands}


def _stream(eng, report: Dict, index: list, tau: float, stream_rows: int,
            bs: int, seed: int, k: int, router_ab: bool) -> None:
    """Stream ``stream_rows`` rows of ``synthetic_corpus(stream_rows,
    [99 + k, seed])`` in batches of ``bs`` (ids are global row numbers),
    then the router's A/B beyond the budget, into ``report``.  The k-th
    batch size of a run seeded ``seed`` has corpora of its own: two seeds
    never share one, and seed 0's are those of the integer seeds 99 + k and
    201 + k (numpy pads a short seed with zeros).  ``index`` lists the
    CSRs the engine holds, in order, and grows."""
    device = eng.device
    extra = synthetic_corpus(stream_rows, seed=[99 + k, seed])
    times, routes, union, want = [], [], set(), set()
    before = dict(eng.timer.totals)
    for s in range(0, stream_rows, bs):
        e = min(s + bs, stream_rows)
        n0 = eng.n_rows
        batch = [(str(n0 + i - s), extra.row(i)) for i in range(s, e)]
        t0 = time.perf_counter()
        out = eng.insert(batch, tau=tau)
        times.append(time.perf_counter() - t0)
        routes.append(eng.last_route)
        union |= pairs_of(out)
        part = csr_rows(extra, s, e)
        want |= batch_oracle(index, part, n0, tau, device)
        index.append(part)
    n_b = len(times)
    med = float(np.median(times))
    report.setdefault("stream", {})[str(bs)] = {
        "rows": stream_rows, "batch": bs, "batches": n_b,
        "median_batch_seconds": med, "vectors_per_sec": bs / med,
        "first_batch_seconds": times[0],
        "stages_ms_per_batch": {
            k: (eng.timer.totals.get(k, 0.0) - before.get(k, 0.0)) / n_b * 1e3
            for k in STREAM_STAGES},
        "routes": {r: routes.count(r) for r in set(routes)},
        "match_path": max(set(routes), key=routes.count),
        "pairs": len(union), "parity": union == want,
    }
    if eng._match_slabs() is not None or not (bs <= 512 or router_ab):
        return
    probes = synthetic_corpus(2 * bs, seed=[201 + k, seed])
    dev_name = "device_paneled" if eng._paneled_ok() else "device_rebuild"
    ab: Dict = {}
    parity = True
    for h, (force, name) in enumerate(((True, "host_spgemm"),
                                       (False, dev_name))):
        part = csr_rows(probes, h * bs, (h + 1) * bs)
        n0 = eng.n_rows
        if h == 0:
            # the router's own pick for a batch like these
            ab["router_choice"] = ("host_spgemm"
                                   if eng._use_host_match(part.indices)
                                   else dev_name)
        # the router's inputs: the index's nnz before the batch and the
        # batch's document-frequency mass (its spGEMM intersections)
        ab[name + "_index_nnz"] = int(eng.shadow_csr().indptr[-1])
        ab[name + "_df_mass"] = (None if eng._ext_df is None else int(
            eng._ext_df[part.indices].sum()))
        batch = [(str(n0 + i), part.row(i)) for i in range(bs)]
        eng._use_host_match = lambda q, _f=force: _f  # shadow the router
        before = dict(eng.timer.totals)
        try:
            t0 = time.perf_counter()
            out = eng.insert(batch, tau=tau)
            ab[name + "_batch_seconds"] = time.perf_counter() - t0
        finally:
            del eng._use_host_match
        ab[name + "_stages_ms"] = {
            k: (eng.timer.totals.get(k, 0.0) - before.get(k, 0.0)) * 1e3
            for k in STREAM_STAGES}
        if eng.last_route != name:
            raise AssertionError(f"forced {name}, took {eng.last_route}")
        parity &= pairs_of(out) == batch_oracle(index, part, n0, tau,
                                                 device)
        index.append(part)
    ab["router_correct"] = ab[ab["router_choice"] + "_batch_seconds"] == min(
        ab["host_spgemm_batch_seconds"], ab[dev_name + "_batch_seconds"])
    ab["parity"] = parity
    report.setdefault("router_ab", {})[str(bs)] = ab


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


def _opt(args: list, name: str, default):
    """The value after ``name`` in ``args`` (both removed), or default."""
    if name not in args:
        return default
    k = args.index(name)
    val = int(args[k + 1])
    del args[k:k + 2]
    return val


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("apsim_tpu_torch.bench.ooc needs a CUDA device")
    stream = _opt(args, "--stream", 0)
    sbatch = [256]
    if "--stream-batch" in args:
        k = args.index("--stream-batch")
        sbatch = [int(b) for b in args[k + 1].split(",")]
        del args[k:k + 2]
    budget = _opt(args, "--slab-budget-mb", None)
    seed = _opt(args, "--seed", 0)
    flags = {a for a in args if a.startswith("-")}
    sizes = [int(a) for a in args if not a.startswith("-")] or [100_000]
    out = {}
    for n in sizes:
        out[str(n)] = run_ooc(
            n, device="cuda", profile="--profile" in flags,
            compare_stripes="--stripes" in flags, stream_rows=stream,
            stream_batch=sbatch, stream_only="--stream-only" in flags,
            router_ab="--router-ab" in flags, slab_budget_mb=budget,
            seed=seed)
        json.dump(out[str(n)], sys.stderr, indent=1)
        print(file=sys.stderr, flush=True)
    json.dump(out, sys.stdout, indent=2)
    print()


if __name__ == "__main__":
    main()
