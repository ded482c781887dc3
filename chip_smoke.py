#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

Run from the repository root, with one NVIDIA H100 visible:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   the CUDA kernels of ``apsim_tpu_torch/csrc/`` are built with nvcc.
2. Each kernel against its plain PyTorch version on the index of an engine
   built from ``synthetic_corpus(4096)`` with padding rows, at tiles
   (1024, 512) and (256, 256), tau_eff of tau = 0.8.  int8: gb, g64 and cnt
   bit-identical.  bf16: every differing hit cell has a plain fp32 score
   within 1e-5 of tau_eff.  Both: g64 and cnt agree with the kernel's own gb.
3. The main path, ``Engine.build`` + ``Engine.all_pairs(0.8)`` three times,
   on ``synthetic_corpus(32768, seed=0)`` with the default config (int8
   kernel), then on 8,586 rows with ``pallas_int8=False`` (bf16 kernel).
   The launch counters are zeroed just before and read just after; each
   kernel must have launched.  The third join of each is timed.
4. Each kernel against its plain version again, at the main path's own
   operands and tiles (timed, CUDA events, median of 5), and exact pair-set
   parity of both joins with an fp64 dense oracle that shares no code with
   the engine.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from apsim_tpu_torch import AllPairsConfig, CSRMatrix, Engine
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import _build, tri_score as ts

TAU = 0.8
BF16_BAND = 1e-5  # |plain fp32 score - tau_eff| allowed where bf16 bits differ
SOURCE = "apsim_tpu_torch/csrc/score_bits.cu"
REPLACES = {
    "score_bits_int8": "apsim_tpu/ops/pallas_score.py:453",  # _kernel_int8
    "score_bits_bf16": "apsim_tpu/ops/pallas_score.py:117",  # _kernel
}


def log(*a) -> None:
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def blocks(row_cap: int, tm: int, tn: int, dev):
    bi, bj = ts.upper_blocks_rect(row_cap, tm, tn)
    return torch.from_numpy(bi).to(dev), torch.from_numpy(bj).to(dev)


def check_packing(out, step: int = 8) -> None:
    """The kernel's g64 and cnt must be what its own gb implies."""
    gb, g64, cnt = out
    for s in range(0, gb.shape[0], step):
        e = min(s + step, gb.shape[0])
        _, r64, rcnt = ts.bitpack_mask(ts.unpack_bits(gb[s:e]))
        if not (torch.equal(r64, g64[s:e]) and torch.equal(rcnt, cnt[s:e])):
            raise AssertionError(f"g64/cnt disagree with gb in blocks {s}:{e}")


def compare(kind: str, ops, bi, bj, tau_eff, tm: int, tn: int,
            timed: bool) -> dict:
    """Kernel vs plain version on the same operands; returns the record."""
    if kind == "int8":
        kern = lambda: ts.score_bits_int8(*ops, bi, bj, tau_eff, tm, tn)
        plain = lambda: ts.score_bits_int8_plain(*ops, bi, bj, tau_eff, tm, tn)
    else:
        kern = lambda: ts.score_bits_bf16(ops, bi, bj, tau_eff, tm, tn)
        plain = lambda: ts.score_bits_bf16_plain(ops, bi, bj, tau_eff, tm, tn)
    k = kern()
    torch.cuda.synchronize()
    p = plain()
    check_packing(k)
    rec = {"tiles": [tm, tn], "blocks": int(bi.numel()),
           "pairs_kernel": int(k[2][:, 0].sum()),
           "pairs_plain": int(p[2][:, 0].sum())}
    if kind == "int8":
        err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, p))
        if err:
            n = int((ts.unpack_bits(k[0]) != ts.unpack_bits(p[0])).sum())
            raise AssertionError(
                f"int8 kernel differs from plain at tiles {(tm, tn)}: "
                f"{n} hit cells, max byte error {err}"
            )
        rec.update(max_abs_err=0.0, cells_differing=0)
    else:
        worst, n_diff = 0.0, 0
        for s, e, v in ts.bf16_scores(ops, bi, bj, tm, tn):
            d = ts.unpack_bits(k[0][s:e]) != ts.unpack_bits(p[0][s:e])
            if bool(d.any()):
                n_diff += int(d.sum())
                worst = max(worst, float((v[d] - float(tau_eff)).abs().max()))
        if worst > BF16_BAND:
            raise AssertionError(
                f"bf16 kernel differs from plain at tiles {(tm, tn)} on "
                f"{n_diff} cells; worst |score - tau_eff| = {worst} > "
                f"{BF16_BAND}"
            )
        rec.update(max_abs_err=worst, cells_differing=n_diff)
    del k, p
    if timed:
        rec["ms"] = median_ms(kern)
        rec["plain_ms"] = median_ms(plain)
    return rec


def oracle_pairs(csr: CSRMatrix, tau: float, dev) -> set:
    """Exact fp64 pair set: dense product of the raw CSR (np.unique column
    remap) on the card, 4,096 rows at a time, strict upper triangle."""
    active, cols = np.unique(csr.indices, return_inverse=True)
    rows = np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr))
    d = torch.zeros((csr.n_rows, active.size), dtype=torch.float64, device=dev)
    d[torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)] = (
        torch.from_numpy(csr.data).to(dev)
    )
    out = set()
    for r0 in range(0, csr.n_rows, 4096):
        r1 = min(r0 + 4096, csr.n_rows)
        ii, jj = torch.nonzero(d[r0:r1] @ d[r0:].T >= tau, as_tuple=True)
        ii, jj = ii + r0, jj + r0
        keep = ii < jj
        out.update(zip(ii[keep].tolist(), jj[keep].tolist()))
    return out


def check_parity(res, csr: CSRMatrix, dev, label: str) -> int:
    got = set(zip(res.i.tolist(), res.j.tolist()))
    want = oracle_pairs(csr, TAU, dev)
    if got != want:
        raise AssertionError(
            f"{label}: pair set differs from the fp64 oracle: "
            f"{len(got - want)} extra, {len(want - got)} missing "
            f"(e.g. extra {sorted(got - want)[:5]}, "
            f"missing {sorted(want - got)[:5]})"
        )
    log(f"{label}: parity OK, {len(got)} pairs equal the fp64 oracle")
    return len(got)


def timed_join(eng: Engine, label: str) -> dict:
    """all_pairs(TAU) three times; the third is timed with its stage split."""
    eng.all_pairs(TAU)
    eng.all_pairs(TAU)
    before = dict(eng.timer.totals)
    cand0 = eng.stats["candidate_pairs"]
    t0 = time.perf_counter()
    res = eng.all_pairs(TAU)
    secs = time.perf_counter() - t0
    stages = {k: v - before.get(k, 0.0) for k, v in eng.timer.totals.items()}
    n = eng.n_rows
    rec = {
        "rows": n, "row_cap": eng.row_cap, "dim_cap": eng.dim_cap,
        "seconds": secs, "decided_pairs_per_s": n * (n - 1) / 2 / secs,
        "candidates": eng.stats["candidate_pairs"] - cand0,
        "pairs": res.n_pairs, "stages_s": stages,
    }
    log(f"{label}: {json.dumps(rec)}")
    return {"rec": rec, "res": res}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # ---- phase 1: build the kernels
    _build.kernels()
    info = _build.build_info()
    log(f"kernels built in {info['seconds']:.2f} s: {info['library']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # ---- phase 2: kernel vs plain, 4,096 rows with padding rows
    small = Engine(AllPairsConfig(row_bucket=5120), dev)
    small.build(synthetic_corpus(4096))
    if small.row_cap <= small.n_rows:
        raise AssertionError("phase 2 needs padding rows")
    tau_eff = small._tau_eff(TAU)
    q8 = ts.quantize_rows(small.x)
    xb = small.x.to(torch.bfloat16)
    for tm, tn in ((1024, 512), (256, 256)):
        bi, bj = blocks(small.row_cap, tm, tn, dev)
        for kind, ops in (("int8", q8), ("bf16", xb)):
            rec = compare(kind, ops, bi, bj, tau_eff, tm, tn, timed=True)
            log(f"phase 2 {kind} rows={small.n_rows} row_cap={small.row_cap} "
                f"dim_cap={small.dim_cap}: {json.dumps(rec)}")
    del small, q8, xb

    # ---- phase 3: the main path, counters zeroed just before
    big_csr = synthetic_corpus(32768, seed=0)
    enron_csr = synthetic_corpus(8586, seed=0)
    eng8 = Engine(AllPairsConfig(), dev)
    eng16 = Engine(AllPairsConfig(pallas_int8=False), dev)
    for k in ts.LAUNCHES:
        ts.LAUNCHES[k] = 0
    log(f"build int8 engine: {json.dumps(eng8.build(big_csr))}")
    j8 = timed_join(eng8, "main path int8, 32768 rows")
    log(f"build bf16 engine: {json.dumps(eng16.build(enron_csr))}")
    j16 = timed_join(eng16, "main path bf16, 8586 rows")
    launches = dict(ts.LAUNCHES)
    log(f"kernel launches on the main path: {launches}")
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"{k} was not launched on the main path")
    if not eng8._used_int8 or eng16._used_int8:
        raise AssertionError("the joins did not take the intended kernels")

    # ---- phase 4: kernels at the main path's operands, then parity
    kernels = []
    for name, kind, eng in (("score_bits_int8", "int8", eng8),
                            ("score_bits_bf16", "bf16", eng16)):
        tm, tn = eng._tiles()
        bi, bj = blocks(eng.row_cap, tm, tn, dev)
        rec = compare(kind, eng._operands(kind == "int8"), bi, bj,
                      eng._tau_eff(TAU), tm, tn, timed=True)
        log(f"phase 4 {kind} row_cap={eng.row_cap} dim_cap={eng.dim_cap}: "
            f"{json.dumps(rec)}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
        })
    check_parity(j8["res"], big_csr, dev, "int8 join, 32768 rows")
    check_parity(j16["res"], enron_csr, dev, "bf16 join, 8586 rows")
    for j in (j8, j16):
        if not j["res"].n_pairs or not np.all(np.isfinite(j["res"].sims)):
            raise AssertionError("join produced no pairs or non-finite sims")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
