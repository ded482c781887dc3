#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

Run from the repository root, with one NVIDIA H100 visible:

    python3 chip_smoke.py [--profile]

``--profile`` adds one more join of each dense engine under
``torch.profiler`` after phase 3 (device busy time and idle share; the
profiler's start-up costs about 7 s on an H100 machine).

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   the CUDA kernels of ``apsim_tpu_torch/csrc/`` are built with nvcc, and
   ``ptxas`` must report 0 spill bytes for every kernel.
   Then the int8 kernels at their edges, each bit for bit (kernels 1 and
   3: gb, g64, cnt) or exactly (kernel 4: every int32) against its plain
   version: K = 128 (one ring stage) and K = 4,096 at block tiles
   (1024, 512), (512, 512), (256, 256) and (64, 128) (both thread-block
   tiles, 128 x 256 and 64 x 128), the dense triangle and a cross-panel
   rectangle with offsets and valid = 0 blocks, one with every sub-tile
   dead; ±127 operands at K = 32,768 (the int32 gate's largest dot);
   kernel 4 at both thread-block tiles with fewer tiles than SMs.
   Then the bf16 kernel at the same edges against its plain version: K = 64
   elements (one ring stage) and K = 2,048 (32 stages) at the same four
   block tiles, on 1,900 random unit rows and 148 padding rows, with a
   threshold inside the bulk of the scores, and a block list with fewer
   tiles than SMs: every cell whose bit differs has a plain fp32 score
   within 1e-5 of the threshold.  A dense stress (2,048 rows of 32,768
   positive elements each, threshold at the scores' median): the tensor
   cores' fp32 sums of 32,768 positive products drift further from the plain
   version's than any sparse row's can, so there the cells that differ are
   held within (K + 2) * 2^-24, the engine's own bound on fp32 accumulation
   over K nonzeros (``Engine._margin_rel``; its bf16 margin, 2e-2, is ten
   times wider), and the worst distance found is printed.
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
5. The out-of-core path.  The cross-panel kernel against its plain version
   on two panels of a padded 3,000-row chunked index (panel offsets, a
   diagonal and an off-diagonal pair, blocks blanked by valid = 0, tiles
   (1024, 512) and (64, 128)), bit-identical.  Then, with the counters
   zeroed just before, ``ChunkedAllPairs.build`` + ``all_pairs(0.8)``
   three times on ``synthetic_corpus(100000, seed=0)`` (the resident
   sweep; the third timed with its stage split); the kernel against its
   plain version on one diagonal and one off-diagonal panel pair of that
   join (timed); one join with the rolling sweep; exact pair-set parity of
   both joins with the fp64 oracle.
6. The mesh paths, their shards on the one card.  Kernel 4 (the per-shard
   int8 matmul) against its plain version, exact int32 equality, at two
   small shapes and at the mesh join's own per-shard operands (a diagonal
   and an off-diagonal panel pair at 1 shard and at 8), timed beside
   ``torch._int_mm`` on the same operands (a yardstick only: the port never
   calls it).  ``MeshChunkedAllPairs`` on phase 5's corpus: with
   ``make_mesh(1)``, counters zeroed, build + ``all_pairs(0.8)`` three times
   (the third timed with its stage split), kernel 4 launched once per panel
   pair per join; then once over ``make_mesh(8, devices=[cuda:0] * 8)``,
   8 launches per panel pair.  ``MeshEngine(shard_axis="rows")`` over 4
   shards of the card on phase 3's corpus, three joins, kernel 3 launched 4
   times per join; then kernel 3 against its plain version, bit-identical,
   at the first and the last shard's own launch of that join (the gathered
   int8 index, the shard's striped schedule and valid flags).  Every mesh
   join's pair set equals the fp64 oracle and its candidate set that of the
   single-device join on the same corpus.

7. The full-rectangle join and everything that reaches it, each join
   gated on exact parity with the fp64 oracle of its corpus.
   ``Engine(use_pallas="off")`` on phase 3's 32,768 rows (bf16 operands,
   fp32 scores) and ``Engine(matmul_precision="highest")`` (a true fp32
   product) on the 8,586 rows and once at 32,768: build, three joins, the
   third timed with its stage split; the candidate set must contain the
   oracle's pairs; ``torch.backends.cuda.matmul.allow_tf32`` is printed
   before and after and must be unchanged, also when it was on.
   ``ChunkedAllPairs(pallas_int8=False)`` on phase 5's 100,000 rows: the
   bf16 stripes, three joins, pair set equal to phase 5's panel join
   (``stripe_parity``); stripe width, stripes, densify passes, stage split,
   peak memory.  Then one join with ``_int8_stripes = True``: kernel 4
   launched once per (stripe, chunk) between zeroed counters, and one
   (stripe, chunk) product compared bit for bit with its plain version and
   timed beside ``torch._int_mm``.  The meshes on the one card:
   ``MeshEngine(shard_axis="dims")`` over 4 shards and a ``(2, 2)`` mesh on
   the 32,768 rows, phase 6's rows mesh joined once more after
   ``_int8_off = True``, and ``MeshChunkedAllPairs(pallas_int8=False)``
   over 8 shards on the 100,000 rows (one join).

8. The dense engine's streaming path on phase 3's corpus.  ``Engine``
   builds on rows 0-24,575; every other row is streamed through
   ``insert(tau=0.8)`` (16 batches of 1, 16 of 32, then 256-row batches to
   the last row), which grows the row capacity to 49,152.  Gates: the
   build join's pairs and every insert's output, as unordered pairs, equal
   the fp64 oracle's; ``all_pairs(0.8)`` of the streamed index launches
   kernel 1 (counters zeroed just before) and equals the oracle; the bf16
   copy the inserts kept equals ``x.to(bfloat16)`` bit for bit;
   ``topk(k=10)`` for 1,024 queries (512 corpus rows under new ids, 512 of
   another seed) matches a dense fp64 top-k on the card rank for rank
   within 1e-12 (ids equal where the 10th and 11th scores differ by more),
   with ``allow_tf32`` on beforehand and unchanged after; ``freeze`` then
   256 inserts (128 corpus copies, 128 of a third seed) equal the fp64
   oracle at tau = 0.8 and index nothing.  Then, on rows of their own
   seed, host-clock timings (warm, median of 9): insert + ``result()`` at
   bs = 1, 32 and 256 with the stage split at 256, eight bs = 256 batches
   pipelined one deep with ``defer=True``, ``topk`` and frozen matching.

9. The chunked engine's streaming path on phase 5's corpus: 9a builds on
   90,000 rows and streams the rest on the resident route (the streamed
   union, the join of the streamed index with kernel 3, top-k and frozen
   matching against fp64 oracles), 9b beyond the slab budget (the router,
   column growth, both routes forced), then each route's timings.

10. Checkpoints, the server and the command line, on the card.  10a:
    phase 8's streamed dense index (checkpointed right after its join) is
    restored with ``Engine.load``; its join launches kernel 1 (counters
    zeroed just before), equals the fp64 oracle, and kernel 1 equals its
    plain version bit for bit at the restored operands; phase 9a's
    streamed chunked index is restored with its ``build`` made to raise
    (the fast path must place the saved buffers), and its join launches
    kernel 3 and equals the oracle.  Save, restore and build seconds and
    the npz sizes are printed.  10b: phase 3's rows go into a
    ``VectorStore`` table; ``SimilarityServer`` + ``RpcServer`` on
    127.0.0.1 bulk-load the first 24,576 rows through a load RPC, four
    ``ClientConnection``s stream the other 8,192 concurrently (batches of
    1, 32, 256) while a subscriber collects the pushed outputs; the pushed
    pairs and the ``all_pairs`` RPC (kernel 1 launched) equal the oracle,
    the ``topk`` RPC for 256 queries equals ``engine.topk`` id for id, and
    the checkpoint ``close()`` writes restores into a second server with
    the same join.  10c: ``python -m apsim_tpu_torch.cli`` in subprocesses:
    ``etl`` of a seeded 3,000-document text corpus, ``build`` and
    ``join`` on the card (the join's output equals an in-process join of
    the same store), ``serve`` driven by ``bench`` (the load generator;
    its insert -> first-result latencies printed), stopped with SIGINT;
    the checkpoint it writes on the way out loads.

11. The meshes' streaming path, their shards on the one card.  11a:
    ``MeshEngine`` over ``make_mesh(4, devices=[card] * 4)`` with
    ``shard_axis="rows"``, then ``"dims"``, then a ``(2, 2)`` mesh, each
    built on phase 8's first 24,576 rows with the rest streamed on phase
    8's schedule (row_cap 24,576 -> 49,152): the build join and every
    insert's output equal the fp64 oracle; the join of the streamed index
    equals it (the rows layout launches kernel 3 four times, counters
    zeroed just before, and kernel 3 equals its plain version bit for bit
    at shards 0 and 3 of that join, shard 0 timed); every block equals
    phase 8's streamed ``x`` on its live rows and is zero past them;
    phase 8's top-k and frozen queries pass ``check_topk`` /
    ``check_frozen``.  11c, on the rows layout: ``SimilarityServer`` +
    ``RpcServer`` over the streamed mesh, two clients stream 2,048 fresh
    rows, the pushed pairs equal the fp64 oracle.  Then each layout's
    insert (bs = 1, 32, 256, stage split at 256), top-k and frozen-match
    timings.  11b: ``MeshChunkedAllPairs`` over 8 shards of the card on
    phase 5's corpus: build 90,000 rows, stream the rest with phase 9a's
    batch sizes (every match on the rebuild route); the union, the join
    of the streamed index (kernel 4 eight times per panel pair; kernel 4
    exactly its plain version at pair (0, last) of shard 0, timed beside
    ``torch._int_mm``), top-k and frozen matching against fp64; batches of
    rows inside the fullest chunk until every shard's per-chunk capacity
    doubles (asserted; each batch against the fp64 oracle, and the join
    after it); then the timings with the stage split (slabs, product,
    reduce, compact).

Every kernel's record holds its bound: the larger of its operations over
the card's peak rate for their type and its bytes (inputs read once,
outputs written once) over the memory rate, at this run's shapes.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from apsim_tpu_torch import (AllPairsConfig, ChunkedAllPairs, CSRMatrix,
                             Engine, MeshChunkedAllPairs, MeshEngine,
                             SparseVector, make_mesh)
from apsim_tpu_torch.bench.ooc import (batch_oracle, dense_rows, join_ops,
                                       profile_join)
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import _build, panel as panel_ops, tri_score as ts
from apsim_tpu_torch.ops import chunked as chunked_ops
from apsim_tpu_torch.ops import mesh_pallas, panel_mesh
from apsim_tpu_torch.ops import score as score_ops
from apsim_tpu_torch.parallel.collectives import all_gather
from apsim_tpu_torch.vector.batch import round_up

TAU = 0.8
BF16_BAND = 1e-5  # |plain fp32 score - tau_eff| allowed where bf16 bits differ
SOURCE = "apsim_tpu_torch/csrc/score_bits.cu"
REPLACES = {
    "score_bits_int8": "apsim_tpu/ops/pallas_score.py:453",  # _kernel_int8
    "score_bits_bf16": "apsim_tpu/ops/pallas_score.py:117",  # _kernel
    "panel_score_bits_int8": "apsim_tpu/ops/panel.py:151",  # _kernel_int8_cross
    "int8_matmul": "apsim_tpu/ops/panel_mesh.py:42",  # _mm_kernel
}
OOC_ROWS = 100_000
# H100 SXM peaks (NVIDIA data sheet, dense): int8 ops/s, bf16 flop/s, HBM
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


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


def bound(ops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of the operations
    over ``peak`` and the bytes over the memory rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def upper_cells(bi, bj, tm: int, tn: int, off=(0, 0)) -> int:
    """Cells of the blocks (bi, bj) whose global row lies below their
    global column: the cells a scorer must compute."""
    r = (off[0] + bi.cpu().numpy().astype(np.int64)[:, None] * tm
         + np.arange(tm))
    c0 = off[1] + bj.cpu().numpy().astype(np.int64)[:, None] * tn
    return int(np.clip(c0 + tn - (r + 1), 0, tn).sum())


def score_bound(operands, aux_bytes: int, bi, bj, tm: int, tn: int,
                off, peak: float) -> dict:
    """Bound of one score-kernel launch: 2 ops per cell per K element on
    the strict-upper cells; the operand and aux bytes, the block list, and
    the gb / g64 / cnt outputs."""
    k = operands[0].shape[1]
    n = bi.numel()
    nbytes = (sum(o.numel() * o.element_size() for o in operands)
              + aux_bytes + 8 * n + n * (tm // 8 * tn + tm // 64 * tn + 12))
    return bound(2 * upper_cells(bi, bj, tm, tn, off) * k, nbytes, peak)


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
            timed: bool, band: float = BF16_BAND) -> dict:
    """Kernel vs plain version on the same operands; returns the record.
    ``band``: how far from tau_eff the plain fp32 score of a cell may lie
    when the bf16 kernel's bit differs."""
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
        if worst > band:
            raise AssertionError(
                f"bf16 kernel differs from plain at tiles {(tm, tn)} on "
                f"{n_diff} cells; worst |score - tau_eff| = {worst} > {band}"
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


def pair_set(pairs) -> set:
    """(row, col) arrays as a set of int pairs."""
    return set(zip(pairs[0].tolist(), pairs[1].tolist()))


def check_parity(res, want: set, label: str) -> int:
    got = set(zip(res.i.tolist(), res.j.tolist()))
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


def compare_cross(args, valid, label: str, timed: bool) -> dict:
    """Cross-panel kernel vs its plain version on the wrapper's positional
    ``args`` and ``valid``, bit-identical; a block with valid = 0 must
    write nothing."""
    kern = lambda: panel_ops.panel_score_bits_int8(*args, valid=valid)
    plain = lambda: panel_ops.panel_score_bits_int8_plain(*args, valid=valid)
    bi, bj, off, tm, tn = args[4], args[5], args[6], args[8], args[9]
    k = kern()
    torch.cuda.synchronize()
    p = plain()
    check_packing(k)
    err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, p))
    if err:
        n = int((ts.unpack_bits(k[0]) != ts.unpack_bits(p[0])).sum())
        raise AssertionError(
            f"panel kernel differs from plain ({label}) at tiles "
            f"{(tm, tn)}: {n} hit cells, max byte error {err}"
        )
    if valid is not None:
        off_blocks = valid == 0
        if k[0][off_blocks].any() or k[2][off_blocks].any():
            raise AssertionError("a block with valid = 0 wrote hits or counts")
    rec = {"offsets": list(off), "tiles": [tm, tn], "blocks": int(bi.numel()),
           "pairs_kernel": int(k[2][:, 0].sum()), "max_abs_err": 0.0}
    del k, p
    if timed:
        rec["ms"] = median_ms(kern)
        rec["plain_ms"] = median_ms(plain)
        rec["tops"] = (rec["blocks"] * tm * tn * args[0].shape[1] * 2
                       / rec["ms"] / 1e9)
        rec.update(score_bound(args[:2], 4 * (args[2].numel()
                                              + args[3].numel()),
                               bi, bj, tm, tn, off, PEAK_INT8))
    return rec


def compare_panel(eng: ChunkedAllPairs, pi: int, pj: int, tm: int, tn: int,
                  timed: bool, blank: bool = False) -> dict:
    """Cross-panel kernel vs its plain version on panels (pi, pj) of a
    chunked engine's join state; with ``blank`` every third block is
    blanked by valid = 0."""
    st = eng._panel_state()
    rb = st["geom"][0]
    grid = (panel_ops.diag_grid(rb, tm, tn) if pi == pj
            else panel_ops.full_grid(rb, rb, tm, tn))
    bi, bj = (torch.from_numpy(a).to(eng.device) for a in grid)
    valid = None
    if blank:
        valid = torch.ones_like(bi)
        valid[1::3] = 0
    args = (eng._build_slab(st, pi), eng._build_slab(st, pj),
            st["aux_of"][pi], st["aux_of"][pj], bi, bj, (pi * rb, pj * rb),
            eng._tau_eff(TAU), tm, tn)
    rec = compare_cross(args, valid, f"pair {(pi, pj)}", timed)
    return {"pair": [pi, pj], "blanked": blank, **rec}


def int8_rows(dev, rows: int, k: int, seed: int):
    """int8 operands and aux of ``rows`` random unit rows of width ``k``,
    every fourth row a copy of the one before (hits at TAU)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, k), device=dev, generator=gen)
    x[1::4] = x[0::4]
    x /= x.norm(dim=1, keepdim=True)
    return ts.quantize_rows(x)


def bf16_rows(dev, rows: int, pad: int, k: int, seed: int,
              positive: bool = False):
    """bf16 operand of ``rows`` random unit rows of width ``k`` (every
    fourth a copy of the one before; all elements positive on request) and
    ``pad`` zero rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, k), device=dev, generator=gen)
    if positive:
        x.abs_()
    x[1::4] = x[0:-1:4]
    x /= x.norm(dim=1, keepdim=True)
    return torch.cat([x, torch.zeros((pad, k), device=dev)]).to(torch.bfloat16)


def bf16_edge_phase(dev) -> None:
    """The bf16 kernel at the edges of its tiling and ring (phase 1)."""
    for k in (64, 2048):
        tau = 2.4 / k ** 0.5  # 2.4 sigma of a random pair's score
        for tm, tn in ((1024, 512), (512, 512), (256, 256), (64, 128)):
            x = bf16_rows(dev, 1900, 148, k, tm + k)
            bi, bj = blocks(2048, tm, tn, dev)
            rec = compare("bf16", x, bi, bj, tau, tm, tn, timed=False)
            few = compare("bf16", x, bi[:1], bj[:1], tau, tm, tn,
                          timed=False)
            if rec["pairs_kernel"] < 1000 or few["pairs_kernel"] < 1:
                raise AssertionError(
                    f"bf16 edge K={k} tiles {(tm, tn)}: too few hits to "
                    f"tell: {rec['pairs_kernel']}, {few['pairs_kernel']}")
            log(f"phase 1 bf16 edges K={k} tiles {(tm, tn)} thread-block "
                f"tile {ts.thread_block_tile(tm, tn)}: {rec['pairs_kernel']} "
                f"pairs ({rec['cells_differing']} cells differ from plain, "
                f"worst |score - tau| {rec['max_abs_err']:.3g} <= "
                f"{BF16_BAND}); one block: {few['pairs_kernel']} pairs "
                f"({few['cells_differing']} differ)")
    k = 32768
    band = (k + 2) * 2.0 ** -24
    x = bf16_rows(dev, 2048, 0, k, 11, positive=True)
    bi, bj = blocks(2048, 1024, 512, dev)
    tau = float(next(ts.bf16_scores(x, bi[:1], bj[1:2], 1024, 512))[2]
                .median())
    rec = compare("bf16", x, bi, bj, tau, 1024, 512, timed=False, band=band)
    if not 0.2 < rec["pairs_kernel"] / upper_cells(bi, bj, 1024, 512) < 0.8:
        raise AssertionError(f"dense stress: threshold off the bulk: {rec}")
    log(f"phase 1 bf16 dense stress, 2048 rows of {k} positive elements, "
        f"tau {tau:.6f}: {rec['pairs_kernel']} pairs, "
        f"{rec['cells_differing']} cells differ from plain, worst "
        f"|score - tau| {rec['max_abs_err']:.3g} <= {band:.3g} "
        f"((K + 2) * 2^-24)")


def edge_phase(dev) -> None:
    """The int8 kernels at the edges of their tiling and ring (phase 1)."""
    for k in (128, 4096):
        for tm, tn in ((1024, 512), (512, 512), (256, 256), (64, 128)):
            q, aux = int8_rows(dev, 2048, k, tm + k)
            bi, bj = blocks(2048, tm, tn, dev)
            rec = compare("int8", (q, aux), bi, bj, TAU, tm, tn, timed=False)
            recs = [rec["pairs_kernel"]]
            gi, gj = (torch.from_numpy(a).to(dev)
                      for a in panel_ops.full_grid(1024, 1024, tm, tn))
            valid = torch.ones_like(gi)
            valid[::3] = 0
            ai, aj = aux[:, :1024].contiguous(), aux[:, 1024:].contiguous()
            for off in ((0, 1024), (512, 768), (1024, 0)):
                args = (q[:1024], q[1024:], ai, aj, gi, gj, off, TAU, tm, tn)
                recs.append(compare_cross(args, valid, f"edge {off}",
                                          timed=False)["pairs_kernel"])
            if recs[0] == 0 or recs[-1] != 0:
                raise AssertionError(
                    f"edge K={k} tiles {(tm, tn)}: expected hits in the "
                    f"triangle and none in the dead rectangle, got {recs}")
            log(f"phase 1 edges K={k} tiles {(tm, tn)} thread-block tile "
                f"{ts.thread_block_tile(tm, tn)}: bit-identical; pairs (triangle, "
                f"(0, 1024), (512, 768), dead (1024, 0)) = {recs}")
    k = 32768
    gen = torch.Generator(device=dev).manual_seed(7)
    sign = torch.randint(0, 2, (256, 1), device=dev, generator=gen)
    q = (127 * (2 * sign - 1)).to(torch.int8).expand(256, k).contiguous()
    d = panel_mesh.int8_matmul(q[:128], q)
    if (not torch.equal(d, panel_mesh.int8_matmul_plain(q[:128], q))
            or int(d.abs().max()) != 127 * 127 * k):
        raise AssertionError("kernel 4 is not exact on ±127 rows, K = 32768")
    aux = torch.stack([torch.full((256,), 1 / 127 / 181.02, device=dev),
                       torch.ones(256, device=dev),
                       torch.full((256,), float(k), device=dev)])
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    rec = compare_cross((q, q, aux, aux, zero, zero, (0, 256), 0.5, 256, 256),
                        None, "±127 rows", timed=False)
    log(f"phase 1 edges ±127 rows, K = {k}: kernel 4 exact (|D| = "
        f"{int(d.abs().max())}), kernel 3 bit-identical "
        f"({rec['pairs_kernel']} pairs)")
    del q, d
    for m, n, dd in ((64, 128, 128), (128, 256, 128), (128, 256, 4096),
                     (192, 384, 256), (8192, 256, 128)):
        gen = torch.Generator(device=dev).manual_seed(m * n + dd)
        xi, xj = (torch.randint(-127, 128, (r, dd), dtype=torch.int8,
                                device=dev, generator=gen) for r in (m, n))
        if not torch.equal(panel_mesh.int8_matmul(xi, xj),
                           panel_mesh.int8_matmul_plain(xi, xj)):
            raise AssertionError(f"kernel 4 differs at {(m, n, dd)}")
        log(f"phase 1 edges kernel 4 [{m}, {dd}] x [{n}, {dd}]^T, thread-"
            f"block tile {ts.thread_block_tile(m, n)}: exact")


def compare_rows_shard(eng: MeshEngine, s: int, timed: bool = False) -> dict:
    """The cross-panel kernel vs its plain version on shard ``s``'s launch
    of the rows mesh join: the all-gathered int8 index and aux, the shard's
    striped schedule and its valid flags, zero offsets, the path's tiles
    (``timed``: with its time, its plain version's and its bound)."""
    dev = eng.mesh.devices[s]
    tm, tn = eng._mesh_rows_geom()
    bi, bj, va = (torch.from_numpy(a[s]).to(dev) for a in
                  mesh_pallas.rows_schedule(eng.row_cap, eng.n_shards, tm, tn))
    qa = [ts.quantize_rows(x) for x in eng.x_blocks]
    qg = all_gather([q for q, _ in qa], 0, dev)
    ag = all_gather([a for _, a in qa], 1, dev).contiguous()
    del qa
    args = (qg, qg, ag, ag, bi, bj, (0, 0), eng._tau_eff(TAU), tm, tn)
    rec = compare_cross(args, va, f"rows mesh shard {s}", timed=timed)
    if timed:  # the live blocks only; the gathered copy read once
        live = va > 0
        rec.update(score_bound((qg,), 4 * ag.numel(), bi[live], bj[live],
                               tm, tn, (0, 0), PEAK_INT8))
    return {"shard": s, "live_blocks": int(va.sum()), **rec}


def ooc_join(eng: ChunkedAllPairs, label: str, reps: int,
             ops_of=join_ops) -> dict:
    """``reps`` joins at TAU; the last is timed with its stage split.
    ``ops_of(geom)`` gives the join's int8 operations."""
    for _ in range(reps - 1):
        eng.all_pairs(TAU)
    before = dict(eng.timer.totals)
    counts0 = dict(eng.timer.counts)
    cand0 = eng.stats["candidates_scored"]
    t0 = time.perf_counter()
    res = eng.all_pairs(TAU)
    secs = time.perf_counter() - t0
    stages = {k: v - before.get(k, 0.0) for k, v in eng.timer.totals.items()
              if k != "all_pairs"}
    n = eng.n_rows
    geom = eng._panel_geom()
    ops = ops_of(geom)
    rec = {
        "rows": n, "geom": dict(zip(("rb", "tm", "tn", "n_panels", "d_cap"),
                                    geom)),
        "seconds": secs, "decided_pairs_per_s": n * (n - 1) / 2 / secs,
        "candidates": eng.stats["candidates_scored"] - cand0,
        "pairs": res.n_pairs, "stages_s": stages,
        "slab_builds": eng.timer.counts["slabs"] - counts0.get("slabs", 0),
        "int8_ops": ops, "kernel_stage_tops": ops / stages["kernel"] / 1e12,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    log(f"{label}: {json.dumps(rec)}")
    return {"rec": rec, "res": res}


def zero_launches() -> None:
    for k in ts.LAUNCHES:
        ts.LAUNCHES[k] = 0


def mesh_join_ops(geom) -> int:
    """int8 operations of one mesh panel join: every panel pair is a full
    ``rb x rb`` rectangle over the global width."""
    rb, _, _, n_panels, d_cap = geom
    return n_panels * (n_panels + 1) // 2 * 2 * rb * rb * d_cap


def compare_mm(xi, xj, label: str) -> dict:
    """Kernel 4 against its plain version on (xi, xj), exact int32
    equality; timed (CUDA events, median of 5) beside ``torch._int_mm`` on
    the same operands, the library yardstick."""
    k = panel_mesh.int8_matmul(xi, xj)
    torch.cuda.synchronize()
    p = panel_mesh.int8_matmul_plain(xi, xj)
    if not torch.equal(k, p):
        raise AssertionError(
            f"int8_matmul differs from plain ({label}): "
            f"{int((k != p).sum())} cells")
    lib_equal = bool(torch.equal(torch._int_mm(xi, xj.t()), k))
    del k, p
    (m, d), n = xi.shape, xj.shape[0]
    ops = 2 * m * n * d
    rec = {"label": label, "m": m, "n": n, "d": d, "max_abs_err": 0.0,
           "library_equal": lib_equal,
           "ms": median_ms(lambda: panel_mesh.int8_matmul(xi, xj)),
           "plain_ms": median_ms(lambda: panel_mesh.int8_matmul_plain(xi, xj)),
           "library_ms": median_ms(lambda: torch._int_mm(xi, xj.t()))}
    rec["tops"] = ops / rec["ms"] / 1e9
    rec.update(bound(ops, (m + n) * d + 4 * m * n, PEAK_INT8))
    log(f"kernel 4: {json.dumps(rec)}")
    return rec


def rect_flops(row_cap: int, tile: int, dim_cap: int) -> int:
    """Multiply-adds x 2 of one upper rectangle join: every tile against
    its bucket's row prefix."""
    return sum(2 * (b1 * tile) * tile * dim_cap * (b1 - b0)
               for b0, b1 in score_ops.upper_buckets(row_cap // tile))


def rect_phase(cfg: AllPairsConfig, csr, want: set, label: str, dev,
               make=None) -> dict:
    """Build an engine whose join is the full rectangle, join three times
    (the third timed), hold the pair set against the oracle ``want`` and
    the candidate set against it as a superset; TF32 must be as found."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    eng = make(cfg) if make else Engine(cfg, dev)
    log(f"build {label}: {json.dumps(eng.build(csr))}")
    if eng._kernel_ok():
        raise AssertionError(f"{label}: the kernel path was not refused")
    before = dict(ts.LAUNCHES)
    j = timed_join(eng, label)
    flops = rect_flops(eng.row_cap, eng.cfg.query_tile, eng.dim_cap)
    log(f"{label}: {flops:.3e} FLOP a join, "
        f"{flops / j['rec']['stages_s']['kernel'] / 1e12:.1f} TFLOP/s in "
        f"the kernel stage; allow_tf32 {tf32} before, "
        f"{torch.backends.cuda.matmul.allow_tf32} after")
    if torch.backends.cuda.matmul.allow_tf32 != tf32:
        raise AssertionError(f"{label}: the join changed allow_tf32")
    if dict(ts.LAUNCHES) != before or eng._used_int8:
        raise AssertionError(f"{label}: the rectangle launched a kernel")
    check_parity(j["res"], want, label)
    cand = pair_set(eng._all_pairs_rect(eng._tau_eff(TAU)))
    if not cand >= want:
        raise AssertionError(f"{label}: {len(want - cand)} oracle pairs are "
                             f"missing from the candidate set")
    log(f"{label}: {len(cand)} candidates contain the oracle's {len(want)}")
    if not np.all(np.isfinite(j["res"].sims)):
        raise AssertionError(f"{label}: non-finite sims")
    return j


def stripe_join(eng: ChunkedAllPairs, label: str, reps: int) -> dict:
    """``reps`` stripe joins at TAU; the last is timed with its stage
    split, stripe geometry and peak memory."""
    if eng._panel_ok() and eng._panel_state() is not None:
        raise AssertionError(f"{label}: the panel path was not refused")
    for _ in range(reps - 1):
        eng.all_pairs(TAU)
    torch.cuda.reset_peak_memory_stats()
    before = dict(eng.timer.totals)
    counts0 = dict(eng.timer.counts)
    cand0 = eng.stats["candidates_scored"]
    t0 = time.perf_counter()
    res = eng.all_pairs(TAU)
    secs = time.perf_counter() - t0
    st = eng._q_super()
    n = eng.n_rows
    n_stripes = -(-n // st)
    width = eng._chunk_width
    rec = {
        "rows": n, "row_cap": eng.row_cap, "super_tile": st,
        "stripes": n_stripes, "n_chunks": eng._n_chunks, "chunk_width": width,
        "densify_passes": eng.timer.counts["slabs"] - counts0.get("slabs", 0),
        "seconds": secs, "decided_pairs_per_s": n * (n - 1) / 2 / secs,
        "candidates": eng.stats["candidates_scored"] - cand0,
        "pairs": res.n_pairs,
        "stages_s": {k: v - before.get(k, 0.0)
                     for k, v in eng.timer.totals.items() if k != "all_pairs"},
        "ops": n_stripes * eng._n_chunks * 2 * eng.row_cap * st * width,
        "int8": eng._int8_slabs() is not None,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    log(f"{label}: {json.dumps(rec)}")
    return {"rec": rec, "res": res}


def compare_stripe_mm(eng: ChunkedAllPairs, q0: int, c: int) -> dict:
    """Kernel 4 at one (stripe, chunk) product of the int8 stripes, bit for
    bit against its plain version, timed beside ``torch._int_mm``."""
    q2d, _ = eng._int8_slabs()
    slab = chunked_ops.densify_chunk(
        eng._ent[0], eng._ent[1], q2d, eng._counts, c, eng.row_cap,
        eng._chunk_width, torch.int8)
    xj = chunked_ops.stripe_query_rows(slab, q0, eng._q_super(),
                                       panel_mesh.MM_TN)
    if int((slab != 0).sum()) != int(eng._counts[c]):
        raise AssertionError("the slab does not hold the chunk's entries")
    return compare_mm(slab, xj, f"int8 stripe q0={q0}, chunk {c}")


# ------------------------------------------------ phase 8: the streaming path
STREAM_BUILD = 24_576


def csr_rows(csr: CSRMatrix, lo: int, hi: int) -> CSRMatrix:
    """Rows [lo, hi) of ``csr`` as a CSR of their own."""
    a, b = int(csr.indptr[lo]), int(csr.indptr[hi])
    return CSRMatrix(hi - lo, csr.n_cols, csr.indptr[lo:hi + 1] - a,
                     csr.indices[a:b], csr.data[a:b])


def dense64(csr: CSRMatrix, dev) -> torch.Tensor:
    """fp64 ``[rows, 32768]`` of a synthetic corpus (its dims lie below
    32,768) on the card: the streaming oracle's operand."""
    rows = np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr))
    d = torch.zeros((csr.n_rows, 32768), dtype=torch.float64, device=dev)
    d[torch.from_numpy(rows).to(dev),
      torch.from_numpy(csr.indices.astype(np.int64)).to(dev)] = (
        torch.from_numpy(csr.data).to(dev))
    return d


def median_host_ms(fn, reps: int = 9) -> float:
    """Median host-clock time of ``fn`` over ``reps`` warm runs."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def dims_step(eng: Engine, csr: CSRMatrix, d: torch.Tensor,
              want: set) -> None:
    """Column growth and dormant activation on the streamed index: 64
    corpus rows with their dims moved past the corpus's mint columns (dims
    seen twice in the batch) and archive the rest as singletons; copies of
    eight of them then activate those singletons, whose entries go into
    the older rows of ``x`` and of its kept bf16 copy, without growth. The
    outputs equal an fp64 oracle, and the join of the grown index (kernel
    1) equals the old pair set with the new pairs."""
    picks = np.arange(7, csr.n_rows, csr.n_rows // 64)[:64]
    vecs = []
    for p in picks:
        v = csr.row(int(p))
        vecs.append(SparseVector(v.size, v.indices + 32768, v.values))
    n0 = eng.n_rows
    ids = [str(n0 + k) for k in range(72)]
    cap0, dorm0 = eng.dim_cap, eng.stats["dormant_dims"]
    union = set()

    def add(out) -> None:
        for q, cands in out.output.items():
            for c in cands:
                a, b = int(q), int(c)
                union.add((min(a, b), max(a, b)))

    add(eng.insert(list(zip(ids[:64], vecs)), tau=TAU))
    cap1, dorm1 = eng.dim_cap, eng.stats["dormant_dims"]
    kept1 = eng._bf16_cache[1]
    if cap1 <= cap0 or dorm1 <= dorm0:
        raise AssertionError(f"new dims: dim_cap {cap0} -> {cap1}, dormant "
                             f"dims {dorm0} -> {dorm1}")
    add(eng.insert(list(zip(ids[64:], vecs[:8])), tau=TAU))
    dorm2 = eng.stats["dormant_dims"]
    key, kept = eng._bf16_cache
    if eng.dim_cap != cap1 or dorm2 >= dorm1:
        raise AssertionError(f"activation: dim_cap {cap1} -> {eng.dim_cap}, "
                             f"dormant dims {dorm1} -> {dorm2}")
    if kept is not kept1 or key != (id(eng.x), eng.x._version) or not (
            torch.equal(kept, eng.x.to(torch.bfloat16))):
        raise AssertionError("the activation's entries are not in the kept "
                             "bf16 copy, or the copy was recast")
    # fp64 oracle of the 72 new rows against the corpus and each other
    rows = np.repeat(np.arange(72), [v.indices.size for v in vecs + vecs[:8]])
    q = torch.zeros((72, 65536), dtype=torch.float64, device=d.device)
    q[torch.from_numpy(rows).to(d.device),
      torch.from_numpy(np.concatenate(
          [v.indices for v in vecs + vecs[:8]]).astype(np.int64)).to(
              d.device)] = torch.from_numpy(np.concatenate(
                  [v.values for v in vecs + vecs[:8]])).to(d.device)
    want_new = set()
    ii, rr = torch.nonzero(q[:, :32768] @ d.T >= TAU, as_tuple=True)
    want_new.update((r, n0 + i) for i, r in zip(ii.tolist(), rr.tolist()))
    ii, jj = torch.nonzero(q @ q.T >= TAU, as_tuple=True)
    want_new.update((n0 + i, n0 + j) for i, j in zip(ii.tolist(), jj.tolist())
                    if i < j)
    if union != want_new:
        raise AssertionError(f"new-dims inserts differ from the fp64 oracle: "
                             f"{len(union - want_new)} extra, "
                             f"{len(want_new - union)} missing")
    zero_launches()
    res = eng.all_pairs(TAU)
    if ts.LAUNCHES["score_bits_int8"] < 1 or not eng._used_int8:
        raise AssertionError("the grown index's join did not launch "
                             "score_bits_int8")
    check_parity(res, want | want_new, "phase 8 join of the grown index")
    log(f"phase 8 new dims: dim_cap {cap0} -> {cap1}, dormant dims {dorm0} "
        f"-> {dorm1} -> {dorm2} (8 copies activated {dorm1 - dorm2}); kept "
        f"bf16 copy in step; {len(union)} new pairs equal the fp64 oracle; "
        f"join of the grown index (kernel 1, "
        f"{ts.LAUNCHES['score_bits_int8']} launches) equals the oracle")


def check_topk(eng, queries, sq: torch.Tensor, label: str) -> None:
    """``eng.topk(queries, 10)`` with ``allow_tf32`` on beforehand: it must
    come back on, and every query's fp64 scores must equal the dense fp64
    top-k of the scores ``sq [nq, n_rows]`` rank for rank within 1e-12 (the
    ids too where the 10th and 11th scores differ), each reported score
    its row's own."""
    dev = sq.device
    ora_s, ora_r = torch.topk(sq, 11, dim=1)
    ora_s, ora_r = ora_s.cpu().numpy(), ora_r.cpu().numpy()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    top = eng.topk(queries, 10)
    tf32_after = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"{label} topk: allow_tf32 True before, {tf32_after} after")
    if tf32_after is not True:
        raise AssertionError("topk changed allow_tf32")
    n_tied = 0
    for qi, (qid, _) in enumerate(queries):
        got = top[qid]
        scores = np.array([v for _, v in got])
        if len(got) != 10 or np.abs(scores - ora_s[qi, :10]).max() > 1e-12:
            raise AssertionError(f"topk {qid}: scores {scores} vs fp64 "
                                 f"{ora_s[qi, :10]}")
        if ora_s[qi, 9] - ora_s[qi, 10] > 1e-12:
            if {int(c) for c, _ in got} != set(ora_r[qi, :10].tolist()):
                raise AssertionError(f"topk {qid}: ids differ from fp64")
        else:
            n_tied += 1
    ids = torch.tensor([[int(c) for c, _ in top[q]] for q, _ in queries],
                       device=dev)
    mine = torch.tensor([[v for _, v in top[q]] for q, _ in queries],
                        dtype=torch.float64, device=dev)
    if float((torch.gather(sq, 1, ids) - mine).abs().max()) > 1e-12:
        raise AssertionError("topk: a reported score is not its row's")
    log(f"{label} topk(k=10), {len(queries)} queries: fp64 scores rank for "
        f"rank within 1e-12 of the dense fp64 top-k, ids equal where the "
        f"10th and 11th differ ({n_tied} queries tied there)")


def check_frozen(eng, fq, fs: torch.Tensor, fpicks, label: str) -> None:
    """``freeze``, then ``insert(fq)``: the output must equal the fp64
    oracle of the scores ``fs [nq, n_rows]`` at TAU (similarities within
    1e-12), each copied corpus row ``z<r>`` must find row r, and nothing
    may be indexed; ``unfreeze`` after."""
    eng.freeze()
    n0 = eng.n_rows
    out = eng.insert(fq, tau=TAU).output
    if eng.n_rows != n0:
        raise AssertionError("a frozen insert indexed rows")
    qi, ri = torch.nonzero(fs >= TAU, as_tuple=True)
    fs_h = fs.cpu().numpy()
    row_of = {q: k for k, (q, _) in enumerate(fq)}
    want_f: dict = {}
    for a, b in zip(qi.tolist(), ri.tolist()):
        want_f.setdefault(fq[a][0], set()).add(str(b))
    if {q: set(c) for q, c in out.items()} != want_f or any(
            abs(v - fs_h[row_of[q], int(c)]) > 1e-12
            for q, cs in out.items() for c, v in cs.items()):
        raise AssertionError("frozen match differs from the fp64 oracle")
    if any(not out.get(f"z{r}", {}).get(str(r)) for r in fpicks):
        raise AssertionError("a copied row did not find itself")
    log(f"{label} frozen match, {len(fq)} queries: "
        f"{sum(map(len, out.values()))} pairs equal the fp64 oracle at "
        f"tau = {TAU}; n_rows unchanged")
    eng.unfreeze()


def stream_phase(dev, csr: CSRMatrix, want: set, kernels: list,
                 smi: str, ckpt: str) -> dict:
    """Phase 8: build on the first 24,576 rows of phase 3's corpus, stream
    every other row through ``insert``, then hold the union of the outputs,
    the join of the streamed index (and kernel 1 at its operands), the kept
    bf16 copy, ``topk``, frozen matching and ``dims_step`` against fp64
    oracles; then time the streaming entry points.  The streamed index is
    checkpointed to ``ckpt`` right after its join (phase 10 restores it).
    Returns the save's record, and for phase 11 a host copy of the live
    rows of the streamed ``x`` and the top-k and frozen-match query sets
    with their fp64 scores (on the host)."""
    t_phase = time.perf_counter()
    eng = Engine(AllPairsConfig(), dev)
    log(f"phase 8 build, {STREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, STREAM_BUILD)))}")
    caps0 = (eng.row_cap, eng.dim_cap)
    res = eng.all_pairs(TAU)
    union = set(zip(res.i.tolist(), res.j.tolist()))
    sizes = [1] * 16 + [32] * 16
    s = STREAM_BUILD
    t0 = time.perf_counter()
    n_batches = 0
    while s < csr.n_rows:
        bs = sizes[n_batches] if n_batches < len(sizes) else 256
        e = min(s + bs, csr.n_rows)
        out = eng.insert([(str(i), csr.row(i)) for i in range(s, e)], tau=TAU)
        for q, cands in out.output.items():
            for c in cands:
                a, b = int(q), int(c)
                union.add((min(a, b), max(a, b)))
        s, n_batches = e, n_batches + 1
    stream_s = time.perf_counter() - t0
    if eng.n_rows != csr.n_rows or eng.row_cap != 2 * STREAM_BUILD:
        raise AssertionError(f"stream: n_rows {eng.n_rows}, row_cap "
                             f"{eng.row_cap}")
    if union != want:
        raise AssertionError(
            f"streamed union differs from the fp64 oracle: "
            f"{len(union - want)} extra, {len(want - union)} missing")
    x8 = eng.x[:eng.n_rows].cpu()  # phase 11's meshes must equal it
    log(f"phase 8 stream: {n_batches} inserts of rows {STREAM_BUILD}-"
        f"{csr.n_rows - 1} in {stream_s:.3f} s; (row_cap, dim_cap) {caps0} -> "
        f"{(eng.row_cap, eng.dim_cap)}; build join + every insert's output: "
        f"{len(union)} pairs equal the fp64 oracle")

    zero_launches()
    res = eng.all_pairs(TAU)
    launches = dict(ts.LAUNCHES)
    log(f"phase 8 join of the streamed index, kernel launches: {launches}")
    if launches["score_bits_int8"] < 1 or not eng._used_int8:
        raise AssertionError("the streamed index's join did not launch "
                             "score_bits_int8")
    check_parity(res, want, "phase 8 join of the streamed index")
    tm, tn = eng._tiles()
    bi, bj = blocks(eng.row_cap, tm, tn, dev)
    rec = compare("int8", eng._operands(True), bi, bj, eng._tau_eff(TAU),
                  tm, tn, timed=False)
    log(f"phase 8 int8 kernel vs plain at the streamed index's operands, "
        f"row_cap={eng.row_cap} dim_cap={eng.dim_cap} "
        f"({eng.row_cap - eng.n_rows} padding rows): {json.dumps(rec)}")
    kernels[0].update(stream_join_launches=launches["score_bits_int8"],
                      stream_max_abs_err=rec["max_abs_err"])
    del bi, bj
    saved = save_checkpoint(eng, ckpt, "phase 8 streamed dense index")

    key, kept = eng._bf16_cache
    if key != (id(eng.x), eng.x._version) or not torch.equal(
            kept, eng.x.to(torch.bfloat16)):
        raise AssertionError("the kept bf16 copy is not a fresh cast of x")
    log("phase 8 kept bf16 copy: in step with x, equal to x.to(bfloat16) "
        "bit for bit")

    # top-k: 512 corpus rows under new ids (ties at 1.0 with duplicates)
    # and 512 rows of another seed, against an fp64 dense top-k
    d = dense64(csr, dev)
    qsrc = synthetic_corpus(512, seed=7)
    picks = np.arange(0, csr.n_rows, csr.n_rows // 512)[:512]
    queries = ([(f"t{r}", csr.row(int(r))) for r in picks]
               + [(f"s{i}", qsrc.row(i)) for i in range(512)])
    qd = torch.cat([d[torch.from_numpy(picks).to(dev)], dense64(qsrc, dev)])
    sq = qd @ d.T
    check_topk(eng, queries, sq, "phase 8")
    sq_host = sq.cpu()
    del sq, qd

    # frozen matching: queries are scored, not indexed
    fsrc = synthetic_corpus(128, seed=11)
    fpicks = np.arange(5, csr.n_rows, csr.n_rows // 128)[:128]
    fq = ([(f"z{r}", csr.row(int(r))) for r in fpicks]
          + [(f"y{i}", fsrc.row(i)) for i in range(128)])
    fd = torch.cat([d[torch.from_numpy(fpicks).to(dev)], dense64(fsrc, dev)])
    fs = fd @ d.T
    check_frozen(eng, fq, fs, fpicks, "phase 8")
    qsets = (queries, sq_host, fq, fs.cpu(), fpicks)
    dims_step(eng, csr, d, want)
    del d, fd, fs
    torch.cuda.empty_cache()

    # timings (host clock, warm, median of 9), after the gates
    def split(before: dict, names, reps: int = 9) -> dict:
        """Mean ms per call of each Timer section since ``before``."""
        return {k: (eng.timer.totals.get(k, 0.0) - before.get(k, 0.0))
                / reps * 1e3 for k in names}

    rec = {"card": smi, "rows": eng.n_rows, "row_cap": eng.row_cap,
           "dim_cap": eng.dim_cap}
    before = dict(eng.timer.totals)
    rec["topk_ms"] = median_host_ms(lambda: eng.topk(queries, 10))
    rec["topk_queries_per_s"] = len(queries) / rec["topk_ms"] * 1e3
    rec["topk_stages_ms"] = split(before, ("topk_fetch", "topk_rescore",
                                           "topk_assemble"))
    eng.freeze()
    eng.insert(fq, tau=TAU)
    before = dict(eng.timer.totals)
    rec["frozen_ms"] = median_host_ms(lambda: eng.insert(fq, tau=TAU))
    rec["frozen_queries_per_s"] = len(fq) / rec["frozen_ms"] * 1e3
    rec["frozen_stages_ms"] = split(before, ("admit", "frozen_product",
                                             "frozen_rescore"))
    eng.unfreeze()
    extra = synthetic_corpus(8192, seed=13)
    cursor = [0]

    def take(n):
        a = cursor[0]
        cursor[0] += n
        return [(f"x{i}", extra.row(i)) for i in range(a, a + n)]

    for bs in (1, 32, 256):
        batches = [take(bs) for _ in range(11)]
        for b in batches[:2]:
            eng.insert(b, tau=TAU, defer=True).result()
        it = iter(batches[2:])
        before = dict(eng.timer.totals)
        ms = median_host_ms(
            lambda: eng.insert(next(it), tau=TAU, defer=True).result())
        rec[f"insert_bs{bs}_ms"] = ms
        rec[f"insert_bs{bs}_vectors_per_s"] = bs / ms * 1e3
        if bs == 256:
            rec["stages_ms_per_batch_bs256"] = split(
                before, ("insert", "admit", "prepare", "append", "product",
                         "compact", "d2h", "rescore"))
    batches = [take(256) for _ in range(8)]
    t0 = time.perf_counter()
    prev = None
    for b in batches:
        cur = eng.insert(b, tau=TAU, defer=True)
        if prev is not None:
            prev.result()
        prev = cur
    prev.result()
    dt = time.perf_counter() - t0
    rec["pipelined_bs256_ms_per_batch"] = dt / len(batches) * 1e3
    rec["pipelined_bs256_vectors_per_s"] = 256 * len(batches) / dt
    if eng.row_cap != 2 * STREAM_BUILD:
        raise AssertionError("the timing inserts grew the index")
    # the path's two products alone (CUDA events, median of 5): a bs = 256
    # match against the kept bf16 copy, and top-k's true fp32 product for
    # 1,024 queries
    n, k = eng.n_rows, eng.dim_cap
    xo, xs = eng._rect_operand()[:n], eng.x[:n]
    qb, qf = xo[n - 256:], eng.x[:1024]
    rec["match_product"] = {
        "shape": [n, 256, k],
        "ms": median_ms(lambda: score_ops.score_tile(xo, qb, "default")),
        **bound(2 * n * 256 * k, 2 * (n + 256) * k + 4 * n * 256, PEAK_BF16)}
    rec["topk_product"] = {
        "shape": [1024, n, k],
        "ms": median_ms(lambda: score_ops.score_tile(qf, xs, "highest")),
        **bound(2 * 1024 * n * k, 4 * (n + 1024) * k + 4 * 1024 * n,
                PEAK_FP32)}
    rec["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 8 timings: {json.dumps(rec)}")
    return saved, x8, qsets


# ---------------------------------------- phase 9: the chunked streaming path
CSTREAM_BUILD = 90_000
CSTREAM_CAPS = [90112, 98304, 106496]  # the row capacities the stream sees
DIMS_CAPACITY = 36864  # compact capacity after the shifted rows' new dims


def pairs_of(out) -> set:
    """An insert's output as unordered int pairs."""
    return {(min(int(q), int(c)), max(int(q), int(c)))
            for q, cands in out.output.items() for c in cands}


def block_scores(csr: CSRMatrix, qd: torch.Tensor) -> torch.Tensor:
    """fp64 scores ``[nq, csr.n_rows]`` of dense queries ``qd`` against the
    rows of ``csr``, densified on the card 16,384 rows at a time."""
    out = torch.empty((qd.shape[0], csr.n_rows), dtype=torch.float64,
                      device=qd.device)
    for r0 in range(0, csr.n_rows, 16384):
        r1 = min(r0 + 16384, csr.n_rows)
        out[:, r0:r1] = qd @ dense_rows(csr, r0, r1, qd.shape[1],
                                        qd.device).T
    return out


def query_sets(csr: CSRMatrix, dev):
    """Phase 8's query sets on the 100,000-row corpus: 1,024 top-k queries
    (512 corpus rows under new ids, 512 of seed 7) and 256 frozen-match
    queries (128 copies, 128 of seed 11), each with its fp64 scores
    against the corpus."""
    qsrc, fsrc = synthetic_corpus(512, seed=7), synthetic_corpus(128, seed=11)
    picks = np.arange(0, csr.n_rows, csr.n_rows // 512)[:512]
    fpicks = np.arange(5, csr.n_rows, csr.n_rows // 128)[:128]
    queries = ([(f"t{r}", csr.row(int(r))) for r in picks]
               + [(f"s{i}", qsrc.row(i)) for i in range(512)])
    fq = ([(f"z{r}", csr.row(int(r))) for r in fpicks]
          + [(f"y{i}", fsrc.row(i)) for i in range(128)])
    scores = []
    for qs in (queries, fq):
        qcsr = CSRMatrix.from_vectors([v for _, v in qs], csr.n_cols)
        scores.append(block_scores(
            csr, dense_rows(qcsr, 0, qcsr.n_rows, 32768, dev)))
    return queries, scores[0], fq, scores[1], fpicks


def stream_rows(eng, csr: CSRMatrix, lo: int, sizes, route=None,
                beyond_budget: bool = False):
    """Insert rows ``[lo, n_rows)`` of ``csr`` (ids: row numbers) in batches
    of ``sizes``, then of 256; ``route`` (if given) must be each batch's;
    with ``beyond_budget`` each batch must find the chunked engine beyond
    its slab budget.  Returns the union of the outputs, the routes taken
    (chunked engines), the row capacities seen, the batch count and the
    seconds."""
    union, routes, caps = set(), [], [eng.row_cap]
    s, nb = lo, 0
    t0 = time.perf_counter()
    while s < csr.n_rows:
        bs = sizes[nb] if nb < len(sizes) else 256
        e = min(s + bs, csr.n_rows)
        if beyond_budget and not eng._paneled_ok():
            raise AssertionError(f"batch at row {s}: not beyond the budget")
        out = eng.insert([(str(i), csr.row(i)) for i in range(s, e)], tau=TAU)
        routes.append(getattr(eng, "last_route", None))
        if route is not None and eng.last_route != route:
            raise AssertionError(f"batch at row {s} took {eng.last_route}, "
                                 f"not {route}")
        if eng.row_cap != caps[-1]:
            caps.append(eng.row_cap)
        union |= pairs_of(out)
        s, nb = e, nb + 1
    return union, routes, caps, nb, time.perf_counter() - t0


def chunked_stream_resident(dev, csr: CSRMatrix, want: set, kernels: list,
                            qsets, smi: str, ckpt: str) -> dict:
    """Phase 9a: the resident route at 100,000 rows: build on 90,000, stream
    the rest, gate, join (kernel 3), top-k and frozen matching against fp64
    oracles; then the route's timings.  The streamed index is checkpointed
    to ``ckpt`` right after its join.  Returns the save's record."""
    eng = ChunkedAllPairs(AllPairsConfig(), dev)
    log(f"phase 9a build, {CSTREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, CSTREAM_BUILD)))}")
    res = eng.all_pairs(TAU)
    builds0 = eng.timer.counts.get("match_slabs", 0)
    union, _, caps, nb, secs = stream_rows(
        eng, csr, CSTREAM_BUILD, [1] * 8 + [32] * 8, "resident_slabs")
    union |= set(zip(res.i.tolist(), res.j.tolist()))
    builds = eng.timer.counts["match_slabs"] - builds0
    if caps != CSTREAM_CAPS or builds != len(caps):
        raise AssertionError(f"resident stream: row caps {caps}, stack "
                             f"built {builds} times")
    if union != want:
        raise AssertionError(
            f"phase 9a streamed union differs from the fp64 oracle: "
            f"{len(union - want)} extra, {len(want - union)} missing")
    stack = eng._mslab
    log(f"phase 9a stream: {nb} inserts of rows {CSTREAM_BUILD}-"
        f"{csr.n_rows - 1} in {secs:.3f} s, every one on the resident "
        f"route; row_cap {caps}; stack {list(stack.shape)} {stack.dtype} "
        f"({stack.numel() * stack.element_size() / 1e9:.2f} GB) built "
        f"{builds} times; build join + every insert's output: "
        f"{len(union)} pairs equal the fp64 oracle")

    zero_launches()
    res = eng.all_pairs(TAU)
    launches = dict(ts.LAUNCHES)
    geom = eng._panel_geom()
    n_pairs = geom[3] * (geom[3] + 1) // 2
    expect = {k: 0 for k in launches}
    expect["panel_score_bits_int8"] = n_pairs
    if launches != expect or eng._mslab is not None:
        raise AssertionError(f"join of the streamed chunked index: launches "
                             f"{launches}, expected {expect}")
    check_parity(res, want, "phase 9a join of the streamed chunked index")
    last = geom[3] - 1
    recs = [compare_panel(eng, pi, pj, *geom[1:3], timed=False)
            for pi, pj in ((0, last), (last, last))]
    log(f"phase 9a panel kernel vs plain at the streamed index ({eng.n_rows} "
        f"rows, the last panel {geom[0] * geom[3] - eng.n_rows} rows of "
        f"padding): {json.dumps(recs)}")
    k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
    k3.update(stream_join_launches=launches["panel_score_bits_int8"],
              stream_max_abs_err=max(r["max_abs_err"] for r in recs))
    saved = save_checkpoint(eng, ckpt, "phase 9a streamed chunked index")

    queries, sq, fq, fs, fpicks = qsets
    check_topk(eng, queries, sq, "phase 9a")
    if eng._mslab is None:
        raise AssertionError("topk did not score against the resident stack")
    check_frozen(eng, fq, fs, fpicks, "phase 9a")
    if eng.last_route != "resident_slabs":
        raise AssertionError(f"frozen match took {eng.last_route}")

    # timings (host clock, warm, median of 9), after the gates
    rec = {"card": smi, "rows": eng.n_rows, "row_cap": eng.row_cap}
    rec.update(stream_timings(eng, synthetic_corpus(4096, seed=13),
                              (1, 32, 256), "resident_slabs"))
    if eng.row_cap != CSTREAM_CAPS[-1]:
        raise AssertionError("the timing inserts crossed a row capacity")
    # top-k against the bf16 stack fetches deep (the bf16 margin): seconds
    # a call, so the median of 3
    before = dict(eng.timer.totals)
    rec["topk_ms"] = median_host_ms(lambda: eng.topk(queries, 10), 3)
    rec["topk_queries_per_s"] = len(queries) / rec["topk_ms"] * 1e3
    rec["topk_stages_ms"] = {
        k: (eng.timer.totals[k] - before[k]) / 3 * 1e3
        for k in ("topk_fetch", "topk_rescore", "topk_assemble")}
    eng.freeze()
    eng.insert(fq, tau=TAU)
    rec["frozen_ms"] = median_host_ms(lambda: eng.insert(fq, tau=TAU))
    rec["frozen_queries_per_s"] = len(fq) / rec["frozen_ms"] * 1e3
    eng.unfreeze()
    # the match's product alone (CUDA events, median of 5): a bs = 256
    # batch against the whole stack
    stack = eng._match_slabs()
    extra = synthetic_corpus(256, seed=21)
    ccsr = eng.compact.map_csr(eng._drop_unmapped(extra), extend=False)
    q = eng._bucket_queries(ccsr, 256)
    n_c, rc, w = stack.shape
    rec["match_product"] = {
        "shape": [n_c, rc, w, 256],
        "ms": median_ms(lambda: chunked_ops.chunk_scores(
            lambda c: stack[c], q, n_c, w, 256, stack.dtype, "default")),
        **bound(2 * n_c * rc * w * 256,
                stack.numel() * 2 + 12 * int(ccsr.indptr[-1]) + 4 * rc * 256,
                PEAK_BF16)}
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"phase 9a timings: {json.dumps(rec)}")
    return saved


STREAM_SPLIT = ("insert", "admit", "prepare", "append", "match_slabs",
                "sort_entries", "product", "compact", "host_match", "d2h",
                "rescore")


def stream_timings(eng, extra: CSRMatrix, sizes, route, reps: int = 9,
                   cursor=None, split=STREAM_SPLIT) -> dict:
    """Insert latency (host clock, warm: two batches first, then the
    median of ``reps``) and vectors/s at each batch size of ``sizes`` on
    rows of ``extra``, every batch on ``route`` (a chunked engine's; None:
    no route), with the stage split (``split``'s sections) per batch at
    the largest size."""
    cursor = cursor if cursor is not None else [0]
    rec = {}
    for bs in sizes:
        batches = []
        for _ in range(reps + 2):
            a = cursor[0]
            cursor[0] += bs
            batches.append([(f"x{a + i}", extra.row(a + i))
                            for i in range(bs)])
        for b in batches[:2]:
            eng.insert(b, tau=TAU)
        it = iter(batches[2:])
        before = dict(eng.timer.totals)

        def one():
            eng.insert(next(it), tau=TAU)
            if route is not None and eng.last_route != route:
                raise AssertionError(f"timed batch took {eng.last_route}")

        ms = median_host_ms(one, reps)
        rec[f"insert_bs{bs}_ms"] = ms
        rec[f"insert_bs{bs}_vectors_per_s"] = bs / ms * 1e3
        if bs == sizes[-1]:
            rec[f"stages_ms_per_batch_bs{bs}"] = {
                k: (eng.timer.totals.get(k, 0.0) - before.get(k, 0.0))
                / reps * 1e3 for k in split}
    return rec


def chunked_stream_beyond(dev, csr: CSRMatrix, want: set, qsets,
                          smi: str) -> dict:
    """Phase 9b: beyond the slab budget at the same 100,000 rows: the
    router's routes, top-k at "highest", column growth and dormant
    activation into the sorted state's overflow, both routes forced, the
    join of the grown index; then each route's timings (forced; the host
    route's median of 3, its batches take seconds) and the router's own
    choice for such a batch."""
    eng = ChunkedAllPairs(AllPairsConfig(match_slab_budget_mb=0), dev)
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 9b build, {CSTREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, CSTREAM_BUILD)))}")
    res = eng.all_pairs(TAU)
    union, routes, caps, nb, secs = stream_rows(eng, csr, CSTREAM_BUILD, [],
                                                beyond_budget=True)
    union |= set(zip(res.i.tolist(), res.j.tolist()))
    if union != want:
        raise AssertionError(
            f"phase 9b streamed union differs from the fp64 oracle: "
            f"{len(union - want)} extra, {len(want - union)} missing")
    log(f"phase 9b stream: {nb} inserts of 256 rows in {secs:.3f} s, routes "
        f"{ {r: routes.count(r) for r in set(routes)} }; row_cap {caps}; "
        f"{len(union)} pairs equal the fp64 oracle")
    queries, sq, _, _, _ = qsets
    check_topk(eng, queries[:256], sq[:256], "phase 9b (fp32 slabs)")

    # column growth and dormant activation (phase 8's dims step)
    index = [csr]
    picks = np.arange(7, csr.n_rows, csr.n_rows // 64)[:64]
    vecs = []
    for p in picks:
        v = csr.row(int(p))
        vecs.append(SparseVector(v.size, v.indices + 32768, v.values))
    cap0, w0 = eng.compact.capacity, eng._chunk_width
    dorm0 = eng.stats["dormant_dims"]
    grown = set()
    step = {}
    for k, vs in ((0, vecs), (64, vecs[:8])):
        n0 = eng.n_rows
        part = CSRMatrix.from_vectors(vs, csr.n_cols)
        out = eng.insert([(str(n0 + i), v) for i, v in enumerate(vs)],
                         tau=TAU)
        step[k] = (eng.last_route, eng.stats["dormant_dims"])
        want_b = batch_oracle(index, part, n0, TAU, dev)
        if pairs_of(out) != want_b:
            raise AssertionError(f"new-dims insert ({len(vs)} rows) differs "
                                 f"from the fp64 oracle")
        grown |= want_b
        index.append(part)
    st = eng._sort_state
    dorm1, dorm2 = step[0][1], step[64][1]
    if (eng.compact.capacity, eng._chunk_width) != (DIMS_CAPACITY, 2 * w0) or (
            dorm1 <= dorm0 or dorm2 >= dorm1 or st is None
            or st["n_o"] == 0):
        raise AssertionError(
            f"dims step: capacity {cap0} -> {eng.compact.capacity}, width "
            f"{w0} -> {eng._chunk_width}, dormant {dorm0} -> {dorm1} -> "
            f"{dorm2}, overflow {None if st is None else st['n_o']}")
    log(f"phase 9b new dims: compact capacity {cap0} -> "
        f"{eng.compact.capacity}, chunk width {w0} -> {eng._chunk_width}, "
        f"dormant dims {dorm0} -> {dorm1} -> {dorm2}, {st['n_o']} entries "
        f"activated into the overflow region; routes {step[0][0]}, "
        f"{step[64][0]}; {len(grown)} pairs equal the fp64 oracle")

    probes = synthetic_corpus(512, seed=101)
    dev_route = "device_paneled"
    for k, (force, name) in enumerate(((True, "host_spgemm"),
                                       (False, dev_route))):
        part = csr_rows(probes, 256 * k, 256 * (k + 1))
        n0 = eng.n_rows
        eng._use_host_match = lambda q, _f=force: _f  # shadow the router
        try:
            out = eng.insert([(str(n0 + i), part.row(i)) for i in range(256)],
                             tau=TAU)
        finally:
            del eng._use_host_match
        want_b = batch_oracle(index, part, n0, TAU, dev)
        if eng.last_route != name or pairs_of(out) != want_b:
            raise AssertionError(f"forced {name}: took {eng.last_route}, "
                                 f"{len(pairs_of(out) ^ want_b)} pairs off")
        grown |= want_b
        index.append(part)
    log("phase 9b forced routes: a bs = 256 batch on host_spgemm and one on "
        "device_paneled, each equal to the fp64 oracle")
    zero_launches()
    res = eng.all_pairs(TAU)
    if ts.LAUNCHES["panel_score_bits_int8"] < 1:
        raise AssertionError("the grown index's join did not launch kernel 3")
    check_parity(res, want | grown, "phase 9b join of the grown index")

    rec = {"card": smi, "rows": eng.n_rows, "row_cap": eng.row_cap,
           "chunk_width": eng._chunk_width, "ph": eng._paneled_ph()}
    extra = synthetic_corpus(4096, seed=17)
    cursor = [0]
    sample = csr_rows(extra, 0, 256)
    rec["router_choice_bs256"] = ("host_spgemm"
                                  if eng._use_host_match(sample.indices)
                                  else dev_route)
    for name, force, reps in (("paneled", False, 9), ("host", True, 3)):
        eng._use_host_match = lambda q, _f=force: _f  # one route each
        try:
            rec[name] = stream_timings(
                eng, extra, (256,), "host_spgemm" if force else dev_route,
                reps=reps, cursor=cursor)
        finally:
            del eng._use_host_match
    rec["router_correct"] = rec["router_choice_bs256"] == min(
        ("host_spgemm", rec["host"]["insert_bs256_ms"]),
        (dev_route, rec["paneled"]["insert_bs256_ms"]),
        key=lambda kv: kv[1])[0]
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"phase 9b timings: {json.dumps(rec)}")
    return rec


def chunked_stream_phase(dev, csr: CSRMatrix, want: set, kernels: list,
                         smi: str, ckpt: str) -> dict:
    """Phase 9: the chunked engine's streaming path on phase 5's corpus;
    returns the record of 9a's checkpoint save and, for phase 11, the
    query sets with their fp64 scores on the host."""
    t_phase = time.perf_counter()
    qsets = query_sets(csr, dev)
    torch.cuda.empty_cache()
    saved = chunked_stream_resident(dev, csr, want, kernels, qsets, smi, ckpt)
    torch.cuda.empty_cache()
    chunked_stream_beyond(dev, csr, want, qsets, smi)
    torch.cuda.empty_cache()
    log(f"phase 9 seconds: {time.perf_counter() - t_phase:.1f}")
    queries, sq, fq, fs, fpicks = qsets
    return saved, (queries, sq.cpu(), fq, fs.cpu(), fpicks)


# ------------------------- phase 10: checkpoints, the server, the command line
CLI_DOCS = 3_000


def save_checkpoint(eng, path: str, label: str) -> dict:
    """``eng.save(path)`` timed (host clock), with the npz's size."""
    t0 = time.perf_counter()
    eng.save(path)
    rec = {"rows": eng.n_rows, "row_cap": eng.row_cap,
           "save_seconds": time.perf_counter() - t0,
           "npz_bytes": os.path.getsize(os.path.join(path, "index.npz")),
           "path": path}
    log(f"{label}: checkpoint saved: {json.dumps(rec)}")
    return rec


def restore_phase(dev, saved8, saved9, want32: set, want: set,
                  kernels: list, smi: str) -> dict:
    """Phase 10a: restore phase 8's dense and phase 9a's chunked checkpoint
    on the card; each join equals the fp64 oracle and launches its kernel
    (kernel 1 also bit for bit against its plain version at the restored
    operands); the chunked restore takes the fast path (no build pass)."""
    (ck8, build32), (ck9, build100k) = saved8, saved9
    rec = {"card": smi}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine.load(ck8["path"], device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if eng.n_rows != ck8["rows"] or eng.ids != [str(i)
                                                for i in range(eng.n_rows)]:
        raise AssertionError(f"dense restore: {eng.n_rows} rows")
    zero_launches()
    res = eng.all_pairs(TAU)
    launches = dict(ts.LAUNCHES)
    if launches["score_bits_int8"] < 1 or not eng._used_int8:
        raise AssertionError(f"restored dense join: launches {launches}")
    check_parity(res, want32, "phase 10a join of the restored dense index")
    tm, tn = eng._tiles()
    bi, bj = blocks(eng.row_cap, tm, tn, dev)
    cmp = compare("int8", eng._operands(True), bi, bj, eng._tau_eff(TAU),
                  tm, tn, timed=False)
    kernels[0].update(restore_join_launches=launches["score_bits_int8"],
                      restore_max_abs_err=cmp["max_abs_err"])
    rec["dense"] = {
        "rows": eng.n_rows, "saved_row_cap": ck8["row_cap"],
        "restored_row_cap": eng.row_cap, "save_seconds": ck8["save_seconds"],
        "restore_seconds": restore_s,
        "build_seconds": build32["build_seconds"],
        "npz_bytes": ck8["npz_bytes"], "kernel_vs_plain": cmp}
    del eng, res, bi, bj
    torch.cuda.empty_cache()

    cfg = Engine.checkpoint_engine_config(ck9["path"])
    ceng = ChunkedAllPairs(cfg, dev)

    def no_build(*a, **k):
        raise AssertionError("the chunked restore fell back to a build pass")

    ceng.build = no_build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ceng.restore(ck9["path"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if ceng.n_rows != ck9["rows"] or ceng._ent_host is None:
        raise AssertionError(f"chunked restore: {ceng.n_rows} rows")
    zero_launches()
    res = ceng.all_pairs(TAU)
    launches = dict(ts.LAUNCHES)
    if launches["panel_score_bits_int8"] < 1:
        raise AssertionError(f"restored chunked join: launches {launches}")
    check_parity(res, want, "phase 10a join of the restored chunked index")
    k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
    k3["restore_join_launches"] = launches["panel_score_bits_int8"]
    rec["chunked"] = {
        "rows": ceng.n_rows, "save_seconds": ck9["save_seconds"],
        "restore_seconds": restore_s, "fast_path": True,
        "build_seconds": build100k["build_seconds"],
        "npz_bytes": ck9["npz_bytes"]}
    log(f"phase 10a checkpoints: {json.dumps(rec)}")
    return rec


def wait_for(pred, timeout: float, what: str) -> None:
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def server_phase(dev, work: str, csr: CSRMatrix, want32: set,
                 kernels: list) -> dict:
    """Phase 10b: the server in-process on the card.  Phase 3's rows go
    into a store table; a load RPC bulk-loads the first three quarters
    (rows 0-24,575 of 32,768), four clients
    stream the rest concurrently (batches of 1, 32 and 256), a subscriber
    collects the pushed outputs; then the pushed pairs, the all_pairs RPC
    (kernel 1) and the topk RPC (against ``engine.topk``) are checked, and
    the checkpoint written on close restores into a second server."""
    from apsim_tpu_torch.etl.store import VectorStore
    from apsim_tpu_torch.serve import (ClientConnection, RpcServer,
                                       SimilarityServer)

    ids = [str(i) for i in range(csr.n_rows)]
    n_load = csr.n_rows * 3 // 4
    t0 = time.perf_counter()
    store = VectorStore(os.path.join(work, "store"), run_mode="PRODUCT")
    store.write("P3", csr, ids)
    rec = {"store_write_seconds": time.perf_counter() - t0}
    cfg = AllPairsConfig(checkpoint_dir=os.path.join(work, "serve_ckpt"))
    sim = SimilarityServer(None, cfg, store=store, device=dev)
    if sim.engine.device != dev:
        raise AssertionError(f"server engine on {sim.engine.device}")
    rpc = RpcServer(sim, "127.0.0.1", 0).start()
    addr = [f"{rpc.host}:{rpc.port}"]
    pushed: set = set()
    lock = threading.Lock()

    def on_output(out, moment) -> None:
        got = {(min(int(q), int(c)), max(int(q), int(c)))
               for q, cands in out.items() for c in cands}
        with lock:
            pushed.update(got)

    clients = []
    try:
        sub = ClientConnection(addr)
        clients.append(sub)
        sub.subscribe_outputs(on_output)
        cc = ClientConnection(addr)
        clients.append(cc)
        t0 = time.perf_counter()
        cc.load_data("P3", 0, n_load - 1)
        cc.flush()
        rec["load_rpc_seconds"] = time.perf_counter() - t0
        if cc.stats()["n_rows"] != n_load:
            raise AssertionError(f"load RPC: {cc.stats()['n_rows']} rows")
        rows = np.arange(n_load, csr.n_rows)
        errors = []

        def stream(part) -> None:
            try:
                c = ClientConnection(addr)
                sizes = [1] * 16 + [32] * 16
                s, k = 0, 0
                while s < part.size:
                    bs = sizes[k] if k < len(sizes) else 256
                    c.insert_new_vector([(ids[r], csr.row(int(r)))
                                         for r in part[s:s + bs]])
                    s, k = s + bs, k + 1
                c.flush()
                c.close()
            except Exception as e:  # surfaced after the join below
                errors.append(e)

        threads = [threading.Thread(target=stream, args=(rows[k::4],))
                   for k in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        cc.flush()
        rec["stream_seconds"] = time.perf_counter() - t0
        if errors:
            raise errors[0]
        st = cc.stats()
        json.dumps(st)
        if (st["n_rows"], st["errors"], st["vectors_dropped_admission"]) != (
                csr.n_rows, 0, 0):
            raise AssertionError(f"served stream: stats {st}")
        wait_for(lambda: len(pushed) >= len(want32), 60,
                 "the pushed outputs")
        time.sleep(0.2)
        with lock:
            if pushed != want32:
                raise AssertionError(
                    f"pushed pairs differ from the fp64 oracle: "
                    f"{len(pushed - want32)} extra, "
                    f"{len(want32 - pushed)} missing")
        log(f"phase 10b served stream: load RPC of {n_load} rows, "
            f"{rows.size} rows from 4 clients; {len(pushed)} pushed pairs "
            f"equal the fp64 oracle")
        zero_launches()
        t0 = time.perf_counter()
        pairs = cc.all_pairs(TAU)
        rec["all_pairs_rpc_seconds"] = time.perf_counter() - t0
        launches = dict(ts.LAUNCHES)
        got = {(min(int(a), int(b)), max(int(a), int(b))) for a, b, _ in pairs}
        if launches["score_bits_int8"] < 1 or got != want32:
            raise AssertionError(
                f"all_pairs RPC: launches {launches}, {len(got ^ want32)} "
                f"pairs off the fp64 oracle")
        kernels[0]["serve_join_launches"] = launches["score_bits_int8"]
        log(f"phase 10b all_pairs RPC: {len(got)} pairs equal the fp64 "
            f"oracle; launches {launches}")
        qsrc = synthetic_corpus(128, seed=23)
        queries = ([(f"t{r}", csr.row(int(r)))
                    for r in range(3, csr.n_rows, csr.n_rows // 128)][:128]
                   + [(f"s{i}", qsrc.row(i)) for i in range(128)])
        t0 = time.perf_counter()
        tk = cc.topk(queries, 10)
        rec["topk_rpc_seconds"] = time.perf_counter() - t0
        with sim._engine_scope():
            direct = sim.engine.topk(queries, 10)
        for qid, _ in queries:
            a, b = tk[qid], direct[qid]
            if [c for c, _ in a] != [c for c, _ in b] or any(
                    abs(x - y) > 1e-12 for (_, x), (_, y) in zip(a, b)):
                raise AssertionError(f"topk RPC differs for {qid}")
        log(f"phase 10b topk RPC: {len(queries)} queries equal engine.topk "
            f"id for id")
    finally:
        for c in clients:
            c.close()
        t0 = time.perf_counter()
        rpc.close()
        rec["close_seconds"] = time.perf_counter() - t0
    if not os.path.exists(os.path.join(cfg.checkpoint_dir, "index.npz")):
        raise AssertionError("close() wrote no checkpoint")
    t0 = time.perf_counter()
    sim2 = SimilarityServer(None, cfg, device=dev)
    rec["restore_seconds"] = time.perf_counter() - t0
    try:
        if sim2.stats()["n_rows"] != csr.n_rows:
            raise AssertionError(f"restored server: {sim2.stats()['n_rows']}")
        res = sim2.all_pairs(TAU)
        got = {(min(int(a), int(b)), max(int(a), int(b)))
               for a, b, _ in res.id_pairs()}
        if got != want32:
            raise AssertionError("the restored server's join differs")
    finally:
        sim2.close()
    log(f"phase 10b restored server: {csr.n_rows} rows, join equal to the "
        f"fp64 oracle; timings {json.dumps(rec)}")
    return rec


def text_corpus(root: str, n: int, seed: int = 10) -> None:
    """``n`` seeded documents of Zipf-distributed words, one file each;
    every 25th document repeats an earlier one, every 25th (offset 12)
    repeats one with a word appended (pairs above and below 0.8)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        if i % 25 == 24:
            text = docs[int(rng.integers(0, i))]
        elif i % 25 == 12:
            text = docs[int(rng.integers(0, i))] + " extra"
        else:
            k = int(rng.integers(20, 200))
            text = " ".join(f"w{j}" for j in rng.zipf(1.3, size=k))
        docs.append(text)
        sub = os.path.join(root, f"box{i % 10}")
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, f"{i}."), "w") as f:
            f.write(text)


def cli(args, **kw):
    """``python -m apsim_tpu_torch.cli args`` from the repository root."""
    cmd = [sys.executable, "-m", "apsim_tpu_torch.cli"] + args
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300, **kw)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args[:1])} failed: {proc.stderr}")
    return proc, time.perf_counter() - t0


def cli_phase(dev, work: str) -> dict:
    """Phase 10c: the command line in subprocesses: ``etl`` of a seeded
    text corpus; then, side by side, ``build`` and ``join`` on the card
    (join output equal to an in-process join of the same store) and
    ``serve`` on the card driven by ``bench`` (the load generator),
    stopped with SIGINT; the checkpoint it writes on the way out loads."""
    from apsim_tpu_torch.etl.store import VectorStore

    docs, store = os.path.join(work, "docs"), os.path.join(work, "cli_store")
    text_corpus(docs, CLI_DOCS)
    rec = {}
    _, rec["etl_seconds"] = cli(["etl", docs, "--store", store, "--table",
                                 "T"])
    ck = os.path.join(work, "cli_ckpt")
    out = os.path.join(work, "pairs.tsv")
    errors = []

    def build_join() -> None:
        try:
            _, rec["build_seconds"] = cli(
                ["build", "--store", store, "--table", "T", "--checkpoint",
                 ck, "--device", dev.type])
            _, rec["join_seconds"] = cli(
                ["join", "--checkpoint", ck, "--tau", str(TAU), "--device",
                 dev.type, "--out", out])
        except Exception as e:  # surfaced after the serve leg
            errors.append(e)

    side = threading.Thread(target=build_join)
    side.start()
    sck = os.path.join(work, "cli_serve_ckpt")
    cmd = [sys.executable, "-m", "apsim_tpu_torch.cli", "serve", "--port",
           "0", "--store", store, "--table", "T", "--checkpoint-dir", sck,
           "--device", dev.type]
    err_path = os.path.join(work, "serve.err")
    err = open(err_path, "w")
    srv = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                           stdout=subprocess.PIPE, stderr=err, text=True)

    def serve_err() -> str:
        err.flush()
        with open(err_path) as f:
            return f.read()[-4000:]

    try:
        line = srv.stdout.readline()
        if not line.startswith("serving on "):
            raise AssertionError(f"serve: {line!r} {serve_err()}")
        addr = line.split()[-1]
        proc, rec["bench_seconds"] = cli(
            ["bench", "--remote", addr, "--store", store, "--table", "T",
             "--total-message-count", "100", "--children-num", "4",
             "--write-batching-ms", "5"])
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        if rep.get("messages") != 400:
            raise AssertionError(f"bench: {rep}")
        rec["loadgen"] = rep
        log(f"phase 10c load generator, insert -> first result: "
            f"{json.dumps(rep)}")
        t0 = time.perf_counter()
        srv.send_signal(signal.SIGINT)
        rc = srv.wait(timeout=120)
        rec["sigint_to_exit_seconds"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"serve exited {rc}: {serve_err()}")
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
        err.close()
        side.join()
    if errors:
        raise errors[0]
    back = Engine.load(sck, device=dev)
    if back.n_rows != CLI_DOCS:
        raise AssertionError(f"serve's checkpoint: {back.n_rows} rows")
    log(f"phase 10c serve stopped by SIGINT; its checkpoint loads with "
        f"{back.n_rows} rows")
    del back
    with open(out) as f:
        lines = sorted(f.read().splitlines())
    csr, ids = VectorStore(store).read("T")
    eng = Engine(AllPairsConfig(), dev)
    eng.build(csr, ids)
    want = sorted(f"{a}\t{b}\t{s:.6f}" for a, b, s in
                  eng.all_pairs(TAU).id_pairs())
    if lines != want or not want:
        raise AssertionError(f"cli join: {len(lines)} lines, in-process "
                             f"{len(want)}")
    log(f"phase 10c etl of {CLI_DOCS} documents, build and join on the "
        f"card: {len(lines)} pairs equal an in-process join of the store; "
        f"timings {json.dumps(rec)}")
    return rec


def serving_phase(dev, work: str, csr: CSRMatrix, want32: set, want: set,
                  kernels: list, smi: str, saved8, saved9) -> None:
    """Phase 10: checkpoints (10a), the server in-process (10b) and the
    command line in subprocesses (10c), all on the card."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    restore_phase(dev, saved8, saved9, want32, want, kernels, smi)
    torch.cuda.empty_cache()
    server_phase(dev, work, csr, want32, kernels)
    torch.cuda.empty_cache()
    cli_phase(dev, work)
    log(f"phase 10 seconds: {time.perf_counter() - t_phase:.1f}")


# ------------------------ phase 11: the meshes' streaming path, one card
MESH_LAYOUTS = (("rows", 4, "rows"), ("dims", 4, "dims"),
                ("2-D", (2, 2), "dims"))
MESH_SPLIT = ("insert", "admit", "prepare", "append", "gather", "product",
              "reduce", "compact", "d2h", "rescore")
CMESH_SPLIT = ("insert", "admit", "prepare", "append", "slabs", "product",
               "reduce", "compact", "d2h", "rescore")
SERVE_ROWS = 2_048
TIMED_BATCHES = (1, 32, 256)


def mesh_query_timings(eng, queries, fq, reps: int = 9) -> dict:
    """``topk(k=10)`` and frozen-match latency and queries/s (host clock,
    warm, median of ``reps``)."""
    eng.topk(queries, 10)
    rec = {"topk_ms": median_host_ms(lambda: eng.topk(queries, 10), reps)}
    rec["topk_queries_per_s"] = len(queries) / rec["topk_ms"] * 1e3
    eng.freeze()
    eng.insert(fq, tau=TAU)
    rec["frozen_ms"] = median_host_ms(lambda: eng.insert(fq, tau=TAU), reps)
    rec["frozen_queries_per_s"] = len(fq) / rec["frozen_ms"] * 1e3
    eng.unfreeze()
    return rec


def check_blocks(eng: MeshEngine, x8: torch.Tensor, label: str) -> None:
    """Every block of the streamed mesh equals phase 8's streamed ``x`` on
    its live rows and columns, bit for bit, and is zero past them."""
    nr, nd = eng.grid
    hb, wb = eng.row_cap // nr, eng.dim_cap // nd
    if eng.dim_cap != x8.shape[1]:
        raise AssertionError(f"{label}: dim_cap {eng.dim_cap}, phase 8's "
                             f"{x8.shape[1]}")
    for s, blk in enumerate(eng.x_blocks):
        r, d = divmod(s, nd)
        live = min(max(eng.n_rows - r * hb, 0), hb)
        if not torch.equal(blk[:live], x8[r * hb:r * hb + live,
                                          d * wb:(d + 1) * wb]) or bool(
                blk[live:].any()):
            raise AssertionError(f"{label}: block {s} differs from phase "
                                 f"8's streamed x")
    log(f"{label}: {len(eng.x_blocks)} blocks of [{hb}, {wb}] equal phase "
        f"8's streamed x on its {eng.n_rows} live rows, bit for bit")


def serve_mesh(dev, eng: MeshEngine, csr: CSRMatrix) -> dict:
    """Phase 11c: ``SimilarityServer`` + ``RpcServer`` in-process over the
    streamed rows mesh; two clients stream ``SERVE_ROWS`` fresh rows (ids
    ``f<i>``) while a subscriber collects the pushed outputs, which must
    equal the fp64 oracle of the fresh rows against the index and each
    other."""
    from apsim_tpu_torch.serve import (ClientConnection, RpcServer,
                                       SimilarityServer)

    fresh = synthetic_corpus(SERVE_ROWS, seed=31)
    n0 = eng.n_rows
    ids = [str(i) for i in range(n0)] + [f"f{i}" for i in range(SERVE_ROWS)]
    want = {(min(ids[a], ids[b]), max(ids[a], ids[b]))
            for a, b in batch_oracle([csr], fresh, n0, TAU, dev)}
    sim = SimilarityServer(eng, eng.cfg, device=dev)
    rpc = RpcServer(sim, "127.0.0.1", 0).start()
    addr = [f"{rpc.host}:{rpc.port}"]
    pushed: set = set()
    lock = threading.Lock()
    errors = []

    def on_output(out, moment) -> None:
        with lock:
            pushed.update((min(q, c), max(q, c))
                          for q, cands in out.items() for c in cands)

    def stream(part) -> None:
        try:
            c = ClientConnection(addr)
            for s in range(0, part.size, 64):
                c.insert_new_vector([(f"f{i}", fresh.row(int(i)))
                                     for i in part[s:s + 64]])
            c.flush()
            c.close()
        except Exception as e:  # surfaced after the join below
            errors.append(e)

    rec = {}
    sub = ClientConnection(addr)
    try:
        sub.subscribe_outputs(on_output)
        rows = np.arange(SERVE_ROWS)
        threads = [threading.Thread(target=stream, args=(rows[k::2],))
                   for k in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        wait_for(lambda: sim.stats()["n_rows"] == n0 + SERVE_ROWS, 60,
                 "the served rows")
        rec["stream_seconds"] = time.perf_counter() - t0
        wait_for(lambda: len(pushed) >= len(want), 60, "the pushed outputs")
        time.sleep(0.2)
        with lock:
            if pushed != want or not want:
                raise AssertionError(
                    f"phase 11c pushed pairs differ from the fp64 oracle: "
                    f"{len(pushed - want)} extra, {len(want - pushed)} "
                    f"missing")
    finally:
        sub.close()
        rpc.close()
    rec.update(rows=SERVE_ROWS, pairs=len(want))
    log(f"phase 11c server over the rows mesh: 2 clients streamed "
        f"{SERVE_ROWS} fresh rows; {len(want)} pushed pairs equal the fp64 "
        f"oracle; {json.dumps(rec)}")
    return rec


def mesh_dense_stream(dev, csr: CSRMatrix, want32: set, x8, qsets8,
                      kernels: list, smi: str, layout: str, shape,
                      axis: str) -> None:
    """Phase 11a, one layout: ``MeshEngine`` over 4 shards of the card,
    built on phase 8's first 24,576 rows, the rest streamed with phase 8's
    schedule; the union, the join of the streamed index (rows: kernel 3
    once per shard, and bit for bit against its plain version at shard 0's
    and shard 3's streamed operands), the blocks against phase 8's ``x``,
    top-k and frozen matching; the rows layout then serves (11c); then the
    timings."""
    label = f"phase 11a {layout} mesh, 4 shards on one card"
    eng = MeshEngine(AllPairsConfig(shard_axis=axis,
                                    similarity_threshold=TAU),
                     mesh=make_mesh(shape, devices=[dev] * 4))
    log(f"{label} build, {STREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, STREAM_BUILD)))}")
    caps0 = (eng.row_cap, eng.dim_cap)
    res = eng.all_pairs(TAU)
    union, _, _, nb, secs = stream_rows(eng, csr, STREAM_BUILD,
                                        [1] * 16 + [32] * 16)
    union |= set(zip(res.i.tolist(), res.j.tolist()))
    if eng.n_rows != csr.n_rows or eng.row_cap != 2 * STREAM_BUILD:
        raise AssertionError(f"{label}: n_rows {eng.n_rows}, row_cap "
                             f"{eng.row_cap}")
    if union != want32:
        raise AssertionError(f"{label}: streamed union differs from the "
                             f"fp64 oracle: {len(union - want32)} extra, "
                             f"{len(want32 - union)} missing")
    log(f"{label} stream: {nb} inserts in {secs:.3f} s; (row_cap, dim_cap) "
        f"{caps0} -> {(eng.row_cap, eng.dim_cap)}; build join + every "
        f"insert's output: {len(union)} pairs equal the fp64 oracle")
    zero_launches()
    res = eng.all_pairs(TAU)
    launches = dict(ts.LAUNCHES)
    expect = {k: 0 for k in launches}
    if axis == "rows":
        expect["panel_score_bits_int8"] = 4
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    check_parity(res, want32, f"{label} join of the streamed index")
    if axis == "rows":
        recs = [compare_rows_shard(eng, s, timed=s == 0) for s in (0, 3)]
        log(f"{label} kernel 3 vs plain at the streamed operands: "
            f"{json.dumps(recs)}")
        k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
        k3.update({"mesh_stream_join_launches": launches[
            "panel_score_bits_int8"],
            **{f"mesh_stream_{k}": recs[0][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")},
            "mesh_stream_max_abs_err": max(r["max_abs_err"] for r in recs)})
    check_blocks(eng, x8, label)
    queries, sq, fq, fs, fpicks = qsets8
    check_topk(eng, queries, sq, label)
    check_frozen(eng, fq, fs, fpicks, label)
    if axis == "rows":
        serve_mesh(dev, eng, csr)
    rec = {"card": smi, "layout": layout, "rows": eng.n_rows,
           "row_cap": eng.row_cap, "dim_cap": eng.dim_cap,
           "stream_seconds": secs, "stream_batches": nb}
    rec.update(stream_timings(eng, synthetic_corpus(4096, seed=13),
                              TIMED_BATCHES, None, split=MESH_SPLIT))
    rec.update(mesh_query_timings(eng, queries, fq))
    if eng.row_cap != 2 * STREAM_BUILD:
        raise AssertionError(f"{label}: the timing inserts grew the index")
    log(f"{label} timings: {json.dumps(rec)}")


def capacity_rows(eng: MeshChunkedAllPairs, seed: int = 41):
    """Batches of 256 rows whose entries all lie in the fullest chunk (192
    of its dims each, every 16th row a copy of the one before), enough to
    pass its capacity: the streamed corpus alone fills no chunk past its
    power-of-two capacity, so this batch series makes the growth
    happen."""
    c = int(np.argmax(eng._counts))
    dims = eng.compact.ext_of_col[c::eng._n_chunks]
    need = eng._chunk_cap - int(eng._counts[c]) + 1
    n = round_up(-(-need // 192), 256)
    rng = np.random.default_rng(seed)
    vecs = []
    for i in range(n):
        if i % 16 == 15:
            vecs.append(vecs[-1])
            continue
        d = np.sort(rng.choice(dims, 192, replace=False)).astype(np.int32)
        v = rng.random(192) + 0.05
        vecs.append(SparseVector(1 << 20, d, v / np.linalg.norm(v)))
    return c, [vecs[s:s + 256] for s in range(0, n, 256)]


def mesh_chunked_stream(dev, csr: CSRMatrix, want: set, qsets9,
                        kernels: list, smi: str) -> None:
    """Phase 11b: ``MeshChunkedAllPairs`` over 8 shards of the card on
    phase 5's corpus: build 90,000 rows, stream the rest with phase 9a's
    batch sizes (every match on the rebuild route); the union, the join of
    the streamed index (kernel 4 eight times per panel pair, and exactly
    its plain version at one panel pair of shard 0's operands), top-k and
    frozen matching against fp64; a per-chunk capacity growth on every
    shard (asserted) with each batch against fp64 and the join after it;
    then the timings with the stage split."""
    label = "phase 11b chunked mesh, 8 shards on one card"
    eng = MeshChunkedAllPairs(AllPairsConfig(),
                              mesh=make_mesh(8, devices=[dev] * 8))
    torch.cuda.reset_peak_memory_stats()
    log(f"{label} build, {CSTREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, CSTREAM_BUILD)))}")
    res = eng.all_pairs(TAU)
    union, _, caps, nb, secs = stream_rows(
        eng, csr, CSTREAM_BUILD, [1] * 8 + [32] * 8, "device_rebuild")
    union |= set(zip(res.i.tolist(), res.j.tolist()))
    if union != want:
        raise AssertionError(f"{label}: streamed union differs from the "
                             f"fp64 oracle: {len(union - want)} extra, "
                             f"{len(want - union)} missing")
    log(f"{label} stream: {nb} inserts of rows {CSTREAM_BUILD}-"
        f"{csr.n_rows - 1} in {secs:.3f} s, every one on the rebuild route; "
        f"row_cap {caps}; {len(union)} pairs equal the fp64 oracle")

    def join(want_pairs: set, what: str) -> int:
        zero_launches()
        res = eng.all_pairs(TAU)
        launches = dict(ts.LAUNCHES)
        geom = eng._panel_geom()
        expect = {k: 0 for k in launches}
        expect["int8_matmul"] = 8 * geom[3] * (geom[3] + 1) // 2
        if launches != expect:
            raise AssertionError(f"{label} {what}: launches {launches}, "
                                 f"expected {expect}")
        check_parity(res, want_pairs, f"{label} {what}")
        return launches["int8_matmul"]

    n_launch = join(want, "join of the streamed index")
    st = eng._panel_state()
    last = eng._panel_geom()[3] - 1
    x0, xl = eng._build_slab(st, 0), eng._build_slab(st, last)
    mm = compare_mm(x0[0], xl[0], f"{label}, pair (0, {last}), shard 0")
    del st, x0, xl
    k4 = next(k for k in kernels if k["name"] == "int8_matmul")
    k4.update({"mesh_stream_join_launches": n_launch,
               **{f"mesh_stream_{k}": mm[k] for k in (
                   "m", "n", "d", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms", "max_abs_err")}})
    queries, sq, fq, fs, fpicks = qsets9
    check_topk(eng, queries, sq, label)
    check_frozen(eng, fq, fs, fpicks, label)
    if eng.last_route != "device_rebuild":
        raise AssertionError(f"{label}: frozen match took {eng.last_route}")

    cap0 = eng._chunk_cap
    c, batches = capacity_rows(eng)
    index, grown = [csr], set()
    for vs in batches:
        n0 = eng.n_rows
        out = eng.insert([(str(n0 + i), v) for i, v in enumerate(vs)],
                         tau=TAU)
        part = CSRMatrix.from_vectors(vs, csr.n_cols)
        want_b = batch_oracle(index, part, n0, TAU, dev)
        if pairs_of(out) != want_b or eng.last_route != "device_rebuild":
            raise AssertionError(f"{label} capacity batch at row {n0}: "
                                 f"{len(pairs_of(out) ^ want_b)} pairs off "
                                 f"the fp64 oracle, route {eng.last_route}")
        grown |= want_b
        index.append(part)
    shapes = {tuple(t.shape) for t in eng._ent[0]}
    if eng._chunk_cap != 2 * cap0 or shapes != {(eng._n_chunks // 8,
                                                 eng._chunk_cap)}:
        raise AssertionError(f"{label}: chunk capacity {cap0} -> "
                             f"{eng._chunk_cap}, shard buffers {shapes}")
    log(f"{label} capacity growth: {len(batches)} batches of 256 rows into "
        f"chunk {c} grew every shard's per-chunk capacity {cap0} -> "
        f"{eng._chunk_cap}; {len(grown)} new pairs equal the fp64 oracle")
    join(want | grown, "join after the capacity growth")

    rec = {"card": smi, "rows": eng.n_rows, "row_cap": eng.row_cap,
           "n_chunks": eng._n_chunks, "chunk_cap": eng._chunk_cap,
           "stream_seconds": secs, "stream_batches": nb}
    rec.update(stream_timings(eng, synthetic_corpus(4096, seed=13),
                              TIMED_BATCHES, "device_rebuild",
                              split=CMESH_SPLIT))
    rec.update(mesh_query_timings(eng, queries, fq))
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"{label} timings: {json.dumps(rec)}")


def mesh_stream_phase(dev, big_csr: CSRMatrix, want32: set, x8, qsets8,
                      ooc_csr: CSRMatrix, want: set, qsets9, kernels: list,
                      smi: str) -> None:
    """Phase 11: the meshes' streaming path, their shards on the one card
    (11a the dense mesh in three layouts, 11c the server over its rows
    layout, 11b the chunked mesh)."""
    t_phase = time.perf_counter()
    x8 = x8.to(dev)
    q8 = (qsets8[0], qsets8[1].to(dev), qsets8[2], qsets8[3].to(dev),
          qsets8[4])
    for layout, shape, axis in MESH_LAYOUTS:
        mesh_dense_stream(dev, big_csr, want32, x8, q8, kernels, smi,
                          layout, shape, axis)
        torch.cuda.empty_cache()
    del x8, q8
    torch.cuda.empty_cache()
    q9 = (qsets9[0], qsets9[1].to(dev), qsets9[2], qsets9[3].to(dev),
          qsets9[4])
    mesh_chunked_stream(dev, ooc_csr, want, q9, kernels, smi)
    torch.cuda.empty_cache()
    log(f"phase 11 seconds: {time.perf_counter() - t_phase:.1f}")


def main() -> int:
    t_start = time.perf_counter()
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
            if "spill" in line and (
                    "0 bytes spill stores, 0 bytes spill loads" not in line):
                raise AssertionError(f"a kernel spills registers: {line}")
    edge_phase(dev)
    bf16_edge_phase(dev)

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
    zero_launches()
    build32 = eng8.build(big_csr)
    log(f"build int8 engine: {json.dumps(build32)}")
    j8 = timed_join(eng8, "main path int8, 32768 rows")
    log(f"build bf16 engine: {json.dumps(eng16.build(enron_csr))}")
    j16 = timed_join(eng16, "main path bf16, 8586 rows")
    launches = dict(ts.LAUNCHES)
    if "--profile" in sys.argv[1:]:
        for label, eng in (("int8, 32768 rows", eng8),
                           ("bf16, 8586 rows", eng16)):
            t0 = time.perf_counter()
            prof = profile_join(eng, TAU)
            prof["profiling_seconds"] = time.perf_counter() - t0
            log(f"main path {label}, one more join under torch.profiler: "
                f"{json.dumps(prof)}")
    log(f"kernel launches on the main path: {launches}")
    for k in ("score_bits_int8", "score_bits_bf16"):
        if launches[k] < 1:
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
        ops = eng._operands(kind == "int8")
        ops = ops if kind == "int8" else (ops,)
        rec.update(score_bound(
            ops[:1], ops[1].numel() * 4 if kind == "int8" else 0, bi, bj,
            tm, tn, (0, 0), PEAK_INT8 if kind == "int8" else PEAK_BF16))
        rec["tops"] = (2 * upper_cells(bi, bj, tm, tn) * eng.dim_cap
                       / rec["ms"] / 1e9)
        rec["thread_block_tile"] = list(ts.thread_block_tile(tm, tn))
        log(f"phase 4 {kind} row_cap={eng.row_cap} dim_cap={eng.dim_cap}: "
            f"{json.dumps(rec)}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            # no one PyTorch call computes the bound epilogue + bit-pack
            "library_ms": None,
        })
    want32 = oracle_pairs(big_csr, TAU, dev)
    check_parity(j8["res"], want32, "int8 join, 32768 rows")
    want8586 = oracle_pairs(enron_csr, TAU, dev)
    check_parity(j16["res"], want8586, "bf16 join, 8586 rows")
    for j in (j8, j16):
        if not j["res"].n_pairs or not np.all(np.isfinite(j["res"].sims)):
            raise AssertionError("join produced no pairs or non-finite sims")
    cand32 = pair_set(eng8._all_pairs_kernel(eng8._tau_eff(TAU)))
    del eng8, eng16, j8, j16
    torch.cuda.empty_cache()

    # ---- phase 5: the out-of-core path
    small = ChunkedAllPairs(AllPairsConfig(), dev, panel_rows=1024)
    small.build(synthetic_corpus(3000, seed=2))
    if small._panel_geom()[3] != 3 or small.row_cap <= small.n_rows:
        raise AssertionError("phase 5 needs three panels with padding rows")
    for tm, tn in ((1024, 512), (64, 128)):
        for pi, pj in ((0, 0), (0, 2), (1, 2)):
            for blank in (False, True):
                rec = compare_panel(small, pi, pj, tm, tn, timed=False,
                                    blank=blank)
                log(f"phase 5 panel kernel, 3000 rows: {json.dumps(rec)}")
    del small

    ooc_csr = synthetic_corpus(OOC_ROWS, seed=0)
    eng = ChunkedAllPairs(AllPairsConfig(), dev)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    build100k = eng.build(ooc_csr)
    log(f"build chunked engine: {json.dumps(build100k)}")
    jr = ooc_join(eng, f"out-of-core path, resident sweep, {OOC_ROWS} rows",
                  reps=3)
    ooc_launches = dict(ts.LAUNCHES)
    log(f"kernel launches on the out-of-core path: {ooc_launches}")
    n_pairs = jr["rec"]["geom"]["n_panels"] * (
        jr["rec"]["geom"]["n_panels"] + 1) // 2
    if ooc_launches["panel_score_bits_int8"] != 3 * n_pairs:
        raise AssertionError("the out-of-core join did not launch the panel "
                             "kernel once per panel pair")
    launches["panel_score_bits_int8"] = ooc_launches["panel_score_bits_int8"]

    last = jr["rec"]["geom"]["n_panels"] - 1
    recs = []
    for pi, pj in ((0, 0), (0, last)):
        rec = compare_panel(eng, pi, pj, *eng._panel_geom()[1:3], timed=True)
        log(f"phase 5 panel kernel at the join's operands: {json.dumps(rec)}")
        recs.append(rec)
    off = recs[1]
    kernels.append({
        "name": "panel_score_bits_int8", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["panel_score_bits_int8"],
        "launches": launches["panel_score_bits_int8"],
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": off["ms"], "plain_ms": off["plain_ms"],
        "bound_ms": off["bound_ms"], "bound_by": off["bound_by"],
        "library_ms": None,
    })

    eng._panel_resident_bytes = 0
    jroll = ooc_join(eng, f"out-of-core path, rolling sweep, {OOC_ROWS} rows",
                     reps=1)
    cand100k = pair_set(eng._all_pairs_panel(eng._tau_eff(TAU)))
    panel_pairs = jr["res"].pair_set()
    del eng
    torch.cuda.empty_cache()
    want = oracle_pairs(ooc_csr, TAU, dev)
    for label, j in (("resident", jr), ("rolling", jroll)):
        got = set(zip(j["res"].i.tolist(), j["res"].j.tolist()))
        if got != want:
            raise AssertionError(
                f"out-of-core {label} join differs from the fp64 oracle: "
                f"{len(got - want)} extra, {len(want - got)} missing"
            )
        if not got or not np.all(np.isfinite(j["res"].sims)):
            raise AssertionError("join produced no pairs or non-finite sims")
        log(f"out-of-core {label} join, {OOC_ROWS} rows: parity OK, "
            f"{len(got)} pairs equal the fp64 oracle")

    # ---- phase 6: the mesh paths, their shards on the one card
    gen = torch.Generator(device=dev).manual_seed(6)
    for m, n, d in ((1024, 1024, 128), (256, 512, 384)):
        xi, xj = (torch.randint(-127, 128, (r, d), dtype=torch.int8,
                                device=dev, generator=gen) for r in (m, n))
        compare_mm(xi, xj, f"random [{m}, {d}] x [{n}, {d}]^T")
    del xi, xj
    mm_main = None
    for n_shards, reps in ((1, 3), (8, 1)):
        mesh = (make_mesh(1) if n_shards == 1
                else make_mesh(8, devices=[dev] * 8))
        meng = MeshChunkedAllPairs(AllPairsConfig(), mesh=mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        log(f"build mesh chunked engine, {n_shards} shard(s) on one card: "
            f"{json.dumps(meng.build(ooc_csr))}")
        label = (f"mesh out-of-core path, {n_shards} shard(s) on one card, "
                 f"{OOC_ROWS} rows")
        jm = ooc_join(meng, label, reps=reps, ops_of=mesh_join_ops)
        got = dict(ts.LAUNCHES)
        log(f"kernel launches on the {label}: {got}")
        geom = jm["rec"]["geom"]
        n_pairs = geom["n_panels"] * (geom["n_panels"] + 1) // 2
        expect = {k: 0 for k in got}
        expect["int8_matmul"] = reps * n_shards * n_pairs
        if got != expect:
            raise AssertionError(f"{label}: launches {got}, expected {expect}")
        check_parity(jm["res"], want, label)
        if not np.all(np.isfinite(jm["res"].sims)):
            raise AssertionError(f"{label}: non-finite sims")
        if pair_set(meng._all_pairs_panel(meng._tau_eff(TAU))) != cand100k:
            raise AssertionError(f"{label}: candidate set differs from the "
                                 f"single-device join's")
        log(f"{label}: candidate set equals the single-device join's "
            f"({len(cand100k)}); d_local {geom['d_cap'] // n_shards}")
        st = meng._panel_state()
        x0 = meng._build_slab(st, 0)
        xl = meng._build_slab(st, geom["n_panels"] - 1)
        for pair, xj in (("(0, 0)", x0), (f"(0, {geom['n_panels'] - 1})", xl)):
            rec = compare_mm(x0[0], xj[0], f"{label}, pair {pair}, shard 0")
            if n_shards == 1 and xj is xl:
                mm_main = dict(rec, launches=got["int8_matmul"])
        del meng, st, x0, xl, jm
    kernels.append({
        "name": "int8_matmul", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["int8_matmul"],
        **{k: mm_main[k] for k in ("launches", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
    })

    mesh4 = make_mesh(4, devices=[dev] * 4)
    reng = MeshEngine(AllPairsConfig(shard_axis="rows"), mesh=mesh4)
    torch.cuda.empty_cache()
    zero_launches()
    log(f"build mesh rows engine, 4 shards on one card: "
        f"{json.dumps(reng.build(big_csr))}")
    label = "mesh rows path, 4 shards on one card, 32768 rows"
    jrows = timed_join(reng, label)
    got = dict(ts.LAUNCHES)
    log(f"kernel launches on the {label}: {got}")
    expect = {k: 0 for k in got}
    expect["panel_score_bits_int8"] = 3 * 4
    if got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    check_parity(jrows["res"], want32, label)
    if pair_set(reng._all_pairs_kernel(reng._tau_eff(TAU))) != cand32:
        raise AssertionError(f"{label}: candidate set differs from Engine's")
    log(f"{label}: candidate set equals Engine's ({len(cand32)})")
    for shard in (0, reng.n_shards - 1):
        rec = compare_rows_shard(reng, shard)
        log(f"phase 6 panel kernel at the rows path's operands: "
            f"{json.dumps(rec)}")

    # ---- phase 7: the full-rectangle join, the stripes, the mesh layouts
    # the rows mesh once more, demoted: its join is now the rectangle
    reng._int8_off = True
    zero_launches()
    t0 = time.perf_counter()
    res = reng.all_pairs(TAU)
    log(f"mesh rows path after int8 demotion, one join: "
        f"{time.perf_counter() - t0:.4f} s; launches {dict(ts.LAUNCHES)}")
    if reng._kernel_ok() or any(ts.LAUNCHES.values()):
        raise AssertionError("the demoted rows mesh still took a kernel")
    check_parity(res, want32, "mesh rows path after int8 demotion")
    del reng, res
    torch.cuda.empty_cache()

    rect_phase(AllPairsConfig(use_pallas="off"), big_csr, want32,
               "rectangle, default precision, 32768 rows", dev)
    torch.cuda.empty_cache()
    hi = AllPairsConfig(matmul_precision="highest")
    rect_phase(hi, enron_csr, want8586, "rectangle, highest, 8586 rows", dev)
    torch.backends.cuda.matmul.allow_tf32 = True  # must be restored as found
    rect_phase(hi, big_csr, want32, "rectangle, highest, 32768 rows, "
               "allow_tf32 on beforehand", dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    for shape, axis in ((4, "dims"), ((2, 2), "both")):
        mesh = make_mesh(shape, devices=[dev] * 4)
        j = rect_phase(
            AllPairsConfig(shard_axis="dims"), big_csr, want32,
            f"mesh rectangle, {axis}, {shape} shards on one card, 32768 rows",
            dev, make=lambda cfg: MeshEngine(cfg, mesh=mesh))
        del j
        torch.cuda.empty_cache()

    seng = ChunkedAllPairs(AllPairsConfig(pallas_int8=False), dev)
    log(f"build stripe engine: {json.dumps(seng.build(ooc_csr))}")
    zero_launches()
    js = stripe_join(seng, f"bf16 stripes, {OOC_ROWS} rows", reps=3)
    if any(ts.LAUNCHES.values()):
        raise AssertionError("the bf16 stripes launched a kernel")
    check_parity(js["res"], want, f"bf16 stripes, {OOC_ROWS} rows")
    stripe_parity = js["res"].pair_set() == panel_pairs
    log(f"stripe_parity: {stripe_parity} ({len(panel_pairs)} pairs of the "
        f"panel join)")
    if not stripe_parity:
        raise AssertionError("the stripe join's pair set differs from the "
                             "panel join's")
    del seng, js
    torch.cuda.empty_cache()

    ieng = ChunkedAllPairs(AllPairsConfig(use_pallas="off"), dev)
    ieng._int8_stripes = True
    ieng.build(ooc_csr)
    zero_launches()
    ji = stripe_join(ieng, f"int8 stripes, {OOC_ROWS} rows", reps=1)
    stripe_launches = dict(ts.LAUNCHES)
    log(f"kernel launches on the int8 stripes: {stripe_launches}")
    expect = {k: 0 for k in stripe_launches}
    expect["int8_matmul"] = ji["rec"]["stripes"] * ji["rec"]["n_chunks"]
    if stripe_launches != expect or not ji["rec"]["int8"]:
        raise AssertionError(f"int8 stripes: launches {stripe_launches}, "
                             f"expected {expect}")
    check_parity(ji["res"], want, f"int8 stripes, {OOC_ROWS} rows")
    mm_stripe = compare_stripe_mm(ieng, ieng._q_super(), 3)
    kernels[-1].update({
        "stripe_launches": stripe_launches["int8_matmul"],
        **{f"stripe_{k}": mm_stripe[k] for k in (
            "m", "n", "d", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")},
    })
    del ieng, ji
    torch.cuda.empty_cache()

    meng = MeshChunkedAllPairs(AllPairsConfig(pallas_int8=False),
                               mesh=make_mesh(8, devices=[dev] * 8))
    meng.build(ooc_csr)
    label = f"mesh bf16 stripes, 8 shards on one card, {OOC_ROWS} rows"
    jm = stripe_join(meng, label, reps=1)
    check_parity(jm["res"], want, label)
    if jm["res"].pair_set() != panel_pairs:
        raise AssertionError(f"{label}: pair set differs from the "
                             f"single-device panel join's")
    del meng, jm
    torch.cuda.empty_cache()

    # ---- phase 8: the streaming path (insert, join, topk, frozen match)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        saved8, x8, qsets8 = stream_phase(dev, big_csr, want32, kernels,
                                          smi, os.path.join(work, "dense"))

        # ---- phase 9: the chunked engine's streaming path on phase 5's
        # corpus
        saved9, qsets9 = chunked_stream_phase(
            dev, ooc_csr, want, kernels, smi, os.path.join(work, "chunked"))

        # ---- phase 10: checkpoints, the server, the command line
        serving_phase(dev, work, big_csr, want32, want, kernels, smi,
                      (saved8, build32), (saved9, build100k))

        # ---- phase 11: the meshes' streaming path, shards on the one card
        mesh_stream_phase(dev, big_csr, want32, x8, qsets8, ooc_csr, want,
                          qsets9, kernels, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(f"chip_smoke seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
