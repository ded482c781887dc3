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

Every kernel's record holds its bound: the larger of its operations over
the card's peak rate for their type and its bytes (inputs read once,
outputs written once) over the memory rate, at this run's shapes.

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

from apsim_tpu_torch import (AllPairsConfig, ChunkedAllPairs, CSRMatrix,
                             Engine, MeshChunkedAllPairs, MeshEngine,
                             make_mesh)
from apsim_tpu_torch.bench.ooc import join_ops, profile_join
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import _build, panel as panel_ops, tri_score as ts
from apsim_tpu_torch.ops import chunked as chunked_ops
from apsim_tpu_torch.ops import mesh_pallas, panel_mesh
from apsim_tpu_torch.ops import score as score_ops
from apsim_tpu_torch.parallel.collectives import all_gather

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


def compare_rows_shard(eng: MeshEngine, s: int) -> dict:
    """The cross-panel kernel vs its plain version on shard ``s``'s launch
    of the rows mesh join: the all-gathered int8 index and aux, the shard's
    striped schedule and its valid flags, zero offsets, the path's tiles."""
    dev = eng.mesh.devices[s]
    tm, tn = eng._mesh_rows_geom()
    bi, bj, va = (torch.from_numpy(a[s]).to(dev) for a in
                  mesh_pallas.rows_schedule(eng.row_cap, eng.n_shards, tm, tn))
    qa = [ts.quantize_rows(x) for x in eng.x_blocks]
    qg = all_gather([q for q, _ in qa], 0, dev)
    ag = all_gather([a for _, a in qa], 1, dev).contiguous()
    del qa
    args = (qg, qg, ag, ag, bi, bj, (0, 0), eng._tau_eff(TAU), tm, tn)
    rec = compare_cross(args, va, f"rows mesh shard {s}", timed=False)
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
    log(f"build int8 engine: {json.dumps(eng8.build(big_csr))}")
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
    log(f"build chunked engine: {json.dumps(eng.build(ooc_csr))}")
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

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
