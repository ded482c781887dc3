"""Time the kernels (1-6) of ``csrc/score_bits.cu`` at the main paths'
shapes, on one CUDA card, for comparing two source trees.

Usage, on a machine with one CUDA card:

    python apsim_tpu_torch/bench/kernels.py [--tree DIR]

``--tree DIR`` imports ``apsim_tpu_torch`` from ``DIR`` (default: the
checkout that holds this file; another, e.g. the parent commit unpacked with
``git archive``), so one script times both trees; run them in turns
(parent, change, change, parent) in one call.
Shapes: kernel 1 (int8) over the 1,056-block upper triangle of
``synthetic_corpus(32768, seed=0)``'s index at tiles (1024, 512); kernel 2
(bf16) over ``synthetic_corpus(8586, seed=0)``'s (90 blocks of the
9,216-row index: the bf16 join of ``chip_smoke.py``) and over the same
32,768-row triangle as kernel 1 (the shape an engine runs after its int8
path is gated off or demoted), and there once more on the first 16,384
columns (``score_bits_bf16_32768_k16384``: rows as many bytes wide as
kernel 1's, so the two rates tell how much of the difference to kernel 1
is the operand bytes the thread blocks share through L2); kernel 3 on the cross
pair rows [0, 8192) x [8192, 16384) of the 32,768-row int8 index (128
blocks of 1024 x 512, K = 32,768: the shape of the out-of-core join's
off-diagonal pair); kernel 4 (int8 matmul) at the mesh join's per-shard
shapes, ``[8192, K] . [8192, K]^T`` on rows [0, 8192) and [8192, 16384)
of the same index, K = 32,768 (one shard) and its first 4,096 columns (8
shards), beside ``torch._int_mm`` on the same operands (a yardstick only);
kernel 5 (the summed-partial epilogue) on that pair's 8 shards' int32
partial dots (columns split in 8), the first one and all 8, and kernel 6
(where the tree has it) on the same partials as fp32 scores.
Beside kernel 2 it times one ``torch.matmul`` of the 9,216-row bf16 index
against its transpose (``bf16_matmul_9216_*``): a yardstick of the bf16
mainloop only.  It computes the whole square, not the upper triangle, and
no threshold, bit-pack or counts, so it is not a library call for kernel
2's function (there is none), and the port never calls it.
Times: CUDA events, median of ``REPS`` launches.  Prints one JSON object
with the card, the package and kernel library it loaded (both checked to
lie under the tree), each kernel's median ms, its TOPS (operations: 2 per
strict-upper cell per K element for kernels 1, 2 and 3, 2 m n K for kernel
4 and the yardsticks) and the thread-block tile it ran
(``tri_score.thread_block_tile``, ``int8_tile`` in an older tree; a kernel
of a tree that predates its move onto the TMA ring ran 64 x 128 sub-tiles
of the first design, whatever this records).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPS = 7


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import apsim_tpu_torch
    from apsim_tpu_torch import AllPairsConfig, Engine
    from apsim_tpu_torch.bench.scale import synthetic_corpus
    from apsim_tpu_torch.ops import _build
    from apsim_tpu_torch.ops import panel as panel_ops
    from apsim_tpu_torch.ops import panel_mesh
    from apsim_tpu_torch.ops import tri_score as ts

    if not torch.cuda.is_available():
        raise SystemExit("bench/kernels.py needs a CUDA device")
    dev = torch.device("cuda", 0)

    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def blocks(grid):
        return (torch.from_numpy(g).to(dev) for g in grid)

    def under_tree(path: str) -> str:
        path = os.path.realpath(path)
        if os.path.commonpath([path, os.path.realpath(tree)]) != (
                os.path.realpath(tree)):
            raise SystemExit(f"{path} is not under the tree {tree}")
        return path

    out = {"tree": tree,
           "package": under_tree(apsim_tpu_torch.__file__),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip()}
    eng = Engine(AllPairsConfig(), dev)
    eng.build(synthetic_corpus(32768, seed=0))
    q, aux = ts.quantize_rows(eng.x)
    tau = eng._tau_eff(0.8)
    tile = (getattr(ts, "thread_block_tile", None)
            or getattr(ts, "int8_tile", lambda m, n: (64, 128)))

    def record(name, fn, ops, shape):
        ms = median_ms(fn)
        out[f"{name}_ms"] = ms
        out[f"{name}_tops"] = ops / ms / 1e9
        out[f"{name}_tile"] = list(tile(*shape))

    def upper_cells(grid, tm, tn) -> int:
        rows = grid[0].astype(np.int64)[:, None] * tm + np.arange(tm)
        return int(np.clip(grid[1].astype(np.int64)[:, None] * tn + tn
                           - (rows + 1), 0, tn).sum())

    k = q.shape[1]
    grid = ts.upper_blocks_rect(eng.row_cap, 1024, 512)
    cells = upper_cells(grid, 1024, 512)
    bi, bj = blocks(grid)
    record("score_bits_int8",
           lambda: ts.score_bits_int8(q, aux, bi, bj, tau, 1024, 512),
           2 * cells * k, (1024, 512))
    xb = eng.x.to(torch.bfloat16)
    record("score_bits_bf16_32768",
           lambda: ts.score_bits_bf16(xb, bi, bj, tau, 1024, 512),
           2 * cells * k, (1024, 512))
    xh = xb[:, :k // 2].contiguous()
    del xb
    record("score_bits_bf16_32768_k16384",
           lambda: ts.score_bits_bf16(xh, bi, bj, tau, 1024, 512),
           2 * cells * (k // 2), (1024, 512))
    del xh
    xi, xj = q[:8192].contiguous(), q[8192:16384].contiguous()
    ai, aj = aux[:, :8192].contiguous(), aux[:, 8192:16384].contiguous()
    bi, bj = blocks(panel_ops.full_grid(8192, 8192, 1024, 512))
    record("panel_score_bits_int8",
           lambda: panel_ops.panel_score_bits_int8(
               xi, xj, ai, aj, bi, bj, (0, 8192), tau, 1024, 512),
           2 * 8192 * 8192 * k, (1024, 512))
    for label, d in (("1shard", k), ("8shard", k // 8)):
        a, b = xi[:, :d].contiguous(), xj[:, :d].contiguous()
        record(f"int8_matmul_{label}", lambda: panel_mesh.int8_matmul(a, b),
               2 * 8192 * 8192 * d, (8192, 8192))
        ms = median_ms(lambda: torch._int_mm(a, b.t()))
        out[f"int_mm_{label}_ms"] = ms
        out[f"int_mm_{label}_tops"] = 2 * 8192 * 8192 * d / ms / 1e9
        del a, b
    # kernel 5 (and 6, where the tree has it) at the off-diagonal pair's
    # 8,192 x 8,192 cells: the 8 shards' int32 partial dots (1 or all 8),
    # and as fp32 scores; GB/s over the partials read and the bits written
    w = k // 8
    parts = [panel_mesh.int8_matmul(xi[:, s * w:(s + 1) * w].contiguous(),
                                    xj[:, s * w:(s + 1) * w].contiguous())
             for s in range(8)]
    for n_parts in (1, 8):
        ps = parts[:n_parts]
        nbytes = 4 * n_parts * 8192 * 8192 + 8192 * 8192 * 9 // 64
        ms = median_ms(lambda: panel_mesh.pair_bits_int8(
            ps, ai, aj, 0, 8192, tau))
        out[f"pair_bits_int8_{n_parts}part_ms"] = ms
        out[f"pair_bits_int8_{n_parts}part_gb_per_s"] = nbytes / ms / 1e6
        if hasattr(panel_mesh, "pair_bits_f32"):
            fs = [p.float() * 1e-4 for p in ps]
            ms = median_ms(lambda: panel_mesh.pair_bits_f32(fs, 0, 8192,
                                                            tau))
            out[f"pair_bits_f32_{n_parts}part_ms"] = ms
            out[f"pair_bits_f32_{n_parts}part_gb_per_s"] = nbytes / ms / 1e6
            del fs
    del eng, q, aux, xi, xj, parts, ps
    eng = Engine(AllPairsConfig(pallas_int8=False), dev)
    eng.build(synthetic_corpus(8586, seed=0))
    xb = eng.x.to(torch.bfloat16)
    tm, tn = eng._tiles()
    grid = ts.upper_blocks_rect(eng.row_cap, tm, tn)
    bi, bj = blocks(grid)
    record("score_bits_bf16",
           lambda: ts.score_bits_bf16(xb, bi, bj, eng._tau_eff(0.8), tm, tn),
           2 * upper_cells(grid, tm, tn) * xb.shape[1], (tm, tn))
    ms = median_ms(lambda: torch.matmul(xb, xb.t()))
    out[f"bf16_matmul_{eng.row_cap}_ms"] = ms
    out[f"bf16_matmul_{eng.row_cap}_tops"] = (
        2 * eng.row_cap ** 2 * xb.shape[1] / ms / 1e9)
    out["library"] = under_tree(_build.build_info()["library"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
