"""Triangle-vs-rectangle accounting for the full-rectangle join on the card
(the counterpart of ``apsim_tpu/bench/tri_probe.py``).

``score.allpairs_extract``, the join of every configuration the kernels
refuse, scores the upper triangle through at most 16 static-prefix buckets
(``score.upper_buckets``, mode="upper") instead of the full rectangle every
tile (mode="all"): about half the multiplies and, on a dims mesh, half the
fp32 partials to sum.  On cuBLAS a short prefix is a small product that may
run below the rate of a long one, so whether the triangle pays is measured
here, not assumed:

1. **parity** (tiny corpus, executed): mode="upper" gives exactly the
   canonical i<j pair set of mode="all" (self pairs dropped, symmetric
   pairs folded, as ``fold_pairs`` does);
2. **per-device accounting** (requested size): the JAX study's closed form
   for both modes, each tile's product ``prefix x (dim_cap / n_dev) x
   tile`` per device and its fp32 ``[prefix, tile]`` partial summed across
   the dim shards; ``n_devices`` is the mesh's shard count (1 without
   ``--shards``), ``mesh_devices`` the device of each shard;
3. **executed wall-time A/B**: at the requested size on one device (the JAX
   study's ``--tpu`` leg); with ``--shards N`` over a dims mesh of N shards
   (on one card when N exceeds the card count) through
   ``mesh_score.mesh_allpairs_extract`` in each mode; on the CPU at the JAX
   study's shrunken sizes.  One warm call, then the median of 5 on the host
   clock; each call ends in exact-length device pairs and a synchronize.

The legs are plain functions on tensors (``parity_pairs``, ``parity_leg``,
``accounting``, ``wall_leg``); ``main`` prints the JAX study's JSON keys,
``wall_ms.backend`` being the device's name.

Usage: python -m apsim_tpu_torch.bench.tri_probe [row_cap] [dim_cap]
       [--device cuda|cpu] [--shards N]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import mesh_score
from ..ops import score as score_ops
from ..parallel.mesh import make_mesh

__all__ = ["study_device", "study_mesh", "device_name", "timed_s",
           "fold_pairs", "parity_pairs", "parity_leg", "accounting",
           "dims_blocks", "wall_leg", "main"]

CAP_TILE = 1024  # the accounting's and the card leg's query tile
CPU_SHAPE = (4096, 4096, 512)  # the CPU leg's row_cap, dim_cap, tile caps
REPS = 5  # timed calls after the warm one


def study_device(name: str | None) -> torch.device:
    """The device a study runs on: the card unless ``name`` is "cpu"; with
    no CUDA device it raises (no fallback to the CPU)."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")
    return dev


def study_mesh(dev: torch.device, shards: int):
    """A mesh of ``shards`` shards: over that many cards when there are,
    else every shard on ``dev`` (a CPU mesh is ``shards`` CPU shards)."""
    if dev.type == "cuda" and shards <= torch.cuda.device_count():
        return make_mesh(shards)
    return make_mesh(shards, devices=[dev] * shards)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_s(fn, dev: torch.device) -> float:
    """Median seconds of ``fn`` over ``REPS`` calls after one warm call,
    each ending in a synchronize (host clock)."""
    fn()
    _sync(dev)
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def fold_pairs(rows, cols, mode: str) -> set:
    """The pair set of a join's ``(rows, cols)``; mode="all" is made
    canonical (self pairs dropped, ``(j, i)`` folded onto ``(i, j)``)."""
    s = set(zip(np.asarray(rows).tolist(), np.asarray(cols).tolist()))
    if mode == "all":
        s = {(min(i, j), max(i, j)) for i, j in s if i != j}
    return s


def parity_pairs(dev: torch.device):
    """``({mode: pair set}, rng)``: leg 1's joins of 1,024 x 512
    row-normalised normals from ``default_rng(0)`` at tau 0.1, tile 256,
    "highest", group 8; leg 3 draws from ``rng`` next."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((1024, 512)).astype(np.float32)
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    x = torch.from_numpy(xs).to(dev)
    got = {}
    for m in ("all", "upper"):
        r, c = score_ops.allpairs_extract(x, 0.1, 256, m, "highest", 8)
        got[m] = fold_pairs(r.cpu().numpy(), c.cpu().numpy(), m)
    return got, rng


def parity_leg(dev: torch.device):
    """``({"n_pairs", "equal"}, rng)``; raises if the triangle lost or
    gained a pair against the rectangle."""
    got, rng = parity_pairs(dev)
    rep = {"n_pairs": len(got["upper"]), "equal": got["upper"] == got["all"]}
    if not rep["equal"]:
        raise AssertionError("triangle lost pairs vs rectangle")
    return rep, rng


def accounting(row_cap: int, dim_cap: int, tile: int, n_dev: int):
    """``(per-mode counts, flops ratio)``: the JAX study's closed form
    (``apsim_tpu/bench/tri_probe.py:93-119``), word for word."""
    n_tiles = row_cap // tile
    n_buckets = min(n_tiles, 16)
    bounds = [n_tiles * b // n_buckets for b in range(n_buckets + 1)]
    # per tile in bucket b: prefix = bounds[b+1]*tile rows scored
    pref_rows_upper = sum(
        (bounds[b + 1] - bounds[b]) * bounds[b + 1] * tile
        for b in range(n_buckets)
    )  # in units of tiles*rows
    pref_rows_all = n_tiles * row_cap
    dim_local = dim_cap // n_dev
    per_mode = {
        m: {
            "matmul_flops_per_device": 2 * pr * tile * dim_local,
            "psum_bytes_per_device": (
                pr * tile * 4 if n_dev > 1 else 0
            ),
        }
        for m, pr in (("all", pref_rows_all), ("upper", pref_rows_upper))
    }
    return per_mode, round(pref_rows_upper / pref_rows_all, 4)


def dims_blocks(x: torch.Tensor, mesh, precision: str) -> list:
    """``x [row_cap, dim_cap]`` (host or device) as a dims mesh's operand
    blocks: column block ``s`` on shard ``s``'s device, as
    ``score.score_operand`` multiplies it."""
    n = mesh.size
    w = x.shape[1] // n
    return [score_ops.score_operand(
        x[:, s * w:(s + 1) * w].contiguous().to(mesh.devices[s]), precision)
        for s in range(n)]


def wall_leg(x: np.ndarray, tile: int, dev: torch.device, mesh=None) -> dict:
    """Median ms of one join of ``x`` in each mode at "default" precision:
    ``score.allpairs_extract`` on ``dev``, or over ``mesh`` (a dims mesh)
    through ``mesh_allpairs_extract``, at tau 0.8.  The operands are
    converted once, as the engines cache them."""
    tau = 0.8
    xt = torch.from_numpy(x)
    wall = {}
    if mesh is None:
        xo = score_ops.score_operand(xt.to(dev), "default")
        calls = {m: (lambda m=m: score_ops.allpairs_extract(
            xo, tau, tile, m, "default", 8)) for m in ("all", "upper")}
    else:
        blocks = dims_blocks(xt, mesh, "default")
        calls = {m: (lambda m=m: mesh_score.mesh_allpairs_extract(
            blocks, (1, mesh.size), mesh, tau, tile, "default", 8, mode=m))
            for m in ("all", "upper")}
    for m, fn in calls.items():
        wall[m] = timed_s(fn, dev) * 1e3
    return wall


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="tri_probe")
    ap.add_argument("row_cap", type=int, nargs="?", default=8192)
    ap.add_argument("dim_cap", type=int, nargs="?", default=16384)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (raises without CUDA)")
    ap.add_argument("--shards", type=int, default=None,
                    help="run leg 3 over a dims mesh of N shards")
    args = ap.parse_args(argv)
    dev = study_device(args.device)
    row_cap, dim_cap, tile = args.row_cap, args.dim_cap, CAP_TILE
    report: dict = {"row_cap": row_cap, "dim_cap": dim_cap, "tile": tile}

    # ---- leg 1: executed parity at a tiny size (square vs triangle) ----
    report["parity"], rng = parity_leg(dev)

    # ---- leg 2: closed-form per-device accounting at the requested size
    mesh = study_mesh(dev, args.shards) if args.shards else None
    n_dev = mesh.size if mesh else 1
    report["modes"], report["flops_ratio_upper_vs_all"] = accounting(
        row_cap, dim_cap, tile, n_dev)
    report["n_devices"] = n_dev
    report["mesh_devices"] = [str(d) for d in (mesh.devices if mesh
                                               else (dev,))]

    # ---- leg 3: executed wall-time A/B ----
    if dev.type == "cuda":
        wr, wd, wt = row_cap, dim_cap, tile  # the card: full size
    else:
        wr, wd, wt = (min(row_cap, CPU_SHAPE[0]), min(dim_cap, CPU_SHAPE[1]),
                      CPU_SHAPE[2])
    x = rng.standard_normal((wr, wd)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
    wall = wall_leg(x, wt, dev, mesh)
    report["wall_ms"] = {"backend": device_name(dev), "shape": [wr, wd],
                         "tile": wt, **wall}
    report["wall_speedup_upper_vs_all"] = wall["all"] / wall["upper"]

    print(json.dumps(report, indent=1), flush=True)
    return report


if __name__ == "__main__":
    main()
