"""Triangular vs rectangular mesh-join accounting on the card (the
counterpart of ``apsim_tpu/bench/mesh_tri_probe.py``).

The dims-sharded ``MeshEngine``'s join is ``mesh_score.
mesh_allpairs_extract``: on a dims mesh every shard multiplies its column
block of the query tile against its column block of the row prefix, and
the fp32 partials are summed across the shards, so the schedule sets both
the multiplies and the bytes of that sum.  This study runs both schedules
over the same dims-sharded index and reports, per schedule:

  - the flops and bytes of the calls actually made, counted per device
    (total / shards) by ``ProductCounter``, a ``TorchDispatchMode`` around
    one join: every product (``aten.mm``, with and without ``out_dtype``)
    adds ``2 m n k`` flops and the bytes of its operands and its result;
    every copy between two devices adds the bytes moved.  This takes the
    place of the JAX study's ``compiled.cost_analysis()``, which has no
    torch counterpart and which counts a ``fori_loop`` body once whatever
    its trip count (``apsim_tpu/bench/tri_probe.py:16-20`` found it 4.5x
    the wrong way); the counter sees every call, so ``flops`` must equal
    the closed form (``closed_form_flops``);
  - the candidate count and the wall time (median of 5 joins, each ending
    in a synchronize).

"Rectangular" is ``mode="all"``: the full ``row_cap`` every tile, self and
symmetric pairs kept (about twice the candidates).  Compaction is exact
length, so there is no extraction cap to grow and the report has no
``cap``.  ``folded_all_equals_upper`` says whether the rectangle's
candidates, folded (``tri_probe.fold_pairs``), are the triangle's.

Usage: python -m apsim_tpu_torch.bench.mesh_tri_probe [n_rows]
       [--device cuda|cpu] [--shards N]
(default shards: every visible card; 8 on the CPU, the JAX study's
virtual devices.)
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..config import AllPairsConfig
from ..ops import mesh_score
from ..ops import score as score_ops
from ..parallel.mesh import MeshEngine
from .scale import synthetic_corpus
from .tri_probe import fold_pairs, study_device, study_mesh, timed_s

__all__ = ["ProductCounter", "closed_form_flops", "probe_mode", "main"]

_aten = torch.ops.aten


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ProductCounter(TorchDispatchMode):
    """Counts, while active, the flops and bytes of every ``aten.mm`` and
    the bytes of every copy between two devices."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.mm_bytes = 0
        self.copy_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func.overloadpacket
        if op is _aten.mm:
            a, b = args[0], args[1]
            self.flops += 2 * a.shape[0] * b.shape[1] * a.shape[1]
            self.mm_bytes += _nbytes(a) + _nbytes(b) + _nbytes(out)
        elif op is _aten._to_copy and args[0].device != out.device:
            self.copy_bytes += _nbytes(args[0])
        elif op is _aten.copy_ and args[0].device != args[1].device:
            self.copy_bytes += _nbytes(args[1])
        return out


def closed_form_flops(row_cap: int, tile: int, dim_cap: int, mode: str,
                      shards: int) -> int:
    """Per-device flops of one join: ``2 x prefix x tile x dim_cap`` per
    tile (prefix = its bucket's end for "upper", ``row_cap`` for "all"),
    over the shards."""
    if mode == "all":
        total = 2 * row_cap * row_cap * dim_cap
    else:
        total = sum(2 * (b1 * tile) * tile * dim_cap * (b1 - b0)
                    for b0, b1 in score_ops.upper_buckets(row_cap // tile))
    return total // shards


def probe_mode(eng: MeshEngine, tau: float, mode: str):
    """One counted join of ``eng``'s index in ``mode``, then the timed
    ones (``tri_probe.timed_s``).  Returns ``(record, pair set)``, the set
    folded."""
    tau_eff = eng._tau_eff(tau)
    tile = eng._tile()
    grp = int(eng.cfg.extract_group)
    blocks = eng._rect_blocks()

    def join():
        return mesh_score.mesh_allpairs_extract(
            blocks, eng.grid, eng.mesh, tau_eff, tile,
            eng.cfg.matmul_precision, grp, mode=mode)

    with ProductCounter() as pc:
        found = join()
    rows = torch.cat([r.cpu() for r, _ in found]).numpy()
    cols = torch.cat([c.cpu() for _, c in found]).numpy()
    n = eng.n_shards
    rec = {
        "pairs_or_candidates": int(rows.size),
        "flops": pc.flops / n,
        "bytes_accessed": (pc.mm_bytes + pc.copy_bytes) / n,
        "copy_bytes": pc.copy_bytes / n,
        "flops_closed_form": closed_form_flops(
            eng.row_cap, tile, eng.dim_cap, mode, n),
        "wall_s_median": timed_s(join, eng.mesh.lead),
    }
    return rec, fold_pairs(rows, cols, mode)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="mesh_tri_probe")
    ap.add_argument("n_rows", type=int, nargs="?", default=8192)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (raises without CUDA)")
    ap.add_argument("--shards", type=int, default=None)
    args = ap.parse_args(argv)
    dev = study_device(args.device)
    n = args.n_rows
    shards = args.shards or (torch.cuda.device_count()
                             if dev.type == "cuda" else 8)
    csr = synthetic_corpus(n)
    eng = MeshEngine(AllPairsConfig(shard_axis="dims", use_pallas="off"),
                     mesh=study_mesh(dev, shards))
    eng.build(csr)
    report = {
        "n_rows": n, "devices": shards,
        "mesh_devices": [str(d) for d in eng.mesh.devices],
        "row_cap": eng.row_cap,
        "dim_cap": eng.dim_cap, "tile": eng._tile(), "shard_axis": "dims",
    }
    folded = {}
    for mode in ("upper", "all"):
        report[mode], folded[mode] = probe_mode(eng, 0.8, mode)
        print(f"{mode}: {json.dumps(report[mode])}", flush=True)
    up, rect = report["upper"], report["all"]
    report["folded_all_equals_upper"] = folded["all"] == folded["upper"]
    report["flops_ratio_upper_over_rect"] = up["flops"] / rect["flops"]
    report["wall_ratio_upper_over_rect"] = (
        up["wall_s_median"] / rect["wall_s_median"]
    )
    print(json.dumps(report, indent=1), flush=True)
    return report


if __name__ == "__main__":
    main()
