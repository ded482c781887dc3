"""The stripe joins of one source tree, for comparing two trees in turns on
one card (the join every configuration that the panel kernels refuse runs).

Usage, on a machine with one CUDA card:

    python apsim_tpu_torch/bench/stripe_ab.py --make CORPUS N [--seed S]
    python apsim_tpu_torch/bench/stripe_ab.py CORPUS [--tree DIR]
        [--legs bf16,int8,mesh4] [--joins 2] [--device cuda]

``--make`` writes ``synthetic_corpus(N, seed)`` (``bench/scale.py``) to
``CORPUS`` (an ``.npz``) once, so that every turn joins the same rows.
``--tree DIR`` imports ``apsim_tpu_torch`` from ``DIR`` (default: the
checkout that holds this file; another, e.g. the parent commit unpacked
with ``git archive``), so one script times both trees; run them in turns
(parent, change, change, parent) in one call.

Each leg of ``--legs`` builds an engine on the corpus and runs ``--joins``
``all_pairs(0.8)``:

  - ``bf16``: ``ChunkedAllPairs(pallas_int8=False)`` (bf16 slabs, fp32
    scores);
  - ``highest``: ``pallas_int8=False, matmul_precision="highest"`` (true
    fp32 products);
  - ``int8``: ``ChunkedAllPairs(use_pallas="off")`` with
    ``_int8_stripes`` (int8 slabs, kernel 4);
  - ``meshN`` / ``meshN_int8``: ``MeshChunkedAllPairs`` over N shards of
    the card, bf16 or int8 stripes.

Per leg: each join's wall seconds (host clock; a join ends with its pairs
on the host), the last join's stage split (``Timer`` sections), the
stripe width and count, the peak device memory over the joins, the pair
count and a digest of the pair set (equal digests: equal sets), and the
launches of each kernel (``tri_score.LAUNCHES``) over the joins.  The
card's name and power limit, the tree and the package it loaded head the
report, one JSON object on stdout.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

TAU = 0.8


def make_corpus(path: str, n: int, seed: int) -> None:
    """``synthetic_corpus(n, seed)`` as an ``.npz`` at ``path``."""
    import numpy as np

    from apsim_tpu_torch.bench.scale import synthetic_corpus

    csr = synthetic_corpus(n, seed=seed)
    np.savez(path, indptr=csr.indptr, indices=csr.indices, data=csr.data,
             n_cols=csr.n_cols)


def digest(res) -> str:
    """A digest of a join's pair set (its (i, j) pairs, sorted)."""
    import numpy as np

    order = np.lexsort((res.j, res.i))
    pairs = np.stack([res.i[order], res.j[order]]).astype(np.int64)
    return hashlib.sha1(pairs.tobytes()).hexdigest()


def run_leg(leg: str, csr, device, joins: int) -> dict:
    """One leg (module docstring) on ``csr``: build, ``joins`` joins."""
    import torch

    from apsim_tpu_torch import (AllPairsConfig, ChunkedAllPairs,
                                 MeshChunkedAllPairs, make_mesh)
    from apsim_tpu_torch.ops import tri_score as ts

    int8 = leg.endswith("int8")
    cfg = (AllPairsConfig(use_pallas="off") if int8
           else AllPairsConfig(pallas_int8=False))
    if leg == "highest":
        cfg = cfg.replace(matmul_precision="highest")
    if leg.startswith("mesh"):
        n = int(leg[4:].split("_")[0])
        eng = MeshChunkedAllPairs(cfg, mesh=make_mesh(
            n, devices=[device] * n))
    elif leg in ("bf16", "highest", "int8"):
        eng = ChunkedAllPairs(cfg, device)
    else:
        raise ValueError(f"unknown leg {leg!r}")
    eng._int8_stripes = int8
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    eng.build(csr)
    rec = {"leg": leg, "build_s": time.perf_counter() - t0}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    before = dict(ts.LAUNCHES)
    rec["join_s"] = []
    for _ in range(joins):
        totals = dict(eng.timer.totals)
        t0 = time.perf_counter()
        res = eng.all_pairs(TAU)
        rec["join_s"].append(time.perf_counter() - t0)
    if eng._panel_ok() and eng._panel_state() is not None:
        raise AssertionError(f"{leg}: the panel join was not refused")
    st = eng._q_super()
    rec.update(
        stages_s={k: v - totals.get(k, 0.0)
                  for k, v in eng.timer.totals.items()
                  if k != "all_pairs" and v != totals.get(k, 0.0)},
        super_tile=st, stripes=-(-eng.n_rows // st),
        int8=eng._int8_slabs() is not None, pairs=res.n_pairs,
        digest=digest(res),
        launches={k: v - before[k] for k, v in ts.LAUNCHES.items()},
        max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                              if cuda else None))
    if rec["int8"] != int8:
        raise AssertionError(f"{leg}: int8 stripes {rec['int8']}")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("corpus")
    ap.add_argument("n", nargs="?", type=int)
    ap.add_argument("--make", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", default=None)
    ap.add_argument("--legs", default="bf16,int8,mesh4")
    ap.add_argument("--joins", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, tree)
    if args.make:
        make_corpus(args.corpus, args.n, args.seed)
        return {}
    import numpy as np
    import torch

    import apsim_tpu_torch
    from apsim_tpu_torch import CSRMatrix

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench/stripe_ab.py needs a CUDA device")
    z = np.load(args.corpus)
    csr = CSRMatrix(z["indptr"].size - 1, int(z["n_cols"]), z["indptr"],
                    z["indices"], z["data"])
    out = {"tree": tree, "package": os.path.realpath(
        apsim_tpu_torch.__file__), "rows": csr.n_rows}
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    out["legs"] = {}
    for leg in args.legs.split(","):
        out["legs"][leg] = run_leg(leg, csr, device, args.joins)
        print(json.dumps(out["legs"][leg]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
