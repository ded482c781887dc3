"""The control of a cell's comparison: the reference one precision down.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--seconds <run_seconds>]

For each seed, makes the cell's data and the set of answers a run checks
(the join's sampled rows, the ingest cell's sampled fresh vectors), computes the float64 reference and the same
reference in float32 (TF32 off: the precision below the configuration's
float64), and compares the float32 answers with the float64 reference as
a run compares the port's.  Each seed prints one JSON line with the
numbers compared and their limits; ``fails`` says whether the control
came out not correct, as it has to.  No window runs: the control computes
the answers directly, at the cell's own sizes.
"""

from __future__ import annotations

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or os.getcwd()) != _HERE]
sys.path.insert(0, os.path.dirname(_HERE))

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import corpus as corpus_mod  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark.reference.compare import LIMITS, compare  # noqa: E402

__all__ = ["control_numbers", "main"]


def _answers(keys, sims, tau):
    keep = sims >= tau
    return keys[keep], sims[keep]


def control_numbers(name: str, cell: dict, config: dict, seed: int,
                    seconds: float, device) -> dict:
    """The comparison's numbers with the float32 reference in the port's
    place, for one seed."""
    kind = cell["kind"]
    p = cell["params"]
    tau = float(config["tau"])
    f64, f32 = torch.float64, torch.float32
    if kind == "join_loop":
        jl = harness.load_module("traffic", "join_loop")
        n = int(config["rows"])
        c = corpus_mod.make_corpus(config["corpus"], n, seed, device)
        rows = jl.check_rows_of(seed, n, int(p["check_rows"]), device)
        rk, rs = jl.reference_keys(c, rows, tau, f64)
        gk, gs = _answers(*jl.reference_keys(c, rows, tau, f32), tau)
        return compare(gk, gs, rk, rs, tau)
    stream = harness.load_module("traffic", "_stream")
    n_index = int(config["index_rows"])
    if kind == "ingest_stream":
        ing = harness.load_module("traffic", "ingest_stream")
        cap = int(config["max_flush_batch"])
        step = float(p["period_ms"]) / 1e3 / int(p["children"])
        n_warm = 2 * cap - 1
        lo = int(np.ceil(float(p["warm_s"]) / step - 1e-9))
        hi = int(np.ceil((float(p["warm_s"]) + seconds) / step - 1e-9))
        n_rows = n_index + n_warm + hi
        c = corpus_mod.make_corpus(config["corpus"], n_rows, seed, device)
        pick = np.sort(stream.seeded_rows(
            seed, 2, hi - lo, min(int(p["check_vectors"]), hi - lo),
            device)) + lo
        g = (n_index + n_warm + pick).astype(np.int64)
        rk, rs, before = ing.reference_keys(c, g, n_rows, tau, f64)
        gk, gs, _ = ing.reference_keys(c, g, n_rows, tau, f32)
        return compare(*_answers(gk, gs, tau), rk, rs, tau, required=before)
    raise ValueError(f"no control for the traffic kind {kind!r} of {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    _, cell, config = harness.load_cell(spec, args.workload)
    seconds = (float(spec["run_seconds"]) if args.seconds is None
               else args.seconds)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the control runs on the card")
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t = harness.now()
        nums = control_numbers(args.workload, cell, config, seed, seconds,
                               "cuda")
        fails = any(nums[k] > LIMITS[k] for k in LIMITS)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": harness.now() - t, **nums,
                          "limits": LIMITS, "fails": fails}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
