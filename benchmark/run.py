"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell names;
without them it exits with code 3 and prints no result.  Set-up makes the
cell's data on the card from ``--seed``, builds the port's engine on it and
warms every shape the traffic uses; then the window measures for
``--seconds``.  Once it has closed the port's outputs are compared with
the plain reference (``reference/``).  With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a traced stretch after the window.  The last
line of standard output is the result; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.
A run in which a module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``apsim_tpu`` has loaded exits with code 4 and prints none.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
_HERE = os.path.dirname(os.path.abspath(__file__))
# the script's directory must not shadow the standard library (profile)
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or os.getcwd()) != _HERE]
sys.path.insert(0, os.path.dirname(_HERE))

import argparse  # noqa: E402
import json  # noqa: E402

from benchmark import harness  # noqa: E402

__all__ = ["run_cell", "main"]

TOP = 10  # entries of each breakdown list


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def _metric_names(spec: dict, cell: str, group: str) -> list:
    return [m for m in spec[group]
            if cell in m.get("workloads", [cell])]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """The result of one run of the cell ``name``.  ``overrides`` (for the
    tests, which run tiny cells on the CPU) is merged into the cell's
    ``params`` and its configuration."""
    spec = harness.load_spec()
    entry, cell, config = harness.load_cell(spec, name)
    if overrides:
        cell = _merge(cell, {"params": overrides.get("params", {})})
        config = _merge(config, overrides.get("config", {}))
    ctx = harness.Ctx(name, cell, config, seed, seconds, trace, device)
    kind = harness.load_module("traffic", cell["kind"])
    out = kind.run(ctx)
    setup_s = out["window_start"] - T_START
    metrics = {}
    if not trace:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in _metric_names(spec, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in _metric_names(spec, name, "per_layer"):
            v = harness.load_module("metrics", m["name"]).read(out["records"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = harness.device_record(ctx, entry["chips"], out["memory_peak"])
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    prof = out.get("profile")
    if trace and prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = {
            "device_ops": [[k[:200], v] for k, v in
                           list(prof["kernels_s"].items())[:TOP]],
            "idle_gaps": prof["idle_gaps"][:TOP],
        }
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    entry = harness.load_cell(spec, args.workload)[0]
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark runs on the card only")
        return 3
    if torch.cuda.device_count() < entry["chips"]:
        harness.log(f"the cell needs {entry['chips']} cards, "
                    f"{torch.cuda.device_count()} visible")
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    line = json.dumps(result)
    # after every module of the run has loaded, just before the result
    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded JAX modules: {', '.join(found)}; no result")
        return 4
    for k, c in result["checks"].items():
        harness.log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
