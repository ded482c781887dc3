"""The chunked engine's join and stream under several sets of its planner
constants, in turns, on one card: an A/B of the class attributes and config
values that pick the panel height, the sweep mode, the stripe width and the
streaming route (``ChunkedAllPairs._panel_*``, ``_stripe_acc_budget``,
``_host_ns_per_*``, ``match_slab_budget_mb``, ...).

Usage, on a machine with one CUDA card:

    python -m apsim_tpu_torch.bench.constants_ab SPEC

``SPEC`` is a JSON object (every key but ``sizes`` and ``sets`` optional):

    {"sizes": [100000, 499712],          # corpus rows, synthetic_corpus
     "sets": {"a": {"attrs": {...}, "config": {...}}, "b": {}},
     "joins": ["a", "b", "b", "a"],      # the join turns
     "stripes": ["a", "b"],              # the stripe-join turns
     "streams": ["a", "b", "b", "a"],    # the stream turns
     "stream_rows": 4096, "stream_batch": [32, 256, 1024],
     "oracle": true, "seed": 0}

A set's ``attrs`` are set on each engine it builds (shadowing the class's:
``_panel_*``, ``panel_rows``, ...), its ``config`` replaces fields of
``AllPairsConfig()``; ``"shards": n`` makes its engine a
``MeshChunkedAllPairs`` over n shards of the one card.  Per size, on
``synthetic_corpus(n, seed)``:

  - joins: one engine per set, each turn three ``all_pairs(0.8)`` of the
    turn's engine with the third timed (``bench.ooc``'s join report: panel
    geometry, sweep mode, stage split), then each set's pair set against
    an fp64 oracle (``ooc.batch_oracle`` in 16,384-row blocks on the card;
    with ``"oracle": false``, against the first set's);
  - stripes: the set with ``pallas_int8=False`` (the stripe join), two
    joins, the second timed, with its stripe width and peak memory, pair
    set against the same reference;
  - streams (``stream_rows`` > 0): a fresh engine of the set built on the
    corpus streams ``stream_rows`` rows in batches of each size of
    ``stream_batch`` (``ooc``'s stream report: median batch seconds,
    routes, stage split, parity of every output with an fp64 oracle).

The card's name and power limit head the report; one JSON object per size
goes to stderr as it finishes, the whole report to stdout at the end.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Dict

import torch

from ..config import AllPairsConfig
from ..engine.chunked import ChunkedAllPairs
from ..parallel.chunked_mesh import MeshChunkedAllPairs
from ..parallel.mesh import make_mesh
from . import ooc
from .scale import synthetic_corpus

__all__ = ["main", "run_size", "make_engine", "oracle"]

TAU = 0.8
ORACLE_BLOCK = 16384


def make_engine(spec: Dict, device, **config) -> ChunkedAllPairs:
    """A chunked engine of one set: its ``config`` fields (and
    ``config``'s keyword overrides) on ``AllPairsConfig()``, its
    ``attrs`` on the instance; with ``"shards": n`` a
    ``MeshChunkedAllPairs`` of n shards, every one on ``device``."""
    cfg = AllPairsConfig().replace(**{**spec.get("config", {}), **config})
    if spec.get("shards"):
        n = int(spec["shards"])
        eng = MeshChunkedAllPairs(cfg, mesh=make_mesh(n, devices=[device] * n))
    else:
        eng = ChunkedAllPairs(cfg, device)
    for k, v in spec.get("attrs", {}).items():
        if not hasattr(eng, k):
            raise AttributeError(f"ChunkedAllPairs has no attribute {k}")
        setattr(eng, k, v)
    return eng


def oracle(csr, tau: float, device) -> set:
    """The fp64 pair set of ``csr`` in row blocks (``ooc.batch_oracle`` of
    each block against the rows before it and itself)."""
    out: set = set()
    for r0 in range(0, csr.n_rows, ORACLE_BLOCK):
        r1 = min(r0 + ORACLE_BLOCK, csr.n_rows)
        index = [ooc.csr_rows(csr, 0, r0)] if r0 else []
        out |= ooc.batch_oracle(index, ooc.csr_rows(csr, r0, r1), r0, tau,
                                device)
    return out


def _pairs(res) -> set:
    return set(zip(res.i.tolist(), res.j.tolist()))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device):
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else None)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def run_size(n: int, spec: Dict, device) -> Dict:
    """Every measurement of ``spec`` at ``n`` rows (module docstring)."""
    device = torch.device(device)
    sets = spec["sets"]
    seed = int(spec.get("seed", 0))
    t0 = time.perf_counter()
    csr = synthetic_corpus(n, seed=seed)
    rep: Dict = {"n_rows": n, "gen_seconds": time.perf_counter() - t0}
    want = None
    if spec.get("oracle", True):
        t0 = time.perf_counter()
        want = oracle(csr, TAU, device)
        rep["oracle_seconds"] = time.perf_counter() - t0
        rep["oracle_pairs"] = len(want)

    turns = spec.get("joins", [])
    if turns:
        # one engine per set, the turns in order
        engines = {name: make_engine(sets[name], device)
                   for name in dict.fromkeys(turns)}
        for eng in engines.values():
            eng.build(csr)
        rep["joins"] = []
        for name in turns:
            eng = engines[name]
            _reset_peak(device)
            r: Dict = {}
            ooc._join(eng, r, TAU, device, 2048, csr, False, False)
            rb, tm, tn, n_panels, d_cap = eng._panel_geom()
            rec = {
                "set": name, "join_seconds": r["join_seconds"],
                "panel_geom": {"rb": rb, "tm": tm, "tn": tn,
                               "n_panels": n_panels, "d_cap": d_cap},
                "sweep": ("resident" if eng._keeps_all(n_panels, rb, d_cap)
                          else "rolling"),
                "slab_builds": r["slab_builds"], "stages_s": r["stages_s"],
                "int8_ops": r["int8_ops"], "kernel_tops": r["kernel_tops"],
                "pairs": r["pairs"], "peak_bytes": _peak(device),
            }
            rep["joins"].append(rec)
            print(json.dumps({"join": n, **rec}), file=sys.stderr,
                  flush=True)
        got = {name: _pairs(eng.all_pairs(TAU))
               for name, eng in engines.items()}
        if want is None:
            want = got[turns[0]]
        for rec in rep["joins"]:
            rec["parity"] = got[rec["set"]] == want
        del engines, eng, got
        _reset_peak(device)

    if spec.get("stripes"):
        rep["stripes"] = []
        for name in spec["stripes"]:
            eng = make_engine(sets[name], device, pallas_int8=False)
            eng.build(csr)
            eng.all_pairs(TAU)
            _reset_peak(device)
            t0 = time.perf_counter()
            res = eng.all_pairs(TAU)
            secs = time.perf_counter() - t0
            st = eng._q_super()
            rec = {"set": name, "join_seconds": secs, "super_tile": st,
                   "stripes": -(-eng.n_rows // st),
                   "peak_bytes": _peak(device), "pairs": res.n_pairs,
                   "parity": None if want is None else _pairs(res) == want}
            rep["stripes"].append(rec)
            print(json.dumps({"stripes": n, **rec}), file=sys.stderr,
                  flush=True)
            del eng, res
            _reset_peak(device)

    rows = int(spec.get("stream_rows", 0))
    if rows and spec.get("streams"):
        rep["streams"] = []
        for name in spec["streams"]:
            eng = make_engine(sets[name], device)
            eng.build(csr)
            _reset_peak(device)
            r: Dict = {}
            index = [csr]
            for k, bs in enumerate(spec.get("stream_batch", [256])):
                ooc._stream(eng, r, index, TAU, rows, int(bs), seed, k,
                            False)
            _sync(device)
            rec = {"set": name, "peak_bytes": _peak(device),
                   "stream": {b: {key: s[key] for key in (
                       "median_batch_seconds", "vectors_per_sec", "routes",
                       "parity", "stages_ms_per_batch", "batches")}
                       for b, s in r["stream"].items()}}
            rep["streams"].append(rec)
            print(json.dumps({"stream": n, **rec}), file=sys.stderr,
                  flush=True)
            del eng
            _reset_peak(device)
    return rep


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> Dict:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 1:
        raise SystemExit(__doc__)
    spec = json.loads(args[0])
    if not torch.cuda.is_available():
        raise SystemExit("apsim_tpu_torch.bench.constants_ab needs a CUDA "
                         "device")
    device = torch.device("cuda")
    out: Dict = {"card": smi_line(), "spec": spec, "sizes": {}}
    for n in spec["sizes"]:
        out["sizes"][str(n)] = run_size(int(n), spec, device)
    json.dump(out, sys.stdout, indent=1)
    print()
    return out


if __name__ == "__main__":
    main()
