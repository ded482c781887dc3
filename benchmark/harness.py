"""What every cell shares: finding its files by name, the run's context,
the device record and the check that no JAX module was loaded.

A cell ``<cell>`` of ``BENCHMARK.json`` has ``workloads/<cell>.json``: its
configuration's name, its traffic mix's name, its chips, its traffic kind
and the kind's parameters.  The configuration ``<config>`` has
``configs/<config>.json``; the kind ``<kind>`` is ``traffic/<kind>.py`` and
a per-layer metric ``<metric>`` is ``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

__all__ = ["BENCH", "ROOT", "load_spec", "load_cell", "load_module",
           "Ctx", "forbidden_modules", "device_record", "log"]

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "apsim_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH, *parts), encoding="utf-8") as f:
        return json.load(f)


def load_cell(spec: dict, name: str) -> tuple[dict, dict, dict]:
    """``(entry of BENCHMARK.json, cell file, configuration file)`` of the
    cell ``name``; raises where the three disagree."""
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"cell {name!r} {len(entries)} times in "
                       "BENCHMARK.json")
    entry, cell = entries[0], _json("workloads", f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} {cell[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    return entry, cell, _json("configs", f"{cell['config']}.json")


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark, loaded from its path (a
    metric's name may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    mod_name = f"benchmark_{kind}_{name.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Ctx:
    """One run of one cell: its files, the seed, the window's length, the
    trace switch and the device."""

    def __init__(self, name: str, cell: dict, config: dict, seed: int,
                 seconds: float, trace: bool, device):
        import torch

        self.name, self.cell, self.config = name, cell, config
        self.params = cell["params"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        """The peak of device memory the process allocated so far."""
        import torch

        if self.device.type != "cuda":
            return 0
        return int(max(torch.cuda.max_memory_allocated(d)
                       for d in range(torch.cuda.device_count())))

    def settle(self) -> None:
        """Before the window: collect what set-up dropped and move every
        object set-up made out of the collector's reach
        (``gc.freeze``), so that a full collection in the window scans
        only what the window makes."""
        gc.collect()
        gc.freeze()
        self.sync()

    def free(self) -> None:
        """Give the device memory of what was dropped back."""
        import torch

        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is ``jax``, ``jaxlib``,
    ``flax`` or ``apsim_tpu`` (``apsim_tpu_torch`` is not one of them)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def device_record(ctx: Ctx, chips: int, peak: int) -> dict:
    import torch

    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": peak, "power_limit_w": None}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(ctx.device),
            "count": chips, "memory_peak_bytes": peak,
            "power_limit_w": _power_limit_w()}


def now() -> float:
    return time.perf_counter()
