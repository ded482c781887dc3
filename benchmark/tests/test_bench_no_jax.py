"""Importing the benchmark, and every module its run loads, brings in no
module whose whole top-level name is ``jax``, ``jaxlib``, ``flax`` or
``apsim_tpu`` (``apsim_tpu_torch`` begins with ``apsim_tpu`` and is not
one of them)."""

import ast
import os
import subprocess
import sys

from benchmark import harness

PROBE = r"""
import glob, os, sys
sys.path.insert(0, sys.argv[1])
import benchmark.run
from benchmark import harness
for kind in ("traffic", "metrics"):
    for path in sorted(glob.glob(os.path.join(harness.BENCH, kind, "*.py"))):
        name = os.path.basename(path)[:-3]
        if name != "__init__":
            harness.load_module(kind, name)
import benchmark.control, benchmark.sweep
import apsim_tpu_torch.engine.chunked, apsim_tpu_torch.serve.server
print("forbidden:" + ",".join(harness.forbidden_modules()))
"""


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "apsim_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "apsim_tpux.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "apsim_tpu.engine", sys)
    assert harness.forbidden_modules() == ["apsim_tpu", "jax"]


def test_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE, harness.ROOT],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden:", out.stdout


def test_sources_import_no_jax():
    for root, _, files in os.walk(harness.BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            for node in ast.walk(ast.parse(open(path).read(), path)):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_a_bare_checkout_fails(tmp_path):
    """In a directory with only the benchmark's files, a run exits with an
    error and prints no result."""
    import shutil

    shutil.copytree(harness.BENCH, tmp_path / "benchmark")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "rcv1_join_200k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_main_refuses_a_run_that_loaded_jax(monkeypatch, capsys):
    """A module whose top-level name is forbidden, loaded by any part of
    the run (a metric's reader too), ends it with no result."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "benchmark_run_jax_probe", os.path.join(harness.BENCH, "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)

    def fake_cell(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", sys)
        return {"correct": True, "checks": {}}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", fake_cell)
    rc = run.main(["--workload", "rcv1_join_200k", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert '"correct"' not in out.out
    assert "jax" in out.err
