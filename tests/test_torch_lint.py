"""The port, its chip script and its benchmark script (``bench_torch.py``)
stay lint-clean under tools/lint.py (the repo's zero-dependency ruff
subset), which does not list them by default, and import neither JAX nor
the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the benchmark suite, the stage probes (ROADMAP item D2) and the schedule
# and slab studies
BENCH_MODULES = ("suite", "baseline", "mfu", "scale", "join_probe",
                 "insert_probe", "panel_probe", "serve_probe", "tri_probe",
                 "mesh_tri_probe", "ell_probe", "constants_ab")


@pytest.mark.parametrize("target", ["apsim_tpu_torch", "chip_smoke.py",
                                    "bench_torch.py"])
def test_port_lint_clean(target):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "lint.py"),
         os.path.join(REPO, target)],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def port_sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "bench_torch.py")]
    for root, _, files in os.walk(os.path.join(REPO, "apsim_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_no_jax():
    """Every import statement of the port's sources, at any depth: no
    ``jax`` (or ``jaxlib``, ``flax``), and nothing of ``apsim_tpu``."""
    banned = {"jax", "jaxlib", "flax", "apsim_tpu"}
    sources = port_sources()
    assert len(sources) > 20
    rel = {os.path.relpath(p, REPO) for p in sources}
    for need in ("bench_torch.py", "apsim_tpu_torch/cli.py",
                 "apsim_tpu_torch/etl/tfidf.py",
                 "apsim_tpu_torch/etl/store.py",
                 "apsim_tpu_torch/serve/server.py",
                 "apsim_tpu_torch/serve/rpc.py",
                 "apsim_tpu_torch/serve/client.py",
                 "apsim_tpu_torch/bench/loadgen.py",
                 *(f"apsim_tpu_torch/bench/{m}.py" for m in BENCH_MODULES)):
        assert need in rel, need
    bad = []
    for path in sources:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad += [(os.path.relpath(path, REPO), n) for n in names
                    if n.split(".")[0] in banned]
    assert not bad, bad


def test_serving_path_imports_leave_jax_out():
    """Importing the CLI, the ETL, the serving stack, the bench helpers,
    the suite, the stage probes and ``bench_torch.py`` (in a fresh
    interpreter) loads no JAX and nothing of the JAX package."""
    mods = ("apsim_tpu_torch.cli", "apsim_tpu_torch.etl",
            "apsim_tpu_torch.serve", "apsim_tpu_torch.bench.loadgen",
            "apsim_tpu_torch.bench.data",
            "apsim_tpu_torch.bench.restore_probe",
            *(f"apsim_tpu_torch.bench.{m}" for m in BENCH_MODULES),
            "bench_torch")
    code = (f"import sys, importlib; [importlib.import_module(m) for m in "
            f"{mods!r}]; bad = [m for m in sys.modules if m.split('.')[0] "
            f"in ('jax', 'jaxlib', 'apsim_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_port_exports_the_jax_api():
    """The port's top-level ``__all__`` holds every name of the JAX
    package's, and each is importable from it."""
    import apsim_tpu
    import apsim_tpu_torch

    missing = set(apsim_tpu.__all__) - set(apsim_tpu_torch.__all__)
    assert not missing, sorted(missing)
    assert all(hasattr(apsim_tpu_torch, n) for n in apsim_tpu_torch.__all__)
