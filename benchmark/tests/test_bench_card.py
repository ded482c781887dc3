"""On the card: a reduced join cell runs through the whole harness and
comes out correct, the control one precision down does not, and each
cell at its own size with its threshold shifted either way comes out not
correct.  Marked ``cuda``; the ``card`` fixture skips without one."""

import importlib.util
import os

import pytest

from benchmark import harness

SMALL = {"config": {"rows": 20_000}, "params": {"check_rows": 2048}}


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "benchmark_run_on_card", os.path.join(harness.BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_reduced_join_cell_on_the_card(card):
    r = _run_module().run_cell("rcv1_join_200k", 2**33 + 5, 2.0, True,
                               device="cuda", overrides=SMALL)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert 0 < r["metrics"]["kernel3_roofline"]["value"] <= 105


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    from benchmark.control import control_numbers
    from benchmark.reference.compare import LIMITS

    spec = harness.load_spec()
    _, cell, config = harness.load_cell(spec, "rcv1_join_200k")
    config = dict(config, rows=20_000)
    cell = dict(cell, params=dict(cell["params"], check_rows=2048))
    nums = control_numbers("rcv1_join_200k", cell, config, 7, 1.0, "cuda")
    assert any(nums[k] > LIMITS[k] for k in LIMITS)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [0.05, -0.05], ids=["up", "down"])
@pytest.mark.parametrize("cell", ["rcv1_join_200k", "rcv1_ingest_440k_over"])
def test_shifted_threshold_at_the_cells_size(card, cell, delta, monkeypatch):
    from benchmark.tests.test_bench_faults import shifted

    shifted(delta)(monkeypatch)
    r = _run_module().run_cell(cell, 2**34 + 17, 5.0, False, device="cuda")
    print(cell, delta, r["checks"])
    assert not r["correct"], r["checks"]
