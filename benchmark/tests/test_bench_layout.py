"""BENCHMARK.json against the contract and against the files it names."""

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}
CELLS = {w["name"]: w for w in SPEC["workloads"]}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    metric_names = [n for m, n in names if m]
    assert len(metric_names) == len(set(metric_names))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_configs_match_their_files():
    files = set()
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"] and _line(c["source"])
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert "guarantees" in cfg and "assumed" in cfg
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files(cell):
    entry, cfile, config = harness.load_cell(SPEC, cell)
    assert cfile["config"] in {c["name"] for c in SPEC["configs"]}
    assert os.path.exists(os.path.join(harness.BENCH, "traffic",
                                       cfile["kind"] + ".py"))
    assert cfile["why"] == entry["why"]
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert pairs.count((entry["config"], entry["traffic"])) == 1


def test_every_cell_file_loads():
    """Every cell file is a cell of BENCHMARK.json, and every metric file
    names only such cells."""
    names = sorted(f[:-5] for f in os.listdir(os.path.join(harness.BENCH,
                                                           "workloads")))
    assert set(CELLS) == set(names)
    for name in names:
        _, cfile, _ = harness.load_cell(SPEC, name)
        assert os.path.exists(os.path.join(harness.BENCH, "traffic",
                                           cfile["kind"] + ".py"))
    for f in os.listdir(os.path.join(harness.BENCH, "metrics")):
        if f.endswith(".py") and not f.startswith("_"):
            mod = harness.load_module("metrics", f[:-3])
            assert set(mod.WORKLOADS) <= set(names), f


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_reports_enough(cell):
    e2e = [m for m in SPEC["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    per = [m for m in SPEC["per_layer"]
           if cell in m.get("workloads", [cell])]
    assert per


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_file_declares_its_entry(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    mod = harness.load_module("metrics", metric)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
        m["unit"], m["better"], m["source"], m["layer"], m["moves"])
    assert mod.WORKLOADS == m["workloads"]
    assert callable(mod.read)
    moves = E2E[m["moves"]]
    for cell in m["workloads"]:
        assert cell in CELLS
        assert cell in moves.get("workloads", [cell])


def test_layers_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers <= {"kernels", "engine", "rescore", "serve", "device"}


def test_run_seconds_fit_the_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_within_quota():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
