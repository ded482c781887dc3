"""The port's MFU accounting, ``run_scale`` and stage probes
(``apsim_tpu_torch.bench``: ``mfu``, ``scale.run_scale``, ``join_probe``,
``insert_probe``, ``panel_probe``, ``serve_probe``, ``constants_ab``) on
the CPU, beside the JAX package's where it has the same function.

Tolerances: op counts, capacities, candidate and pair counts are compared
exactly; times are never compared (a CPU run reports no utilization).
"""

import json

import pytest
import torch

from apsim_tpu.bench import join_probe as jax_join_probe
from apsim_tpu.bench.mfu import int8_join_ops as jax_int8_join_ops
from apsim_tpu.bench.scale import run_scale as jax_run_scale
from apsim_tpu.bench.scale import synthetic_corpus as jax_synthetic_corpus
from apsim_tpu_torch.bench import (constants_ab, insert_probe, join_probe,
                                   mfu, panel_probe, serve_probe)
from apsim_tpu_torch.bench.scale import run_scale, synthetic_corpus
from apsim_tpu_torch.bench.suite import _oracle_pairs
from apsim_tpu_torch.engine.chunked import ChunkedAllPairs
from apsim_tpu_torch.ops import panel as panel_ops


@pytest.mark.parametrize("rows, dim", [(1024, 8192), (32768, 32768),
                                       (65536, 34816), (500_000, 32768)])
def test_int8_join_ops_matches_jax(rows, dim):
    assert mfu.int8_join_ops(rows, dim) == jax_int8_join_ops(rows, dim)


def test_card_peaks():
    peaks = mfu.card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["int8"] == 1979e12
    assert peaks["bf16"] == 989e12
    assert peaks["hbm"] == 3.35e12
    with pytest.raises(KeyError, match="no peak rates known"):
        mfu.card_peaks("TPU v5 lite")
    assert mfu.mfu_pct(1979e12, 1.0, peaks["int8"]) == pytest.approx(100.0)
    assert mfu.mfu_pct(1.0, 0.0, peaks["int8"]) == 0.0


def test_run_scale_matches_jax():
    got = run_scale(sizes=(512,), device="cpu")
    want = jax_run_scale((512,))
    assert got["device"] == "cpu"
    for key in ("pairs", "row_cap", "dim_cap", "int8_ops"):
        assert got["512"][key] == want["512"][key], key
    assert got["512"]["mfu_pct"] is None  # no utilization from a CPU run


def test_join_probe_matches_jax():
    got = join_probe.probe_size(synthetic_corpus(400), device="cpu",
                                check_plain=True)
    want = jax_join_probe.probe_size(jax_synthetic_corpus(400))
    for key in ("row_cap", "dim_cap", "int8_ops"):
        assert got[key] == want[key], key
    assert got["tiles"] == [1024, 512]
    assert got["kernel_equals_plain"] is True
    assert got["mfu_pct_e2e"] is None and got["mfu_pct_kernel"] is None
    assert got["compact_fetch_s"] == got["extract_s"] - got["kernel_s"]


def test_join_probe_main(capsys):
    rec = join_probe.main(["300", "--cpu"])
    assert rec["device"] == "cpu"
    r = rec["join_probe"]["300"]
    assert r["candidates"] >= 1 and r["n_blocks"] >= 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(rec))


def test_join_probe_geom(capsys):
    rec = join_probe.main(["300", "--geom", "--cpu"])
    sweep = rec["geom_sweep"]
    assert sweep["candidates_agree"]
    ran = [k for k, v in sweep.items()
           if isinstance(v, dict) and "kernel_s" in v]
    # row_cap 1024 takes every tile but the 2048-row one
    assert ran == ["1024x512", "1024x1024", "512x512", "256x256"]
    assert "note" in sweep["2048x512"]
    assert "geom_sweep" in capsys.readouterr().out


def test_insert_probe_main(capsys):
    rec = insert_probe.main(["300", "--stages", "--cpu"])
    assert sorted(rec["unpipelined"]) == [1, 32, 256]
    assert sorted(rec["stages"]) == [1, 256]
    assert rec["pipelined"]["batch_size"] == 256
    assert "link_floor_ms" not in rec  # no link on the CPU
    out = capsys.readouterr().out
    assert "no parse stage" in out
    assert '"insert_probe"' in out.strip().splitlines()[-1]


def test_panel_probe_main_rolling(monkeypatch, capsys):
    """At 1,500 rows in 1,024-row panels (the smallest the cost model may
    pick, forced by a one-byte slab budget) with no resident budget: the
    rolling sweep at every ``B`` and at panels twice as tall, each join
    finding the fp64 oracle's pairs."""
    monkeypatch.setattr(ChunkedAllPairs, "_panel_resident_bytes", 0)
    monkeypatch.setattr(ChunkedAllPairs, "_panel_slab_budget", 1)
    rec = panel_probe.main(["1500", "--cpu"])
    assert rec["mode"] == "rolling"
    assert rec["geom"]["n_panels"] == 2
    assert sorted(rec["joins"]) == ["B=1", "B=2", "default",
                                    "default warm-up", "rb=2048",
                                    "rb=2048 warm-up"]
    assert rec["pairs_agree"]
    want, _ = _oracle_pairs(synthetic_corpus(1500), 0.8)
    assert rec["joins"]["default"]["pairs"] == len(want)
    assert len(rec["pair_ms"]) == 3 and rec["slab_build_ms"] > 0
    assert '"panel_probe"' in capsys.readouterr().out


def test_panel_probe_pair_split(monkeypatch):
    """The pair split the cost model is calibrated from: an off-diagonal
    and a diagonal pair, each end to end and its kernel alone, the
    overhead the difference and the rate the pair's multiply-adds (its
    scheduled blocks x tm x tn x d_cap) over the kernel's time."""
    monkeypatch.setattr(ChunkedAllPairs, "_panel_slab_budget", 1)
    rec = panel_probe.main(["1500", "--cpu", "--joins-only"])
    assert "pair_split" not in rec  # --joins-only skips it
    rec = panel_probe.main(["1500", "--cpu"])
    g = rec["geom"]
    split = rec["pair_split"]
    assert sorted(split) == ["diag", "off"]
    blocks = {"off": (g["rb"] // g["tm"]) * (g["rb"] // g["tn"]),
              "diag": panel_ops.diag_grid(g["rb"], g["tm"], g["tn"])[0].size}
    for k, s in split.items():
        assert s["macs"] == blocks[k] * g["tm"] * g["tn"] * g["d_cap"]
        assert s["overhead_ms"] == s["pair_ms"] - s["kernel_ms"]
        assert s["kernel_macs_per_s"] == s["macs"] / s["kernel_ms"] * 1e3


def test_constants_ab_on_cpu():
    """The planner-constant A/B on the CPU at 400 rows: two sets in turns
    (a forced rolling sweep against the defaults), every join, stripe
    join and streamed output against the fp64 oracle."""
    turns = ["roll", "dflt", "dflt", "roll"]
    spec = {"sizes": [400],
            "sets": {"roll": {"attrs": {"_panel_resident_bytes": 0},
                              "config": {"match_slab_budget_mb": 0}},
                     "dflt": {}, "tall": {"attrs": {"panel_rows": 2048}}},
            "joins": turns + ["tall"], "stripes": ["roll", "dflt"],
            "streams": turns, "stream_rows": 48, "stream_batch": [16, 32]}
    rep = constants_ab.run_size(400, spec, torch.device("cpu"))
    want = _oracle_pairs(synthetic_corpus(400), 0.8)[0]
    assert rep["oracle_pairs"] == len(want) > 0
    assert [j["set"] for j in rep["joins"]] == spec["joins"]
    for j in rep["joins"]:
        assert j["parity"] is True and j["pairs"] == len(want)
        assert j["sweep"] == ("rolling" if j["set"] == "roll"
                              else "resident")
        assert (j["panel_geom"]["rb"] == 2048) is (j["set"] == "tall")
    assert [s["set"] for s in rep["stripes"]] == ["roll", "dflt"]
    assert all(s["parity"] for s in rep["stripes"])
    assert [s["set"] for s in rep["streams"]] == turns
    for s in rep["streams"]:
        assert sorted(s["stream"]) == ["16", "32"]
        for b in s["stream"].values():
            assert b["parity"] is True
            assert ("resident_slabs" in b["routes"]) is (s["set"] == "dflt")
    # without the oracle the joins are held to the first set's pair set
    rep = constants_ab.run_size(400, {"sets": spec["sets"], "oracle": False,
                                      "joins": ["dflt", "tall"]}, "cpu")
    assert "oracle_pairs" not in rep and "streams" not in rep
    assert [j["parity"] for j in rep["joins"]] == [True, True]
    eng = constants_ab.make_engine(spec["sets"]["roll"], "cpu")
    assert eng._panel_resident_bytes == 0 and eng.cfg.match_slab_budget_mb == 0
    assert ChunkedAllPairs._panel_resident_bytes > 0  # the class is untouched
    with pytest.raises(AttributeError, match="no attribute _panel_typo"):
        constants_ab.make_engine({"attrs": {"_panel_typo": 1}}, "cpu")
    with pytest.raises(SystemExit):
        constants_ab.main([])


def test_serve_probe_main(capsys):
    rec = serve_probe.main(["300", "--rates", "50", "--duration", "1",
                            "--flush-cap", "512", "--cpu"])
    (phase,) = rec["phases"]
    assert phase["indexed"] == phase["offered_vectors"] == 50
    assert sum(n for _, n, _ in phase["flush_timeline"]) == 50
    assert rec["max_flush_batch"] == 512
    assert '"serve_probe"' in capsys.readouterr().out.strip().splitlines()[-1]

