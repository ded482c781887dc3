"""``bench_torch.py``, the port's benchmark script, on the CPU at a few
hundred rows: each cell's runner (its pair set against the JAX package's
engine on the same seeded corpus), the exit code on a forged pair-set
mismatch, the refusal to run without CUDA, the last line, and the seed
that reaches every corpus (with ``bench.ooc.run_ooc`` and
``bench.scale.run_scale``).

Tolerances: every pair set is compared exactly; every parity flag must be
true (false where a mismatch is forged); times are never compared.
"""

import json

import numpy as np
import pytest
import torch

import apsim_tpu
import bench_torch
from apsim_tpu.bench.scale import synthetic_corpus as jax_corpus
from apsim_tpu.vector.batch import CSRMatrix as JaxCSR
from apsim_tpu_torch.bench import ooc, scale, suite
from apsim_tpu_torch.engine.engine import Engine
from apsim_tpu_torch.engine.output import PairResult
from apsim_tpu_torch.ops import tri_score

CPU = torch.device("cpu")
# the cells cut to a few hundred rows (widths, batch size and tau stay)
SMALL = {"dense_int8_join_8586": {"rows": 300},
         "dense_int8_join_32768": {"rows": 400},
         "dense_bf16_join_8586": {"rows": 300},
         "ooc_join_100k": {"rows": 600},
         "dense_insert_bs32": {"rows": 384, "build": 256}}
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "parity", "seconds",
             "int8_ops", "mfu_pct", "device", "cells", "baseline", "corpus"}


@pytest.fixture
def small_cells(monkeypatch):
    cells = {k: dict(v, **SMALL[k]) for k, v in bench_torch.CELLS.items()}
    monkeypatch.setattr(bench_torch, "CELLS", cells)
    return cells


@pytest.fixture
def two_joins(monkeypatch):
    """``main`` times two joins per join cell, with no time window."""
    monkeypatch.setattr(bench_torch, "REPEATS", 2)
    monkeypatch.setattr(bench_torch, "WINDOW_SECONDS", 0.0)


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def jax_pairs(n_rows: int) -> set:
    """The JAX package's exact join of ``synthetic_corpus(n_rows)``."""
    eng = apsim_tpu.Engine(apsim_tpu.AllPairsConfig())
    eng.build(jax_corpus(n_rows))
    res = eng.all_pairs(bench_torch.TAU)
    return set(zip(res.i.tolist(), res.j.tolist()))


@pytest.mark.parametrize("name", list(SMALL))
def test_cell_runner(name, small_cells, monkeypatch):
    # a caller's own launch count survives the runner (chip_smoke's does)
    monkeypatch.setitem(tri_score.LAUNCHES, "int8_matmul", 7)
    rec, csr, got = bench_torch.run_cell(name, CPU, repeats=2, window=0)
    assert tri_score.LAUNCHES["int8_matmul"] == 7
    spec = small_cells[name]
    assert rec["parity"] is True, rec
    assert rec["rows"] == csr.n_rows == spec["rows"]
    assert rec["corpus"] == f"synthetic_corpus({spec['rows']}, seed=0)"
    assert set(rec["profile"]) >= {"device_idle_share", "top_kernels_ms",
                                   "idle_gaps", "idle_ms_by_section"}
    assert not any(rec["launches"].values())  # the CPU runs plain versions
    if spec["kind"] == "insert":
        assert rec["batches"] == (spec["rows"] - spec["build"]) // 32
        assert rec["passes"] == 1 and rec["samples"] == rec["batches"]
        assert rec["insert_vectors_per_sec"] > 0
        assert rec["insert_p95_ms"] >= rec["insert_p50_ms"] > 0
        assert set(rec["stages_ms_per_batch"]) >= {"prepare", "admit",
                                                   "append", "rescore"}
        # the JAX engine streamed the same batches into the same index
        eng = apsim_tpu.Engine(apsim_tpu.AllPairsConfig())
        jcsr = jax_corpus(spec["rows"])
        head = ooc.csr_rows(jcsr, 0, spec["build"])
        eng.build(JaxCSR(head.n_rows, head.n_cols, head.indptr,
                         head.indices, head.data))
        want = set()
        for s in range(spec["build"], spec["rows"], spec["batch"]):
            out = eng.insert([(str(i), jcsr.row(i)) for i in range(
                s, min(s + spec["batch"], spec["rows"]))],
                tau=bench_torch.TAU)
            want |= {(min(int(q), int(c)), max(int(q), int(c)))
                     for q, cands in out.output.items() for c in cands}
        assert got == want and rec["pairs"] == len(want)
        return
    assert rec["repeats"] == 2
    assert rec["seconds_min"] <= rec["seconds_median"] <= rec["seconds_max"]
    assert rec["seconds_min"] <= rec["seconds_mean"] <= rec["seconds_max"]
    n = spec["rows"]
    assert rec["decided_pairs_per_sec"] == pytest.approx(
        2 * n * (n - 1) / 2 / rec["seconds_total"])
    assert rec["build_seconds"] > 0
    assert rec["kernel"] == spec["kernel"]
    want_stages = ({"slabs", "kernel", "compact", "d2h", "rescore"}
                   if spec["kind"] == "chunked"
                   else {"score_extract", "rescore", "operands"})
    assert set(rec["stages_ms"]) >= want_stages
    assert got == jax_pairs(spec["rows"]) and rec["pairs"] == len(got) > 0


@pytest.mark.parametrize("name", [bench_torch.HEADLINE,
                                  "dense_insert_bs32"])
def test_cell_times_its_window(name, small_cells):
    """A cell times joins or insert passes until they fill the window, and
    its rate is all their work over all their time."""
    window = 0.3
    rec, csr, _ = bench_torch.run_cell(name, CPU, repeats=1, window=window)
    assert rec["parity"] is True
    assert rec["seconds_total"] >= window
    if name == "dense_insert_bs32":
        assert rec["samples"] == rec["passes"] * rec["batches"]
        # the loop stopped at the first pass that filled the window
        assert len(rec["pass_seconds"]) == rec["passes"]
        assert sum(rec["pass_seconds"][:-1]) < window
        assert rec["insert_vectors_per_sec"] == pytest.approx(
            rec["passes"] * rec["rows_streamed"] / rec["seconds_total"])
        return
    # the loop stopped at the first join that filled the window
    assert rec["seconds_total"] - rec["seconds_max"] < window
    assert rec["seconds_total"] == pytest.approx(
        rec["repeats"] * rec["seconds_mean"])
    n = csr.n_rows
    assert rec["decided_pairs_per_sec"] == pytest.approx(
        rec["repeats"] * n * (n - 1) / 2 / rec["seconds_total"])


def test_join_oracle_is_the_sparse_oracle():
    """The cells' oracle (dense fp64 row blocks) gives the pair set of
    ``suite._oracle_pairs`` (the sparse fp64 product) where both fit."""
    csr = scale.synthetic_corpus(300, seed=4)
    want, _ = suite._oracle_pairs(csr, bench_torch.TAU)
    assert ooc.batch_oracle([], csr, 0, bench_torch.TAU, CPU) == want
    assert want


def drop_first_pair(monkeypatch):
    real = Engine.all_pairs

    def forged(self, tau=None):
        res = real(self, tau)
        return PairResult(res.i[1:], res.j[1:], res.sims[1:], res.ids)

    monkeypatch.setattr(Engine, "all_pairs", forged)


def drop_first_output(monkeypatch):
    real = Engine.insert

    def forged(self, vectors, tau=None, bulk=False, defer=False):
        out = real(self, vectors, tau, bulk, defer)
        for q in list(out.output):
            if out.output[q]:
                out.output[q] = {}
                break
        return out

    monkeypatch.setattr(Engine, "insert", forged)


@pytest.mark.parametrize("cell, forge", [
    ("dense_int8_join_8586", drop_first_pair),
    ("dense_insert_bs32", drop_first_output),
], ids=["join", "insert"])
def test_forged_mismatch_fails_the_run(cell, forge, small_cells, two_joins,
                                       monkeypatch, capsys):
    """A pair missing from the engine's result fails the cell's gate: the
    line says ``parity: false`` and the exit code is 1."""
    for name in list(small_cells):
        if name not in (cell, bench_torch.HEADLINE):
            del small_cells[name]
    forge(monkeypatch)
    assert bench_torch.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["parity"] is False
    assert line["cells"][cell]["parity"] is False


def test_no_cuda_raises(no_cuda, monkeypatch):
    """The default device is the card: without CUDA the script raises
    before it generates a corpus, and does not run on the CPU."""
    def no_corpus(*a, **k):
        raise AssertionError("a cell ran without CUDA")

    monkeypatch.setattr(bench_torch, "synthetic_corpus", no_corpus)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.main([])


def test_last_line(small_cells, two_joins, capsys):
    """``--device cpu`` runs every cell in order; the last stdout line is
    one JSON object with ``bench.py``'s headline fields, the device and
    every cell's metrics, and ``--seed`` reaches every corpus."""
    assert bench_torch.main(["--device", "cpu", "--seed", "3"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) >= LINE_KEYS
    assert line["metric"] == ("synthetic_corpus_300_allpairs_decided_pairs_"
                              "per_sec_tau0.8")
    assert line["unit"] == "pairs/s" and line["parity"] is True
    assert line["device"] == {"name": "cpu", "count": 0, "smi": None}
    assert list(line["cells"]) == list(SMALL)
    head = line["cells"][bench_torch.HEADLINE]
    assert line["value"] == head["decided_pairs_per_sec"]
    assert line["seconds"] == head["seconds_mean"]
    assert head["repeats"] == 2
    assert line["int8_ops"] == head["ops"] and line["mfu_pct"] is None
    assert line["baseline"]["prefix_agreement"] is True
    assert line["baseline"]["n_rows"] == 300
    assert line["vs_baseline"] > 0
    for name, rec in line["cells"].items():
        assert rec["parity"] is True, name
        assert rec["corpus"] == f"synthetic_corpus({rec['rows']}, seed=3)"
        assert ("insert_p95_ms" in rec) == (name == "dense_insert_bs32")
        assert "decided_pairs_per_sec" in rec or "insert_vectors_per_sec" in rec


def test_synthetic_corpus_seed():
    a, b = scale.synthetic_corpus(300, seed=1), scale.synthetic_corpus(
        300, seed=2)
    again = scale.synthetic_corpus(300, seed=1)
    for k in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(a, k), getattr(again, k)), k
        assert not np.array_equal(getattr(a, k), getattr(b, k)), k


def test_seed_reaches_run_ooc_and_run_scale(monkeypatch):
    seen = []
    real = scale.synthetic_corpus

    def recording(n, *a, seed=0, **k):
        seen.append((n, seed))
        return real(n, *a, seed=seed, **k)

    monkeypatch.setattr(ooc, "synthetic_corpus", recording)
    monkeypatch.setattr(scale, "synthetic_corpus", recording)
    rep = scale.run_scale((256,), device="cpu", seed=5)
    assert seen == [(256, 5)] and rep["256"]["pairs"] > 0
    rep = ooc.run_ooc(300, device="cpu", chunk_dim=1024, seed=5,
                      stream_rows=32, stream_batch=(32,), stream_only=True)
    assert seen[1:] == [(300, 5), (32, [99, 5])]
    assert rep["stream"]["32"]["parity"] is True


def same_corpus(a, b) -> bool:
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("indptr", "indices", "data"))


def test_stream_corpora_of_two_seeds_differ():
    """``run_ooc``'s k-th stream corpus is ``[99 + k, seed]``: seed 0's is
    the one of the integer seed 99 + k (its numbers stay comparable), and
    seed s at k = 1 does not stream seed s + 1's corpus of k = 0."""
    corpus = scale.synthetic_corpus
    assert same_corpus(corpus(64, seed=[99 + 1, 0]), corpus(64, seed=100))
    assert same_corpus(corpus(64, seed=[201, 0]), corpus(64, seed=201))
    assert not same_corpus(corpus(64, seed=[99 + 1, 5]),
                           corpus(64, seed=[99, 6]))


def test_spread(tmp_path, capsys):
    """``--spread`` reads saved runs' last lines and prints each metric's
    relative spread and the bound it sets (twice the spread, at least
    5 %)."""
    paths = []
    for k, (rate, p95) in enumerate(((100.0, 4.0), (110.0, 4.1),
                                     (105.0, 4.05))):
        line = {"device": {"name": "cpu"}, "cells": {
            "j": {"decided_pairs_per_sec": rate, "pairs": 7},
            "i": {"insert_vectors_per_sec": 1000.0, "insert_p95_ms": p95}}}
        path = tmp_path / f"run{k}.json"
        path.write_text("progress\n" + json.dumps(line) + "\n")
        paths.append(str(path))
    assert bench_torch.main(["--spread", *paths]) == 0
    out = json.loads(capsys.readouterr().out)
    j = out["cells"]["j"]["decided_pairs_per_sec"]
    assert j["values"] == [100.0, 110.0, 105.0]
    assert j["spread"] == pytest.approx(10 / 105)
    assert j["bound"] == pytest.approx(20 / 105) and j["higher_is_better"]
    i = out["cells"]["i"]
    assert i["insert_vectors_per_sec"]["bound"] == 0.05
    assert i["insert_p95_ms"]["spread"] == pytest.approx(0.1 / 4.05)
    assert not i["insert_p95_ms"]["higher_is_better"]
    assert set(out["cells"]) == {"j", "i"}
