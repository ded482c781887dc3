"""The dimension-sharded join cell ``rcv1_join_500k_mesh4`` on the CPU: at
a tiny size over four CPU shards it comes out correct with the pair set of
the one-device engine, and with its threshold shifted either way it does
not; ``profile_cards`` reduces a trace card by card; the cell's five
per-layer readers read hand-made records, and nothing without a
profile."""

import importlib.util
import os

import pytest

from apsim_tpu_torch.config import AllPairsConfig
from apsim_tpu_torch.engine.chunked import ChunkedAllPairs
from apsim_tpu_torch.parallel.chunked_mesh import MeshChunkedAllPairs
from apsim_tpu_torch.vector.batch import CSRMatrix
from benchmark import corpus as corpus_mod
from benchmark import harness
from benchmark.profile_cards import reduce_cards
from benchmark.tests.test_bench_faults import shifted

_spec = importlib.util.spec_from_file_location(
    "benchmark_run_mesh4_under_test", os.path.join(harness.BENCH, "run.py"))
RUN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(RUN)

CELL = "rcv1_join_500k_mesh4"
TINY = {"config": {"rows": 3000, "chunk_dim": 512,
                   "corpus": {"terms": 2000, "dup_rate": 0.15}},
        "params": {"check_rows": 600}}
SEED = 2**35 + 29


@pytest.mark.parametrize("delta", [0.0, 0.05, -0.05],
                         ids=["sound", "tau_up", "tau_down"])
def test_cell_on_four_cpu_shards(delta, monkeypatch):
    if delta:
        shifted(delta)(monkeypatch)
    joined = []
    real = MeshChunkedAllPairs.all_pairs

    def kept(self, tau=None):
        assert self.n_shards == 4
        res = real(self, tau)
        joined.append(res.pair_set())
        return res

    monkeypatch.setattr(MeshChunkedAllPairs, "all_pairs", kept)
    r = RUN.run_cell(CELL, SEED, 1.0, False, device="cpu", overrides=TINY)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["count"] == 4
    if delta:
        assert not r["correct"], r["checks"]
        return
    assert r["correct"], r["checks"]
    assert r["metrics"]["join_pairs_per_s"]["value"] > 0
    cfg = harness.load_cell(harness.load_spec(), CELL)[2]
    cfg = RUN._merge(cfg, TINY["config"])
    c = corpus_mod.make_corpus(cfg["corpus"], cfg["rows"], SEED, "cpu")
    one = ChunkedAllPairs(
        AllPairsConfig(vector_dim=c.vector_dim,
                       similarity_threshold=cfg["tau"]),
        "cpu", chunk_dim=cfg["chunk_dim"])
    one.build(CSRMatrix(cfg["rows"], c.vector_dim, *c.host()))
    want = one.all_pairs(cfg["tau"]).pair_set()
    assert want and all(got == want for got in joined)


CARD_GAPS = [["card0:reduce", 4e-6], ["card1:all_pairs", 4e-6],
             ["card1:reduce", 2e-6], ["card1:all_pairs", 1e-6]]


@pytest.mark.parametrize("cards,busy,gaps", [
    (None, {"0": 6e-6, "1": 3e-6}, CARD_GAPS),
    ([0, 1, 2], {"0": 6e-6, "1": 3e-6, "2": 0.0},
     [["card2:all_pairs", 1e-5]] + CARD_GAPS),
], ids=["cards_with_events", "a_card_without"])
def test_profile_cards_by_card(cards, busy, gaps):
    """Two cards' events in a window of 10 us: each card's union, the
    mean over the cards listed, kernels summed over the cards, and the
    gaps named by card and innermost section, longest first."""
    events = [(0, "k4", 0, 4), (0, "k4", 2, 6), (1, "k4", 1, 3),
              (1, "k5", 7, 8), (0, "k5", 20, 30)]  # the last outside
    sections = [(0, 10, "all_pairs"), (6, 9, "reduce")]
    out = reduce_cards(events, 0, 10, sections, cards)
    assert out["window_s"] == pytest.approx(1e-5)
    assert out["busy_by_card_s"] == pytest.approx(busy)
    assert out["busy_s"] == pytest.approx(sum(busy.values()) / len(busy))
    assert out["kernels_s"] == pytest.approx({"k4": 1e-5, "k5": 1.1e-5})
    assert out["kernels_by_card_s"]["1"] == pytest.approx({"k4": 2e-6,
                                                           "k5": 1e-6})
    assert [g[0] for g in out["idle_gaps"]] == [g[0] for g in gaps]
    assert [g[1] for g in out["idle_gaps"]] == pytest.approx(
        [g[1] for g in gaps])


K3 = "void ring_kernel<Int8, ScoreJob<Int8, Int8Op>>(CUtensorMap)"
K4 = "void ring_kernel<Int8, MatmulJob<Int8>>(CUtensorMap)"
K5 = "void pair_bits_kernel<BoundAdmit>(PairParts<int>)"
K6 = "void pair_bits_kernel<ThresholdAdmit>(PairParts<float>)"
H100 = {"int8": 1979e12, "hbm": 3.35e12}


def records(profile=True):
    rec = {"n_rows": 500_000, "terms_used": 40_000, "n_shards": 4,
           "n_cards": 4, "panel_rows": 16384, "panel_pairs": 496,
           "peaks": H100}
    if profile:
        rec["profile"] = {
            "window_s": 5.0, "busy_s": 4.0,
            "kernels_s": {K3: 100.0, K4: 8.0, K5: 4.0, K6: 100.0},
            "sections_s": {"all_pairs": 5.0, "kernel": 2.0, "reduce": 1.0,
                           "epilogue": 0.5, "compact": 0.75,
                           "compact_sync": 0.25}}
    return rec


def _kernel4():
    n = 500_000
    return 100.0 * n * (n - 1) / 2 * 40_000 * 2 / 1979e12 / 8.0


def _kernel5():
    rb = 16384
    per_pair = (4 * 4 * rb * rb + 12 * rb + 12 * rb * 4 + rb * rb // 8
                + rb * rb // 64 + 24 * 4)
    return 100.0 * 496 * per_pair / 3.35e12 / 4.0


READINGS = {
    "kernel4_roofline.join4": _kernel4(),
    "kernel5_bw_pct.join4": _kernel5(),
    "mesh_reduce_pct.join4": 20.0,
    "mesh_compact_pct.join4": 15.0,
    "device_idle_pct.join4": 20.0,
}


def _read(metric, rec):
    return harness.load_module("metrics", metric).read(rec)


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_on_synthetic_records(metric):
    got = _read(metric, records())
    assert got == pytest.approx(READINGS[metric])
    assert 0 < got <= 100


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_reads_nothing_without_a_profile(metric):
    assert _read(metric, records(profile=False)) is None
    assert _read(metric, dict(records(profile=False), profile=None)) is None


@pytest.mark.parametrize("metric,kernel", [
    ("kernel4_roofline.join4", K4), ("kernel5_bw_pct.join4", K5)])
def test_kernel_readers_take_their_own_kernel(metric, kernel):
    """Kernel 3's score job and kernel 6's threshold are not read: with
    only those in the trace there is nothing to read."""
    rec = records()
    rec["profile"]["kernels_s"] = {K3: 1.0, K6: 1.0}
    assert _read(metric, rec) is None
    rec["profile"]["kernels_s"] = {K3: 1.0, K6: 1.0, kernel: 8.0}
    assert _read(metric, rec) is not None
