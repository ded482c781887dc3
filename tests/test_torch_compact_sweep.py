"""The out-of-core sweep's one-pair lookahead, on the CPU.

``ChunkedAllPairs._sweep`` takes pair k's lists only after it has launched
pair k+1; here, on CPU tensors, the plain chain compacts each pair.  The
lookahead must give the same lists, pair for pair and in order, as taking
each pair's lists right after its launch, in the all-resident sweep and in
the blocked-I rolling sweep, with a ragged last panel and pairs without a
hit.  A kernel count planted wrong raises once the join's lists are on the
host, after every pair was compacted.
"""

import pytest
import torch

import apsim_tpu_torch as pt
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import panel as panel_ops
from apsim_tpu_torch.ops import tri_score as ts

ROWS, RB, TAU = 700, 128, 0.9


@pytest.fixture(scope="module")
def csr():
    return synthetic_corpus(ROWS, n_dims=4096, active_dims=512, nnz_mean=20,
                            dup_rate=0.05, seed=7)


def engine(csr, rolling: bool):
    cfg = pt.AllPairsConfig(vector_dim=4096, row_bucket=64, dim_bucket=64,
                            query_tile=64)
    eng = pt.ChunkedAllPairs(cfg, "cpu", chunk_dim=128, panel_rows=RB)
    eng.build(csr)
    rb, _, _, n_panels, d_cap = eng._panel_geom()
    if rolling:
        eng._panel_resident_bytes = 0
        # S = 4 slabs in flight -> B = 2 row panels per column scan
        eng._panel_sweep_bytes = 4 * rb * d_cap
    assert eng._keeps_all(n_panels, rb, d_cap) is not rolling
    return eng


def pair_by_pair(eng, monkeypatch):
    """Make ``eng``'s pairs finish at their launch (no lookahead)."""
    launch = eng._op_panel_pair
    monkeypatch.setattr(eng, "_op_panel_pair", lambda *a, **k: ts.Ready(
        launch(*a, **k).result()))


@pytest.mark.parametrize("rolling", [False, True])
def test_lookahead_equals_pair_by_pair(csr, rolling, monkeypatch):
    eng = engine(csr, rolling)
    rb, _, _, n_panels, _ = eng._panel_geom()
    assert n_panels * rb > ROWS > (n_panels - 1) * rb  # a ragged last panel
    state = eng._panel_state()
    tau_eff = eng._tau_eff(TAU)
    order = []
    score = panel_ops.panel_score_bits_int8
    result = ts.PendingPair.result
    monkeypatch.setattr(panel_ops, "panel_score_bits_int8", lambda *a, **k: (
        order.append("launch"), score(*a, **k))[1])
    monkeypatch.setattr(ts.PendingPair, "result", lambda self: (
        order.append("result"), result(self))[1])
    tally = ts.CountTally("cpu")
    ahead = eng._sweep(state, tau_eff, tally)
    tally.check()
    n_pairs = n_panels * (n_panels + 1) // 2
    # pair k's lists are taken right after pair k+1's launch
    assert order == (["launch"] + ["launch", "result"] * (n_pairs - 1)
                     + ["result"])
    assert tally.want[0] == sum(r.numel() for r, _ in ahead)
    pair_by_pair(eng, monkeypatch)
    each = eng._sweep(state, tau_eff)
    assert len(ahead) == len(each) == n_pairs
    for (ra, ca), (re, ce) in zip(ahead, each):
        assert torch.equal(ra, re) and torch.equal(ca, ce)
    hits = [r.numel() for r, _ in ahead]
    assert min(hits) == 0 and max(hits) > 0


def test_planted_count_raises_at_the_end(csr, monkeypatch):
    eng = engine(csr, rolling=False)
    _, _, _, n_panels, _ = eng._panel_geom()
    want = eng.all_pairs(TAU).pair_set()
    score = panel_ops.panel_score_bits_int8
    launched = []

    def planted(*a, **k):
        gb, g64, cnt = score(*a, **k)
        if not launched:
            cnt[0, 0] += 1
        launched.append(1)
        return gb, g64, cnt

    monkeypatch.setattr(panel_ops, "panel_score_bits_int8", planted)
    compacted = []
    result = ts.PendingPair.result
    monkeypatch.setattr(ts.PendingPair, "result", lambda self: (
        compacted.append(1), result(self))[1])
    with pytest.raises(RuntimeError, match="kernel counted"):
        eng.all_pairs(TAU)
    n_pairs = n_panels * (n_panels + 1) // 2
    assert len(launched) == len(compacted) == n_pairs
    monkeypatch.setattr(panel_ops, "panel_score_bits_int8", score)
    assert eng.all_pairs(TAU).pair_set() == want and want
