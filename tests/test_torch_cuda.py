"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where no CUDA device is present.  This file
imports neither JAX nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int8 (gb, g64, cnt) bit-identical, the dense and the
cross-panel kernel alike; bf16 hit cells may differ only where the plain
fp32 score lies within 1e-5 of tau_eff.
"""

import pytest
import torch

from apsim_tpu_torch import AllPairsConfig, ChunkedAllPairs, Engine
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import panel as panel_ops
from apsim_tpu_torch.ops import tri_score as ts

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = AllPairsConfig(row_bucket=4096)
    csr = synthetic_corpus(3000, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = Engine(cfg, dev)
        out[dev].build(csr)
    return out


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("tiles", [(1024, 512), (256, 256)])
def test_kernel_matches_plain(engines, kind, tiles):
    eng = engines["cuda"]
    tm, tn = tiles
    bi, bj = (torch.from_numpy(a).cuda()
              for a in ts.upper_blocks_rect(eng.row_cap, tm, tn))
    tau_eff = eng._tau_eff(0.8)
    if kind == "int8":
        ops = ts.quantize_rows(eng.x)
        k = ts.score_bits_int8(*ops, bi, bj, tau_eff, tm, tn)
        p = ts.score_bits_int8_plain(*ops, bi, bj, tau_eff, tm, tn)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        return
    xb = eng.x.to(torch.bfloat16)
    k = ts.score_bits_bf16(xb, bi, bj, tau_eff, tm, tn)
    p = ts.score_bits_bf16_plain(xb, bi, bj, tau_eff, tm, tn)
    for s, e, v in ts.bf16_scores(xb, bi, bj, tm, tn):
        d = ts.unpack_bits(k[0][s:e]) != ts.unpack_bits(p[0][s:e])
        assert bool(((v[d] - float(tau_eff)).abs() <= 1e-5).all())


@pytest.mark.parametrize("int8", [True, False])
def test_all_pairs_on_cuda_equals_cpu(engines, int8):
    name = "score_bits_int8" if int8 else "score_bits_bf16"
    got = {}
    for dev, eng in engines.items():
        eng._int8_off = not int8
        before = ts.LAUNCHES[name]
        got[dev] = eng.all_pairs(0.8).pair_set()
        launched = ts.LAUNCHES[name] - before
        assert launched == (1 if dev == "cuda" else 0)
    assert got["cuda"] == got["cpu"] and got["cpu"]


@pytest.fixture(scope="module")
def chunked():
    """Chunked engines on the card and on the CPU: 3,000 rows in three
    panels of 1,024 (the last one mostly padding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    csr = synthetic_corpus(3000, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = ChunkedAllPairs(AllPairsConfig(), dev, panel_rows=1024)
        out[dev].build(csr)
    assert out["cuda"]._panel_geom()[3] == 3
    return out


@pytest.mark.parametrize("valid", ["all", "some_zero"])
@pytest.mark.parametrize("pair", [(0, 0), (0, 1), (1, 2)])
@pytest.mark.parametrize("tiles", [(64, 128), (1024, 512)])
def test_panel_kernel_matches_plain(chunked, tiles, pair, valid):
    """Kernel 3 against its plain version on two panels of the padded
    index: panel offsets, diagonal and off-diagonal pairs, blocks blanked
    by valid = 0."""
    eng = chunked["cuda"]
    st = eng._panel_state()
    rb = st["geom"][0]
    tm, tn = tiles
    pi, pj = pair
    grid = (panel_ops.diag_grid(rb, tm, tn) if pi == pj
            else panel_ops.full_grid(rb, rb, tm, tn))
    bi, bj = (torch.from_numpy(a).cuda() for a in grid)
    v = None
    if valid == "some_zero":
        v = torch.ones_like(bi)
        v[1::3] = 0
    args = (eng._build_slab(st, pi), eng._build_slab(st, pj),
            st["aux_of"][pi], st["aux_of"][pj], bi, bj, (pi * rb, pj * rb),
            eng._tau_eff(0.5), tm, tn)
    before = ts.LAUNCHES["panel_score_bits_int8"]
    k = panel_ops.panel_score_bits_int8(*args, valid=v)
    assert ts.LAUNCHES["panel_score_bits_int8"] == before + 1
    p = panel_ops.panel_score_bits_int8_plain(*args, valid=v)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    if v is not None:
        assert not k[0][1::3].any() and not k[2][1::3].any()


def test_chunked_all_pairs_on_cuda_equals_cpu(chunked):
    got = {}
    for dev, eng in chunked.items():
        before = ts.LAUNCHES["panel_score_bits_int8"]
        got[dev] = eng.all_pairs(0.8).pair_set()
        launched = ts.LAUNCHES["panel_score_bits_int8"] - before
        assert launched == (6 if dev == "cuda" else 0)  # 3 + 2 + 1 pairs
    assert got["cuda"] == got["cpu"] and got["cpu"]
