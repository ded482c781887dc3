"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where no CUDA device is present.  This file
imports neither JAX nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int8 (gb, g64, cnt) bit-identical; bf16 hit cells may differ
only where the plain fp32 score lies within 1e-5 of tau_eff.
"""

import pytest
import torch

from apsim_tpu_torch import AllPairsConfig, Engine
from apsim_tpu_torch.bench.scale import synthetic_corpus
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
