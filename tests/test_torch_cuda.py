"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where no CUDA device is present.  This file
imports neither JAX nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int8 (gb, g64, cnt) bit-identical, the dense and the
cross-panel kernel alike; bf16 hit cells may differ only where the plain
fp32 score lies within 1e-5 of tau_eff; the int8 matmul (kernel 4) equal
to its plain version in every int32; the mesh joins over four shards of
the card give the pair sets of the same joins over four CPU shards.
"""

import pytest
import torch

from apsim_tpu_torch import (AllPairsConfig, ChunkedAllPairs, Engine,
                             MeshChunkedAllPairs, MeshEngine, make_mesh)
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import panel as panel_ops
from apsim_tpu_torch.ops import panel_mesh
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


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(64, 128, 128), (1024, 1024, 128),
                                   (256, 512, 384), (512, 256, 4096)])
def test_int8_matmul_matches_plain(card, shape):
    """Kernel 4 against its plain version, every int32 equal."""
    m, n, d = shape
    gen = torch.Generator(device=card).manual_seed(m + n + d)
    xi, xj = (torch.randint(-127, 128, (r, d), dtype=torch.int8,
                            device=card, generator=gen) for r in (m, n))
    before = ts.LAUNCHES["int8_matmul"]
    k = panel_mesh.int8_matmul(xi, xj)
    assert ts.LAUNCHES["int8_matmul"] == before + 1
    assert k.dtype == torch.int32 and k.device == card
    assert torch.equal(k, panel_mesh.int8_matmul_plain(xi, xj))


@pytest.fixture(scope="module")
def mesh_csr(card):
    return synthetic_corpus(3000, seed=1)


def test_mesh_chunked_on_cuda_equals_cpu(card, mesh_csr):
    """MeshChunkedAllPairs over four shards of the card and of the CPU:
    kernel 4 once per shard per panel pair on the card, none on the CPU,
    the same pair set."""
    got = {}
    for dev in (card, torch.device("cpu")):
        eng = MeshChunkedAllPairs(
            AllPairsConfig(), mesh=make_mesh(4, devices=[dev] * 4),
            panel_rows=1024)
        eng.build(mesh_csr)
        n_panels = eng._panel_geom()[3]
        before = ts.LAUNCHES["int8_matmul"]
        got[dev.type] = eng.all_pairs(0.8).pair_set()
        launched = ts.LAUNCHES["int8_matmul"] - before
        pairs = n_panels * (n_panels + 1) // 2
        assert launched == (4 * pairs if dev.type == "cuda" else 0)
    assert got["cuda"] == got["cpu"] and got["cpu"]


def test_mesh_rows_on_cuda_equals_cpu(card, mesh_csr):
    """MeshEngine(shard_axis="rows") over four shards of the card and of
    the CPU: kernel 3 once per shard on the card, the same pair set."""
    got = {}
    for dev in (card, torch.device("cpu")):
        eng = MeshEngine(AllPairsConfig(shard_axis="rows", use_pallas="on"),
                         mesh=make_mesh(4, devices=[dev] * 4))
        eng.build(mesh_csr)
        before = ts.LAUNCHES["panel_score_bits_int8"]
        got[dev.type] = eng.all_pairs(0.8).pair_set()
        launched = ts.LAUNCHES["panel_score_bits_int8"] - before
        assert launched == (4 if dev.type == "cuda" else 0)
    assert got["cuda"] == got["cpu"] and got["cpu"]
