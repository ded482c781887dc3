"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where no CUDA device is present.  This file
imports neither JAX nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int8 (gb, g64, cnt) bit-identical, the dense and the
cross-panel kernel alike; bf16 hit cells may differ only where the plain
fp32 score lies within 1e-5 of tau_eff (within (K + 2) * 2^-24, the
engine's bound on fp32 accumulation over K nonzeros, on the dense stress
of 32,768 positive elements per row); the int8 matmul (kernel 4) equal
to its plain version in every int32; the summed-partial epilogues
(kernels 5 and 6) bit-identical to their plain versions (gb, g64,
counts), also on strided operands; the compaction (kernel 7) gives the
plain chain's lists, value and order; and the stripe joins' candidate lists
on the card equal, in order, those of the plain versions on the same
accumulators; the mesh joins over four shards of
the card give the pair sets of the same joins over four CPU shards.  The
full-rectangle join on the card gives the CPU engine's pair set (both are
exact by the fp64 rescore), leaves ``allow_tf32`` as it found it, and its
score tiles are fp32; the int8 stripes' accumulator equals the plain
product in every int32.  The streaming path on the card gives the CPU
engine's outputs (fp64 similarities equal), index and top-k lists; the
bf16 copy that inserts keep in step equals a fresh cast bit for bit; the
match's scores are fp32; ``topk`` multiplies with TF32 off and leaves
``allow_tf32`` as it found it.  The meshes' streaming over four shards of
the card gives the CPU meshes' outputs, blocks and entry buffers, and the
bf16 copies of the blocks that inserts keep equal fresh casts bit for bit.
"""

import numpy as np
import pytest
import torch

from apsim_tpu_torch import (AllPairsConfig, ChunkedAllPairs, CSRMatrix,
                             Engine, MeshChunkedAllPairs, MeshEngine,
                             SparseVector, make_mesh)
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import chunked as chunked_ops
from apsim_tpu_torch.ops import panel as panel_ops
from apsim_tpu_torch.ops import panel_mesh
from apsim_tpu_torch.ops import score as score_ops
from apsim_tpu_torch.ops import tri_score as ts
from apsim_tpu_torch.parallel.collectives import gather_rows

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
    _bf16_matches_plain(eng.x.to(torch.bfloat16), bi, bj, tau_eff, tm, tn)


def _bf16_matches_plain(xb, bi, bj, tau_eff, tm, tn, band=1e-5):
    """Kernel 2 against its plain version: one launch counted; g64 and cnt
    are what its own gb implies; a cell whose bit differs has a plain fp32
    score within ``band`` of tau_eff.  Returns the kernel's pair count."""
    before = ts.LAUNCHES["score_bits_bf16"]
    k = ts.score_bits_bf16(xb, bi, bj, tau_eff, tm, tn)
    assert ts.LAUNCHES["score_bits_bf16"] == before + 1
    p = ts.score_bits_bf16_plain(xb, bi, bj, tau_eff, tm, tn)
    for s, e, v in ts.bf16_scores(xb, bi, bj, tm, tn):
        _, r64, rcnt = ts.bitpack_mask(ts.unpack_bits(k[0][s:e]))
        assert torch.equal(r64, k[1][s:e]) and torch.equal(rcnt, k[2][s:e])
        d = ts.unpack_bits(k[0][s:e]) != ts.unpack_bits(p[0][s:e])
        assert bool(((v[d] - float(tau_eff)).abs() <= band).all())
    return int(k[2][:, 0].sum())


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


def test_chunked_join_compacts_on_the_card(chunked):
    """The panel join on the card launches kernel 7 once a panel pair, and
    its candidate lists equal, in order, those the plain chain gives on the
    CPU engine."""
    lists = {}
    for dev, eng in chunked.items():
        n_panels = eng._panel_geom()[3]
        before = ts.LAUNCHES["compact_bits"]
        lists[dev] = eng._all_pairs_panel(eng._tau_eff(0.8))
        launched = ts.LAUNCHES["compact_bits"] - before
        assert launched == (n_panels * (n_panels + 1) // 2
                            if dev == "cuda" else 0)
    for a, b in zip(lists["cuda"], lists["cpu"]):
        assert np.array_equal(a, b) and a.size


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


def compact_case(card, case: str):
    """A hit structure on the card, its block ids and the scan: ``(gb, g64,
    cnt, bi, bj, tm, tn, pre_level)``."""
    nb, tm, tn, density, pre = {
        "pre_level": (3, 1024, 512, 1e-3, None),  # tm % 512 == 0
        "super": (5, 64, 128, 2e-2, None),
        "supers_of_tall_blocks": (2, 1024, 256, 5e-3, False),
        "zero_hits": (4, 1024, 512, 0.0, None),
        "all_hit_block": (2, 512, 128, 1.0, None),
    }[case]
    gen = torch.Generator(device=card).manual_seed(len(case))
    mask = torch.rand((nb, tm, tn), device=card, generator=gen) < density
    if case == "all_hit_block":
        mask[1] = torch.rand((tm, tn), device=card, generator=gen) < 0.01
    gb, g64, cnt = ts.bitpack_mask(mask)
    bi = torch.randint(0, 40, (nb,), dtype=torch.int32, device=card,
                       generator=gen)
    bj = torch.randint(0, 40, (nb,), dtype=torch.int32, device=card,
                       generator=gen)
    return gb, g64, cnt, bi, bj, tm, tn, pre


@pytest.mark.parametrize("case", ["pre_level", "super",
                                  "supers_of_tall_blocks", "zero_hits",
                                  "all_hit_block"])
def test_compact_kernel_matches_plain(card, case):
    """Kernel 7 against the plain chain on the same hit structure: the
    same (row, col) lists, value and order; one launch; a count planted
    wrong raises, and so does a count at the int32 limit, before any
    launch."""
    gb, g64, cnt, bi, bj, tm, tn, pre = compact_case(card, case)
    scan = tm % ts.SUPER2 == 0 if pre is None else pre
    before = ts.LAUNCHES["compact_bits"]
    r, c = ts.compact_bits(gb, g64, cnt, bi, bj, tm, tn, pre_level=pre)
    assert ts.LAUNCHES["compact_bits"] == before + 1
    pr, pc, found = ts.compact_bits_plain(gb, g64, bi, bj, tm, tn, scan)
    assert r.device == card and torch.equal(r, pr) and torch.equal(c, pc)
    assert found[2] == r.numel() == int(cnt[:, 0].sum())
    assert (r.numel() == 0) is (case == "zero_hits")
    bad = cnt.clone()
    bad[0, 0] += 1
    with pytest.raises(RuntimeError, match="kernel counted"):
        ts.compact_bits(gb, g64, bad, bi, bj, tm, tn, pre_level=pre)
    bad[0, 0] = 2**31 - 1
    before = ts.LAUNCHES["compact_bits"]
    with pytest.raises(ValueError, match="2\\^31"):
        ts.compact_bits(gb, g64, bad, bi, bj, tm, tn, pre_level=pre)
    assert ts.LAUNCHES["compact_bits"] == before


def test_compact_kernel_on_row_slices(card):
    """The pre-level override: a 2,048-row block's two 1,024-row slices,
    each compacted with the block's own scan (``pre_level``) and their
    rows offset, give the block's lists in order (``pair_candidates``'
    rule); kernel 7 equals the plain chain on each slice."""
    gen = torch.Generator(device=card).manual_seed(5)
    mask = torch.rand((1, 2048, 256), device=card, generator=gen) < 2e-3
    zero = torch.zeros(1, dtype=torch.int32, device=card)
    whole = ts.compact_bits(*ts.bitpack_mask(mask), zero, zero, 2048, 256)
    rows, cols = [], []
    for a in (0, 1024):
        gb, g64, cnt = ts.bitpack_mask(mask[:, a:a + 1024].contiguous())
        r, c = ts.compact_bits(gb, g64, cnt, zero, zero, 1024, 256,
                               pre_level=True)
        pr, pc, _ = ts.compact_bits_plain(gb, g64, zero, zero, 1024, 256,
                                          True)
        assert torch.equal(r, pr) and torch.equal(c, pc)
        rows.append(r + a)
        cols.append(c)
    assert torch.equal(torch.cat(rows), whole[0]) and whole[0].numel()
    assert torch.equal(torch.cat(cols), whole[1])


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
        before = dict(ts.LAUNCHES)
        got[dev.type] = eng.all_pairs(0.8).pair_set()
        launched = {k: ts.LAUNCHES[k] - before[k]
                    for k in ("int8_matmul", "pair_bits_int8")}
        pairs = n_panels * (n_panels + 1) // 2
        on_card = dev.type == "cuda"
        assert launched == {"int8_matmul": 4 * pairs if on_card else 0,
                            "pair_bits_int8": pairs if on_card else 0}
    assert got["cuda"] == got["cpu"] and got["cpu"]


@pytest.mark.parametrize("pair", ["diagonal", "off_diagonal"])
@pytest.mark.parametrize("n_parts", [1, 8])
def test_pair_bits_int8_matches_plain(card, n_parts, pair):
    """Kernel 5 against its plain version on the S int32 partial dots of
    two 1,024-row panels (kernel 4 on S column slices), ``tau_eff`` at a
    cell's bound value: gb, g64 and the counts bit for bit; one launch.
    Then the pair's candidate lists from two row slices on the card equal
    the whole rectangle's, in order."""
    rb, width = 1024, 128
    gen = torch.Generator(device=card).manual_seed(n_parts)
    x = torch.rand((2 * rb, width * n_parts), device=card, generator=gen)
    x *= torch.rand(x.shape, device=card, generator=gen) < 0.05
    x[rb::7] = x[:rb:7]  # duplicates across the two panels
    q, aux = ts.quantize_rows(x)
    row0, col0 = (0, rb) if pair == "off_diagonal" else (0, 0)
    qi, qj = q[row0:row0 + rb], q[col0:col0 + rb]
    ai = aux[:, row0:row0 + rb].contiguous()
    aj = aux[:, col0:col0 + rb].contiguous()
    parts = [panel_mesh.int8_matmul(
        qi[:, s * width:(s + 1) * width].contiguous(),
        qj[:, s * width:(s + 1) * width].contiguous())
        for s in range(n_parts)]
    d = torch.stack(parts).sum(0, dtype=torch.int32)
    v = ts.int8_bound_value(d, ai[0][:, None], ai[1][:, None],
                            ai[2][:, None], aj[0][None], aj[1][None],
                            aj[2][None])
    tau = float(torch.quantile(v.flatten()[::97].float(), 0.98))
    before = ts.LAUNCHES["pair_bits_int8"]
    k = panel_mesh.pair_bits_int8(parts, ai, aj, row0, col0, tau)
    assert ts.LAUNCHES["pair_bits_int8"] == before + 1
    torch.cuda.synchronize()
    p = panel_mesh.pair_bits_int8_plain(parts, ai, aj, row0, col0, tau)
    for a, b in zip(k, p):
        assert a.device == card and torch.equal(a, b)
    assert int(k[2][0, 0]) > 0
    whole = panel_mesh.pair_candidates([parts], [(0, rb)], [card], ai, aj,
                                       row0, col0, rb, tau, card)
    bounds = panel_mesh.row_slices(rb, 2)
    sliced = panel_mesh.pair_candidates(
        gather_rows(parts, bounds, [card] * 2), bounds, [card] * 2, ai, aj,
        row0, col0, rb, tau, card)
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b) and a.numel() > 0


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("n_parts", [1, 8])
def test_pair_bits_f32_matches_plain(card, n_parts, strided):
    """Kernel 6 against its plain version on S fp32 partials of a slice
    of a stripe's rows (global offsets, cells on and below the diagonal),
    ``tau_eff`` the value of a strict-upper cell's left-to-right sum, also
    with every partial a column slice of a wider tensor (a row stride, read
    in place): gb, g64 and the counts bit for bit; one launch."""
    rows, cols, row0, col0 = 2048, 1024, 512, 1024
    gen = torch.Generator(device=card).manual_seed(60 + n_parts)
    parts = [torch.randn((rows, cols + 128 * strided), device=card,
                         generator=gen)[:, :cols] for _ in range(n_parts)]
    if not strided:
        parts = [p.contiguous() for p in parts]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    up = ((row0 + torch.arange(rows, device=card))[:, None]
          < (col0 + torch.arange(cols, device=card))[None])
    vals = total[up].sort().values
    tau = float(vals[int(0.95 * vals.numel())])
    before = ts.LAUNCHES["pair_bits_f32"]
    k = panel_mesh.pair_bits_f32(parts, row0, col0, tau)
    assert ts.LAUNCHES["pair_bits_f32"] == before + 1
    torch.cuda.synchronize()
    p = panel_mesh.pair_bits_f32_plain(parts, row0, col0, tau)
    for a, b in zip(k, p):
        assert a.device == card and torch.equal(a, b)
    assert int(k[2][0, 0]) == int(((total >= tau) & up).sum()) > 0


def test_pair_bits_int8_reads_strided_operands(card):
    """Kernel 5 on a partial that is a column slice of a wider product
    and aux tables that are column slices of the whole index's (the int8
    stripes' operands), bit for bit its plain version on contiguous
    copies."""
    rows, width = 1024, 256
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.rand((rows, width), device=card, generator=gen)
    x *= torch.rand(x.shape, device=card, generator=gen) < 0.1
    x[1::5] = x[:-1:5]
    q, aux = ts.quantize_rows(x)
    q0, tile = 512, 64
    d = panel_mesh.int8_matmul(q, q[q0:q0 + 128].contiguous())[:, :tile]
    assert not d.is_contiguous()
    aj = aux[:, q0:q0 + tile]
    args = ([d], aux, aj, 0, q0)
    v = ts.int8_bound_value(d, aux[0][:, None], aux[1][:, None],
                            aux[2][:, None], aj[0][None], aj[1][None],
                            aj[2][None])
    tau = float(torch.quantile(v.flatten().float(), 0.99))
    k = panel_mesh.pair_bits_int8(*args, tau)
    torch.cuda.synchronize()
    p = panel_mesh.pair_bits_int8_plain([d.contiguous()], aux,
                                        aj.contiguous(), 0, q0, tau)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert int(k[2][0, 0]) > 0


@pytest.mark.parametrize("case", ["bf16", "highest", "int8"])
def test_stripe_epilogue_on_cuda_equals_cpu(card, mesh_csr, case):
    """The single-card stripe epilogue at every stripe of a 3,000-row
    engine (1,024-wide stripes): one launch of kernel 6 (kernel 5 on the
    int8 stripes) a stripe, and each stripe's candidate lists equal, in
    order, those of the plain versions on the same accumulator on the
    CPU."""
    cfg = AllPairsConfig(**({"use_pallas": "off"} if case == "int8" else {
        "pallas_int8": False, "matmul_precision": case.replace(
            "bf16", "default")}))
    eng = ChunkedAllPairs(cfg, card, super_tile=1024)
    eng._int8_stripes = case == "int8"
    eng.build(mesh_csr)
    tau_eff = eng._tau_eff(0.8)
    name = "pair_bits_int8" if case == "int8" else "pair_bits_f32"
    for q0 in range(0, eng.n_rows, 1024):
        if case == "int8":
            q2d, aux = eng._int8_slabs()
            acc = chunked_ops.stripe_dots_int8(
                eng._ent[0], eng._ent[1], q2d, eng._counts, q0, eng.row_cap,
                eng._chunk_width, 1024)
            before = ts.LAUNCHES[name]
            got = chunked_ops.int8_join_epilogue(acc, aux, q0, tau_eff)
            assert ts.LAUNCHES[name] == before + 1
            want = chunked_ops.int8_join_epilogue(acc.cpu(), aux.cpu(), q0,
                                                  tau_eff)
        else:
            acc = chunked_ops.stripe_scores(
                *eng._ent, eng._counts, q0, eng.row_cap, eng._chunk_width,
                1024, eng.cfg.matmul_precision)
            before = ts.LAUNCHES[name]
            got = chunked_ops.join_epilogue_bits(acc, q0, tau_eff)
            assert ts.LAUNCHES[name] == before + 1
            want = chunked_ops.join_epilogue_bits(acc.cpu(), q0, tau_eff)
        for a, b in zip(got, want):
            assert a.device == card and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("int8", [False, True])
def test_mesh_stripes_sum_where_the_rows_live(card, mesh_csr, int8):
    """The chunked mesh's stripe join over four shards of the card: one
    kernel 6 (or kernel 5) launch a stripe on the one card, no eager sum;
    each stripe's lists equal, in order, those of the same partials on a
    mesh of four CPU shards (the plain versions), and the join's pair set
    the CPU mesh's."""
    from apsim_tpu_torch.ops import chunked_mesh as cm_ops

    cfg = AllPairsConfig(**({"use_pallas": "off"} if int8 else
                            {"pallas_int8": False}))
    eng = MeshChunkedAllPairs(cfg, mesh=make_mesh(4, devices=[card] * 4),
                              super_tile=1024)
    eng._int8_stripes = int8
    eng.build(mesh_csr)
    cpu_mesh = make_mesh(4, devices=["cpu"] * 4)
    tau_eff = eng._tau_eff(0.8)
    aux = eng._int8_slabs()[1] if int8 else None
    for q0 in range(0, eng.n_rows, 1024):
        if int8:
            q2d = eng._int8_slabs()[0]
            parts = [chunked_ops.stripe_dots_int8(
                r, c, q, n, q0, eng.row_cap, eng._chunk_width, 1024)
                for r, c, q, n in zip(eng._ent[0], eng._ent[1], q2d,
                                      eng._local_counts())]
        else:
            parts = [chunked_ops.stripe_scores(
                r, c, v, n, q0, eng.row_cap, eng._chunk_width, 1024)
                for r, c, v, n in zip(*eng._ent, eng._local_counts())]
        got = cm_ops._stripe_where_rows_live(eng.mesh, parts, aux, q0,
                                             tau_eff, None)
        want = cm_ops._stripe_where_rows_live(
            cpu_mesh, [p.cpu() for p in parts],
            None if aux is None else aux.cpu(), q0, tau_eff, None)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    name = "pair_bits_int8" if int8 else "pair_bits_f32"
    before = dict(ts.LAUNCHES)
    got = eng.all_pairs(0.8)
    n_stripes = -(-eng.n_rows // 1024)
    assert ts.LAUNCHES[name] - before[name] == n_stripes
    assert ts.LAUNCHES["int8_matmul"] - before["int8_matmul"] == (
        n_stripes * eng._n_chunks if int8 else 0)
    cpu = MeshChunkedAllPairs(cfg, mesh=cpu_mesh, super_tile=1024)
    cpu._int8_stripes = int8
    cpu.build(mesh_csr)
    assert got.pair_set() == cpu.all_pairs(0.8).pair_set()


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


def _int8_rows(card, rows: int, k: int, seed: int):
    """int8 operands and aux of ``rows`` random unit rows of width ``k``,
    every fourth row a copy of the one before (hits at tau = 0.8)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((rows, k), device=card, generator=gen)
    x[1::4] = x[0::4]
    x /= x.norm(dim=1, keepdim=True)
    return ts.quantize_rows(x)


@pytest.mark.parametrize("k", [128, 4096])
@pytest.mark.parametrize("tiles", [(1024, 512), (512, 512), (256, 256),
                                   (64, 128)])
def test_int8_score_kernel_edges(card, tiles, k):
    """Kernels 1 and 3 on both thread-block tiles (128 x 256 and 64 x 128),
    one ring stage (K = 128) and 32 (K = 4,096): the dense triangle, a
    cross-panel rectangle with offsets and valid = 0 blocks, and a block
    list whose every sub-tile is dead (all zero bytes); gb, g64 and cnt
    bit-identical to the plain versions."""
    tm, tn = tiles
    q, aux = _int8_rows(card, 2048, k, tm + k)
    tau = 0.8
    bi, bj = (torch.from_numpy(a).to(card)
              for a in ts.upper_blocks_rect(2048, tm, tn))
    k1 = ts.score_bits_int8(q, aux, bi, bj, tau, tm, tn)
    p1 = ts.score_bits_int8_plain(q, aux, bi, bj, tau, tm, tn)
    assert all(torch.equal(a, b) for a, b in zip(k1, p1))
    assert int(k1[2][:, 0].sum()) > 0
    xi, xj = q[:1024], q[1024:]
    ai, aj = aux[:, :1024].contiguous(), aux[:, 1024:].contiguous()
    bi, bj = (torch.from_numpy(a).to(card)
              for a in panel_ops.full_grid(1024, 1024, tm, tn))
    valid = torch.ones_like(bi)
    valid[::3] = 0
    for off in ((0, 1024), (512, 768), (1024, 0)):
        args = (xi, xj, ai, aj, bi, bj, off, tau, tm, tn)
        k3 = panel_ops.panel_score_bits_int8(*args, valid=valid)
        p3 = panel_ops.panel_score_bits_int8_plain(*args, valid=valid)
        assert all(torch.equal(a, b) for a, b in zip(k3, p3))
        assert not k3[0][::3].any() and not k3[2][::3].any()
    # (1024, 0): every global row lies at or below every column: all dead
    assert not k3[0].any() and not k3[1].any() and not k3[2].any()


def test_int8_kernels_saturated_rows(card):
    """±127 operands at K = 32,768: the largest dot the int32 gate allows
    (127^2 * 32,768 ~ 5.3e8), exact in kernel 4 and kernel 3."""
    k = 32768
    gen = torch.Generator(device=card).manual_seed(7)
    sign = torch.randint(0, 2, (256, 1), device=card, generator=gen)
    q = (127 * (2 * sign - 1)).to(torch.int8).expand(256, k).contiguous()
    d = panel_mesh.int8_matmul(q[:128], q)
    assert torch.equal(d, panel_mesh.int8_matmul_plain(q[:128], q))
    assert int(d.abs().max()) == 127 * 127 * k
    aux = torch.stack([torch.full((256,), 1 / 127 / 181.02, device=card),
                       torch.full((256,), 1.0, device=card),
                       torch.full((256,), float(k), device=card)])
    bi = torch.zeros(1, dtype=torch.int32, device=card)
    args = (q, q, aux, aux, bi, bi, (0, 256), 0.5, 256, 256)
    kk = panel_ops.panel_score_bits_int8(*args)
    pp = panel_ops.panel_score_bits_int8_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(kk, pp))


@pytest.mark.parametrize("shape", [(128, 256, 128), (128, 256, 4096),
                                   (192, 384, 256), (8192, 256, 128)])
def test_int8_matmul_tile_variants(card, shape):
    """Kernel 4 at both thread-block tiles (128 x 256 where it divides
    (m, n), else 64 x 128), one ring stage and many, fewer tiles than SMs
    (blocks without a tile) and a tall operand."""
    m, n, d = shape
    gen = torch.Generator(device=card).manual_seed(m * n + d)
    xi, xj = (torch.randint(-127, 128, (r, d), dtype=torch.int8,
                            device=card, generator=gen) for r in (m, n))
    assert torch.equal(panel_mesh.int8_matmul(xi, xj),
                       panel_mesh.int8_matmul_plain(xi, xj))


def _bf16_rows(card, rows: int, pad: int, k: int, seed: int,
               positive: bool = False):
    """bf16 operand of ``rows`` random unit rows of width ``k`` (every
    fourth a copy of the one before) and ``pad`` zero rows."""
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((rows, k), device=card, generator=gen)
    if positive:
        x.abs_()
    x[1::4] = x[0:-1:4]
    x /= x.norm(dim=1, keepdim=True)
    return torch.cat([x, torch.zeros((pad, k), device=card)]).to(
        torch.bfloat16)


@pytest.mark.parametrize("k", [64, 2048])
@pytest.mark.parametrize("tiles", [(1024, 512), (512, 512), (256, 256),
                                   (64, 128)])
def test_bf16_score_kernel_edges(card, tiles, k):
    """Kernel 2 on both thread-block tiles (128 x 256 and 64 x 128), one
    ring stage (K = 64 elements) and 32 (K = 2,048), with padding rows, a
    threshold inside the bulk of the scores (2.4 sigma of a random pair's),
    and a one-block list (fewer tiles than SMs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tm, tn = tiles
    x = _bf16_rows(card, 1900, 148, k, tm + k)
    tau = 2.4 / k ** 0.5
    bi, bj = (torch.from_numpy(a).to(card)
              for a in ts.upper_blocks_rect(2048, tm, tn))
    assert _bf16_matches_plain(x, bi, bj, tau, tm, tn) > 1000
    assert _bf16_matches_plain(x, bi[:1], bj[:1], tau, tm, tn) > 0


def test_bf16_score_kernel_dense_stress(card):
    """Rows of 32,768 positive elements, threshold at the scores' median:
    cells that differ from the plain version lie within the engine's bound
    on fp32 accumulation over K nonzeros, (K + 2) * 2^-24."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k = 32768
    x = _bf16_rows(card, 2048, 0, k, 11, positive=True)
    bi, bj = (torch.from_numpy(a).to(card)
              for a in ts.upper_blocks_rect(2048, 1024, 512))
    tau = float(next(ts.bf16_scores(x, bi[:1], bj[1:2], 1024, 512))[2]
                .median())
    n = _bf16_matches_plain(x, bi, bj, tau, 1024, 512,
                            band=(k + 2) * 2.0 ** -24)
    assert 400_000 < n < 1_700_000  # of 2,096,128 strict-upper cells


def test_bf16_wrapper_refuses_misaligned_on_card(card):
    """A view that starts off a 16-byte boundary is refused before any
    launch (TMA could not load it)."""
    buf = torch.zeros(256 * 64 + 8, dtype=torch.bfloat16, device=card)
    x = buf[1:1 + 256 * 64].view(256, 64)
    b = torch.zeros(1, dtype=torch.int32, device=card)
    before = ts.LAUNCHES["score_bits_bf16"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        ts.score_bits_bf16(x, b, b, 0.5, 64, 128)
    assert ts.LAUNCHES["score_bits_bf16"] == before


# ------------------------------------------- the full-rectangle join paths
@pytest.mark.parametrize("tf32_before", [False, True])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_rectangle_join_on_cuda_equals_cpu(card, mesh_csr, precision,
                                           tf32_before):
    """The rectangle on the card: the CPU engine's pair set, no kernel
    launch, and ``allow_tf32`` (and the precision level behind it) left as
    found, whether it was on or off."""
    cfg = AllPairsConfig(use_pallas="off", matmul_precision=precision,
                         row_bucket=1024)
    want = Engine(cfg, "cpu")
    want.build(mesh_csr)
    want = want.all_pairs(0.8).pair_set()
    eng = Engine(cfg, "cuda")
    eng.build(mesh_csr)
    before = dict(ts.LAUNCHES)
    torch.set_float32_matmul_precision("medium" if tf32_before else "highest")
    try:
        got = eng.all_pairs(0.8)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32_before
        assert torch.get_float32_matmul_precision() == (
            "medium" if tf32_before else "highest")
    finally:
        torch.set_float32_matmul_precision("highest")
    assert got.pair_set() == want and len(want) > 0
    assert ts.LAUNCHES == before and eng._used_int8 is False
    assert eng._rect_operand().dtype == (
        torch.float32 if precision == "highest" else torch.bfloat16)


def test_score_tile_is_fp32_on_the_card(card):
    """bf16 operands multiply on the tensor cores into fp32 scores: far
    closer to the fp64 product of the same bf16 values than a bf16 matmul's
    rounded output (up to 2^-9 of a score near 0.8: every second row lies
    at cosine 0.8 from the one before); ``highest`` is a true fp32 product
    even with TF32 allowed around it."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn((2048, 4096), device="cuda", generator=gen)
    a /= a.norm(dim=1, keepdim=True)
    a[1::2] = 0.8 * a[0::2] + 0.6 * a[1::2]
    a /= a.norm(dim=1, keepdim=True)
    ab = score_ops.score_operand(a, "default")
    assert ab.dtype == torch.bfloat16
    assert score_ops.score_operand(a, "highest") is a
    s = score_ops.score_tile(ab, ab[:256], "default")
    assert s.dtype == torch.float32 and s.is_cuda
    ref = ab.double() @ ab[:256].double().T
    err = float((s.double() - ref).abs().max())
    rounded = float(((ab @ ab[:256].T).double() - ref).abs().max())
    assert err <= 4096 * 2.0 ** -24 and rounded > 1e-3 > 20 * err
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        hi = score_ops.score_tile(a, a[:256], "highest")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ref32 = a.double() @ a[:256].double().T
    assert hi.dtype == torch.float32
    assert float((hi.double() - ref32).abs().max()) <= 4098 * 2.0 ** -24


@pytest.mark.parametrize("super_tile", [1024, 96])
def test_int8_stripe_accumulator_matches_plain(card, mesh_csr, super_tile):
    """Kernel 4 under the int8 stripes: one launch per chunk, the summed
    int32 accumulator equal to the plain products' sum in every cell (also
    with query rows padded to the kernel's 128-row quantum)."""
    eng = ChunkedAllPairs(AllPairsConfig(use_pallas="off"), "cuda")
    eng._int8_stripes = True
    eng.build(mesh_csr)
    q2d, aux = eng._int8_slabs()
    args = (eng._ent[0], eng._ent[1], q2d, eng._counts)
    before = ts.LAUNCHES["int8_matmul"]
    d = chunked_ops.stripe_dots_int8(*args, 1024, eng.row_cap,
                                     eng._chunk_width, super_tile)
    assert ts.LAUNCHES["int8_matmul"] == before + eng._n_chunks
    want = torch.zeros_like(d)
    for c in range(eng._n_chunks):
        slab = chunked_ops.densify_chunk(*args, c, eng.row_cap,
                                         eng._chunk_width, torch.int8)
        want += panel_mesh.int8_matmul_plain(
            slab, slab[1024:1024 + super_tile].contiguous())
    assert d.dtype == torch.int32 and torch.equal(d, want)
    assert int(d.abs().max()) > 0


def test_stripe_scores_are_fp32_and_match_cpu(card, mesh_csr):
    """The bf16 stripes on the card: an fp32 accumulator, within fp32
    accumulation error of the CPU's fp32 product of the same bf16 slabs."""
    eng = ChunkedAllPairs(AllPairsConfig(pallas_int8=False), "cuda")
    eng.build(mesh_csr)
    cpu = ChunkedAllPairs(AllPairsConfig(pallas_int8=False), "cpu")
    cpu.build(mesh_csr)
    s = chunked_ops.stripe_scores(*eng._ent, eng._counts, 0, eng.row_cap,
                                  eng._chunk_width, 1024)
    ref = chunked_ops.stripe_scores(*cpu._ent, cpu._counts, 0, cpu.row_cap,
                                    cpu._chunk_width, 1024)
    assert s.dtype == torch.float32 and s.is_cuda
    assert float((s.cpu() - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("case", ["no_int8", "int8_stripes", "mesh_no_int8",
                                  "mesh_int8_stripes"])
def test_stripe_join_on_cuda_equals_cpu(card, mesh_csr, case):
    def make(dev):
        cfg = AllPairsConfig(**({"pallas_int8": False} if "no_int8" in case
                                else {"use_pallas": "off"}))
        if case.startswith("mesh"):
            e = MeshChunkedAllPairs(cfg, mesh=make_mesh(4, devices=[dev] * 4))
        else:
            e = ChunkedAllPairs(cfg, dev)
        e._int8_stripes = case.endswith("int8_stripes")
        e.build(mesh_csr)
        return e

    eng, cpu = make("cuda"), make("cpu")
    before = ts.LAUNCHES["int8_matmul"]
    got, want = eng.all_pairs(0.8), cpu.all_pairs(0.8)
    assert got.pair_set() == want.pair_set() and want.n_pairs > 0
    n = eng._n_chunks * -(-eng.n_rows // eng._q_super())
    assert ts.LAUNCHES["int8_matmul"] - before == (
        n if case.endswith("int8_stripes") else 0)


@pytest.mark.parametrize("layout", ["dims", "mesh_2x2", "rows_demoted"])
def test_mesh_rectangle_on_cuda_equals_cpu(card, mesh_csr, layout):
    def make(dev):
        shape = (2, 2) if layout == "mesh_2x2" else 4
        axis = "rows" if layout == "rows_demoted" else "dims"
        e = MeshEngine(AllPairsConfig(shard_axis=axis, row_bucket=1024),
                       mesh=make_mesh(shape, devices=[dev] * 4))
        e.build(mesh_csr)
        e._int8_off = layout == "rows_demoted"
        return e

    eng, cpu = make("cuda"), make("cpu")
    assert not eng._kernel_ok() and eng.x is None
    before = dict(ts.LAUNCHES)
    got, want = eng.all_pairs(0.8), cpu.all_pairs(0.8)
    assert got.pair_set() == want.pair_set() and want.n_pairs > 0
    assert ts.LAUNCHES == before
    assert all(b.is_cuda for b in eng.x_blocks)


# ------------------------------------------------------ the streaming path
def _head(csr, n):
    return CSRMatrix(n, csr.n_cols, csr.indptr[: n + 1],
                     csr.indices[: csr.indptr[n]], csr.data[: csr.indptr[n]])


def _stream(eng, csr, s, bs, shift=0):
    """Insert rows [s, s + bs) of ``csr``; ``shift`` moves every second
    row's dims past the corpus's (new dims: column growth)."""
    batch = []
    for i in range(s, s + bs):
        v = csr.row(i)
        if shift and i % 2:
            v = SparseVector(v.size, v.indices + shift, v.values)
        batch.append((str(i), v))
    return eng.insert(batch, tau=0.8)


def test_stream_on_cuda_equals_cpu(card, mesh_csr):
    """Build 2,000 rows, stream batches of 1, 32, 256 and one with new
    dims, then copies of shifted rows: outputs, index and capacities equal
    the CPU engine's after every batch, and the kept bf16 copy equals a
    fresh cast of the index bit for bit (re-keyed to the index's version,
    dropped at growth).  Batches that activate dormant dims without growth
    write the activated entries into the kept copy itself."""
    cfg = AllPairsConfig(row_bucket=1024, dim_bucket=2048)
    engs = {d: Engine(cfg, d) for d in ("cuda", "cpu")}
    for e in engs.values():
        e.build(_head(mesh_csr, 2000))
    dim_cap0 = engs["cuda"].dim_cap
    # the copies re-send rows of the shifted batch (rows 2290-2589, every
    # second one shifted): the dims they archived as singletons activate
    copies = []
    for i in range(2291, 2323, 2):
        v = mesh_csr.row(i)
        copies.append((f"c{i}", SparseVector(v.size, v.indices + 40000,
                                             v.values)))
    s = 2000
    activated_in_place = 0
    for bs, shift in ((1, 0), (32, 0), (256, 0), (1, 0), (300, 40000),
                      (256, 0), (len(copies), None)):
        g, c = engs["cuda"], engs["cpu"]
        caps, dorm = (g.row_cap, g.dim_cap), g.stats["dormant_dims"]
        kept0 = g._bf16_cache[1] if g._bf16_cache else None
        if shift is None:
            outs = {d: e.insert(copies, tau=0.8).output
                    for d, e in engs.items()}
            assert all(outs["cuda"][q][q[1:]] > 0.999 for q, _ in copies)
        else:
            outs = {d: _stream(e, mesh_csr, s, bs, shift).output
                    for d, e in engs.items()}
            s += bs
        assert outs["cuda"] == outs["cpu"]
        assert (g.row_cap, g.dim_cap) == (c.row_cap, c.dim_cap)
        assert g.stats["dormant_dims"] == c.stats["dormant_dims"]
        assert torch.equal(g.x.cpu(), c.x)
        key, kept = g._bf16_cache
        assert key == (id(g.x), g.x._version)
        assert torch.equal(kept, g.x.to(torch.bfloat16))
        if (kept0 is not None and g.stats["dormant_dims"] < dorm
                and (g.row_cap, g.dim_cap) == caps):
            assert kept is kept0
            activated_in_place += 1
    assert activated_in_place >= 2
    assert engs["cuda"].row_cap == 4096 and engs["cuda"].dim_cap > dim_cap0
    got = engs["cuda"].all_pairs(0.8).pair_set()
    assert got == engs["cpu"].all_pairs(0.8).pair_set() and got


def test_stream_match_scores_are_fp32(card, mesh_csr, monkeypatch):
    """The insert's product multiplies the bf16 copy into fp32 scores; no
    bf16 score tile meets the threshold."""
    eng = Engine(AllPairsConfig(row_bucket=1024), "cuda")
    eng.build(_head(mesh_csr, 1500))
    seen = []
    real = score_ops.score_tile

    def spy(a, q, precision):
        s = real(a, q, precision)
        seen.append((a.dtype, q.dtype, s.dtype))
        return s

    monkeypatch.setattr(score_ops, "score_tile", spy)
    _stream(eng, mesh_csr, 1500, 64)
    assert seen == [(torch.bfloat16, torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("tf32_before", [False, True])
def test_topk_and_frozen_match_on_cuda_equal_cpu(card, mesh_csr, tf32_before,
                                                 monkeypatch):
    """``topk`` on the card: the CPU engine's lists, a product run with TF32
    off, ``allow_tf32`` as found; frozen matching: the CPU output."""
    cfg = AllPairsConfig(row_bucket=1024)
    engs = {d: Engine(cfg, d) for d in ("cuda", "cpu")}
    for e in engs.values():
        e.build(_head(mesh_csr, 2500))
    qs = [(f"q{i}", mesh_csr.row(i)) for i in range(2400, 2600)]
    flags = []
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    try:
        monkeypatch.setattr(score_ops, "true_fp32_matmul",
                            _tf32_probe(score_ops.true_fp32_matmul, flags))
        got = engs["cuda"].topk(qs, 10)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32_before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert flags and not any(flags)
    want = engs["cpu"].topk(qs, 10)
    assert list(got) == list(want)
    for q in got:
        assert [c for c, _ in got[q]] == [c for c, _ in want[q]]
        assert np.allclose([v for _, v in got[q]], [v for _, v in want[q]],
                           rtol=0, atol=1e-12)
    for e in engs.values():
        e.freeze()
    outs = {d: e.insert(qs, tau=0.8).output for d, e in engs.items()}
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]


def _tf32_probe(ctx, flags):
    """``true_fp32_matmul`` that records ``allow_tf32`` inside its block."""
    import contextlib

    @contextlib.contextmanager
    def probe():
        with ctx():
            flags.append(torch.backends.cuda.matmul.allow_tf32)
            yield
    return probe


@pytest.mark.parametrize("budget", [7168, 0])
def test_chunked_stream_on_cuda_equals_cpu(budget):
    """The chunked streaming path on the card and on the CPU, batch for
    batch: the resident route (``budget`` 7,168 MiB) or the paneled route
    (0): outputs equal (fp64 similarities equal), entry buffers and the
    resident stack equal, every match's scores fp32; then ``topk``, a
    frozen match and the join of the streamed index (the cross-panel
    kernel launched on the card) equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    csr = synthetic_corpus(3000, seed=1)
    engs = {}
    for dev in ("cuda", "cpu"):
        e = ChunkedAllPairs(AllPairsConfig(match_slab_budget_mb=budget), dev,
                            panel_rows=1024)
        e._host_stream_match = False
        a = int(csr.indptr[2000])
        e.build(CSRMatrix(2000, csr.n_cols, csr.indptr[:2001],
                          csr.indices[:a], csr.data[:a]))
        engs[dev] = e
    s = 2000
    for bs in (1, 32, 256, 256, 256, 199):
        outs = {dev: e.insert([(str(i), csr.row(i)) for i in range(s, s + bs)],
                              tau=0.8).output for dev, e in engs.items()}
        assert outs["cuda"] == outs["cpu"]
        route = {dev: e.last_route for dev, e in engs.items()}
        assert route["cuda"] == route["cpu"] == (
            "resident_slabs" if budget else "device_paneled")
        for a, b in zip(engs["cuda"]._ent, engs["cpu"]._ent):
            assert torch.equal(a.cpu(), b)
        if budget:
            assert torch.equal(engs["cuda"]._mslab.cpu(), engs["cpu"]._mslab)
        s += bs
    assert s == 3000
    q = [(f"q{i}", csr.row(i)) for i in range(0, 3000, 97)]
    tops = {dev: e.topk(q, 5) for dev, e in engs.items()}
    assert {k: [r for r, _ in v] for k, v in tops["cuda"].items()} == {
        k: [r for r, _ in v] for k, v in tops["cpu"].items()}
    before = ts.LAUNCHES["panel_score_bits_int8"]
    joins = {dev: e.all_pairs(0.8).pair_set() for dev, e in engs.items()}
    assert ts.LAUNCHES["panel_score_bits_int8"] - before == 6  # 3 panels
    assert joins["cuda"] == joins["cpu"]
    for e in engs.values():
        e.freeze()
    frozen = {dev: e.insert(q, tau=0.8).output for dev, e in engs.items()}
    assert frozen["cuda"] == frozen["cpu"] and frozen["cpu"]
    stack = engs["cuda"]._match_slabs()
    if stack is not None:
        e, a = engs["cuda"], int(csr.indptr[8])
        qb = e._bucket_queries(e.compact.map_csr(e._drop_unmapped(
            CSRMatrix(8, csr.n_cols, csr.indptr[:9], csr.indices[:a],
                      csr.data[:a]))), 8)
        sc = chunked_ops.chunk_scores(lambda c: stack[c], qb, stack.shape[0],
                                      stack.shape[2], 8, stack.dtype,
                                      "default")
        assert sc.dtype == torch.float32


@pytest.mark.parametrize("shape, axis", [(4, "rows"), (4, "dims"),
                                         ((2, 2), "dims")])
def test_mesh_stream_on_cuda_equals_cpu(card, mesh_csr, shape, axis):
    """``MeshEngine`` over four shards of the card and of the CPU, the
    phase-8 stream in small (batches of 1, 32, 256, one with new dims,
    copies of shifted rows that activate dormant entries): outputs,
    capacities and blocks equal the CPU mesh's after every batch, and the
    bf16 copies the inserts keep equal fresh casts of their blocks bit for
    bit (re-keyed to the blocks' versions); then ``topk``, a frozen match
    and the join of the streamed index equal (the rows layout launches
    kernel 3 once per shard)."""
    cfg = AllPairsConfig(row_bucket=1024, dim_bucket=2048, shard_axis=axis)
    engs = {d: MeshEngine(cfg, mesh=make_mesh(shape, devices=[d] * 4))
            for d in ("cuda", "cpu")}
    for e in engs.values():
        e.build(_head(mesh_csr, 2000))
    copies = []
    for i in range(2291, 2323, 2):
        v = mesh_csr.row(i)
        copies.append((f"c{i}", SparseVector(v.size, v.indices + 40000,
                                             v.values)))
    s = 2000
    for bs, shift in ((1, 0), (32, 0), (256, 0), (300, 40000), (256, 0),
                      (len(copies), None)):
        g, c = engs["cuda"], engs["cpu"]
        if shift is None:
            outs = {d: e.insert(copies, tau=0.8).output
                    for d, e in engs.items()}
        else:
            outs = {d: _stream(e, mesh_csr, s, bs, shift).output
                    for d, e in engs.items()}
            s += bs
        assert outs["cuda"] == outs["cpu"]
        assert (g.row_cap, g.dim_cap) == (c.row_cap, c.dim_cap)
        assert g.stats["dormant_dims"] == c.stats["dormant_dims"]
        for a, b in zip(g.x_blocks, c.x_blocks):
            assert torch.equal(a.cpu(), b)
        key, kept = g._block_operands
        assert key == g._blocks_key()
        for blk, cp in zip(g.x_blocks, kept):
            assert torch.equal(cp, blk.to(torch.bfloat16))
    assert engs["cuda"].row_cap == 4096
    q = [(f"q{i}", mesh_csr.row(i)) for i in range(0, 3000, 97)]
    tops = {d: e.topk(q, 5) for d, e in engs.items()}
    assert {k: [r for r, _ in v] for k, v in tops["cuda"].items()} == {
        k: [r for r, _ in v] for k, v in tops["cpu"].items()}
    before = ts.LAUNCHES["panel_score_bits_int8"]
    joins = {d: e.all_pairs(0.8).pair_set() for d, e in engs.items()}
    launched = ts.LAUNCHES["panel_score_bits_int8"] - before
    assert launched == (4 if axis == "rows" and shape == 4 else 0)
    assert joins["cuda"] == joins["cpu"] and joins["cpu"]
    for e in engs.values():
        e.freeze()
    frozen = {d: e.insert(q, tau=0.8).output for d, e in engs.items()}
    assert frozen["cuda"] == frozen["cpu"] and frozen["cpu"]


def test_mesh_chunked_stream_on_cuda_equals_cpu(card, mesh_csr):
    """``MeshChunkedAllPairs`` over four shards of the card and of the
    CPU, batch for batch: outputs equal, every shard's entry buffers equal,
    every match on the rebuild route; then ``topk``, a frozen match and the
    join of the streamed index (kernel 4 once per shard per panel pair on
    the card) equal."""
    engs = {}
    for d in ("cuda", "cpu"):
        e = MeshChunkedAllPairs(AllPairsConfig(),
                                mesh=make_mesh(4, devices=[d] * 4),
                                panel_rows=1024)
        e.build(_head(mesh_csr, 2000))
        engs[d] = e
    s = 2000
    for bs in (1, 32, 256, 256, 256, 199):
        outs = {d: e.insert([(str(i), mesh_csr.row(i))
                             for i in range(s, s + bs)], tau=0.8).output
                for d, e in engs.items()}
        assert outs["cuda"] == outs["cpu"]
        assert {e.last_route for e in engs.values()} == {"device_rebuild"}
        for a, b in zip(engs["cuda"]._ent, engs["cpu"]._ent):
            assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b))
        s += bs
    q = [(f"q{i}", mesh_csr.row(i)) for i in range(0, 3000, 97)]
    tops = {d: e.topk(q, 5) for d, e in engs.items()}
    assert {k: [r for r, _ in v] for k, v in tops["cuda"].items()} == {
        k: [r for r, _ in v] for k, v in tops["cpu"].items()}
    n_panels = engs["cuda"]._panel_geom()[3]
    before = ts.LAUNCHES["int8_matmul"]
    joins = {d: e.all_pairs(0.8).pair_set() for d, e in engs.items()}
    assert ts.LAUNCHES["int8_matmul"] - before == (
        4 * n_panels * (n_panels + 1) // 2)
    assert joins["cuda"] == joins["cpu"] and joins["cpu"]
    for e in engs.values():
        e.freeze()
    frozen = {d: e.insert(q, tau=0.8).output for d, e in engs.items()}
    assert frozen["cuda"] == frozen["cpu"] and frozen["cpu"]
