"""The port's out-of-core panel ops against the JAX package's, on the same
seeded entry buffers: chunk bucketing, per-row int8 quantization of the
entries, the row sort, panel slabs, and the cross-panel scorer against the
Pallas ``_kernel_int8_cross`` run as the JAX tests run it on the CPU
(``interpret=True``) and against its XLA reference.

Tolerances: every comparison is bit-identical (arrays equal, dtypes
equal); compaction returns exactly the JAX pair set (compared sorted).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsim_tpu.ops import chunked as jch
from apsim_tpu.ops import pallas_score as jps
from apsim_tpu.ops import panel as jpanel
from apsim_tpu_torch import AllPairsConfig, ChunkedAllPairs, CSRMatrix
from apsim_tpu_torch.ops import chunked as pch
from apsim_tpu_torch.ops import panel as ppanel
from apsim_tpu_torch.ops import tri_score as ts

from oracle import random_sparse_corpus

DIM = 600
N = 300
RB = 128


@pytest.fixture(scope="module")
def engine():
    """A port engine on an unnormalized corpus (values scaled by 0.1-3,
    so the quantization rounds at many magnitudes) with exact duplicates
    across panels: rows 0-9 repeat as the last rows."""
    rng = np.random.default_rng(5)
    base = random_sparse_corpus(rng, N - 10, DIM)
    rows = [base.row(i) for i in range(base.n_rows)]
    rows += [base.row(i) for i in range(10)]
    csr = CSRMatrix.from_vectors(rows, DIM)
    csr.data = csr.data * rng.uniform(0.1, 3.0, csr.data.size)
    eng = ChunkedAllPairs(AllPairsConfig(vector_dim=DIM, dim_bucket=64),
                          "cpu", chunk_dim=128, panel_rows=RB)
    eng.build(csr)
    assert eng._n_chunks >= 4 and eng._panel_geom()[3] == 3
    return eng


@pytest.fixture(scope="module")
def quantized(engine):
    rows2d, _, vals2d = engine._ent_host
    jax_out = jch.quantize_chunk_entries(
        jnp.asarray(rows2d), jnp.asarray(vals2d), engine.row_cap
    )
    pt_out = pch.quantize_chunk_entries(
        torch.from_numpy(rows2d), torch.from_numpy(vals2d), engine.row_cap
    )
    return jax_out, pt_out


@pytest.fixture(scope="module")
def sorted_coo(engine, quantized):
    rows2d, cols2d, _ = engine._ent_host
    n_panels = engine._panel_geom()[3]
    j = jpanel.sort_entries_by_row(
        jnp.asarray(rows2d), jnp.asarray(cols2d), quantized[0][0],
        jnp.asarray(engine._counts.astype(np.int32)), RB, n_panels,
    )
    p = ppanel.sort_entries_by_row(
        torch.from_numpy(rows2d), torch.from_numpy(cols2d), quantized[1][0],
        engine._counts_dev, RB, n_panels,
    )
    return j, p


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_bucket_entries_identical(n_chunks):
    rng = np.random.default_rng(n_chunks)
    rows = rng.integers(0, 50, 700).astype(np.int32)
    cols = rng.integers(0, 900, 700).astype(np.int32)
    vals = rng.random(700)
    a = jch.bucket_entries(rows, cols, vals, n_chunks, 1024, 1 << 30)
    b = pch.bucket_entries(rows, cols, vals, n_chunks, 1024, 1 << 30)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_quantize_chunk_entries_bit_identical(engine, quantized):
    (jq, jaux, jmax), (q, aux, max_nnz) = quantized
    assert q.dtype == torch.int8 and aux.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(aux.numpy(), np.asarray(jaux))
    assert max_nnz == int(jmax) > 0
    # rows beyond the corpus (padding up to row_cap): alpha = 0, no bound
    assert torch.all(aux[:, engine.n_rows:] == 0)
    # unused slots (pad row 2^30) quantize to 0
    rows2d = torch.from_numpy(engine._ent_host[0])
    assert torch.all(q[rows2d >= engine.row_cap] == 0)


def test_sort_entries_by_row_bit_identical(sorted_coo):
    j, p = sorted_coo
    for a, b, name in zip(j, p, ("rows", "gcols", "q", "pcounts")):
        assert b.dtype == getattr(torch, str(np.asarray(a).dtype)), name
        assert np.array_equal(np.asarray(a), b.numpy()), name


def test_build_panel_slab_bit_identical(engine, sorted_coo):
    (jr, jg, jq, jpc), (r, g, q, pc) = sorted_coo
    n_panels, d_cap = engine._panel_geom()[3:]
    starts = np.concatenate([[0], np.cumsum(pc.numpy()[:n_panels])])
    p_cap = int(pc[:n_panels].max())
    for p in range(n_panels):
        s, e = int(starts[p]), int(starts[p + 1])
        # the entries of a panel hit each (row, col) cell once: the
        # assignment scatter equals the JAX scatter-set
        keys = (r[s:e].long() - p * RB) * d_cap + g[s:e].long()
        assert torch.unique(keys).numel() == e - s > 0
        want = jpanel.build_panel_slab(jr, jg, jq, np.int32(s),
                                       np.int32(p * RB), RB, d_cap, p_cap)
        got = ppanel.build_panel_slab(r, g, q, s, e, p * RB, RB, d_cap)
        assert got.dtype == torch.int8
        assert np.array_equal(np.asarray(want), got.numpy()), p
    # a slice reaching past the panel drops the out-of-panel rows
    got = ppanel.build_panel_slab(r, g, q, int(starts[0]), int(starts[2]),
                                  0, RB, d_cap)
    assert torch.equal(got, ppanel.build_panel_slab(
        r, g, q, int(starts[0]), int(starts[1]), 0, RB, d_cap))


def test_int8_bound_mask_identical():
    rng = np.random.default_rng(9)
    d = rng.integers(-2000, 40000, (64, 128)).astype(np.int32)
    auxi = np.stack([rng.random(64) * 1e-2, rng.random(64) * 0.3,
                     rng.integers(0, 90, 64)]).astype(np.float32)
    auxj = np.stack([rng.random(128) * 1e-2, rng.random(128) * 0.3,
                     rng.integers(0, 90, 128)]).astype(np.float32)
    rows = (500 + np.arange(64))[:, None].repeat(128, 1).astype(np.int32)
    cols = (530 + np.arange(128))[None, :].repeat(64, 0).astype(np.int32)
    want = jpanel.int8_bound_mask(*(jnp.asarray(a) for a in (
        d, auxi, auxj, rows, cols)), np.float32(0.6))
    got = ppanel.int8_bound_mask(*(torch.from_numpy(a) for a in (
        d, auxi, auxj, rows, cols)), np.float32(0.6))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert 0 < int(got.sum()) < got.numel()


def test_grids_identical():
    for rb, tm, tn in ((256, 64, 128), (1024, 128, 256), (8192, 1024, 512)):
        for a, b in zip(jpanel.diag_grid(rb, tm, tn),
                        ppanel.diag_grid(rb, tm, tn)):
            assert np.array_equal(a, b)
        for a, b in zip(jpanel.full_grid(rb, 2 * rb, tm, tn),
                        ppanel.full_grid(rb, 2 * rb, tm, tn)):
            assert np.array_equal(a, b)


def panel_operands(engine, quantized, sorted_coo, pi, pj):
    _, (r, g, q, pc) = sorted_coo
    aux = quantized[1][1]
    n_panels, d_cap = engine._panel_geom()[3:]
    starts = np.concatenate([[0], np.cumsum(pc.numpy()[:n_panels])])

    def slab(p):
        return ppanel.build_panel_slab(r, g, q, int(starts[p]),
                                       int(starts[p + 1]), p * RB, RB, d_cap)

    return (slab(pi), slab(pj), aux[:, pi * RB:(pi + 1) * RB].contiguous(),
            aux[:, pj * RB:(pj + 1) * RB].contiguous())


@pytest.mark.parametrize("ref", ["interpret", "xla_ref"])
@pytest.mark.parametrize("valid", ["all", "some_zero"])
@pytest.mark.parametrize("pair", [(0, 0), (0, 2), (1, 2)])
def test_panel_plain_matches_pallas(engine, quantized, sorted_coo, pair,
                                    valid, ref):
    """Kernel 3's plain version against the Pallas cross kernel: panel
    offsets (diagonal and off-diagonal pairs), (64, 128) tiles, and blocks
    blanked by ``valid = 0``; bit-identical gb, g64 and counts."""
    pi, pj = pair
    tm, tn = 64, 128
    xi, xj, ai, aj = panel_operands(engine, quantized, sorted_coo, pi, pj)
    bi, bj = (ppanel.diag_grid if pi == pj else
              lambda rb, a, b: ppanel.full_grid(rb, rb, a, b))(RB, tm, tn)
    v = np.ones(bi.size, np.int32)
    if valid == "some_zero":
        v[::2] = 0
    tau_eff = engine._tau_eff(0.5)
    off = (pi * RB, pj * RB)
    jargs = (jnp.asarray(xi.numpy()), jnp.asarray(xj.numpy()),
             jnp.asarray(ai.numpy()), jnp.asarray(aj.numpy()),
             jnp.asarray(bi), jnp.asarray(bj), jnp.asarray(off, jnp.int32),
             tau_eff)
    if ref == "interpret":
        gb, g64, cnt = jpanel.panel_score_bits_int8(
            *jargs, tm, tn, xi.shape[1], interpret=True,
            valid=jnp.asarray(v))
    else:
        gb, g64, cnt = jpanel.panel_score_bits_int8_ref(
            *jargs, tm, tn, valid=jnp.asarray(v))
    got = ppanel.panel_score_bits_int8(
        xi, xj, ai, aj, torch.from_numpy(bi), torch.from_numpy(bj), off,
        tau_eff, tm, tn, valid=torch.from_numpy(v),
    )
    want = (np.asarray(gb), np.asarray(g64), np.asarray(cnt)[:, 0, :3])
    for a, b in zip(want, got):
        assert np.array_equal(a, b.numpy())
    n_pairs = int(got[2][:, 0].sum())
    if pair == (0, 2) and valid == "all":  # the cross-panel duplicates
        assert n_pairs >= 10
    if valid == "some_zero":
        assert not got[0][::2].any() and not got[2][::2].any()


@pytest.mark.parametrize("pair", [(0, 0), (0, 2)])
def test_panel_pair_extract_matches_jax(engine, quantized, sorted_coo, pair):
    """Global (row, col) candidates of one panel pair, against the JAX
    ``panel_pair_extract_int8`` (interpret mode) at the same tiles."""
    pi, pj = pair
    tm, tn = 64, 128
    xi, xj, ai, aj = panel_operands(engine, quantized, sorted_coo, pi, pj)
    grid = (ppanel.diag_grid(RB, tm, tn) if pi == pj
            else ppanel.full_grid(RB, RB, tm, tn))
    tau_eff = engine._tau_eff(0.3)
    cap = 1 << 14
    (jr, jc), head = jpanel.panel_pair_extract_int8(
        jnp.asarray(xi.numpy()), jnp.asarray(xj.numpy()),
        jnp.asarray(ai.numpy()), jnp.asarray(aj.numpy()),
        jnp.asarray(grid[0]), jnp.asarray(grid[1]), jnp.int32(pi * RB),
        jnp.int32(pj * RB), tau_eff, cap, cap, cap, tm, tn, xi.shape[1],
        True,
    )
    total = jps.unpack_pallas_head(np.asarray(head))[2]
    want = sorted(zip(np.asarray(jr)[:total].tolist(),
                      np.asarray(jc)[:total].tolist()))
    r, c = ppanel.panel_pair_extract_int8(
        xi, xj, ai, aj, torch.from_numpy(grid[0]), torch.from_numpy(grid[1]),
        pi * RB, pj * RB, tau_eff, tm, tn,
    )
    assert r.dtype == torch.int64 and total > 0
    assert sorted(zip(r.tolist(), c.tolist())) == want
    assert bool(torch.all((r >= pi * RB) & (r < (pi + 1) * RB) & (r < c)))


def test_panel_wrapper_routes_and_checks(engine, quantized, sorted_coo):
    """A CPU tensor takes the plain version (no launch counted); operands
    and tiles the kernel does not take are refused."""
    xi, xj, ai, aj = panel_operands(engine, quantized, sorted_coo, 0, 1)
    bi, bj = (torch.from_numpy(a)
              for a in ppanel.full_grid(RB, RB, 64, 128))
    before = dict(ts.LAUNCHES)
    ppanel.panel_score_bits_int8(xi, xj, ai, aj, bi, bj, (0, RB), 0.5,
                                 64, 128)
    assert ts.LAUNCHES == before
    with pytest.raises(ValueError, match="multiple"):
        ppanel.panel_score_bits_int8(xi, xj, ai, aj, bi, bj, (0, RB), 0.5,
                                     64, 64)
    with pytest.raises(ValueError, match="aux"):
        ppanel.panel_score_bits_int8(xi, xj, ai, aj[:, :64], bi, bj,
                                     (0, RB), 0.5, 64, 128)
    with pytest.raises(ValueError, match="valid"):
        ppanel.panel_score_bits_int8(xi, xj, ai, aj, bi, bj, (0, RB), 0.5,
                                     64, 128, valid=bi.long())
    with pytest.raises(ValueError, match="width"):
        ppanel.panel_score_bits_int8(xi, xj[:, :256].contiguous(), ai, aj,
                                     bi, bj, (0, RB), 0.5, 64, 128)
    meta = torch.empty(xi.shape, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ppanel.panel_score_bits_int8(
            meta, meta, ai.to("meta"), aj.to("meta"), bi.to("meta"),
            bj.to("meta"), (0, RB), 0.5, 64, 128)
