"""The port's scorers and compaction against the JAX package's Pallas
kernels, run as the JAX tests run them on the CPU (``interpret=True``).

Tolerances:
  - int8 (gb, g64, cnt) are bit-identical; a hit cell may differ only if its
    fp32 ``s_hat + bound`` lies within 2 ulp of ``tau_eff`` (an FMA or
    rounding-order difference in the JAX interpreter), and the test names it;
  - bf16 hit cells may differ only where the plain fp32 score lies within
    1e-5 of ``tau_eff`` (the two sum the K products in different orders);
  - compaction returns exactly the JAX pair set (compared sorted: the SUPER2
    pre-level changes the order).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsim_tpu.ops import pallas_score as ps
from apsim_tpu_torch import AllPairsConfig, CSRMatrix, Engine
from apsim_tpu_torch.ops import tri_score as ts

from oracle import random_sparse_corpus

DIM = 700
N = 300


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(21)
    base = random_sparse_corpus(rng, N - 12, DIM, n_hot_dims=12)
    rows = [base.row(i) for i in range(base.n_rows)]
    rows += [base.row(i) for i in range(12)]  # exact duplicates: tau~1 pairs
    csr = CSRMatrix.from_vectors(rows, DIM).normalized()
    eng = Engine(AllPairsConfig(vector_dim=DIM, row_bucket=256,
                                dim_bucket=2048, query_tile=256), "cpu")
    eng.build(csr)
    assert (eng.row_cap, eng.dim_cap) == (512, 2048)
    return eng


def blocks(row_cap, tm, tn):
    bi, bj = ts.upper_blocks_rect(row_cap, tm, tn)
    return bi, bj, torch.from_numpy(bi), torch.from_numpy(bj)


def jax_bits(out):
    gb, g64, cnt = (np.array(a) for a in out)  # writable copies
    return gb, g64, cnt[:, 0, :3]


def assert_bits_match(ref, got, scores, tau_eff, band, label):
    """``ref``/``got`` (gb, g64, cnt) as numpy; ``scores`` the plain version's
    chunked score generator.  Differing hit cells must lie within ``band``
    of tau_eff; blocks without such cells must match exactly."""
    bad, near, blocks_diff = [], [], set()
    for s, e, v in scores:
        d = (ts.unpack_bits(torch.from_numpy(ref[0][s:e]))
             != ts.unpack_bits(torch.from_numpy(got[0][s:e])))
        for p, r, c in torch.nonzero(d).tolist():
            val = float(v[p, r, c])
            blocks_diff.add(s + p)
            (near if abs(val - float(tau_eff)) <= band else bad).append(
                (s + p, r, c, val)
            )
    assert not bad, f"{label}: cells differ away from tau_eff: {bad[:10]}"
    if near:  # allowed, but named: (block, row, col, score)
        warnings.warn(f"{label}: {len(near)} hit cells differ at tau_eff "
                      f"{float(tau_eff)!r}: {near[:10]}")
    same = np.array([p not in blocks_diff for p in range(ref[0].shape[0])])
    for a, b in zip(ref, got):
        assert np.array_equal(a[same], b[same]), label


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_identical(engine, dtype):
    x = engine.x.to(getattr(torch, dtype))
    q, aux = ts.quantize_rows(x)
    jq, jaux = ps.quantize_rows(jnp.asarray(x.float().numpy()).astype(dtype))
    assert q.dtype == torch.int8 and aux.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(aux.numpy(), np.asarray(jaux))
    # padded (all-zero) rows: alpha = 0, so a zero score AND a zero bound
    assert torch.all(aux[:, engine.n_rows:] == 0)
    assert torch.all(q[engine.n_rows:] == 0)


@pytest.mark.parametrize("tau", [0.5, 0.8])
@pytest.mark.parametrize("tiles", [(256, 256), (512, 256)])
def test_int8_plain_matches_pallas(engine, tiles, tau):
    tm, tn = tiles
    tau_eff = engine._tau_eff(tau)
    q, aux = ts.quantize_rows(engine.x)
    bi, bj, tbi, tbj = blocks(engine.row_cap, tm, tn)
    ref = jax_bits(ps.pallas_score_bits_int8(
        jnp.asarray(q.numpy()), jnp.asarray(aux.numpy()), jnp.asarray(bi),
        jnp.asarray(bj), tau_eff, tm, tn, engine.dim_cap, interpret=True,
    ))
    got = [a.numpy() for a in ts.score_bits_int8(q, aux, tbi, tbj, tau_eff,
                                                 tm, tn)]
    assert int(got[2][:, 0].sum()) >= 12  # the duplicate pairs
    ulp = float(np.spacing(np.float32(tau_eff)))
    assert_bits_match(
        ref, got, ts.int8_scores(q, aux, tbi, tbj, tm, tn), tau_eff,
        2 * ulp, f"int8 tiles={tiles} tau={tau}",
    )


def bf16_rows(rows: int, pad: int, k: int, seed: int) -> np.ndarray:
    """``rows`` unit fp32 rows of width ``k`` (every fourth a copy of the one
    before, so some scores sit far above any tau) and ``pad`` zero rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x[1::4] = x[0:-1:4]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return np.concatenate([x, np.zeros((pad, k), np.float32)])


# (tm, tn): the engine fixture's index.  (tm, tn, K): the shapes of the
# card's bf16 edge legs, 1,900 seeded rows + 148 padding rows of width K:
# one 128-byte stage of the CUDA ring (K = 64) and several (K = 1,024), at
# the smallest and the largest block tiles of ``Engine._tiles``.
@pytest.mark.parametrize("tiles", [
    (256, 256), (512, 256), (256, 256, 64), (1024, 512, 64),
    (256, 256, 1024), (1024, 512, 1024),
])
def test_bf16_plain_matches_pallas(engine, tiles):
    tm, tn = tiles[:2]
    if len(tiles) == 2:
        x32, tau_eff = engine.x.numpy(), engine._tau_eff(0.5)
    else:
        x32 = bf16_rows(1900, 148, tiles[2], seed=sum(tiles))
        tau_eff = np.float32(0.78)
    row_cap, dim_cap = x32.shape
    xb = torch.from_numpy(x32).to(torch.bfloat16)
    bi, bj, tbi, tbj = blocks(row_cap, tm, tn)
    ref = jax_bits(ps.pallas_score_bits(
        jnp.asarray(x32).astype(jnp.bfloat16), jnp.asarray(bi),
        jnp.asarray(bj), tau_eff, tm, tn, dim_cap, interpret=True,
    ))
    got = [a.numpy() for a in ts.score_bits_bf16(xb, tbi, tbj, tau_eff,
                                                 tm, tn)]
    assert int(got[2][:, 0].sum()) > 0
    if len(tiles) == 3:  # no hit touches a padding row
        rows_hit = ts.unpack_bits(torch.from_numpy(got[0])).any(dim=2)
        for p, i in enumerate(bi.tolist()):
            assert not rows_hit[p][max(0, 1900 - i * tm):].any()
    assert_bits_match(
        ref, got, ts.bf16_scores(xb, tbi, tbj, tm, tn), tau_eff, 1e-5,
        f"bf16 tiles={tiles}",
    )


@pytest.mark.parametrize("tm", [256, 512])  # 512 takes the SUPER2 pre-level
def test_compaction_matches_jax(engine, tm):
    tn = 256
    q, aux = ts.quantize_rows(engine.x)
    bi, bj, tbi, tbj = blocks(engine.row_cap, tm, tn)
    gb, g64, cnt = ps.pallas_score_bits_int8(
        jnp.asarray(q.numpy()), jnp.asarray(aux.numpy()), jnp.asarray(bi),
        jnp.asarray(bj), engine._tau_eff(0.5), tm, tn, engine.dim_cap,
        interpret=True,
    )
    cap = 1 << 16
    (jr, jc), head = ps._compact_bits(
        gb, g64, cnt, jnp.asarray(bi), jnp.asarray(bj), cap,
        ps.capb_for(cap, ps.GROUP), ps.capb_for(cap, ps.GROUP), tm, tn,
    )
    total = ps.unpack_pallas_head(np.asarray(head))[2]
    want = sorted(zip(np.asarray(jr)[:total].tolist(),
                      np.asarray(jc)[:total].tolist()))
    r, c = ts.compact_bits(
        torch.from_numpy(np.array(gb)), torch.from_numpy(np.array(g64)),
        torch.from_numpy(np.asarray(cnt)[:, 0, :3].copy()), tbi, tbj, tm, tn,
    )
    assert r.dtype == torch.int64 and total > N
    assert sorted(zip(r.tolist(), c.tolist())) == want


def test_compaction_checks_counts(engine):
    q, aux = ts.quantize_rows(engine.x)
    _, _, tbi, tbj = blocks(engine.row_cap, 256, 256)
    gb, g64, cnt = ts.score_bits_int8(q, aux, tbi, tbj, engine._tau_eff(0.5),
                                      256, 256)
    cnt[0, 0] += 1
    with pytest.raises(RuntimeError, match="kernel counted"):
        ts.compact_bits(gb, g64, cnt, tbi, tbj, 256, 256)
    cnt[0, 0] = 2**31 - 1
    with pytest.raises(ValueError, match="2\\^31"):
        ts.compact_bits(gb, g64, cnt, tbi, tbj, 256, 256)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_padded_rows_give_no_candidates(engine, kind):
    """Even at the lowest device threshold, no candidate touches a padded
    row (the round-2 alpha=1 bug leaked every padded x real pair)."""
    assert engine.row_cap > engine.n_rows
    _, _, tbi, tbj = blocks(engine.row_cap, 256, 256)
    tau_eff = np.float32(1e-30)
    if kind == "int8":
        q, aux = ts.quantize_rows(engine.x)
        r, c = ts.allpairs_extract_int8(q, aux, tbi, tbj, tau_eff, 256, 256)
    else:
        xb = engine.x.to(torch.bfloat16)
        r, c = ts.allpairs_extract_bf16(xb, tbi, tbj, tau_eff, 256, 256)
    assert r.numel() > N
    assert int(r.max()) < engine.n_rows and int(c.max()) < engine.n_rows
    assert bool(torch.all(r < c))


def test_wrappers_route_by_device(engine):
    """A CPU tensor takes the plain version (no launch counted); a device
    other than cpu/cuda and tiles the kernels cannot take are refused."""
    q, aux = ts.quantize_rows(engine.x)
    _, _, tbi, tbj = blocks(engine.row_cap, 256, 256)
    before = dict(ts.LAUNCHES)
    ts.score_bits_int8(q, aux, tbi, tbj, 0.5, 256, 256)
    assert ts.LAUNCHES == before
    with pytest.raises(ValueError, match="multiple"):
        ts.score_bits_int8(q, aux, tbi, tbj, 0.5, 256, 64)
    meta = torch.empty(q.shape, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ts.score_bits_int8(meta, aux.to("meta"), tbi.to("meta"),
                           tbj.to("meta"), 0.5, 256, 256)
