"""The port's full-rectangle join ops on the CPU, against the JAX package's
functions on the same seeded inputs: ``ops/score.allpairs_extract`` and the
stripe ops of ``ops/chunked.py`` (``densify_chunk``, the fp32/bf16 stripes,
the int8 stripes).

Tolerances: ``densify_chunk`` equals ``_densify_chunk`` array for array; the
int8 stripes' candidate lists equal the JAX function's element for element
(int32 dots are exact); the float rectangles' sorted candidate lists are
equal at thresholds chosen at least ``GAP`` = 1e-4 away from every fp64
score of the operands as multiplied (an fp32 accumulation over these rows
errs by ~1e-6, so both packages decide every cell alike), and equal the
fp64 oracle's set at that threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apsim_tpu
import apsim_tpu_torch as pt
from apsim_tpu.engine import ChunkedAllPairs as JaxChunked
from apsim_tpu.ops import chunked as jax_chunked
from apsim_tpu.ops import pallas_score as jax_ps
from apsim_tpu.ops import score as jax_score
from apsim_tpu_torch.ops import chunked as chunked_ops
from apsim_tpu_torch.ops import score as score_ops
from apsim_tpu_torch.ops import tri_score as ts

from oracle import random_sparse_corpus

DIM = 500
GAP = 1e-4  # least distance of a test threshold from every fp64 score
CAP = 1 << 15  # JAX extraction capacity: above every candidate count here


def gapped_thresholds(scores: np.ndarray, n: int = 2, lo: float = 0.25):
    """``n`` thresholds from ``lo`` up, each at least ``GAP`` away from
    every entry of the fp64 ``scores``."""
    out = []
    for tau in np.arange(lo, 0.95, 0.0937):
        if np.abs(scores - tau).min() >= GAP:
            out.append(float(tau))
        if len(out) == n:
            return out
    raise AssertionError("no gapped threshold found")


@pytest.fixture(scope="module")
def index():
    """A seeded dense index ``[256, 512]`` fp32: 230 normalized sparse rows
    (some exact duplicates) and 26 zero padding rows."""
    rng = np.random.default_rng(41)
    base = random_sparse_corpus(rng, 220, DIM, n_hot_dims=12)
    rows = [base.row(i) for i in range(base.n_rows)]
    rows += [base.row(i) for i in range(10)]
    csr = apsim_tpu.vector.batch.CSRMatrix.from_vectors(rows, DIM).normalized()
    x = np.zeros((256, 512), np.float32)
    x[:csr.n_rows, :DIM] = csr.to_dense().astype(np.float32)
    return x


def jax_pairs(bufs, packed):
    pairs, needed = jax_score.consume_packed(bufs, np.asarray(packed), CAP, 8)
    assert needed == 0
    return sorted(zip(pairs[0].tolist(), pairs[1].tolist()))


# ------------------------------------------------------- allpairs_extract
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("mode", ["upper", "all"])
def test_allpairs_extract_equals_jax(index, mode, precision):
    s64 = index.astype(np.float64) @ index.astype(np.float64).T
    taus = gapped_thresholds(s64)
    assert all(np.abs(s64 - t).min() >= GAP for t in taus)
    for tau in taus:
        rows, cols = score_ops.allpairs_extract(
            torch.from_numpy(index), np.float32(tau), 64, mode, precision, 8)
        assert rows.dtype == cols.dtype == torch.int64
        got = sorted(zip(rows.tolist(), cols.tolist()))
        bufs, packed = jax_score.allpairs_extract(
            jnp.asarray(index), np.float32(tau), 64, CAP, mode, precision, 8)
        assert got == jax_pairs(bufs, packed)
        hit = s64 >= tau
        if mode == "upper":
            hit = np.triu(hit, k=1)
        assert got == sorted(zip(*(a.tolist() for a in np.nonzero(hit))))
        assert len(got) >= (10 if mode == "upper" else 256 - 26)


def test_allpairs_extract_refusals_and_empty(index):
    x = torch.from_numpy(index)
    with pytest.raises(ValueError, match="not a multiple of tile"):
        score_ops.allpairs_extract(x, 0.5, 96)
    with pytest.raises(ValueError, match="not a multiple of group"):
        score_ops.allpairs_extract(x, 0.5, 64, group=48)
    with pytest.raises(ValueError, match="unknown mode"):
        score_ops.allpairs_extract(x, 0.5, 64, mode="lower")
    rows, cols = score_ops.allpairs_extract(x, 2.0, 64)
    assert rows.numel() == cols.numel() == 0 and rows.dtype == torch.int64
    ts.check_pair_count(2**31 - 2)
    with pytest.raises(ValueError, match="2\\^31 candidate pairs"):
        ts.check_pair_count(2**31 - 1)


@pytest.mark.parametrize("n_tiles", [1, 5, 16, 17, 32, 100])
def test_upper_buckets_follow_the_jax_rule(n_tiles):
    """At most 16 near-even buckets that tile [0, n_tiles) in order."""
    got = score_ops.upper_buckets(n_tiles)
    n_buckets = min(n_tiles, 16)
    bounds = [n_tiles * b // n_buckets for b in range(n_buckets + 1)]
    assert got == [(a, b) for a, b in zip(bounds, bounds[1:]) if a < b]
    assert got[0][0] == 0 and got[-1][1] == n_tiles and len(got) <= 16
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_score_tile_is_fp32_on_the_cpu(index, dtype):
    """CPU tensors: operands upcast to fp32 (exact for bf16), fp32 product,
    and the operand is the tensor itself (no bf16 copy on the CPU)."""
    a = torch.from_numpy(index).to(dtype)
    assert score_ops.score_operand(a, "default") is a
    s = score_ops.score_tile(a, a[:64], "default")
    assert s.dtype == torch.float32 and tuple(s.shape) == (256, 64)
    assert torch.equal(s, a.float() @ a[:64].float().T)


@pytest.mark.parametrize("level", ["highest", "high", "medium"])
def test_true_fp32_matmul_restores_the_setting(level):
    """Inside the block TF32 is off; afterwards the process-wide setting is
    what it was, also after an exception, ``"medium"`` included."""
    mm = torch.backends.cuda.matmul
    torch.set_float32_matmul_precision(level)
    try:
        with score_ops.true_fp32_matmul():
            assert mm.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == level
        with pytest.raises(KeyError):
            with score_ops.true_fp32_matmul():
                raise KeyError("boom")
        assert torch.get_float32_matmul_precision() == level
        assert mm.allow_tf32 is (level != "highest")
    finally:
        torch.set_float32_matmul_precision("highest")


# ------------------------------------------------------------- stripe ops
@pytest.fixture(scope="module")
def chunked_pair():
    """(port engine, JAX engine) over the same corpus: 4 chunks of 128."""
    rng = np.random.default_rng(23)
    csr = random_sparse_corpus(rng, 220, DIM)
    kw = dict(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64)
    p = pt.ChunkedAllPairs(pt.AllPairsConfig(**kw), "cpu", chunk_dim=128)
    p.build(pt.CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                         csr.data))
    j = JaxChunked(apsim_tpu.AllPairsConfig(**kw), chunk_dim=128)
    j.build(csr)
    assert p._n_chunks == j._n_chunks == 4 and p.row_cap == j.row_cap == 1024
    return p, j


def test_chunk_entries_are_unique(chunked_pair):
    """``densify_chunk`` is a scatter *set*: within a chunk no (row, local
    column) occurs twice."""
    p, _ = chunked_pair
    rows2d, cols2d, _ = p._ent_host
    for c in range(p._n_chunks):
        k = int(p._counts[c])
        keys = rows2d[c, :k].astype(np.int64) * p._chunk_width + cols2d[c, :k]
        assert k > 0 and np.unique(keys).size == k


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("counts_on", ["host", "device"])
def test_densify_chunk_equals_jax(chunked_pair, kind, counts_on):
    p, j = chunked_pair
    q2d, _, _ = chunked_ops.quantize_chunk_entries(p._ent[0], p._ent[2],
                                                   p.row_cap)
    jq2d, _, _ = jax_chunked.quantize_chunk_entries(j._ent[0], j._ent[2],
                                                    j.row_cap)
    assert np.array_equal(q2d.numpy(), np.asarray(jq2d))
    vals, jvals = (q2d, jq2d) if kind == "int8" else (p._ent[2], j._ent[2])
    counts = p._counts if counts_on == "host" else p._counts_dev
    for c in range(p._n_chunks):
        slab = chunked_ops.densify_chunk(
            p._ent[0], p._ent[1], vals, counts, c, p.row_cap,
            p._chunk_width, getattr(torch, kind))
        want = jax_chunked._densify_chunk(
            j._ent[0], j._ent[1], jvals, j._counts_dev, c, j.row_cap,
            j._chunk_width, jnp.dtype(kind))
        assert slab.dtype == getattr(torch, kind)
        assert tuple(slab.shape) == (p.row_cap, p._chunk_width)
        assert np.array_equal(slab.float().numpy(),
                              np.asarray(want).astype(np.float32))
        assert int((slab != 0).sum()) > 100


def test_densify_chunk_filters_pad_rows_and_tail(chunked_pair):
    """Slots past ``counts[c]`` and rows at or past ``cap_rows`` never
    land, whatever they hold."""
    p, _ = chunked_pair
    rows, cols, vals = (a.clone() for a in p._ent)
    k = int(p._counts[0])
    rows[0, k:] = 3  # live-looking garbage past the count
    vals[0, k:] = 7.0
    rows[0, 0] = 1 << 30  # a pad row inside the counted range
    slab = chunked_ops.densify_chunk(rows, cols, vals, p._counts, 0, 1024,
                                     p._chunk_width)
    want = chunked_ops.densify_chunk(*p._ent, p._counts, 0, 1024,
                                     p._chunk_width)
    want[p._ent[0][0, 0], p._ent[1][0, 0]] = 0.0
    assert torch.equal(slab, want) and not (slab == 7.0).any()


def jax_stripe_pairs(bufs, packed):
    rows_h, cols_h, total, _, _ = jax_ps.unpack_pallas_head(np.asarray(packed))
    assert total <= min(rows_h.size, CAP)
    return sorted(zip(rows_h[:total].tolist(), cols_h[:total].tolist()))


@pytest.mark.parametrize("super_tile", [256, 1024])
def test_int8_stripes_equal_jax(chunked_pair, super_tile):
    """int32 dots are exact, so the candidates are the JAX function's
    element for element; CPU tensors run kernel 4's plain version."""
    p, j = chunked_pair
    q2d, aux, _ = chunked_ops.quantize_chunk_entries(p._ent[0], p._ent[2],
                                                     p.row_cap)
    jq2d, jaux, _ = jax_chunked.quantize_chunk_entries(j._ent[0], j._ent[2],
                                                       j.row_cap)
    before = dict(ts.LAUNCHES)
    n = 0
    for tau in (0.3, 0.6):
        tau_eff = p._tau_eff(tau)
        for q0 in range(0, p.n_rows, super_tile):
            rows, cols = chunked_ops.chunked_stripe_extract_int8(
                p._ent[0], p._ent[1], q2d, p._counts, aux, q0, tau_eff,
                p.row_cap, p._chunk_width, super_tile)
            bufs, packed = jax_chunked.chunked_stripe_extract_int8(
                j._ent[0], j._ent[1], jq2d, j._counts_dev, jaux,
                np.int32(q0), tau_eff, j.row_cap, j._chunk_width, super_tile,
                CAP)
            got = sorted(zip(rows.tolist(), cols.tolist()))
            assert got == jax_stripe_pairs(bufs, packed)
            n += len(got)
    assert n > 100 and ts.LAUNCHES == before


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_float_stripes_equal_jax(chunked_pair, precision):
    """bf16 slabs (default) or fp32 slabs (highest), fp32 scores: equal to
    the JAX stripes at thresholds ``GAP`` away from every fp64 score of
    the slabs as multiplied (the bf16-rounded values at the default)."""
    p, j = chunked_pair
    sdt = torch.float32 if precision == "highest" else torch.bfloat16
    dense = torch.cat([
        chunked_ops.densify_chunk(*p._ent, p._counts, c, p.row_cap,
                                  p._chunk_width, sdt)
        for c in range(p._n_chunks)], dim=1).double().numpy()
    s64 = dense @ dense.T
    taus = gapped_thresholds(s64, lo=0.15)
    assert all(np.abs(s64 - t).min() >= GAP for t in taus)
    for tau in taus:
        got = []
        for q0 in range(0, p.n_rows, 256):
            s = chunked_ops.stripe_scores(
                *p._ent, p._counts, q0, p.row_cap, p._chunk_width, 256,
                precision)
            assert s.dtype == torch.float32
            rows, cols = chunked_ops.chunked_stripe_extract(
                *p._ent, p._counts, q0, np.float32(tau), p.row_cap,
                p._chunk_width, 256, precision)
            bufs, packed = jax_chunked.chunked_stripe_extract(
                *j._ent, j._counts_dev, np.int32(q0), np.float32(tau),
                j.row_cap, j._chunk_width, 256, CAP, precision=precision)
            pairs = sorted(zip(rows.tolist(), cols.tolist()))
            assert pairs == jax_stripe_pairs(bufs, packed)
            got += pairs
        want = np.nonzero(np.triu(s64 >= tau, k=1))
        assert sorted(got) == sorted(zip(*(a.tolist() for a in want)))
        assert len(got) >= 5


def test_int8_stripes_pad_to_kernel_quanta():
    """Kernel 4's geometry by a stated rule: width and query rows are
    zero-padded to multiples of 128 (the dots do not change), a row_cap off
    the 64-row quantum is refused by name."""
    rng = np.random.default_rng(3)
    n_chunks, cap, row_cap, width = 3, 64, 128, 40
    cols = torch.from_numpy(np.stack([rng.permutation(width * 2)[:cap] % width
                                      for _ in range(n_chunks)])
                            .astype(np.int32))
    # unique (row, col) per chunk: one entry per row id
    rows = torch.from_numpy(np.stack([rng.permutation(100)[:cap]
                                      for _ in range(n_chunks)])
                            .astype(np.int32))
    q = torch.from_numpy(rng.integers(-127, 128, (n_chunks, cap))
                         .astype(np.int8))
    counts = np.full(n_chunks, cap, np.int64)
    d = chunked_ops.stripe_dots_int8(rows, cols, q, counts, 32, row_cap,
                                     width, 32)
    dense = torch.cat([
        chunked_ops.densify_chunk(rows, cols, q, counts, c, row_cap, width,
                                  torch.int8) for c in range(n_chunks)],
        dim=1).double()
    assert d.dtype == torch.int32 and tuple(d.shape) == (row_cap, 32)
    assert torch.equal(d, (dense @ dense[32:64].T).to(torch.int32))
    assert int(d.abs().max()) > 0
    with pytest.raises(ValueError, match="row_cap % 64"):
        chunked_ops.stripe_dots_int8(rows, cols, q, counts, 0, 96, width, 32)


def test_stripe_epilogue_chunking_is_invisible(chunked_pair, monkeypatch):
    """The epilogue's row chunks bound its temporaries; one chunk per
    stripe and one super-group (64 rows) per chunk give identical lists."""
    p, _ = chunked_pair
    tau_eff = p._tau_eff(0.3)
    args = (*p._ent, p._counts, 0, tau_eff, p.row_cap, p._chunk_width, 256)
    whole = chunked_ops.chunked_stripe_extract(*args)
    assert ts.epilogue_rows(p.row_cap, 256, 1) == ts.SUPER
    monkeypatch.setattr(
        ts, "epilogue_rows", lambda n_rows, n_cols: ts.SUPER)
    split = chunked_ops.chunked_stripe_extract(*args)
    for a, b in zip(whole, split):
        assert torch.equal(a, b)
    assert whole[0].numel() > 50
