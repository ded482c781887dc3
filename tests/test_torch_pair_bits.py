"""Kernel 5 of the port (``panel_mesh.pair_bits_int8``, the mesh panel
pair's summed-partial epilogue) and the row-sliced placement around it, on
the CPU, where the wrapper runs its plain version.

The plain version is held against the JAX package's ``int8_bound_mask`` +
``bitpack_mask`` on the sum of the same S int32 partial dots (the mesh
join's epilogue, ``apsim_tpu/ops/panel_mesh.py:183-213``): ``gb``, ``g64``
and the three counts bit for bit, on a seeded corpus whose threshold is
the bound value of one of its cells, for a diagonal and an off-diagonal
panel pair.  The row slices a mesh over several cards compacts one each
give, concatenated in slice order, the whole rectangle's candidate lists
in order.  Tolerance: none (every comparison is exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsim_tpu.ops.pallas_score import bitpack_mask as jax_bitpack_mask
from apsim_tpu.ops.panel import int8_bound_mask as jax_int8_bound_mask
from apsim_tpu_torch.ops import panel_mesh
from apsim_tpu_torch.ops import tri_score as ts
from apsim_tpu_torch.parallel.collectives import gather_rows

CPU = torch.device("cpu")
RB = 256  # rows of a panel
DIM = 512  # columns of the corpus, split over the shards


def corpus(seed: int, n: int):
    """``n`` sparse rows with duplicates and near-duplicates (so high
    scores exist), quantized: int8 rows and their aux table."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, DIM), np.float32)
    for r in range(n):
        cols = rng.choice(DIM, size=rng.integers(4, 40), replace=False)
        x[r, cols] = rng.random(cols.size, dtype=np.float32) + 0.05
    for r in range(0, n, 9):  # a near-duplicate of a row 3 panels up
        x[r] = x[(r * 7) % n] * np.float32(1.5)
        x[r, r % DIM] += np.float32(0.3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q, aux = ts.quantize_rows(torch.from_numpy(x))
    return q.numpy(), aux.numpy()


def partials(qi, qj, n_parts: int):
    """The shards' int32 partial dots: shard s holds the columns
    ``[s * DIM / S, (s + 1) * DIM / S)``, as the chunked mesh's slabs."""
    w = DIM // n_parts
    return [(qi[:, s * w:(s + 1) * w].astype(np.int64)
             @ qj[:, s * w:(s + 1) * w].astype(np.int64).T).astype(np.int32)
            for s in range(n_parts)]


def bound_values(d, ai, aj):
    """The epilogue's ``s_hat + bound`` in numpy float32, in the JAX
    kernels' operation order (no fused multiply-add)."""
    a_i, b_i, n_i = (ai[k][:, None] for k in range(3))
    a_j, b_j, n_j = (aj[k][None, :] for k in range(3))
    aa = a_i * a_j
    s_hat = d.astype(np.float32) * aa
    bound = (np.float32(0.5) * (a_j * b_i + a_i * b_j)
             + np.float32(0.25) * aa * np.minimum(n_i, n_j))
    return s_hat + bound


PAIRS = {"diagonal": (RB, RB), "off_diagonal": (0, 2 * RB)}


def pair_operands(pair: str, n_parts: int):
    """``(parts, aux_i, aux_j, row0, col0, tau_eff)`` of one panel pair of
    a 768-row corpus; ``tau_eff`` is the bound value of a strict-upper cell
    near the top 4 % of the pair's, so cells lie exactly at it."""
    q, aux = corpus(41, 3 * RB)
    row0, col0 = PAIRS[pair]
    qi, qj = q[row0:row0 + RB], q[col0:col0 + RB]
    ai, aj = aux[:, row0:row0 + RB], aux[:, col0:col0 + RB]
    parts = partials(qi, qj, n_parts)
    v = bound_values(sum(p.astype(np.int64) for p in parts).astype(
        np.int32), ai, aj)
    upper = (row0 + np.arange(RB))[:, None] < (col0 + np.arange(RB))[None]
    tau = np.sort(v[upper])[int(0.96 * upper.sum())]
    assert (v[upper] == tau).any()
    return (parts, np.ascontiguousarray(ai), np.ascontiguousarray(aj), row0,
            col0, float(tau))


def jax_bits(parts, ai, aj, row0: int, col0: int, tau: float):
    """The JAX mesh join's epilogue on the summed partials: gb, g64 and
    the counts (pairs, hit groups, hit supers)."""
    d = jnp.asarray(sum(p.astype(np.int64) for p in parts).astype(np.int32))
    rows = row0 + jnp.arange(RB, dtype=jnp.int32)[:, None]
    cols = col0 + jnp.arange(RB, dtype=jnp.int32)[None, :]
    mi = jax_int8_bound_mask(d, jnp.asarray(ai), jnp.asarray(aj), rows, cols,
                             jnp.float32(tau)).astype(jnp.int32)
    gbi, g_any, g64i = jax_bitpack_mask(mi)
    cnt = [int(mi.sum()), int(g_any.sum()), int(g64i.sum())]
    return np.asarray(gbi).astype(np.uint8), np.asarray(g64i).astype(
        np.uint8), cnt


def as_torch(parts, ai, aj):
    return ([torch.from_numpy(p) for p in parts], torch.from_numpy(ai),
            torch.from_numpy(aj))


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("n_parts", [1, 2, 4, 8])
def test_plain_equals_jax_epilogue(n_parts, pair, chunked, monkeypatch):
    """The plain version (whole slice, or one super-group a chunk) equals
    the JAX mesh join's bound mask + bit-pack on the sum of S partials,
    bit for bit, with cells exactly at ``tau_eff`` admitted and the
    diagonal's ``row == col`` cells left out."""
    parts, ai, aj, row0, col0, tau = pair_operands(pair, n_parts)
    want_gb, want_g64, want_cnt = jax_bits(parts, ai, aj, row0, col0, tau)
    if chunked:
        monkeypatch.setattr(panel_mesh, "EPILOGUE_CELLS", 1)
    tp, tai, taj = as_torch(parts, ai, aj)
    before = dict(ts.LAUNCHES)
    gb, g64, cnt = panel_mesh.pair_bits_int8(tp, tai, taj, row0, col0, tau)
    assert ts.LAUNCHES == before  # CPU tensors: the plain version
    assert gb.dtype == g64.dtype == torch.uint8 and cnt.dtype == torch.int64
    assert tuple(gb.shape) == (1, RB // 8, RB)
    assert tuple(g64.shape) == (1, RB // 64, RB) and tuple(cnt.shape) == (
        1, 3)
    assert np.array_equal(gb[0].numpy(), want_gb)
    assert np.array_equal(g64[0].numpy(), want_g64)
    assert cnt[0].tolist() == want_cnt and want_cnt[0] > 50
    hits = ts.unpack_bits(gb)[0].numpy()
    d = sum(p.astype(np.int64) for p in parts).astype(np.int32)
    v = bound_values(d, ai, aj)
    rows = row0 + np.arange(RB)[:, None]
    cols = col0 + np.arange(RB)[None, :]
    at_tau = (v == np.float32(tau)) & (rows < cols)
    assert at_tau.any() and hits[at_tau].all()
    if pair == "diagonal":
        assert not hits[rows >= cols].any()
        assert ((v >= np.float32(tau)) & (rows >= cols)).any()
    for out, ref in zip((gb, g64, cnt), panel_mesh.pair_bits_int8_plain(
            tp, tai, taj, row0, col0, tau)):
        assert torch.equal(out, ref)


def whole_and_sliced(rb: int, n: int):
    """An off-diagonal pair of ``rb``-row panels (two shards): its
    candidate lists from the whole rectangle, from ``n`` row slices, and
    through the compaction of the one-block layout the join used before
    the slices (block ids ``(row0 // rb, col0 // rb)``)."""
    q, aux = corpus(7, 2 * rb)
    row0, col0 = 0, rb
    parts = partials(q[:rb], q[rb:], 2)
    ai, aj = aux[:, :rb].copy(), aux[:, rb:].copy()
    v = bound_values(sum(p.astype(np.int64) for p in parts).astype(
        np.int32), ai, aj)
    tau = float(np.sort(v.ravel())[int(0.97 * v.size)])
    tp, tai, taj = as_torch(parts, ai, aj)
    whole = panel_mesh.pair_candidates([tp], [(0, rb)], [CPU], tai, taj,
                                       row0, col0, rb, tau, CPU)
    bounds = [ab for ab in panel_mesh.row_slices(rb, n) if ab[1] > ab[0]]
    placed = gather_rows(tp, bounds, [CPU] * len(bounds))
    sliced = panel_mesh.pair_candidates(placed, bounds, [CPU] * len(bounds),
                                        tai, taj, row0, col0, rb, tau, CPU)
    gb, g64, cnt = panel_mesh.pair_bits_int8_plain(tp, tai, taj, row0, col0,
                                                   tau)
    blk = torch.tensor([row0 // rb], dtype=torch.int32)
    blk_j = torch.tensor([col0 // rb], dtype=torch.int32)
    one_block = ts.compact_bits(gb, g64, cnt, blk, blk_j, rb, rb)
    return whole, sliced, one_block, bounds


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("rb", [384, 1024, 1088])
def test_row_slices_compact_to_the_whole_rectangle(rb, n):
    """The slices' lists, concatenated in slice order, are the whole
    rectangle's, in order, and the whole rectangle's are those of the
    one-block compaction: 384 rows (6 super-groups, 4 slices of 1, 2, 1, 2),
    1,024 (two 512-row cells: the pre-level in each slice; 3 or 4 slices
    leave some empty), 1,088 (17 super-groups, no pre-level: 2 slices cut
    a 512-row slice that must still take the super-group scan)."""
    whole, sliced, one_block, bounds = whole_and_sliced(rb, n)
    for a, b, c in zip(whole, sliced, one_block):
        assert a.dtype == b.dtype == torch.int64
        assert torch.equal(a, b) and torch.equal(a, c)
    assert whole[0].numel() > 100
    assert bounds[0][0] == 0 and bounds[-1][1] == rb
    assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))
    unit = 512 if rb % 512 == 0 else 64
    assert all((b - a) % unit == 0 for a, b in bounds)
    assert len(bounds) == min(n, rb // unit)
    # the lists run by (cell or super, column, row): not row-sorted
    rows = whole[0].numpy()
    assert (np.diff(rows) < 0).any()


def test_row_slices_balance():
    assert panel_mesh.row_slices(16384, 4) == [
        (0, 4096), (4096, 8192), (8192, 12288), (12288, 16384)]
    assert panel_mesh.row_slices(384, 4) == [(0, 64), (64, 192), (192, 256),
                                            (256, 384)]
    assert panel_mesh.row_slices(1024, 3) == [(0, 0), (0, 512), (512, 1024)]
    assert panel_mesh.row_slices(8192, 1) == [(0, 8192)]


def test_gather_rows_views_in_place_and_copies_elsewhere():
    """A part already on its slice's device is a view of its rows (no
    copy); the slices hold every part's rows in shard order."""
    parts = [torch.arange(64 * 8, dtype=torch.int32).reshape(64, 8) + k
             for k in range(3)]
    placed = gather_rows(parts, [(0, 16), (16, 64)], [CPU, CPU])
    assert len(placed) == 2 and all(len(ps) == 3 for ps in placed)
    for k, p in enumerate(parts):
        assert placed[0][k].data_ptr() == p.data_ptr()
        assert placed[1][k].data_ptr() == p[16:].data_ptr()
        assert torch.equal(torch.cat([placed[0][k], placed[1][k]]), p)
        assert placed[1][k].is_contiguous()


def test_compact_bits_pre_level_needs_whole_cells():
    gb = torch.zeros((1, 64 // 8, 128), dtype=torch.uint8)
    g64 = torch.zeros((1, 1, 128), dtype=torch.uint8)
    cnt = torch.zeros((1, 3), dtype=torch.int64)
    zero = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="512-row cells"):
        ts.compact_bits(gb, g64, cnt, zero, zero, 64, 128, pre_level=True)
    r, c = ts.compact_bits(gb, g64, cnt, zero, zero, 64, 128,
                           pre_level=False)
    assert r.numel() == c.numel() == 0


BAD = {
    "rows": lambda p, a, b: ([x[:32].contiguous() for x in p],
                             a[:, :32].contiguous(), b),
    "dtype": lambda p, a, b: ([x.to(torch.int64) for x in p], a, b),
    "shapes": lambda p, a, b: (p[:1] + [p[1][:, :128].contiguous()], a, b),
    "too_many": lambda p, a, b: (p * 33, a, b),
    "aux": lambda p, a, b: (p, a[:2].contiguous(), b),
    "strided": lambda p, a, b: ([x.t() for x in p], a, b),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_pair_bits_refuses_what_the_kernel_cannot_take(bad):
    parts, ai, aj, row0, col0, tau = pair_operands("off_diagonal", 2)
    args = BAD[bad](*as_torch(parts, ai, aj))
    with pytest.raises(ValueError):
        panel_mesh.pair_bits_int8(*args, row0, col0, tau)
