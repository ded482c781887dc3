"""Kernel 6 of the port (``panel_mesh.pair_bits_f32``, the bf16 and fp32
stripe joins' summed-partial epilogue), kernel 5 on the int8 stripes, and
the row-sliced stripe join around them, on the CPU, where the wrappers run
their plain versions.

The plain version of kernel 6 is held against the JAX package's
``join_epilogue_bits`` (``apsim_tpu/ops/chunked.py:288``) on the left to
right sum of S seeded fp32 partial stripes (numpy adds them for JAX, as
the mesh's ``psum`` chain adds them): ``gb``, ``g64`` and the three counts
bit for bit against ``pallas_score.bitpack_mask`` of the JAX mask, and the
candidate lists, in order, against the JAX compaction's.  The int8 stripe
epilogue through kernel 5's plain version is held against the JAX
``int8_join_epilogue`` (``:547``) the same way.  A stripe cut into row
slices of its live rows (the strict-upper row cut) compacts to the whole
stripe's lists, in order.  Every threshold is the value of a strict-upper
cell, so cells lie exactly at it.  Tolerance: none (every comparison is
exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsim_tpu.ops import chunked as jax_chunked
from apsim_tpu.ops import pallas_score as jax_ps
from apsim_tpu.ops.panel import int8_bound_mask as jax_int8_bound_mask
from apsim_tpu_torch.ops import chunked as chunked_ops
from apsim_tpu_torch.ops import chunked_mesh as cm_ops
from apsim_tpu_torch.ops import panel_mesh
from apsim_tpu_torch.ops import tri_score as ts
from apsim_tpu_torch.parallel import make_mesh
from apsim_tpu_torch.parallel.collectives import gather_rows

CPU = torch.device("cpu")
ROW_CAP = 1024  # a multiple of 512: the compaction's pre-level
TILE = 256  # the stripe width
DIM = 512  # columns of the int8 corpus
CAP = 1 << 16  # the JAX compaction's capacities


def tau_at(v: np.ndarray, q0: int, quantile: float) -> float:
    """The value of a strict-upper cell of the stripe at ``q0`` near
    ``quantile`` of them, so that cells lie exactly at the threshold."""
    rows = np.arange(v.shape[0])[:, None]
    cols = q0 + np.arange(v.shape[1])[None, :]
    upper = np.sort(v[rows < cols])
    return float(upper[int(quantile * upper.size)])


def f32_parts(n_parts: int, q0: int, rows: int = ROW_CAP):
    """``n_parts`` seeded fp32 partial stripes ``[rows, TILE]`` (scores
    spread about 0.5, so their sums cross the threshold), their left to
    right numpy sum and a threshold at one of its strict-upper cells."""
    rng = np.random.default_rng(100 * n_parts + q0)
    parts = [rng.normal(0.5 / n_parts, 0.2, (rows, TILE)).astype(np.float32)
             for _ in range(n_parts)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return parts, total, tau_at(total, q0, 0.97)


def jax_lists(out) -> tuple:
    """The candidate lists of a JAX stripe epilogue, in its order."""
    rows, cols, total, _, _ = jax_ps.unpack_pallas_head(np.asarray(out[1]))
    assert total <= CAP
    return rows[:total].tolist(), cols[:total].tolist()


def jax_bits(mask) -> tuple:
    """``bitpack_mask`` of a JAX hit mask: gb, g64 and the counts."""
    mi = jnp.asarray(mask).astype(jnp.int32)
    gbi, g_any, g64i = jax_ps.bitpack_mask(mi)
    return (np.asarray(gbi).astype(np.uint8), np.asarray(g64i).astype(
        np.uint8), [int(mi.sum()), int(g_any.sum()), int(g64i.sum())])


def jax_caps() -> tuple:
    capb = jax_ps.capb_for(CAP, jax_ps.GROUP)
    return CAP, capb, capb


def upper_mask(rows: int, q0: int) -> np.ndarray:
    return (np.arange(rows)[:, None] < q0 + np.arange(TILE)[None, :])


def assert_bits(got, want) -> None:
    gb, g64, cnt = got
    assert gb.dtype == g64.dtype == torch.uint8 and cnt.dtype == torch.int64
    assert np.array_equal(gb[0].numpy(), want[0])
    assert np.array_equal(g64[0].numpy(), want[1])
    assert cnt[0].tolist() == want[2]


@pytest.mark.parametrize("q0", [0, 256, 768])
@pytest.mark.parametrize("n_parts", [1, 2, 4, 8])
def test_pair_bits_f32_plain_equals_jax_epilogue(n_parts, q0):
    """Kernel 6's plain version over the whole stripe equals the JAX
    stripe epilogue's bit-pack of ``sum >= tau_eff`` and the strict upper
    mask, bit for bit; the stripe's candidate lists (one stripe of S
    shards, summed where the rows live) equal the JAX compaction's, in
    order; cells at ``tau_eff`` are admitted, cells on or below the
    diagonal never."""
    parts, total, tau = f32_parts(n_parts, q0)
    mask = (total >= np.float32(tau)) & upper_mask(ROW_CAP, q0)
    want_bits = jax_bits(mask)
    want = jax_lists(jax_chunked.join_epilogue_bits(
        jnp.asarray(total), q0, jnp.float32(tau), *jax_caps()))
    tp = [torch.from_numpy(p) for p in parts]
    before = dict(ts.LAUNCHES)
    bits = panel_mesh.pair_bits_f32(tp, 0, q0, tau)
    assert ts.LAUNCHES == before  # CPU tensors: the plain version
    assert_bits(bits, want_bits)
    assert want_bits[2][0] > 100
    at_tau = (total == np.float32(tau)) & upper_mask(ROW_CAP, q0)
    hits = ts.unpack_bits(bits[0])[0].numpy()
    assert at_tau.any() and hits[at_tau].all()
    assert not hits[~upper_mask(ROW_CAP, q0)].any()
    if n_parts == 1:
        got = chunked_ops.join_epilogue_bits(tp[0], q0, tau)
    else:
        got = cm_ops._stripe_where_rows_live(
            make_mesh(n_parts, devices=[CPU] * n_parts), tp, None, q0, tau,
            None)
    assert got[0].dtype == got[1].dtype == torch.int64
    assert (got[0].tolist(), got[1].tolist()) == want


def int8_stripe(q0: int, n_parts: int):
    """A seeded int8 corpus of ``ROW_CAP`` rows with near-duplicates, its
    aux table, the stripe's S int32 partial dots (shard s: columns ``[s *
    DIM / S, (s + 1) * DIM / S)``) and a threshold at the bound value of
    one of the summed stripe's strict-upper cells."""
    rng = np.random.default_rng(q0 + 7)
    x = np.zeros((ROW_CAP, DIM), np.float32)
    for r in range(ROW_CAP):
        cols = rng.choice(DIM, size=rng.integers(4, 40), replace=False)
        x[r, cols] = rng.random(cols.size, dtype=np.float32) + 0.05
    for r in range(0, ROW_CAP, 9):  # near-duplicates across the stripe
        x[r] = x[(r * 7) % ROW_CAP] * np.float32(1.5)
        x[r, r % DIM] += np.float32(0.3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q, aux = ts.quantize_rows(torch.from_numpy(x))
    q, aux = q.numpy().astype(np.int64), aux.numpy()
    w = DIM // n_parts
    parts = [(q[:, s * w:(s + 1) * w] @ q[q0:q0 + TILE, s * w:(s + 1) * w].T)
             .astype(np.int32) for s in range(n_parts)]
    d = sum(p.astype(np.int64) for p in parts).astype(np.int32)
    aj = aux[:, q0:q0 + TILE]
    v = ts.int8_bound_value(
        torch.from_numpy(d), *(torch.from_numpy(aux[k][:, None])
                               for k in range(3)),
        *(torch.from_numpy(aj[k][None]) for k in range(3))).numpy()
    return parts, d, aux, tau_at(v, q0, 0.96), v


@pytest.mark.parametrize("q0", [0, 512, 768])
@pytest.mark.parametrize("n_parts", [1, 4])
def test_int8_join_epilogue_equals_jax(n_parts, q0):
    """The int8 stripe epilogue through kernel 5's plain version (the
    whole stripe's bits, then the stripe's lists on one device and summed
    where the rows live over S shards) equals the JAX
    ``int8_join_epilogue``: the bound mask's bit-pack bit for bit, the
    lists in order."""
    parts, d, aux, tau, v = int8_stripe(q0, n_parts)
    rows = jnp.arange(ROW_CAP, dtype=jnp.int32)[:, None]
    cols = q0 + jnp.arange(TILE, dtype=jnp.int32)[None, :]
    mask = jax_int8_bound_mask(
        jnp.asarray(d), jnp.asarray(aux), jnp.asarray(aux[:, q0:q0 + TILE]),
        rows, cols, jnp.float32(tau))
    want_bits = jax_bits(mask)
    want = jax_lists(jax_chunked.int8_join_epilogue(
        jnp.asarray(d), jnp.asarray(aux), q0, jnp.float32(tau), *jax_caps()))
    tp = [torch.from_numpy(p) for p in parts]
    taux = torch.from_numpy(aux)
    # the query side's aux is a column slice of the whole table's: read
    # with its row stride, no copy
    bits = panel_mesh.pair_bits_int8(tp, taux, taux[:, q0:q0 + TILE], 0, q0,
                                     tau)
    assert_bits(bits, want_bits)
    assert want_bits[2][0] > 20
    at_tau = (v == np.float32(tau)) & upper_mask(ROW_CAP, q0)
    assert at_tau.any() and ts.unpack_bits(bits[0])[0].numpy()[at_tau].all()
    got = chunked_ops.int8_join_epilogue(torch.from_numpy(d), taux, q0, tau)
    assert (got[0].tolist(), got[1].tolist()) == want
    mesh = make_mesh(n_parts, devices=[CPU] * n_parts)
    got = cm_ops._stripe_where_rows_live(mesh, tp, taux, q0, tau, None)
    assert (got[0].tolist(), got[1].tolist()) == want


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("row_cap,q0", [(1024, 0), (1024, 256), (1024, 768),
                                        (1280, 0), (1280, 1024)])
def test_stripe_slices_compact_to_the_whole_stripe(row_cap, q0, n):
    """A stripe's live rows cut into ``n`` row slices (one a card,
    ``card_slices``; placed by ``gather_rows``) compact to the lists of the
    whole ``(row_cap, TILE)`` block at ``bj = q0 / TILE``, in order: the
    rows cut off at ``stripe_live_rows`` hold no bit.  1,024 rows take the
    pre-level (512-row cells), 1,280 (20 super-groups) do not."""
    parts, total, tau = f32_parts(2, q0, row_cap)
    tp = [torch.from_numpy(p) for p in parts]
    gb, g64, cnt = panel_mesh.pair_bits_f32_plain(tp, 0, q0, tau)
    zero = torch.zeros(1, dtype=torch.int32)
    whole = ts.compact_bits(gb, g64, cnt, zero,
                            torch.tensor([q0 // TILE], dtype=torch.int32),
                            row_cap, TILE)
    assert whole[0].numel() > 100
    live = chunked_ops.stripe_live_rows(row_cap, q0, TILE)
    assert not ts.unpack_bits(gb)[0, live:].any()
    assert live < row_cap or q0 + TILE >= row_cap - TILE
    bounds, devices = panel_mesh.card_slices([f"cpu:{k}" for k in range(n)],
                                             live)
    assert bounds[0][0] == 0 and bounds[-1][1] == live
    unit = 512 if row_cap % 512 == 0 else 64
    assert all((b - a) % unit == 0 and b > a for a, b in bounds)
    placed = gather_rows(tp, bounds, [CPU] * len(bounds))
    got = chunked_ops.stripe_candidates(placed, bounds, [CPU] * len(bounds),
                                        None, q0, TILE, row_cap, tau, CPU)
    for a, b in zip(got, whole):
        assert a.dtype == torch.int64 and torch.equal(a, b)


def test_stripe_live_rows():
    """The rows of a stripe that can hold a hit, rounded up to the
    compaction's unit, worked by hand: ``row < q0 + col`` needs ``row <=
    q0 + TILE - 2``."""
    assert chunked_ops.stripe_live_rows(1024, 0, 256) == 512
    assert chunked_ops.stripe_live_rows(1024, 256, 256) == 512
    assert chunked_ops.stripe_live_rows(1024, 512, 256) == 1024
    assert chunked_ops.stripe_live_rows(1280, 0, 256) == 256
    assert chunked_ops.stripe_live_rows(1280, 768, 256) == 1024
    assert chunked_ops.stripe_live_rows(1280, 1024, 256) == 1280
    assert chunked_ops.stripe_live_rows(106496, 0, 8192) == 8192
    assert chunked_ops.stripe_live_rows(106496, 98304, 8192) == 106496
    assert chunked_ops.stripe_live_rows(64, 0, 64) == 64


def test_mesh_stripe_join_sums_where_the_rows_live(monkeypatch):
    """``mesh_stripe_extract`` on one process forms no stripe-sized sum:
    it places the live rows of every shard's partial (one slice: every
    shard on the one device) and runs kernel 6's wrapper once on the S
    partials; its lists equal the single-device epilogue of the left to
    right sum."""
    n_parts, q0 = 4, 256
    parts, total, tau = f32_parts(n_parts, q0)
    tp = [torch.from_numpy(p) for p in parts]
    calls = []
    real = panel_mesh.pair_bits_f32

    def spy(ps, row0, col0, tau_eff):
        calls.append((len(ps), ps[0].shape, row0, col0))
        return real(ps, row0, col0, tau_eff)

    monkeypatch.setattr(panel_mesh, "pair_bits_f32", spy)
    monkeypatch.setattr(cm_ops, "psum", None)  # no sum on one process
    mesh = make_mesh(n_parts, devices=[CPU] * n_parts)
    got = cm_ops._stripe_where_rows_live(mesh, tp, None, q0, tau, None)
    live = chunked_ops.stripe_live_rows(ROW_CAP, q0, TILE)
    assert calls == [(n_parts, (live, TILE), 0, q0)]
    want = chunked_ops.join_epilogue_bits(torch.from_numpy(total), q0, tau)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pair_bits_read_row_strided_partials():
    """A partial that is a column slice of a wider tensor (the int8
    stripes' product sliced to the stripe width) is taken with its row
    stride, and gives the contiguous copy's bits."""
    parts, _, tau = f32_parts(2, 256)
    wide = [torch.cat([torch.from_numpy(p), torch.zeros((ROW_CAP, 64))], 1)
            for p in parts]
    views = [w[:, :TILE] for w in wide]
    assert not views[0].is_contiguous()
    for a, b in zip(panel_mesh.pair_bits_f32(views, 0, 256, tau),
                    panel_mesh.pair_bits_f32(
                        [v.contiguous() for v in views], 0, 256, tau)):
        assert torch.equal(a, b)


BAD = {
    "rows": lambda p: [x[:32] for x in p],
    "dtype": lambda p: [x.double() for x in p],
    "int32": lambda p: [x.to(torch.int32) for x in p],
    "shapes": lambda p: p[:1] + [p[1][:, :128]],
    "none": lambda p: [],
    "too_many": lambda p: p * 33,
    "strided": lambda p: [x.t() for x in p],
    "one_dim": lambda p: [x.reshape(-1) for x in p],
    "meta": lambda p: p[:1] + [p[1].to("meta")],
}


@pytest.mark.parametrize("bad", list(BAD))
def test_pair_bits_f32_refuses_what_the_kernel_cannot_take(bad):
    """Kernel 6's refusals mirror kernel 5's: 1 to 64 fp32 partials of
    one 2-D shape with contiguous rows on one device, rows whole
    super-groups; the global offsets within int32."""
    parts, _, tau = f32_parts(2, 256, 256)
    tp = [torch.from_numpy(p) for p in parts]
    with pytest.raises(ValueError):
        panel_mesh.pair_bits_f32(BAD[bad](tp), 0, 256, tau)
    with pytest.raises(ValueError):
        panel_mesh.pair_bits_f32_plain(BAD[bad](tp), 0, 256, tau)


@pytest.mark.parametrize("offsets", [(-64, 0), (0, -1), (2**31 - 128, 0),
                                     (0, 2**31 - 200)])
def test_pair_bits_refuse_offsets_past_int32(offsets):
    parts, _, tau = f32_parts(1, 0, 256)
    tp = [torch.from_numpy(p) for p in parts]
    with pytest.raises(ValueError, match="offsets"):
        panel_mesh.pair_bits_f32(tp, *offsets, tau)


def test_stripe_ab_reports_each_leg_on_cpu(tmp_path):
    """``bench/stripe_ab.py`` on the CPU at a few hundred rows: the corpus
    written once, every leg's joins with the stripes' launches (none on
    the CPU), stage split and one digest for the one pair set."""
    from apsim_tpu_torch.bench import stripe_ab

    path = str(tmp_path / "corpus.npz")
    stripe_ab.main([path, "600", "--make", "--seed", "3"])
    out = stripe_ab.main([path, "--legs", "bf16,highest,int8,mesh2,"
                          "mesh2_int8", "--joins", "1", "--device", "cpu"])
    legs = out["legs"]
    assert out["rows"] == 600 and list(legs) == [
        "bf16", "highest", "int8", "mesh2", "mesh2_int8"]
    assert len({r["digest"] for r in legs.values()}) == 1
    assert len({r["pairs"] for r in legs.values()}) == 1
    for leg, r in legs.items():
        assert r["int8"] is leg.endswith("int8") and len(r["join_s"]) == 1
        assert not any(r["launches"].values())
        assert r["stages_s"]["epilogue"] > 0 and r["stripes"] >= 1
    assert "reduce" in legs["mesh2"]["stages_s"]
    with pytest.raises(ValueError, match="unknown leg"):
        stripe_ab.main([path, "--legs", "panel", "--device", "cpu"])
