"""The port's schedule and slab studies (``apsim_tpu_torch.bench``:
``tri_probe``, ``mesh_tri_probe``, ``ell_probe``) against the JAX
package's on the CPU, and ``mesh_allpairs_extract``'s two modes against
``score.allpairs_extract``.

The JAX studies run in process on the conftest's 8 virtual CPU devices;
the port's run with ``--device cpu`` and, where the JAX study shards, a
mesh of 8 CPU shards.  Tolerances: sizes, closed-form counts, pair and
candidate sets, ELL arrays and counts are compared exactly; times are only
required to be positive.  Where a score is compared with a tolerance, the
test says why.
"""

import json
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsim_tpu.bench import ell_probe as jax_ell_probe
from apsim_tpu.bench import mesh_tri_probe as jax_mesh_tri_probe
from apsim_tpu.bench import tri_probe as jax_tri_probe
from apsim_tpu.bench.scale import synthetic_corpus as jax_synthetic_corpus
from apsim_tpu.ops import score as jax_score
from apsim_tpu_torch.bench import ell_probe, mesh_tri_probe, tri_probe
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import mesh_score
from apsim_tpu_torch.ops import score as score_ops

CPU = torch.device("cpu")


def run_jax_main(mod, argv, monkeypatch, capsys) -> str:
    """A JAX study's ``main()`` in process with ``sys.argv = argv``; its
    standard output."""
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def last_json(out: str) -> dict:
    """The indented JSON object that ends a study's output."""
    lines = out.splitlines()
    return json.loads("\n".join(lines[lines.index("{"):]))


# ------------------------------------------------------------- tri_probe
def test_tri_probe_matches_jax(monkeypatch, capsys):
    want = last_json(run_jax_main(
        jax_tri_probe, ["tri_probe", "2048", "1024"], monkeypatch, capsys))
    got = tri_probe.main(["2048", "1024", "--device", "cpu",
                          "--shards", "8"])
    assert last_json(capsys.readouterr().out) == json.loads(json.dumps(got))
    for key in ("row_cap", "dim_cap", "tile", "parity", "modes",
                "flops_ratio_upper_vs_all", "n_devices"):
        assert got[key] == want[key], key
    assert got["parity"]["equal"] and got["n_devices"] == 8
    for key in ("shape", "tile"):
        assert got["wall_ms"][key] == want["wall_ms"][key], key
    assert got["wall_ms"]["backend"] == "cpu"
    assert got["wall_ms"]["all"] > 0 and got["wall_ms"]["upper"] > 0
    assert got["wall_speedup_upper_vs_all"] > 0


@pytest.mark.parametrize("mode", ["all", "upper"])
def test_tri_probe_parity_pairs_match_jax(mode):
    """Leg 1's pair sets equal JAX's ``allpairs_extract`` folded through
    the JAX study's own ``_pairs``."""
    got, _ = tri_probe.parity_pairs(CPU)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((1024, 512)).astype(np.float32)
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    want = jax_tri_probe._pairs(*jax_score.allpairs_extract(
        jnp.asarray(xs), jnp.float32(0.1), 256, 1 << 18, mode, "highest",
        8), mode)
    assert got[mode] == want and len(want) > 1000


@pytest.mark.parametrize("shards", [1, 4])
def test_tri_probe_accounting_closed_form(shards):
    """The closed form at the study's default size: "all" is the full
    rectangle, "upper" the bucket prefixes (``score.upper_buckets``)."""
    modes, ratio = tri_probe.accounting(8192, 16384, 1024, shards)
    upper = sum(2 * b1 * 1024 * 1024 * (16384 // shards) * (b1 - b0)
                for b0, b1 in score_ops.upper_buckets(8))
    assert modes["all"]["matmul_flops_per_device"] == (
        2 * 8192 * 8192 * 16384 // shards)
    assert modes["upper"]["matmul_flops_per_device"] == upper
    assert ratio == round(upper / (2 * 8192 * 8192 * 16384 // shards), 4)
    psum = modes["all"]["psum_bytes_per_device"]
    assert psum == (0 if shards == 1 else 8 * 8192 * 1024 * 4)


# -------------------------------------------------------- mesh_tri_probe
@pytest.mark.parametrize("n", [1024, 2048])
def test_mesh_tri_probe_matches_jax(n, monkeypatch, capsys):
    want = last_json(run_jax_main(
        jax_mesh_tri_probe, ["mesh_tri_probe", str(n)], monkeypatch, capsys))
    got = mesh_tri_probe.main([str(n), "--device", "cpu", "--shards", "8"])
    for key in ("n_rows", "devices", "row_cap", "dim_cap", "tile",
                "shard_axis"):
        assert got[key] == want[key], key
    for mode in ("upper", "all"):
        assert got[mode]["pairs_or_candidates"] == (
            want[mode]["pairs_or_candidates"]), mode
        # the dispatch counter saw every product, once
        assert got[mode]["flops"] == got[mode]["flops_closed_form"], mode
        assert got[mode]["flops_closed_form"] == (
            mesh_tri_probe.closed_form_flops(got["row_cap"], got["tile"],
                                             got["dim_cap"], mode, 8))
        assert got[mode]["copy_bytes"] == 0  # every shard on the CPU
        assert got[mode]["wall_s_median"] > 0
    assert got["folded_all_equals_upper"] is True
    if n == 1024:
        assert (got["upper"]["pairs_or_candidates"],
                got["all"]["pairs_or_candidates"]) == (21, 1066)
    ratio = got["flops_ratio_upper_over_rect"]
    assert ratio == got["upper"]["flops"] / got["all"]["flops"]
    assert ratio == (1.0 if got["row_cap"] == got["tile"] else 0.75)
    assert "cap" not in got["upper"]


def test_product_counter_counts_mm_and_copies():
    a = torch.ones(6, 4)
    b = torch.ones(5, 4)
    with mesh_tri_probe.ProductCounter() as pc:
        s = a @ b.T
        s.to("meta")
    assert pc.flops == 2 * 6 * 5 * 4
    assert pc.mm_bytes == (6 * 4 + 5 * 4 + 6 * 5) * 4
    assert pc.copy_bytes == 6 * 5 * 4


@pytest.fixture(scope="module")
def mesh_index():
    """A 256 x 512 row-normalised index and two thresholds at least 1e-4
    from every fp64 score, so the fp32 sums of either package agree on
    every cell."""
    rng = np.random.default_rng(21)
    x = (rng.random((256, 512)) * (rng.random((256, 512)) < 0.05)
         ).astype(np.float32)
    x[100:110] = x[0:10]  # duplicates: scores of 1 off the diagonal
    x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
    s64 = x.astype(np.float64) @ x.astype(np.float64).T
    taus = [t for t in np.arange(0.2, 0.9, 0.0731)
            if np.abs(s64 - t).min() >= 1e-4][:2]
    assert len(taus) == 2
    return x, taus


def jax_pairs(x, tau, mode):
    bufs, packed = jax_score.allpairs_extract(
        jnp.asarray(x), jnp.float32(tau), 64, 1 << 16, mode, "highest", 8)
    (rows, cols), _ = jax_score.consume_packed(bufs, np.asarray(packed),
                                               1 << 16, 8)
    return sorted(zip(rows.tolist(), cols.tolist()))


@pytest.mark.parametrize("grid", [(1, 8), (8, 1), (2, 4)],
                         ids=["dims", "rows", "2x4"])
def test_mesh_allpairs_modes_equal_jax(mesh_index, grid):
    x, taus = mesh_index
    nr, nd = grid
    hb, wb = x.shape[0] // nr, x.shape[1] // nd
    xt = torch.from_numpy(x)
    blocks = [xt[r * hb:(r + 1) * hb, d * wb:(d + 1) * wb].contiguous()
              for r in range(nr) for d in range(nd)]
    devices = (CPU,) * (nr * nd)
    for tau in taus:
        got = {}
        for mode in ("upper", "all", None):
            kw = {} if mode is None else {"mode": mode}
            found = mesh_score.mesh_allpairs_extract(
                blocks, grid, devices, tau, 64, "highest", 8, **kw)
            got[mode] = sorted((a, b) for r, c in found
                               for a, b in zip(r.tolist(), c.tolist()))
        assert got[None] == got["upper"] == jax_pairs(x, tau, "upper")
        assert got["all"] == jax_pairs(x, tau, "all")
        assert len(got["all"]) == 2 * len(got["upper"]) + x.shape[0]
        assert tri_probe.fold_pairs(*zip(*got["all"]), "all") == set(
            got["upper"])
    with pytest.raises(ValueError, match="unknown mode"):
        mesh_score.mesh_allpairs_extract(blocks, grid, devices, 0.5, 64,
                                         mode="lower")


# ------------------------------------------------------------- ell_probe
@pytest.fixture(scope="module")
def ell_corpus():
    """Both packages' 4,096-row corpora with dims compacted: the JAX
    study's in-place renumbering on its own copy, the port's on a copy."""
    jcsr = jax_synthetic_corpus(4096)
    uniq, inv = np.unique(jcsr.indices, return_inverse=True)
    jcsr.indices[:] = inv
    pcsr = synthetic_corpus(4096)
    before = pcsr.indices.copy()
    csr, n_dims = ell_probe.compact_dims(pcsr)
    assert np.array_equal(pcsr.indices, before)  # the caller's is untouched
    assert n_dims == uniq.size
    return jcsr, csr, n_dims


@pytest.mark.parametrize("K", [16, 64, 192])
def test_to_ell_matches_jax(ell_corpus, K):
    jcsr, csr, n_dims = ell_corpus
    want = jax_ell_probe.to_ell(jcsr, 4096, K, n_dims)
    got = ell_probe.to_ell(csr, 4096, K, n_dims)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_ell_probe_lines_match_jax(monkeypatch, capsys):
    """The ``corpus:`` and ``ELL K=`` lines, timings aside."""
    def lines(out):
        keep = [ln for ln in out.splitlines()
                if ln.startswith(("corpus:", "ELL K="))]
        return [re.sub(r"\d+\.\ds host build", "host build", ln)
                for ln in keep]

    want = lines(run_jax_main(
        jax_ell_probe, ["ell_probe", "4096", "64", "32"], monkeypatch,
        capsys))
    rec = ell_probe.main(["4096", "64", "32", "--device", "cpu"])
    got = lines(capsys.readouterr().out)
    assert len(want) == 2 and got == want
    assert list(rec["blocked_ms"]) == [2048]  # 8,192 does not divide 4,096
    assert rec["scan_ms"] > 0 and "gather_floor_ms" not in rec


def jax_formulations(idx, val, qd):
    """The JAX study's two closures (``apsim_tpu/bench/ell_probe.py:
    105-128``), returning their scores instead of counting them."""
    import jax

    def blocked(block):
        out = []
        for i in range(idx.shape[0] // block):
            ib = jax.lax.dynamic_slice_in_dim(idx, i * block, block, 0)
            vb = jax.lax.dynamic_slice_in_dim(val, i * block, block, 0)
            out.append(jnp.einsum("bk,bkq->bq", vb, qd[ib],
                                  preferred_element_type=jnp.float32))
        return np.asarray(jnp.concatenate(out))

    @jax.jit
    def scan(idx, val, qdm):
        def step(acc, k):
            acc = acc + val[:, k, None] * qdm[idx[:, k]]
            return acc, None
        acc0 = jnp.zeros((idx.shape[0], qdm.shape[1]), jnp.float32)
        acc, _ = jax.lax.scan(step, acc0, jnp.arange(idx.shape[1]))
        return acc

    return blocked(2048), np.asarray(scan(idx, val, qd))


def test_ell_contractions_match_jax(ell_corpus):
    """Both formulations at 4,096 rows, K 64, bs 32, block 2,048.  The
    scan keeps the compiled JAX scan's rounding order (the exact product
    of two bf16 values, then an fp32 add, k ascending), so its scores are
    equal bit for bit.  The blocked
    product's fp32 sums may run in another order than XLA's, so its scores
    are held to ``(K + 2) * 2^-24 * sum |terms|`` of an fp64 reference
    (the rounding bound of an fp32 sum of K exact bf16 products, any
    order) and its counts to JAX's exactly, at the study's tau 0.8 (no
    hit at K 64: the rows are cut) and at a tau at least 1e-4 from every
    fp64 score."""
    _, csr, n_dims = ell_corpus
    K, bs, block = 64, 32, 2048
    idx_h, val_h, _ = ell_probe.to_ell(csr, 4096, K, n_dims)
    qd_h = ell_probe.query_dense(csr, bs, n_dims)
    idx, val = torch.from_numpy(idx_h), torch.from_numpy(val_h).bfloat16()
    qd = torch.from_numpy(qd_h).bfloat16()
    want_blocked, want_scan = jax_formulations(
        jnp.asarray(idx_h), jnp.asarray(val_h, jnp.bfloat16),
        jnp.asarray(qd_h, jnp.bfloat16))

    scan = ell_probe.ell_scan_scores(idx, val, qd).numpy()
    assert np.array_equal(scan.view(np.uint32), want_scan.view(np.uint32))

    v64 = val.double().numpy()
    g64 = qd.double().numpy()[idx_h]  # [rows, K, bs]
    s64 = np.einsum("rk,rkq->rq", v64, g64)
    bound = (K + 2) * 2.0 ** -24 * np.einsum("rk,rkq->rq", np.abs(v64),
                                             np.abs(g64))
    blocked = torch.cat([ell_probe.ell_block_scores(
        idx[i:i + block], val[i:i + block], qd) for i in (0, block)]).numpy()
    assert np.all(np.abs(blocked - s64) <= bound)
    assert np.all(np.abs(want_blocked - s64) <= bound)

    lo = [t for t in np.arange(0.3, 0.7, 0.0173)
          if np.abs(s64 - t).min() >= 1e-4][0]
    for tau in (0.8, lo):
        got = ell_probe.ell_match_blocked(idx, val, qd, block, tau)
        want = (want_blocked >= tau).reshape(2, block, bs).sum(axis=(1, 2))
        assert got.dtype == torch.int32
        assert got.tolist() == want.tolist()
        assert int(ell_probe.ell_match_scan(idx, val, qd, tau)) == int(
            (want_scan >= tau).sum())
    assert int(ell_probe.ell_match_scan(idx, val, qd, lo)) > 0


# ---------------------------------------------------- no CPU fallback
@pytest.mark.parametrize("study, argv", [
    (tri_probe, ["256", "256"]), (mesh_tri_probe, ["256"]),
    (ell_probe, ["256", "16", "8"])], ids=["tri", "mesh_tri", "ell"])
def test_studies_need_cuda_unless_told(study, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.main(argv + ["--device", "cuda"])
