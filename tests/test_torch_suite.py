"""The port's benchmark suite (``apsim_tpu_torch.bench.suite``) on the CPU,
beside the JAX package's on the same corpora (``tests/test_suite.py``'s
cases), and the CLI's ``bench-suite``.

Tolerances: every pair count and pair set is compared exactly; every
parity flag must be true; times are never compared.
"""

import json
import sys

import numpy as np
import pytest

from apsim_tpu.bench import suite as jax_suite
from apsim_tpu_torch.bench import suite
from apsim_tpu_torch.cli import main as cli_main
from apsim_tpu_torch.vector.batch import CSRMatrix

from oracle import random_sparse_corpus


def to_pt(csr):
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                     csr.data)


def test_suite_small():
    rng = np.random.default_rng(17)
    csr = random_sparse_corpus(rng, 96, 300)
    ids = [str(i) for i in range(csr.n_rows)]
    kw = dict(taus=(0.5, 0.7), stream_batch=17, topk_queries=8, mesh=True)
    want = jax_suite.run_suite(csr, ids, **kw)
    report = suite.run_suite(to_pt(csr), ids, device="cpu",
                             mesh_devices=["cpu"] * 8, **kw)
    assert suite.failures(report) == [], suite.failures(report)
    for tau, entry in report["threshold_sweep"].items():
        assert entry["parity_full"], tau
        assert entry["pairs"] == want["threshold_sweep"][tau]["pairs"], tau
    assert report["streaming"]["equals_batch_join"]
    assert (report["streaming"]["results_emitted"]
            == want["streaming"]["results_emitted"])
    assert report["topk"]["self_match_rate"] == 1.0
    assert report["mesh"]["matches_single_device"]
    assert report["mesh"]["devices"] == 8
    assert report["mesh"]["pairs"] == want["mesh"]["pairs"]
    # the second corpus shape: the same pairs as the JAX package's leg
    for key, leg in report["rcv1_shape"].items():
        if key.startswith("tau_"):
            assert leg["dense_parity"] and leg["chunked_parity"], key
            assert leg["pairs"] == want["rcv1_shape"][key]["pairs"], key
    # the CC_WEB loadgen leg ran end-to-end (no swallowed error)
    lg = report["ccweb_loadgen"]
    assert "error" not in lg, lg
    assert lg["messages"] > 0 and lg["avg_latency_ms"] > 0
    assert lg["indexed_after_warmup"] == lg["fixture_vectors"]
    assert lg["indexed_after_warmup"] == (
        want["ccweb_loadgen"]["indexed_after_warmup"])
    json.dumps(report)  # the report is plain JSON


def test_rcv1_shape_leg_parity():
    out = suite._rcv1_shape_leg(512, (0.8,), device="cpu")
    want = jax_suite._rcv1_shape_leg(n_rows=512, taus=(0.8,))
    leg = out["tau_0.8"]
    assert leg["dense_parity"] and leg["chunked_parity"], out
    assert leg["pairs"] == want["tau_0.8"]["pairs"]
    assert leg["pairs"] >= 2  # the 1% dup injection guarantees sim≈1 pairs
    assert out["nnz"] == want["nnz"]


@pytest.mark.parametrize("scipy_ok", [True, False],
                         ids=["scipy", "numpy_fallback"])
def test_oracle_pairs_match_jax(scipy_ok, monkeypatch):
    rng = np.random.default_rng(21)
    csr = random_sparse_corpus(rng, 150, 400)
    wants = {(tau, limit): jax_suite._oracle_pairs(csr, tau, limit)
             for tau in (0.4, 0.7) for limit in (None, 90)}
    if not scipy_ok:
        monkeypatch.setitem(sys.modules, "scipy.sparse", None)
        with pytest.raises(ImportError):
            import scipy.sparse  # noqa: F401
    pt_csr = to_pt(csr)
    for (tau, limit), (want, m) in wants.items():
        got, got_m = suite._oracle_pairs(pt_csr, tau, limit)
        assert got_m == m
        assert got == want, (tau, limit)
    assert any(len(w) for w, _ in wants.values())


CLEAN = {"threshold_sweep": {"0.8": {"parity_full": True}},
         "streaming": {"equals_batch_join": True},
         "topk": {"self_match_rate": 1.0},
         "rcv1_shape": {"tau_0.8": {"dense_parity": True,
                                    "chunked_parity": True}},
         "ccweb_loadgen": {"messages": 32},
         "mesh": {"matches_single_device": True}}


def _with(path, value):
    rep = json.loads(json.dumps(CLEAN))
    node = rep
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return rep


@pytest.mark.parametrize("report, rc", [
    (CLEAN, 0),
    (_with(("rcv1_shape",), {"error": "RuntimeError('boom')"}), 1),
    (_with(("ccweb_loadgen",), {"error": "OSError()"}), 1),
    (_with(("threshold_sweep", "0.8", "parity_full"), False), 1),
    (_with(("rcv1_shape", "tau_0.8", "chunked_parity"), False), 1),
    (_with(("streaming", "equals_batch_join"), False), 1),
    (_with(("mesh", "matches_single_device"), False), 1),
    (_with(("topk", "self_match_rate"), 0.5), 1),
], ids=["clean", "rcv1_error", "ccweb_error", "sweep_parity", "rcv1_parity",
        "streaming", "mesh", "topk"])
def test_cli_bench_suite(report, rc, monkeypatch, capsys):
    """``bench-suite --device cpu`` runs the suite on the CPU (the mesh
    over the CPU) on the synthetic corpus of Enron's row count, prints the
    report and exits non-zero when a leg holds ``"error"`` or a check
    fails."""
    seen = {}

    def stub(csr, ids, **kw):
        seen.update(kw, n_rows=csr.n_rows, n_ids=len(ids))
        return json.loads(json.dumps(report))

    monkeypatch.setattr(suite, "run_suite", stub)
    assert cli_main(["bench-suite", "--device", "cpu"]) == rc
    assert seen == {"device": "cpu", "mesh_devices": ["cpu"],
                    "n_rows": 8586, "n_ids": 8586}
    out = json.loads(capsys.readouterr().out)
    assert out["corpus"] == "synthetic_corpus(8586, seed=0)"
    assert bool(out["failures"]) == bool(rc)
