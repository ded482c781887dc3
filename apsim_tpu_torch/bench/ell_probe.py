"""ELL-gather streaming-match study on the card: can a row-gather
contraction beat the chunked engine's match beyond the resident-slab
budget? (the counterpart of ``apsim_tpu/bench/ell_probe.py``).

Beyond ``match_slab_budget_mb`` the chunked engine matches a micro-batch on
its paneled route (on the card) or its rebuild route; dense resident slabs
cannot hold 500k x 32k in any byte format.  But the match only needs a
tau-margin superset of candidates (exactness comes from the host fp64
rescore of the shadow CSR), so the corpus can stay on the device in a
compact bounded-row form:

  ELL: idx [rows, K] int32 + val [rows, K] bf16
  match: S[r, q] = sum_k val[r, k] * Qd[idx[r, k], q]

i.e. densify only the query batch (``Qd [dims + 1, bs]``, a zero pad row
last) and contract through a row gather.  The gather materializes ``nnz x
bs`` bf16 values a batch, ``gather_floor_ms`` of the record: those bytes
over the card's memory rate (``mfu.card_peaks``; 3.35 TB/s on the H100
SXM).  Rows with nnz > K spill; spilled entries are counted here (an
integration would match them on a COO side path).

The two formulations of the JAX study, as functions on tensors:

  - ``ell_match_blocked``: per ``block`` rows, gather ``[block, K, bs]``
    and contract with one batched product of bf16 operands and fp32 sums
    (``bmm`` with ``out_dtype`` on the card, an fp32 product of the upcast
    operands on the CPU, exact for bf16); per-block int32 counts;
  - ``ell_match_scan``: a loop over k gathering ``[rows, bs]`` a step,
    each product of bf16 values added to an fp32 accumulator in k order;
    the count.  JAX writes the product ``val[:, k, None] * qdm[idx[:,
    k]]`` in bf16, but XLA folds its bf16 round trip into the fp32 add, so
    the compiled scan adds the exact product (fp32 holds the product of
    two bf16 values exactly); the port does the same in one
    ``addcmul_``, which makes its scores JAX's bit for bit on the CPU.

A block that does not divide ``n_rows`` is skipped, as in the JAX study
(so 100,000 rows run the scan only; 98,304 and 499,712 run all three
legs).  Timing: one warm call, then the median of 5 on the host clock, each
call ending in a synchronize.

Usage:  python -m apsim_tpu_torch.bench.ell_probe [n_rows] [K] [bs]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..vector.batch import CSRMatrix
from .mfu import card_peaks
from .scale import synthetic_corpus
from .tri_probe import device_name, study_device, timed_s

__all__ = ["BLOCKS", "compact_dims", "to_ell", "query_dense",
           "ell_block_scores", "ell_match_blocked", "ell_scan_scores",
           "ell_match_scan", "main"]

BLOCKS = (2048, 8192)


def compact_dims(csr: CSRMatrix):
    """``(copy of csr with its dims renumbered 0..n-1 in id order, n)``;
    the caller's matrix is left as it is."""
    uniq, inv = np.unique(csr.indices, return_inverse=True)
    out = CSRMatrix(csr.n_rows, int(uniq.size), csr.indptr.copy(),
                    inv.astype(csr.indices.dtype), csr.data.copy())
    return out, int(uniq.size)


def to_ell(csr, n_rows: int, K: int, compact_dims: int):
    """CSR -> ELL (idx, val, spilled_entries). Pad idx with ``compact_dims``
    (one past the last real dim — gathers read a zero pad row there).

    NOTE (timing probe only): rows with nnz > K keep their first K entries
    in dim-id order, NOT the K largest by |value|.  An ENGINE integration
    must keep top-|val| entries per row and route the spill to a COO
    side-match, otherwise high-weight entries spill arbitrarily and the
    tau-margin superset guarantee breaks.  For measuring the gather
    contraction's cost the entry choice is irrelevant."""
    idx = np.full((n_rows, K), compact_dims, np.int32)
    val = np.zeros((n_rows, K), np.float32)
    spilled = 0
    for r in range(n_rows):
        lo, hi = csr.indptr[r], csr.indptr[r + 1]
        k = min(hi - lo, K)
        spilled += (hi - lo) - k
        idx[r, :k] = csr.indices[lo : lo + k]
        val[r, :k] = csr.data[lo : lo + k]
    return idx, val, spilled


def query_dense(csr, bs: int, compact_dims: int) -> np.ndarray:
    """The first ``bs`` rows as the densified query ``[compact_dims + 1,
    bs]`` fp32 (the pad row zero)."""
    qd = np.zeros((compact_dims + 1, bs), np.float32)
    for j in range(bs):
        lo, hi = csr.indptr[j], csr.indptr[j + 1]
        qd[csr.indices[lo:hi], j] = csr.data[lo:hi]
    return qd


def ell_block_scores(idx: torch.Tensor, val: torch.Tensor,
                     qd: torch.Tensor) -> torch.Tensor:
    """fp32 ``[rows, bs]`` scores of ELL rows ``(idx, val)`` against the
    bf16 query ``qd``: the gathered ``[rows, K, bs]`` contracted over K,
    bf16 operands, fp32 sums (never a bf16 product, which would round the
    scores to bf16)."""
    g = qd.index_select(0, idx.reshape(-1)).view(*idx.shape, qd.shape[1])
    v = val[:, None, :]
    if qd.is_cuda:
        s = torch.bmm(v, g, out_dtype=torch.float32)
    else:
        s = torch.bmm(v.float(), g.float())
    return s[:, 0, :]


def ell_match_blocked(idx: torch.Tensor, val: torch.Tensor,
                      qd: torch.Tensor, block: int, tau: float):
    """Per-block int32 counts of scores >= ``tau``, ``block`` rows a
    block (``n_rows // block`` blocks)."""
    nb = idx.shape[0] // block
    out = torch.empty(nb, dtype=torch.int32, device=idx.device)
    for i in range(nb):
        sl = slice(i * block, (i + 1) * block)
        out[i] = (ell_block_scores(idx[sl], val[sl], qd) >= tau).sum()
    return out


def ell_scan_scores(idx: torch.Tensor, val: torch.Tensor,
                    qd: torch.Tensor) -> torch.Tensor:
    """fp32 ``[rows, bs]`` scores summed over k in ascending order, each
    step adding the exact product of its bf16 operands (JAX's compiled
    scan formulation)."""
    acc = torch.zeros((idx.shape[0], qd.shape[1]), dtype=torch.float32,
                      device=idx.device)
    for k in range(idx.shape[1]):
        acc.addcmul_(val[:, k, None], qd.index_select(0, idx[:, k]))
    return acc


def ell_match_scan(idx: torch.Tensor, val: torch.Tensor, qd: torch.Tensor,
                   tau: float) -> torch.Tensor:
    """The count of scan scores >= ``tau`` (a device scalar)."""
    return (ell_scan_scores(idx, val, qd) >= tau).sum()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="ell_probe")
    ap.add_argument("n_rows", type=int, nargs="?", default=100_000)
    ap.add_argument("K", type=int, nargs="?", default=192)
    ap.add_argument("bs", type=int, nargs="?", default=256)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (raises without CUDA)")
    args = ap.parse_args(argv)
    dev = study_device(args.device)
    n_rows, K, bs = args.n_rows, args.K, args.bs
    tau = 0.8

    csr, n_dims = compact_dims(synthetic_corpus(n_rows))
    nnz = int(csr.indices.size)
    print(f"corpus: {n_rows} rows, nnz={nnz}, compact_dims={n_dims}",
          flush=True)
    t0 = time.time()
    idx_h, val_h, spilled = to_ell(csr, n_rows, K, n_dims)
    print(
        f"ELL K={K}: {time.time() - t0:.1f}s host build, spilled "
        f"{spilled} entries ({spilled / nnz:.2%}), "
        f"device bytes="
        f"{(idx_h.nbytes + val_h.nbytes // 2) >> 20} MiB (idx int32 + "
        f"val bf16, the dtypes actually device-put below)",
        flush=True,
    )
    idx = torch.from_numpy(idx_h).to(dev)
    val = torch.from_numpy(val_h).to(dev, torch.bfloat16)
    qd = torch.from_numpy(query_dense(csr, bs, n_dims)).to(
        dev, torch.bfloat16)

    rec = {"n_rows": n_rows, "K": K, "bs": bs, "nnz": nnz,
           "compact_dims": n_dims, "spilled": int(spilled),
           "device": device_name(dev), "blocked_ms": {}}
    if dev.type == "cuda":
        rec["gather_floor_ms"] = ((nnz - spilled) * bs * 2
                                  / card_peaks(rec["device"])["hbm"] * 1e3)
    for block in BLOCKS:
        if n_rows % block:
            continue
        dt = timed_s(lambda: ell_match_blocked(idx, val, qd, block, tau), dev)
        rec["blocked_ms"][block] = dt * 1e3
        print(
            f"ell_blocked[{block}]: {dt * 1e3:8.1f} ms/batch "
            f"({bs / dt:7.0f} vec/s)", flush=True,
        )
    dt = timed_s(lambda: ell_match_scan(idx, val, qd, tau), dev)
    rec["scan_ms"] = dt * 1e3
    print(
        f"ell_scan:          {dt * 1e3:8.1f} ms/batch "
        f"({bs / dt:7.0f} vec/s)", flush=True,
    )
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
