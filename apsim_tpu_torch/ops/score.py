"""Dense-index device ops as torch ops (counterpart of
``apsim_tpu/ops/score.py``).

The index is a dense ``[row_cap, dim_cap]`` matrix over compact columns (see
``index/compact.py``) that lives on an explicit device.  Sparse rows reach it
as the flat packed COO of ``vector.batch.pack_coo_i32``.

``allpairs_extract`` is the full-rectangle join: the path of every index
the upper-triangle kernels refuse (``use_pallas="off"``,
``matmul_precision="highest"``, an untiled or oversized index).

The streaming ops serve ``Engine.insert``, ``topk`` and frozen matching:
``append_rows`` (a micro-batch's rows into the live index, in place),
``scatter_entries`` (dormant-dim activation), ``grow``,
``match_rows_extract`` (a batch against the index), ``densify_rows`` +
``queries_match_extract`` (external queries) and ``topk_scores``.  They are
plain functions on an explicit device: no caps, cursor, packed head or
shape buckets; compaction is exact-length ``torch.nonzero``.

Every score is **fp32** whatever the operands (``score_tile``): the
engine's margins (``Engine._margin_rel``) count operand rounding and fp32
accumulation, never a rounded score.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import tri_score as ts

__all__ = [
    "index_dtype", "new_index_matrix", "scatter_coo", "MIN_TAU_EFF",
    "true_fp32_matmul", "rounds_to_bf16", "score_operand", "score_tile",
    "upper_buckets", "allpairs_extract", "append_rows", "scatter_entries",
    "grow", "match_rows_extract", "densify_rows", "queries_match_extract",
    "topk_scores",
]

# floor for the device threshold: keeps all-zero (padded/invalid) rows out of
# the candidate set without any index arithmetic in the score epilogue
MIN_TAU_EFF = 1e-30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def index_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of the configured index dtype name."""
    return _DTYPES[dtype]


def new_index_matrix(
    row_cap: int, dim_cap: int, dtype: str, device: torch.device | str
) -> torch.Tensor:
    return torch.zeros((row_cap, dim_cap), dtype=_DTYPES[dtype], device=device)


def scatter_coo(x: torch.Tensor, coo: np.ndarray) -> torch.Tensor:
    """Write the entries of ONE packed ``[3, ecap]`` int32 COO array (rows /
    cols / fp32 value bits) into ``x`` in place and return it.

    Padding entries carry ``row == row_cap`` and are dropped
    (``_coo_entries``).  The caller guarantees unique (row, col) entries
    that land on zeros (a fresh index), so a plain assignment equals the
    JAX package's ``.add(unique_indices=True)``."""
    rows, cols, vals = _coo_entries(coo, x.shape[0], x.device, x.dtype)
    x.index_put_((rows, cols), vals)
    return x


def _coo_entries(coo: np.ndarray, n: int, device, dtype):
    """(rows, cols, vals) of a packed COO on ``device``, the entries whose
    row lies in ``[0, n)`` only: padding rows carry a row id ``>= n``, and
    torch has no scatter mode that drops them (XLA's drops them silently,
    ``index_put_`` raises)."""
    c = torch.from_numpy(coo).to(device)
    keep = c[0] < n
    return (c[0][keep].long(), c[1][keep].long(),
            c[2][keep].view(torch.float32).to(dtype))


# --------------------------------------------------------- streaming ops


def append_rows(x: torch.Tensor, coo: np.ndarray, s0: int) -> torch.Tensor:
    """Add a micro-batch's entries into ``x[s0:]`` in place and return
    ``x`` (``apsim_tpu/ops/score.py:scatter_rows_sliced``).

    ``coo`` is one packed ``[3, ecap]`` COO whose rows are LOCAL to ``s0``;
    padding entries carry a row ``>= row_cap - s0`` and are dropped.  The
    add touches only the batch's entries, so it costs O(batch nnz), never a
    pass over the index.  The caller guarantees unique (row, col) entries,
    so ``accumulate=True`` is the JAX ``.add(unique_indices=True)``."""
    rows, cols, vals = _coo_entries(coo, x.shape[0] - s0, x.device, x.dtype)
    x[s0:].index_put_((rows, cols), vals, accumulate=True)
    return x


def scatter_entries(x: torch.Tensor, rows: np.ndarray, cols: np.ndarray,
                    vals: np.ndarray) -> torch.Tensor:
    """Add arbitrary ``(row, col, val)`` host entries into ``x`` in place and
    return it (the dormant-dim activation's add into older rows,
    ``apsim_tpu/ops/score.py:scatter_entries``).  Raises ``ValueError`` on a
    repeated (row, col): an accumulating scatter would add the value twice,
    where the JAX scatter assumes ``unique_indices``."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    keys = rows * x.shape[1] + cols
    if np.unique(keys).size != keys.size:
        raise ValueError("scatter_entries: repeated (row, col) entries")
    r = torch.from_numpy(rows).to(x.device)
    c = torch.from_numpy(cols).to(x.device)
    v = torch.from_numpy(np.asarray(vals, np.float32)).to(x.device)
    x.index_put_((r, c), v.to(x.dtype), accumulate=True)
    return x


def grow(x: torch.Tensor, row_cap: int, dim_cap: int) -> torch.Tensor:
    """A new zero ``[row_cap, dim_cap]`` matrix with ``x`` in its top-left
    corner (capacity growth)."""
    out = torch.zeros((row_cap, dim_cap), dtype=x.dtype, device=x.device)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def match_rows_extract(xo: torch.Tensor, q: torch.Tensor, n0: int,
                       n_rows: int, tau_eff, precision: str, timer=None):
    """Candidates of a streamed batch against the index it has just joined
    (``match_tile_extract`` / ``insert_match_fused`` of the JAX package).

    ``xo`` is the index in the form ``score_tile`` multiplies
    (``score_operand``); ``q`` its rows from global row ``n0`` on, the
    batch (callers round its height up to a multiple of 8; the rows past
    ``n_rows`` are zero).  Scores ``xo[:n_rows] @ q^T`` (fp32) and returns
    device int64 ``(rows, cols)`` of every cell with ``s >= tau_eff`` and
    ``row != col``, ``cols`` as global row ids (``>= n0``).  Both directions
    of an intra-batch pair come out.

    The JAX op scores a whole static tile window; the window's other
    columns lie below ``n0`` (masked there) or are zero rows (score 0 <
    ``MIN_TAU_EFF``), so the candidate set is the same.  With a ``Timer``
    the product is timed as "product", mask and ``nonzero`` as "compact"."""
    with ts._section(timer, "product"):
        s = score_tile(xo[:n_rows], q, precision)
        if s.is_cuda and timer is not None:
            torch.cuda.synchronize(s.device)
    with ts._section(timer, "compact"):
        m = s >= float(tau_eff)
        k = min(q.shape[0], n_rows - n0)
        # the batch's own cells: row n0 + j against column j
        m[n0 + torch.arange(k, device=s.device),
          torch.arange(k, device=s.device)] = False
        hit = torch.nonzero(m)
    return hit[:, 0], hit[:, 1] + n0


def densify_rows(coo: np.ndarray, n: int, dim_cap: int, dtype,
                 device) -> torch.Tensor:
    """Dense ``[n, dim_cap]`` rows of ``dtype`` from one packed COO
    (padding rows carry ``n``): the on-device densify of the JAX package's
    ``queries_match_fused`` and ``topk_scores_fused``."""
    q = torch.zeros((n, dim_cap), dtype=dtype, device=device)
    rows, cols, vals = _coo_entries(coo, n, device, dtype)
    q.index_put_((rows, cols), vals, accumulate=True)
    return q


def queries_match_extract(xo: torch.Tensor, q: torch.Tensor, tau_eff,
                          precision: str):
    """Frozen-index match (``queries_match_fused`` / ``dense_queries_extract``):
    device int64 ``(index rows, query rows)`` of every cell of ``xo @ q^T``
    (fp32) with ``s >= tau_eff``.  ``q`` comes from ``densify_rows``."""
    hit = torch.nonzero(score_tile(xo, q, precision) >= float(tau_eff))
    return hit[:, 0], hit[:, 1]


def topk_scores(x: torch.Tensor, q: torch.Tensor, n_rows: int, k: int,
                precision: str = "highest"):
    """Top ``k`` scores per query row and their index rows, descending:
    ``(scores [nq, k] fp32, rows [nq, k] int64)``.  Rows ``>= n_rows`` are
    masked to ``-inf``; ``x`` may be cut to fewer rows than its capacity
    but must hold at least ``n_rows``.  ``torch.topk`` orders ties
    arbitrarily (``Engine.topk`` re-ranks in fp64)."""
    s = score_tile(q, x, precision)
    s[:, n_rows:] = -float("inf")
    return torch.topk(s, k, dim=1)


# ------------------------------------------------------ full-rectangle join


@contextlib.contextmanager
def true_fp32_matmul():
    """fp32 CUDA matmuls inside this block are true fp32 products: TF32 is
    switched off through ``torch.backends.cuda.matmul.allow_tf32`` and the
    process-wide setting is put back as it was found, also when the block
    raises.  (TF32 rounds the operands to 10 mantissa bits; the ``highest``
    margin, ``(max_nnz + 2) * 2^-24``, is a proof only for fp32 operands.)

    ``torch.set_float32_matmul_precision`` drives the same flag with three
    levels, so where TF32 was on the level is read first and set again at
    the end ("medium" would otherwise come back as "high").  torch refuses
    to report the level to a process that has mixed its two precision APIs;
    there only the flag is restored."""
    mm = torch.backends.cuda.matmul
    was = bool(mm.allow_tf32)
    level = None
    if was:
        try:
            level = torch.get_float32_matmul_precision()
        except RuntimeError:
            level = None
        mm.allow_tf32 = False
    try:
        yield
    finally:
        if was and level is not None:
            torch.set_float32_matmul_precision(level)
        elif was:
            mm.allow_tf32 = True


def rounds_to_bf16(x: torch.Tensor, precision: str) -> bool:
    """Does ``score_tile`` multiply a bf16 copy of ``x``?  Only an fp32
    tensor on a CUDA device at ``"default"``/``"high"`` precision: one
    rounding of each operand, what the 2e-2 margin allows."""
    return x.is_cuda and precision != "highest" and x.dtype == torch.float32


def score_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The form in which ``score_tile`` multiplies ``x``: its bf16 copy
    where ``rounds_to_bf16``, else ``x`` itself.  Callers that score many
    tiles of one index convert once and cache the result."""
    return x.to(torch.bfloat16) if rounds_to_bf16(x, precision) else x


def score_tile(a: torch.Tensor, q: torch.Tensor, precision: str) -> torch.Tensor:
    """``a [m, d] @ q [n, d]^T`` as **fp32** scores ``[m, n]``.

    - CPU tensors: the operands upcast to fp32 (exact for bf16) and an fp32
      product.
    - CUDA, bf16 operands (a bf16 index, or ``score_operand``'s copy): a
      bf16 tensor-core product with fp32 accumulation and an fp32 result
      (``out_dtype``); a plain bf16 ``matmul`` would round the scores to
      bf16 too (2^-9 relative), which no margin counts.
    - CUDA, fp32 operands: ``"highest"`` is a true fp32 product
      (``true_fp32_matmul``); any other precision rounds the operands to
      bf16 first (``score_operand``)."""
    if not a.is_cuda:
        return a.float() @ q.float().T
    if a.dtype == torch.float32 and precision == "highest":
        with true_fp32_matmul():
            return a @ q.T
    a, q = score_operand(a, precision), score_operand(q, precision)
    return torch.mm(a, q.T, out_dtype=torch.float32)


def upper_buckets(n_tiles: int) -> list[tuple[int, int]]:
    """``mode="upper"``'s tile buckets ``(first tile, end tile)``: at most
    16, near-even, the last takes the remainder; bucket ``b`` scores only
    the rows below its end tile (the JAX package's static prefixes)."""
    n_buckets = min(n_tiles, 16)
    bounds = [n_tiles * b // n_buckets for b in range(n_buckets + 1)]
    return [(bounds[b], bounds[b + 1]) for b in range(n_buckets)
            if bounds[b] < bounds[b + 1]]


def allpairs_extract(x: torch.Tensor, tau_eff, tile: int, mode: str = "upper",
                     precision: str = "highest", group: int = 8, timer=None):
    """All-pairs join over the whole index ``x [row_cap, dim_cap]``: device
    int64 ``(rows, cols)`` of every cell with ``score >= tau_eff``, exact
    length (``apsim_tpu/ops/score.py:allpairs_extract`` without its caps,
    cursor and packed head).

    One query tile ``x[q0:q0 + tile]`` at a time is scored against the
    index (``score_tile``: fp32 scores) and thresholded.

    mode="upper": strict upper triangle (``row < q0 + col``).  Tiles fall
    into at most 16 buckets (``upper_buckets``); a bucket's tiles score only
    the rows below the bucket's end, which halves the multiplies.
    mode="all": every thresholded (row, col), self and symmetric pairs too,
    one bucket over ``row_cap``.

    Compaction is ``torch.nonzero`` on each tile's mask, which sizes itself
    (no capacity, no retry): one host synchronization per query tile,
    ``row_cap / tile`` a join.  ``group`` is the JAX extraction's group
    height; exact-length compaction does not use it, but the argument and
    its ``tile % group`` check stay so call sites read like their
    counterparts.  ``x`` may be ``score_operand``'s cached copy.  With a
    ``Timer`` the products are timed as "kernel", mask and ``nonzero`` as
    "compact"."""
    row_cap = x.shape[0]
    if row_cap % tile:
        # a silent floor here would drop the trailing rows as query columns
        # — every pair involving them would vanish from a "lossless" join
        raise ValueError(f"row_cap {row_cap} not a multiple of tile {tile}")
    if tile % group:
        raise ValueError(f"tile {tile} not a multiple of group {group}")
    if mode not in ("upper", "all"):
        raise ValueError(f"unknown mode: {mode}")
    n_tiles = row_cap // tile
    xo = score_operand(x, precision)
    buckets = upper_buckets(n_tiles) if mode == "upper" else [(0, n_tiles)]
    tau_eff = float(tau_eff)
    col_ids = torch.arange(tile, device=x.device)
    found, total = [], 0
    for tb0, tb1 in buckets:
        prefix = tb1 * tile if mode == "upper" else row_cap
        row_ids = torch.arange(prefix, device=x.device)[:, None]
        for t in range(tb0, tb1):
            q0 = t * tile
            with ts._section(timer, "kernel"):
                s = score_tile(xo[:prefix], xo[q0:q0 + tile], precision)
                if x.is_cuda:  # bill the product to its own stage
                    torch.cuda.synchronize(x.device)
            with ts._section(timer, "compact"):
                m = s >= tau_eff
                if mode == "upper":
                    m &= row_ids < q0 + col_ids
                hit = torch.nonzero(m)
                del s, m
            total += hit.shape[0]
            ts.check_pair_count(total)
            found.append((hit[:, 0], hit[:, 1] + q0))
    if not found:
        empty = torch.empty(0, dtype=torch.int64, device=x.device)
        return empty, empty.clone()
    return (torch.cat([r for r, _ in found]), torch.cat([c for _, c in found]))
