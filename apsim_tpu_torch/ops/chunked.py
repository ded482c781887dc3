"""Chunked-sparse entry buffers (the parts of ``apsim_tpu/ops/chunked.py``
that the out-of-core batch join needs).

The chunked engine keeps its index as per-chunk COO entry buffers
``rows/cols/vals [n_chunks, chunk_cap]`` plus a count per chunk, never as a
dense ``[rows, dims]`` matrix.  Chunk assignment interleaves the
frequency-ranked compact dims (``chunk = col % n_chunks``,
``local = col // n_chunks``) so chunk loads are balanced.  Unused slots carry
the pad row ``2^30``, which no slab reaches.

The host bucketing (``split_chunks``, ``bucket_entries``,
``bucket_split_entries``) is a copy of the JAX package's; the per-row int8
quantization of the entries (``quantize_chunk_entries``) is torch and runs on
the buffers' device.  The stripe, match and top-k ops of the JAX module serve
paths that are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "split_chunks",
    "bucket_entries",
    "bucket_split_entries",
    "quantize_chunk_entries",
]


def split_chunks(cols: np.ndarray, n_chunks: int):
    """(chunk, local) of compact columns — interleaved assignment.

    Kept in the input's integer dtype: fresh int64 copies of 100M+-entry
    arrays are page-fault-bound, and every consumer takes int32."""
    cols = np.asarray(cols)
    return cols % n_chunks, cols // n_chunks


def bucket_entries(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_chunks: int,
    chunk_cap: int, pad_row: int,
):
    """Host-side: bucket COO entries into per-chunk 2-D buffers.

    Returns ``(rows2d, cols2d, vals2d, counts)`` with shapes
    ``[n_chunks, chunk_cap]`` / ``[n_chunks]``; unused slots carry
    ``row == pad_row``.  Entries land contiguously in slots
    ``[0, counts[c])`` preserving input order (the panel sort's
    ``pos < counts`` validity mask relies on front-contiguity)."""
    chunk, local = split_chunks(cols, n_chunks)
    counts = np.bincount(chunk, minlength=n_chunks).astype(np.int64)
    return bucket_split_entries(
        rows, chunk, local, vals, counts, chunk_cap, pad_row
    )


def bucket_split_entries(
    rows: np.ndarray, chunk: np.ndarray, local: np.ndarray,
    vals: np.ndarray, counts: np.ndarray, chunk_cap: int, pad_row: int,
):
    """``bucket_entries`` with the (chunk, local, counts) split precomputed
    — callers that size ``chunk_cap`` from the counts reuse the same pass."""
    n_chunks = counts.size
    rows = np.asarray(rows)
    vals = np.asarray(vals)
    if counts.size and int(counts.max()) > chunk_cap:
        raise ValueError("chunk_cap too small")
    rows2d = np.full((n_chunks, chunk_cap), pad_row, np.int32)
    cols2d = np.zeros((n_chunks, chunk_cap), np.int32)
    vals2d = np.zeros((n_chunks, chunk_cap), np.float32)
    for c in range(n_chunks):
        sel = np.flatnonzero(chunk == c)
        k = sel.size
        rows2d[c, :k] = rows[sel]
        cols2d[c, :k] = local[sel]
        vals2d[c, :k] = vals[sel]
    return rows2d, cols2d, vals2d, counts


def quantize_chunk_entries(rows2d: torch.Tensor, vals2d: torch.Tensor,
                           row_cap: int):
    """Per-row symmetric int8 quantization of the chunk entries.

    Returns ``(q2d int8 [n_chunks, chunk_cap], aux f32 [3, row_cap],
    max_nnz int)``: per row ``α = max|v|/127``, ``q = round(v/α)``, and the
    bound ingredients ``aux = [α, α·L1(q), nnz]`` — the same quantities as
    the dense ``quantize_rows``, computed over the entries of each row.
    ``max_nnz`` feeds the int32-accumulator gate.  All-zero rows get α = 0,
    so both their score and their bound are zero.

    Bit-identical to the JAX package's function: the JAX scatters drop the
    pad rows (row 2^30) with ``mode="drop"``; torch has no such mode, so the
    pad entries are filtered out first.  XLA compiles ``mx / 127.0`` to a
    multiply by the fp32 reciprocal, and so does this; ``v / div`` divides
    by a tensor and stays a true division.  L1(q) and nnz are sums of
    integers below 2^24, exact in any order."""
    flat_r = rows2d.reshape(-1)
    flat_v = vals2d.reshape(-1)
    live = flat_r < row_cap
    r_live = flat_r[live].long()
    absv = flat_v.abs()
    mx = torch.zeros(row_cap, dtype=torch.float32, device=flat_v.device)
    mx.scatter_reduce_(0, r_live, absv[live], reduce="amax")
    alpha = torch.where(mx > 0, mx * (1.0 / 127.0), 0.0).to(torch.float32)
    a_e = alpha[flat_r.clamp(max=row_cap - 1).long()]
    div = torch.where(a_e > 0, a_e, 1.0)
    q = (flat_v / div).round_().clamp_(-127, 127).to(torch.int8)
    l1q = torch.zeros_like(mx).index_add_(
        0, r_live, q[live].abs().to(torch.float32)
    )
    nnz = torch.zeros_like(mx).index_add_(
        0, r_live, (flat_v[live] != 0).to(torch.float32)
    )
    aux = torch.stack([alpha, alpha * l1q, nnz])
    max_nnz = int(nnz.max()) if row_cap else 0
    return q.reshape(rows2d.shape), aux, max_nnz
