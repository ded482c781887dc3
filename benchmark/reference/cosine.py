"""Exact thresholded cosine neighbours by dense blocks: the plain
reference.

Each block of query rows and each block of corpus rows is densified from
the benchmark's own CSR (``corpus.Corpus``) over every term rank, and the
block of dot products is one dense matrix product in ``dtype``: float64 for
the reference, float32 (TF32 off) for its control.  Every product at or
above ``tau - band`` is kept with its value, so the comparison can tell a
pair near the threshold from one far below it.  ``pair_dots`` gives the
float64 dot of given pairs of rows, from the same CSR, by merging their
terms.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["neighbours", "pair_dots", "dense_rows", "no_tf32"]


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32, never TF32, inside the context."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def dense_rows(c, r0: int, r1: int, dtype) -> torch.Tensor:
    """Rows ``[r0, r1)`` of the CSR ``c`` as a dense ``[r1 - r0, terms]``
    block."""
    ptr = c.indptr[r0:r1 + 1]
    cnt = ptr[1:] - ptr[:-1]
    s, e = int(ptr[0]), int(ptr[-1])
    out = torch.zeros(r1 - r0, c.terms, dtype=dtype, device=c.data.device)
    rows = torch.repeat_interleave(
        torch.arange(r1 - r0, device=c.data.device), cnt)
    out[rows, c.indices[s:e]] = c.data[s:e].to(dtype)
    return out


def neighbours(q, c, tau: float, band: float, dtype=torch.float64,
               q_block: int = 16384, c_block: int = 16384,
               c_rows: int | None = None):
    """Every ``(query row, corpus row, dot)`` with ``dot >= tau - band``,
    the dot of the query rows ``q`` against the first ``c_rows`` rows of
    ``c`` computed in ``dtype``: host arrays ``(qi int64, ci int64, s
    float64)``."""
    c_rows = c.n_rows if c_rows is None else c_rows
    out_q, out_c, out_s = [], [], []
    with no_tf32(), torch.no_grad():
        for q0 in range(0, q.n_rows, q_block):
            q1 = min(q0 + q_block, q.n_rows)
            qd = dense_rows(q, q0, q1, dtype)
            for c0 in range(0, c_rows, c_block):
                c1 = min(c0 + c_block, c_rows)
                s = qd @ dense_rows(c, c0, c1, dtype).T
                hit = (s >= tau - band).nonzero()
                out_q.append((hit[:, 0] + q0).cpu())
                out_c.append((hit[:, 1] + c0).cpu())
                out_s.append(s[hit[:, 0], hit[:, 1]].double().cpu())
                del s, hit
            del qd
    if not out_q:
        e = np.empty(0, np.int64)
        return e, e, np.empty(0, np.float64)
    return (torch.cat(out_q).numpy().astype(np.int64),
            torch.cat(out_c).numpy().astype(np.int64),
            torch.cat(out_s).numpy())


def pair_dots(c, i, j, block: int = 1 << 16) -> np.ndarray:
    """The float64 dots of the row pairs ``(i[k], j[k])`` of the CSR ``c``:
    both rows' entries keyed by (pair, term rank), sorted, and the
    products of equal neighbours summed."""
    dev = c.data.device
    i = torch.as_tensor(np.asarray(i, np.int64), device=dev)
    j = torch.as_tensor(np.asarray(j, np.int64), device=dev)
    out = torch.zeros(i.numel(), dtype=torch.float64, device=dev)
    for k0 in range(0, i.numel(), block):
        keys, vals = [], []
        for rows in (i[k0:k0 + block], j[k0:k0 + block]):
            cnt = c.indptr[rows + 1] - c.indptr[rows]
            pair = torch.repeat_interleave(
                torch.arange(rows.numel(), device=dev), cnt)
            start = torch.cumsum(cnt, 0) - cnt
            pos = (c.indptr[rows][pair] + torch.arange(int(cnt.sum()),
                                                      device=dev)
                   - start[pair])
            keys.append(pair * c.terms + c.indices[pos])
            vals.append(c.data[pos].double())
        key, order = torch.sort(torch.cat(keys), stable=True)
        val = torch.cat(vals)[order]
        same = key[1:] == key[:-1]  # a term both rows hold, once a row
        prod = val[1:][same] * val[:-1][same]
        out[k0:k0 + block].index_add_(0, key[1:][same] // c.terms, prod)
    return out.cpu().numpy()
