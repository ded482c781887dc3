"""Host-side batch layouts (copied from ``apsim_tpu/vector/batch.py``).

What the batch joins need: :class:`CSRMatrix`, the host CSR that ETL, the
oracle and the dense engine's fp64 shadow use; :class:`GrowableCSR`, the
chunked engine's append-only fp64 shadow; and the flat packed COO that the
index build scatters onto the device.  The padded ``[rows, k]`` layout
belongs to the streaming paths and is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .sparse import SparseVector

__all__ = ["CSRMatrix", "GrowableCSR", "round_up", "pow2_bucket",
           "pack_coo_i32"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pow2_bucket(x: int, lo: int = 64) -> int:
    """Smallest power of two >= max(x, lo)."""
    n = lo
    while n < x:
        n <<= 1
    return n


def pack_coo_i32(rows, cols, vals, pad_row: int, lo: int = 1024):
    """One flat ``[3, ecap]`` int32 COO array: rows / cols / fp32 value
    bits, pow2-bucketed with padding rows = ``pad_row`` (the consumer drops
    entries whose row is out of bounds).  Byte-for-byte the JAX package's
    layout, so one packed array feeds either package."""
    ecap = pow2_bucket(max(rows.size, 1), lo)
    coo = np.empty((3, ecap), np.int32)
    coo[0, : rows.size] = rows
    coo[0, rows.size :] = pad_row
    coo[1, : cols.size] = cols
    coo[1, cols.size :] = 0
    coo[2, : vals.size] = vals.astype(np.float32).view(np.int32)
    coo[2, vals.size :] = 0
    return coo


@dataclasses.dataclass
class CSRMatrix:
    """Host-side CSR: ``indptr`` int64 [n_rows+1], ``indices`` int32 [nnz]
    (sorted within each row), ``data`` float64 [nnz]."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @staticmethod
    def from_vectors(
        vectors: Sequence[SparseVector], n_cols: int | None = None
    ) -> "CSRMatrix":
        if n_cols is None:
            n_cols = vectors[0].size if vectors else 0
        indptr = np.zeros(len(vectors) + 1, dtype=np.int64)
        for i, v in enumerate(vectors):
            indptr[i + 1] = indptr[i] + v.nnz
        nnz = int(indptr[-1])
        indices = np.empty(nnz, dtype=np.int32)
        data = np.empty(nnz, dtype=np.float64)
        for i, v in enumerate(vectors):
            indices[indptr[i] : indptr[i + 1]] = v.indices
            data[indptr[i] : indptr[i + 1]] = v.values
        return CSRMatrix(len(vectors), int(n_cols), indptr, indices, data)

    def row(self, i: int) -> SparseVector:
        s, e = int(self.indptr[i]), int(self.indptr[i + 1])
        return SparseVector(self.n_cols, self.indices[s:e], self.data[s:e])

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def row_norms(self) -> np.ndarray:
        # reduceat, not cumsum: segment sums write n_rows elements instead
        # of materializing a full-nnz prefix array, and avoid cumsum's
        # O(nnz) error growth
        nnz = self.data.size
        if nnz == 0:
            return np.zeros(self.n_rows)
        sq = self.data * self.data
        starts = self.indptr[:-1]
        # reduceat needs in-range boundaries; trailing empty rows start AT
        # nnz — pad one zero only then (clamping instead would corrupt the
        # previous row's end boundary)
        if int(starts[-1]) == nnz:
            sq = np.append(sq, 0.0)
        out = np.add.reduceat(sq, starts)
        # an empty row's "segment" is the single element at its start
        out[np.diff(self.indptr) == 0] = 0.0
        return np.sqrt(out)

    def normalized(self) -> "CSRMatrix":
        norms = self.row_norms()
        norms[norms == 0.0] = 1.0
        data = self.data / np.repeat(norms, self.row_nnz())
        return CSRMatrix(self.n_rows, self.n_cols, self.indptr, self.indices, data)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=np.float64)
        for i in range(self.n_rows):
            s, e = int(self.indptr[i]), int(self.indptr[i + 1])
            out[i, self.indices[s:e]] = self.data[s:e]
        return out

    def max_weights(self) -> np.ndarray:
        """Per-dimension max value over all rows — the reference's
        ``<table>_MAX`` statistic (HBaseUpLoader.scala:113-123)."""
        out = np.zeros(self.n_cols, dtype=np.float64)
        np.maximum.at(out, self.indices, self.data)
        return out

    def doc_freq(self) -> np.ndarray:
        out = np.zeros(self.n_cols, dtype=np.int64)
        np.add.at(out, self.indices, 1)
        return out


class GrowableCSR:
    """Append-only host CSR with geometric capacity growth — the fp64 shadow
    store used by streaming engines (amortized O(nnz) total append cost
    instead of O(nnz · batches) reallocation)."""

    def __init__(self, n_cols: int):
        self.n_cols = int(n_cols)
        self.n_rows = 0
        self._nnz = 0
        self._indptr = np.zeros(1024, dtype=np.int64)
        self._indices = np.empty(4096, dtype=np.int32)
        self._data = np.empty(4096, dtype=np.float64)

    def append(self, csr: CSRMatrix) -> None:
        nnz = int(csr.indptr[-1])
        need_rows = self.n_rows + csr.n_rows + 1
        if need_rows > self._indptr.size:
            grown = np.zeros(max(self._indptr.size * 2, need_rows), np.int64)
            grown[: self.n_rows + 1] = self._indptr[: self.n_rows + 1]
            self._indptr = grown
        need = self._nnz + nnz
        if need > self._indices.size:
            cap = max(self._indices.size * 2, need)
            gi = np.empty(cap, np.int32)
            gi[: self._nnz] = self._indices[: self._nnz]
            gd = np.empty(cap, np.float64)
            gd[: self._nnz] = self._data[: self._nnz]
            self._indices, self._data = gi, gd
        base = self._indptr[self.n_rows]
        self._indptr[self.n_rows + 1 : self.n_rows + csr.n_rows + 1] = (
            base + csr.indptr[1:]
        )
        self._indices[self._nnz : self._nnz + nnz] = csr.indices[:nnz]
        self._data[self._nnz : self._nnz + nnz] = csr.data[:nnz]
        self.n_rows += csr.n_rows
        self._nnz += nnz

    def truncate(self, n_rows: int) -> None:
        """Drop rows >= ``n_rows`` (failed-insert rollback).  O(1): the tail
        storage is simply reused by the next append."""
        if not 0 <= n_rows <= self.n_rows:
            raise ValueError(f"truncate({n_rows}) outside [0, {self.n_rows}]")
        self.n_rows = n_rows
        self._nnz = int(self._indptr[n_rows])

    def view(self) -> CSRMatrix:
        """Read-only CSR view of the current contents."""
        return CSRMatrix(
            self.n_rows,
            self.n_cols,
            self._indptr[: self.n_rows + 1],
            self._indices[: self._nnz],
            self._data[: self._nnz],
        )
