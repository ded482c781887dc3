"""Compact dimension space.

The reference scatters posting lists over the raw 2^20 hashing space keyed by
``dim % maxShardNum`` (WriteWorkerActor.scala:172-174).  On the card the score
path is a dense matmul over *compact* columns, so this module maintains the
bijection  external hashed dim  <->  compact column  with:

  - document-frequency-descending initial ordering (hot dims first — keeps
    early dim blocks dense, helps pruning and block skipping),
  - append-only growth for streaming inserts that introduce unseen dims
    (capacity grows in ``dim_bucket`` quanta, so the device index is
    reallocated only when a quantum fills, and its width stays a multiple
    of the kernels' K tile).
"""

from __future__ import annotations


import numpy as np

from ..vector.batch import CSRMatrix, round_up

__all__ = ["CompactSpace"]


class CompactSpace:
    def __init__(self, vector_dim: int, dim_bucket: int = 4096):
        self.vector_dim = int(vector_dim)
        self.dim_bucket = int(dim_bucket)
        self._base = int(dim_bucket)  # capacity floor; build snaps it tight
        self.ext_of_col = np.empty(0, dtype=np.int64)
        # col_of_ext: int64 lookup table over the external space would be
        # 8 MB for 2^20 dims — affordable and O(1); -1 = unmapped.
        self._col_of_ext = np.full(self.vector_dim, -1, dtype=np.int32)

    @property
    def n_active(self) -> int:
        return int(self.ext_of_col.size)

    @property
    def capacity(self) -> int:
        """Padded column capacity: the build-time base (snapped to a
        ``dim_bucket`` multiple covering the build's active dims) plus
        geometrically-doubling HEADROOM steps until the active dims fit.
        Doubling the headroom (not the capacity) keeps the device index's
        reallocations (each a copy of the whole index and a rebuild of its
        cached int8 / bf16 operands) at O(log new_dims) under streaming
        inserts that continually mint dims, while the first mint after a
        tight build costs ONE bucket of matmul K (+5.5% on Enron), not a 2×
        capacity jump (a raw doubling ladder
        wasted 45% of the matmul K on Enron: 71,763 live dims → 131,072
        columns instead of 73,728; doubling from a tight 73,728 base on the
        first streamed dim would have re-created exactly that)."""
        cap = self._base
        step = self.dim_bucket
        while cap < self.n_active:
            cap += step
            step *= 2
        return cap

    @staticmethod
    def from_csr(
        csr: CSRMatrix, dim_bucket: int = 4096, min_df: int = 1
    ) -> "CompactSpace":
        """Build with dims ordered by document frequency descending
        (ties: lower external dim first, for determinism).

        ``min_df > 1`` leaves rarer dims unmapped — the engine's dormant-dim
        tier: a dim in exactly one document contributes to no i≠j pair, so
        keeping it off the device shrinks the matmul K (42% of Enron's active
        dims are df==1).  Unmapped dims can still be appended later via
        ``extend`` (insert-time activation)."""
        cs = CompactSpace(csr.n_cols, dim_bucket)
        df = csr.doc_freq()
        active = np.nonzero(df >= min_df)[0]
        order = active[np.lexsort((active, -df[active]))]
        cs.ext_of_col = order.astype(np.int64)
        cs._col_of_ext[order] = np.arange(order.size, dtype=np.int32)
        cs._base = max(round_up(order.size, dim_bucket), dim_bucket)
        return cs

    def map_cols(self, ext_dims: np.ndarray) -> np.ndarray:
        """Compact columns of ``ext_dims`` (int32), validating that every
        dim is mapped — the gather-only core of ``map_csr`` for callers
        that don't need a row-sorted CSR (the chunked build buckets COO
        entries, where within-row order is irrelevant; skipping the
        22M-entry lexsort + re-gather halves build time at 200k rows)."""
        cols = self._col_of_ext[np.asarray(ext_dims)]
        if cols.size and int(cols.min()) < 0:
            bad = np.asarray(ext_dims)[np.nonzero(cols < 0)[0][0]]
            raise KeyError(f"dim {int(bad)} not in compact space")
        return cols

    def map_csr(self, csr: CSRMatrix, extend: bool = False) -> CSRMatrix:
        """Rewrite a CSR over the external space into compact columns.

        With ``extend=True``, unseen dims are appended to the space
        (streaming-insert path); otherwise they must already be mapped.
        """
        if extend:
            self.extend(csr.indices)
        cols = self._col_of_ext[csr.indices]
        if np.any(cols < 0):
            missing = int(csr.indices[np.nonzero(cols < 0)[0][0]])
            raise KeyError(f"dim {missing} not in compact space")
        # compact columns are not sorted within rows after remap; re-sort all
        # rows at once by (row, col)
        row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
        order = np.lexsort((cols, row_of))
        return CSRMatrix(
            csr.n_rows,
            self.capacity,
            csr.indptr,
            cols[order].astype(np.int32),
            csr.data[order],
        )

    def extend(self, ext_dims: np.ndarray) -> int:
        """Append any unmapped external dims; returns number appended."""
        ext_dims = np.asarray(ext_dims)
        new = np.unique(ext_dims[self._col_of_ext[ext_dims] < 0])
        if new.size:
            start = self.n_active
            self._col_of_ext[new] = np.arange(
                start, start + new.size, dtype=np.int32
            )
            self.ext_of_col = np.concatenate([self.ext_of_col, new.astype(np.int64)])
        return int(new.size)

    def cols_of(self, ext_dims: np.ndarray) -> np.ndarray:
        return self._col_of_ext[np.asarray(ext_dims)]

