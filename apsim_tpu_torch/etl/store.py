"""Local vector store — the rebuild's replacement for HBase bulk storage (a
copy of ``apsim_tpu/etl/store.py``: the same on-disk table format, so a
table written by either package reads in the other).

The reference persists TF-IDF vectors to an HBase table plus a ``<table>_MAX``
per-dimension max-weight side table (HBaseUpLoader.scala:42-135), and the
server bulk-loads row ranges out of it (WriteWorkerActor.scala:132-162,
``LoadData(tableName, startRow, endRow)``, Message.scala:10).

Here a *table* is a directory containing:
  - ``vectors.npz``  — CSR arrays (indptr/indices/data) + int row count/cols
  - ``ids.txt``      — one external string id per row
  - ``max_weights.npy`` — per-dim max weights (the ``_MAX`` table)

``load_range(table, start, end)`` mirrors the LoadData row-range scan
semantics (inclusive start, inclusive end — the reference splits integer row
keys into inclusive sub-ranges, CommonUtils.scala:61-85).

Also hosts reading/writing the reference's text serialization
``(size,[i,...],[v,...])`` (one vector per line, what Spark's
``saveAsTextFile`` emits — PreprocessWithTFIDF.scala:67).
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np

from ..vector.batch import CSRMatrix
from ..vector.sparse import SparseVector, format_vector, parse_vector

__all__ = [
    "VectorStore",
    "save_text_vectors",
    "load_text_vectors",
    "split_load_range",
]


def save_text_vectors(path: str, csr: CSRMatrix) -> None:
    """Write one reference-format vector per line (saveAsTextFile parity)."""
    with open(path, "w", encoding="utf-8") as f:
        for i in range(csr.n_rows):
            f.write(format_vector(csr.row(i)))
            f.write("\n")


def load_text_vectors(path: str) -> CSRMatrix:
    vecs: List[SparseVector] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                vecs.append(parse_vector(line))
    if not vecs:
        return CSRMatrix(
            0, 0, np.zeros(1, np.int64),
            np.empty(0, np.int32), np.empty(0, np.float64),
        )
    return CSRMatrix.from_vectors(vecs, vecs[0].size)


class VectorStore:
    """Directory-backed table store with row-range loads and max-weight side
    tables.

    ``run_mode`` reproduces the reference's DEBUG/PRODUCT cell-encoding
    split (WriteWorkerActor.scala:83-130, HBaseUpLoader.scala:27-36):
    DEBUG additionally writes the human-readable reference text format
    (``vectors.txt``, one ``(size,[i..],[v..])`` line per row) so a test
    table can be hand-written or inspected, and ``read`` falls back to a
    text-only table when no binary npz exists; PRODUCT is binary-only."""

    def __init__(self, root: str, run_mode: str = "DEBUG"):
        self.root = root
        self.run_mode = str(run_mode).upper()
        os.makedirs(root, exist_ok=True)
        # one-table read cache: bulk loads split into io_range_num sub-ranges
        # hit load_range() once per sub-range — without this, each call
        # re-reads and decompresses the whole npz (O(ranges × table_nnz) I/O)
        self._cache: tuple[str, float, CSRMatrix, List[str]] | None = None

    def _table_dir(self, table: str) -> str:
        return os.path.join(self.root, table)

    def tables(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )

    def write(
        self, table: str, csr: CSRMatrix,
        ids: Sequence[str] | None = None,
    ) -> None:
        """Persist a table + its ``_MAX`` max-weight statistic
        (HBaseUpLoader.scala:113-123)."""
        if ids is None:
            ids = [str(i) for i in range(csr.n_rows)]
        if len(ids) != csr.n_rows:
            raise ValueError("ids length mismatch")
        d = self._table_dir(table)
        os.makedirs(d, exist_ok=True)
        # ids are EMBEDDED in the npz (JSON — newline-safe) and the whole
        # (vectors, ids) pair lands in ONE os.replace: a crashed or
        # concurrent writer can no longer produce a torn table whose new
        # vectors pair with old ids (the read cache keys on this file's
        # mtime).  ids.txt remains as a human-readable DEBUG mirror and the
        # read fallback for hand-written tables.
        tmp = os.path.join(d, ".vectors.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                indptr=csr.indptr,
                indices=csr.indices,
                data=csr.data,
                shape=np.array([csr.n_rows, csr.n_cols], dtype=np.int64),
                ids_json=np.array(json.dumps(list(ids))),
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, "vectors.npz"))
        # the _MAX side table and meta get the same tmp+replace treatment:
        # a truncate-in-place np.save could hand a concurrent reader a torn
        # npy, and a crash after the vectors replace would permanently pair
        # the new corpus with the OLD maxima — understating the admission
        # bound and voiding its losslessness
        mw_tmp = os.path.join(d, ".max_weights.npy.tmp")
        with open(mw_tmp, "wb") as f:
            np.save(f, csr.max_weights())
            f.flush()
            os.fsync(f.fileno())
        os.replace(mw_tmp, os.path.join(d, "max_weights.npy"))
        meta_tmp = os.path.join(d, ".meta.json.tmp")
        with open(meta_tmp, "w", encoding="utf-8") as f:
            json.dump({"n_rows": csr.n_rows, "n_cols": csr.n_cols}, f)
        os.replace(meta_tmp, os.path.join(d, "meta.json"))
        if self.run_mode == "DEBUG":
            with open(os.path.join(d, "ids.txt"), "w", encoding="utf-8") as f:
                f.write("\n".join(ids))
            save_text_vectors(os.path.join(d, "vectors.txt"), csr)

    def read(self, table: str) -> tuple[CSRMatrix, List[str]]:
        d = self._table_dir(table)
        npz = os.path.join(d, "vectors.npz")
        ids: List[str] | None = None
        if os.path.exists(npz):
            z = np.load(npz)
            n_rows, n_cols = (int(x) for x in z["shape"])
            csr = CSRMatrix(
                n_rows, n_cols, z["indptr"], z["indices"], z["data"]
            )
            if "ids_json" in z:  # atomic snapshot layout
                ids = json.loads(str(z["ids_json"]))
        elif self.run_mode == "DEBUG" and os.path.exists(
            os.path.join(d, "vectors.txt")
        ):
            # DEBUG: a hand-written text table is a valid table
            csr = load_text_vectors(os.path.join(d, "vectors.txt"))
        else:
            raise FileNotFoundError(npz)
        if ids is None:  # legacy / hand-written tables: ids.txt sidecar
            ids_path = os.path.join(d, "ids.txt")
            if os.path.exists(ids_path):
                with open(ids_path, "r", encoding="utf-8") as f:
                    text = f.read()
                    # splitlines(): a POSIX trailing newline must not
                    # yield a phantom empty id (the strict length check
                    # below would reject the table)
                    ids = text.splitlines() if text else []
            else:
                ids = [str(i) for i in range(csr.n_rows)]
        if len(ids) != csr.n_rows:
            raise ValueError(
                f"table {table!r}: {len(ids)} ids for {csr.n_rows} rows "
                "(torn or hand-edited table?)"
            )
        return csr, ids

    def _read_cached(self, table: str) -> tuple[CSRMatrix, List[str]]:
        path = os.path.join(self._table_dir(table), "vectors.npz")
        if not os.path.exists(path):  # DEBUG text-only table
            path = os.path.join(self._table_dir(table), "vectors.txt")
        mtime = os.path.getmtime(path)
        if self._cache is not None:
            c_table, c_mtime, c_csr, c_ids = self._cache
            if c_table == table and c_mtime == mtime:
                return c_csr, c_ids
        csr, ids = self.read(table)
        self._cache = (table, mtime, csr, ids)
        return csr, ids

    def load_range(
        self, table: str, start_row: int, end_row: int
    ) -> tuple[CSRMatrix, List[str]]:
        """Inclusive row-range scan (LoadData semantics,
        CommonUtils.scala:61-85)."""
        csr, ids = self._read_cached(table)
        start = max(0, int(start_row))
        end = min(csr.n_rows - 1, int(end_row))
        if end < start:
            return (
                CSRMatrix(0, csr.n_cols, np.zeros(1, np.int64),
                          np.empty(0, np.int32), np.empty(0, np.float64)),
                [],
            )
        s, e = int(csr.indptr[start]), int(csr.indptr[end + 1])
        indptr = (csr.indptr[start : end + 2] - csr.indptr[start]).astype(np.int64)
        return (
            CSRMatrix(end - start + 1, csr.n_cols, indptr,
                      csr.indices[s:e], csr.data[s:e]),
            ids[start : end + 1],
        )

    def max_weights(self, table: str) -> np.ndarray:
        """The ``<table>_MAX`` statistic the reference stores but never loads
        back (SURVEY.md fine-print #4) — we actually use it for admission
        pruning."""
        return np.load(os.path.join(self._table_dir(table), "max_weights.npy"))


def split_load_range(
    start_row: int, end_row: int, max_range_num: int
) -> List[tuple[int, int]]:
    """Split an inclusive row range into sub-ranges of stride
    ``len // max_range_num`` — ``CommonUtils.parseLoadDataRequest`` parity
    (CommonUtils.scala:61-85), including its quirk of emitting ONE extra
    straggler range when the length is not divisible (floor-division stride).
    Deviation: the reference's stride loops forever when
    ranges < max_range_num; we clamp the stride to 1 (yielding fewer,
    single-row ranges) instead."""
    out: List[tuple[int, int]] = []
    max_length = (end_row - start_row + 1) // max_range_num
    if max_length <= 0:
        max_length = 1
    start = start_row
    while start <= end_row:
        step = max_length if start + max_length <= end_row else end_row - start + 1
        out.append((start, start + step - 1))
        start += step
    return out
