"""Exact float64 host-side rescoring of candidate pairs (copied from
``apsim_tpu/ops/rescore.py``; host only, no torch).

The device scores in int8 or bf16; the reference computes in float64
(SparseVector.scala:199-200).  To guarantee an *identical pair set* the
engine thresholds on device at ``tau - margin`` (a superset) and recomputes
every surviving candidate pair here in float64, keeping exactly those with
``sim >= tau``.  The margin only needs to exceed the device error, so no
pair is ever missed.
"""

from __future__ import annotations

import numpy as np

try:  # scipy ships in the image; keep a pure-numpy fallback anyway
    import scipy.sparse as _sp
except Exception:  # pragma: no cover
    _sp = None

__all__ = [
    "pair_dots", "cross_pair_dots", "default_margin", "build_compact",
    "as_scipy", "grouped_available",
]


def grouped_available() -> bool:
    """True when the native library (and so the grouped rescore path) can
    load — callers gate their ``build_compact`` caches on this so hosts
    without a compiler don't pay the O(n_cols + nnz) translation that
    ``pair_dots`` would then discard."""
    from ..native import get_lib

    return get_lib() is not None


def build_compact(indices: np.ndarray, n_cols: int):
    """Compact-dim translation for the grouped native rescore.

    Maps the CSR's raw dim ids (sparse in the 2^20 hashing space) to dense
    ids ``[0, n_active)`` so the rescore's dense scratch stays cache-resident.
    Costs O(n_cols + nnz); callers cache it per corpus snapshot.  Returns
    ``(cindices int32, n_active, token)`` where ``token`` fingerprints the
    source CSR indices (``_csr_token``) so ``pair_dots`` can reject a stale
    cache even when a rebuilt corpus has identical nnz but different dims;
    validated here once so the native call can skip its own O(nnz) range
    scan."""
    indices = np.asarray(indices)
    if indices.size == 0:
        return np.empty(0, np.int32), 1, _csr_token(indices)
    if int(indices.min()) < 0 or int(indices.max()) >= n_cols:
        raise IndexError("CSR indices out of [0, n_cols)")
    flags = np.zeros(n_cols, dtype=bool)
    flags[indices] = True
    lut = np.cumsum(flags, dtype=np.int64) - 1
    cind = lut[indices].astype(np.int32)
    return cind, int(flags.sum()), _csr_token(indices)


def _csr_token(indices: np.ndarray) -> tuple:
    """Cheap fingerprint of a CSR indices array: size + a 64-point strided
    sample sum.  O(1), collision-resistant enough to catch the real hazard
    (same-nnz rebuild with different dims) without an O(nnz) checksum."""
    n = indices.size
    if n == 0:
        return (0, 0)
    sample = indices[np.linspace(0, n - 1, num=min(n, 64), dtype=np.int64)]
    return (n, int(np.asarray(sample, dtype=np.int64).sum()))


def default_margin(dtype: str) -> float:
    """Device-error bound by score dtype: fp32 accumulate on fp32 inputs is
    ~1e-6 relative for these workloads; bfloat16 inputs need a far wider net."""
    return 1e-4 if dtype == "float32" else 5e-2


def cross_pair_dots(
    s_indptr, s_indices, s_data, n_cols,
    q_indptr, q_indices, q_data,
    qrows: np.ndarray, crows: np.ndarray,
) -> np.ndarray:
    """Exact fp64 dots between QUERY-matrix rows (qrows) and SHADOW rows
    (crows) — top-k re-ranking and frozen matching.  Avoids materializing a
    stacked copy of the shadow per call (that copy is O(corpus nnz))."""
    qrows = np.asarray(qrows, dtype=np.int64)
    crows = np.asarray(crows, dtype=np.int64)
    from ..native import native_pair_dots

    nat = native_pair_dots(
        s_indptr, s_indices, s_data, q_indptr, q_indices, q_data,
        crows, qrows,
    )
    if nat is not None:
        return nat
    # numpy fallback: stack the two matrices and reuse pair_dots
    n_s = len(s_indptr) - 1
    indptr = np.concatenate([s_indptr, s_indptr[-1] + q_indptr[1:]])
    indices = np.concatenate([s_indices, q_indices])
    data = np.concatenate([s_data, q_data])
    return pair_dots(indptr, indices, data, qrows + n_s, crows, n_cols)


def as_scipy(indptr, indices, data, n_cols):
    """Build (or pass through) the scipy CSR used for rescoring; callers that
    rescore repeatedly should build this once and reuse it — construction
    touches all of the corpus nnz."""
    if _sp is None:
        return None
    return _sp.csr_matrix(
        (data, indices, indptr), shape=(len(indptr) - 1, n_cols)
    )


def pair_dots(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    i: np.ndarray,
    j: np.ndarray,
    n_cols: int,
    chunk: int = 262144,
    mat=None,
    compact=None,
    mat_fn=None,
) -> np.ndarray:
    """Exact fp64 dot products of row pairs (i[k], j[k]) of a host CSR.
    Pass a prebuilt ``mat`` (``as_scipy``) to skip per-call construction —
    or ``mat_fn`` (a zero-arg callable returning it) so the O(corpus nnz)
    scipy build is only paid if the native paths are unavailable.  Pass a
    prebuilt ``compact`` (``build_compact``) to take the grouped native
    path (bit-identical to the merge path)."""
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    out = np.empty(i.size, dtype=np.float64)
    if i.size == 0:
        return out
    from ..native import native_group_dots, native_pair_dots

    if compact is not None:
        cind, n_active, token = compact
        if token == _csr_token(indices):  # stale cache guard
            perm = np.argsort(i, kind="stable")
            scratch = np.zeros(n_active, dtype=np.float64)
            nat = native_group_dots(
                indptr, cind, data, i[perm], j[perm], scratch
            )
            if nat is not None:
                out[perm] = nat
                return out
    nat = native_pair_dots(
        indptr, indices, data, indptr, indices, data, i, j
    )
    if nat is not None:
        return nat
    if mat is None and mat_fn is not None and i.size >= 1024:
        # for few pairs the O(corpus nnz) scipy build dwarfs the dots;
        # the sort-merge path below is O(pairs · row nnz)
        mat = mat_fn()
    if _sp is not None and (mat is not None or i.size >= 1024):
        if mat is None:
            mat = as_scipy(indptr, indices, data, n_cols)
        for s in range(0, i.size, chunk):
            e = min(s + chunk, i.size)
            a = mat[i[s:e]]
            b = mat[j[s:e]]
            out[s:e] = np.asarray(a.multiply(b).sum(axis=1)).ravel()
        return out
    # numpy fallback: sort-merge over gathered entries, chunked
    nnz = np.diff(indptr)
    for s in range(0, i.size, 65536):
        e = min(s + 65536, i.size)
        out[s:e] = _pair_dots_merge(indptr, indices, data, nnz, i[s:e], j[s:e])
    return out


def _gather_entries(indptr, indices, data, nnz, rows):
    counts = nnz[rows]
    total = int(counts.sum())
    pair_of = np.repeat(np.arange(rows.size), counts)
    # offsets within each gathered row
    starts = np.repeat(indptr[rows], counts)
    pos = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    src = (starts + pos).astype(np.int64)
    return pair_of, indices[src].astype(np.int64), data[src]


def _pair_dots_merge(indptr, indices, data, nnz, i, j) -> np.ndarray:
    pa, da, va = _gather_entries(indptr, indices, data, nnz, i)
    pb, db, vb = _gather_entries(indptr, indices, data, nnz, j)
    # key = (pair, dim); entries sharing a key across sides multiply
    out = np.zeros(i.size, dtype=np.float64)
    # merge: both sides are sorted by (pair, dim) by construction (pair
    # blocks in order, dims sorted within a row), then intersect
    ka = pa * (2 ** 32) + da
    kb = pb * (2 ** 32) + db
    pos = np.searchsorted(kb, ka)
    pos_c = np.clip(pos, 0, kb.size - 1)
    hit = (pos < kb.size) & (kb[pos_c] == ka)
    np.add.at(out, pa[hit], va[hit] * vb[pos_c[hit]])
    return out
