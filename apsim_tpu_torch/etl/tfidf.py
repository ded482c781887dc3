"""Hashing TF-IDF featurization.

Reference parity: ``PreprocessWithTFIDF.computeTFIDFVector``
(etl/.../PreprocessWithTFIDF.scala:45-52) — Spark 1.2 ``HashingTF`` (default
2^20 = 1,048,576 features, matching ``vectorDim`` in conf/app.conf:6) followed
by ``IDF`` (formula ``log((m + 1) / (df + 1))``).

Deviations (documented):
  - token hash is CRC32 (deterministic, fast C path) instead of Scala
    ``hashCode`` — the hashing space layout differs but the algorithmic
    behavior (feature hashing into 2^20 dims) is identical, and all parity
    checks compare our engine against our own oracle over these vectors.
  - tokenization splits on any whitespace and drops empty tokens (the
    reference splits on single spaces and hashes empty strings).
  - optional L2 normalization is exposed here: the reference never normalizes
    the ETL path while its benchmark client does normalize
    (LoadGenerator.scala:34-38) — SURVEY.md §5 fine-print #1.  Threshold
    semantics only make sense on normalized vectors, so ``normalize=True`` is
    the default and the raw mode is kept for strict parity experiments.
"""

from __future__ import annotations

import zlib
from typing import Iterable, List, Sequence

import numpy as np

from ..vector.batch import CSRMatrix

__all__ = [
    "DEFAULT_NUM_FEATURES",
    "hash_term",
    "hashing_tf",
    "idf_weights",
    "apply_idf",
    "tfidf_pipeline",
    "top_dim_filter",
]

DEFAULT_NUM_FEATURES = 1 << 20  # Spark HashingTF default, conf/app.conf:6


def hash_term(term: str, num_features: int = DEFAULT_NUM_FEATURES) -> int:
    """Deterministic non-negative feature hash for one token."""
    return zlib.crc32(term.encode("utf-8")) % num_features


def hashing_tf(
    documents: Iterable[str], num_features: int = DEFAULT_NUM_FEATURES
) -> CSRMatrix:
    """Term-frequency CSR over the hashed feature space (HashingTF parity).

    Uses the native C++ tokenizer/hasher (native/apsim_native.cpp) when
    available — bit-identical to the Python path below (same CRC32 + split
    semantics, asserted in tests) — and falls back to pure Python otherwise.
    """
    docs_list = list(documents)
    try:
        from ..native import hash_corpus
    except ImportError:  # packaging problem -> Python fallback
        hash_corpus = None
    # hash_corpus returns None itself when no compiler/lib is available; a
    # call-time exception is a real native bug and must propagate, not
    # silently degrade to the multi-minute Python path
    native = (
        hash_corpus(docs_list, num_features) if hash_corpus is not None
        else None
    )
    if native is not None:
        indptr_n, indices_n, values_n = native
        return CSRMatrix(
            n_rows=len(docs_list),
            n_cols=num_features,
            indptr=indptr_n,
            indices=indices_n,
            data=values_n,
        )
    documents = docs_list
    indptr: List[int] = [0]
    all_idx: List[np.ndarray] = []
    all_val: List[np.ndarray] = []
    for doc in documents:
        counts: dict[int, int] = {}
        # bytes.split() = ASCII-whitespace tokenization, the exact contract
        # the native path implements (bit-parity between the two)
        for tok in doc.encode("utf-8").split():
            h = zlib.crc32(tok) % num_features
            counts[h] = counts.get(h, 0) + 1
        idx = np.fromiter(counts.keys(), dtype=np.int32, count=len(counts))
        val = np.fromiter(counts.values(), dtype=np.float64, count=len(counts))
        order = np.argsort(idx)
        all_idx.append(idx[order])
        all_val.append(val[order])
        indptr.append(indptr[-1] + len(idx))
    return CSRMatrix(
        n_rows=len(indptr) - 1,
        n_cols=num_features,
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=(
            np.concatenate(all_idx) if all_idx else np.empty(0, np.int32)
        ),
        data=np.concatenate(all_val) if all_val else np.empty(0, np.float64),
    )


def idf_weights(tf: CSRMatrix, min_doc_freq: int = 0) -> np.ndarray:
    """Spark MLlib IDF: ``log((m + 1) / (df + 1))``, zeroed below
    ``min_doc_freq`` (PreprocessWithTFIDF.scala:50-51 uses the default 0)."""
    df = tf.doc_freq()
    m = tf.n_rows
    idf = np.log((m + 1.0) / (df + 1.0))
    if min_doc_freq > 0:
        idf = np.where(df >= min_doc_freq, idf, 0.0)
    return idf


def apply_idf(tf: CSRMatrix, idf: np.ndarray) -> CSRMatrix:
    data = tf.data * idf[tf.indices]
    return CSRMatrix(tf.n_rows, tf.n_cols, tf.indptr, tf.indices, data)


def tfidf_pipeline(
    documents: Sequence[str],
    num_features: int = DEFAULT_NUM_FEATURES,
    normalize: bool = True,
) -> CSRMatrix:
    """documents -> TF-IDF CSR (optionally L2-normalized)."""
    tf = hashing_tf(documents, num_features)
    out = apply_idf(tf, idf_weights(tf))
    if normalize:
        out = out.normalized()
    return out


def top_dim_filter(csr: CSRMatrix, filter_threshold: int) -> CSRMatrix:
    """Keep only the ``filter_threshold`` dimensions with the largest
    per-dimension max weight, dropping all other components — the reference's
    HBase upload filter (HBaseUpLoader.scala:126-135: sort dims by max weight
    descending, keep top-N)."""
    if filter_threshold <= 0 or filter_threshold >= csr.n_cols:
        return csr
    maxw = csr.max_weights()
    # stable top-N by weight descending (ties: lower dim wins, pinned)
    order = np.lexsort((np.arange(csr.n_cols), -maxw))
    keep = np.zeros(csr.n_cols, dtype=bool)
    keep[order[:filter_threshold]] = True
    mask = keep[csr.indices]
    new_nnz_per_row = np.zeros(csr.n_rows, dtype=np.int64)
    row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
    np.add.at(new_nnz_per_row, row_of[mask], 1)
    indptr = np.zeros(csr.n_rows + 1, dtype=np.int64)
    np.cumsum(new_nnz_per_row, out=indptr[1:])
    return CSRMatrix(csr.n_rows, csr.n_cols, indptr, csr.indices[mask], csr.data[mask])
