"""Sparse/dense vector data model.

TPU-native re-design of the reference's Scala vector layer
(``core/src/main/scala/cpslab/vector/SparseVector.scala``): the reference keeps
boxed ``Array[Double]`` Breeze-backed vectors; here the canonical in-memory form
is a pair of NumPy arrays (int32 indices, float64 values) so batches can be
packed straight into device-friendly padded/CSR layouts without per-element
boxing.

Parity notes (reference file:line):
  - text format ``(size,[i,...],[v,...])``: SparseVector.scala:132-156 (parser)
    and :204-206 (writer).
  - factory semantics (sorted strictly-increasing indices, duplicate check):
    SparseVector.scala:96-108.
  - float64 values match the reference's ``Double`` (SparseVector.scala:199-200).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "SparseVector",
    "DenseVector",
    "Vectors",
    "parse_vector",
    "format_vector",
]


@dataclasses.dataclass(frozen=True)
class SparseVector:
    """A sparse vector of a fixed dimensionality.

    ``indices`` are strictly increasing int32; ``values`` float64 of the same
    length (mirrors SparseVector.scala:198-223, minus JVM boxing).
    """

    size: int
    indices: np.ndarray  # int32, strictly increasing
    values: np.ndarray  # float64

    def __post_init__(self) -> None:
        indices = np.asarray(self.indices, dtype=np.int32)
        values = np.asarray(self.values, dtype=np.float64)
        if indices.shape != values.shape or indices.ndim != 1:
            raise ValueError(
                f"indices/values must be 1-D and equal length, got "
                f"{indices.shape} vs {values.shape}"
            )
        if indices.size:
            if int(indices[-1]) >= self.size:
                raise ValueError(
                    f"index {int(indices[-1])} out of range for size {self.size}"
                )
            if int(indices[0]) < 0:
                raise ValueError("negative index")
            if np.any(np.diff(indices) <= 0):
                raise ValueError("indices must be strictly increasing")
        object.__setattr__(self, "indices", indices)
        object.__setattr__(self, "values", values)

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    def to_array(self) -> np.ndarray:
        out = np.zeros(self.size, dtype=np.float64)
        out[self.indices] = self.values
        return out

    def dot(self, other: "SparseVector") -> float:
        """Exact float64 sparse-sparse dot product (the reference's
        ``calculateSimilarity``, CommonUtils.scala:98-117, without the per-call
        HashMap allocation)."""
        if self.size != other.size:
            raise ValueError(f"size mismatch: {self.size} vs {other.size}")
        a_idx, a_val = self.indices, self.values
        b_idx, b_val = other.indices, other.values
        # intersect two sorted index lists
        common_a = np.isin(a_idx, b_idx, assume_unique=True)
        if not common_a.any():
            return 0.0
        common_idx = a_idx[common_a]
        b_pos = np.searchsorted(b_idx, common_idx)
        return float(np.dot(a_val[common_a], b_val[b_pos]))

    def norm(self) -> float:
        return float(np.linalg.norm(self.values))

    def normalized(self) -> "SparseVector":
        n = self.norm()
        if n == 0.0:
            return self
        return SparseVector(self.size, self.indices, self.values / n)

    def filter_values_above(self, threshold: float) -> "SparseVector":
        """Drop components with value <= threshold (the reference's streaming
        ``indexThreshold`` filter, WriteWorkerActor.scala:185-202)."""
        keep = self.values > threshold
        return SparseVector(self.size, self.indices[keep], self.values[keep])

    def __str__(self) -> str:
        return format_vector(self)


@dataclasses.dataclass(frozen=True)
class DenseVector:
    """Dense vector (SparseVector.scala:181-196)."""

    values: np.ndarray  # float64

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "values", np.asarray(self.values, dtype=np.float64)
        )

    @property
    def size(self) -> int:
        return int(self.values.size)

    def to_array(self) -> np.ndarray:
        return self.values

    def to_sparse(self) -> SparseVector:
        nz = np.nonzero(self.values)[0].astype(np.int32)
        return SparseVector(self.size, nz, self.values[nz])

    def __str__(self) -> str:
        return "[" + ",".join(repr(float(v)) for v in self.values) + "]"


def format_vector(v: SparseVector) -> str:
    """Reference text format ``(size,[i,...],[v,...])`` (SparseVector.scala:204)."""
    idx = ",".join(str(int(i)) for i in v.indices)
    val = ",".join(repr(float(x)) for x in v.values)
    return f"({v.size},[{idx}],[{val}])"


def parse_vector(text: str) -> SparseVector:
    """Parse the reference text format (SparseVector.scala:132-156).

    Accepts ``(size,[i1,i2,...],[v1,v2,...])``; raises ValueError on anything
    else (the reference throws a bare Exception).
    """
    parts = text.strip().split(",[")
    if len(parts) != 3:
        raise ValueError(f"cannot parse vector string: {text[:80]!r}")
    size = int(parts[0].replace("(", "").strip())
    idx_str = parts[1].replace("]", "").strip()
    val_str = parts[2].replace("])", "").strip()
    indices = (
        np.array([int(s) for s in idx_str.split(",")], dtype=np.int32)
        if idx_str
        else np.empty(0, np.int32)
    )
    values = (
        np.array([float(s) for s in val_str.split(",")], dtype=np.float64)
        if val_str
        else np.empty(0, np.float64)
    )
    return SparseVector(size, indices, values)


class Vectors:
    """Factory helpers mirroring the reference's ``Vectors`` object
    (SparseVector.scala:56-179)."""

    @staticmethod
    def dense(values: Sequence[float]) -> DenseVector:
        return DenseVector(np.asarray(values, dtype=np.float64))

    @staticmethod
    def sparse(
        size: int,
        indices: Sequence[int] | np.ndarray,
        values: Sequence[float] | np.ndarray,
    ) -> SparseVector:
        return SparseVector(
            size,
            np.asarray(indices, dtype=np.int32),
            np.asarray(values, dtype=np.float64),
        )

    @staticmethod
    def from_pairs(size: int, elements: Iterable[tuple[int, float]]) -> SparseVector:
        """Unordered (index, value) pairs; sorts and rejects duplicates
        (SparseVector.scala:96-108)."""
        elems = sorted(elements, key=lambda p: p[0])
        if not elems:
            return SparseVector(size, np.empty(0, np.int32), np.empty(0, np.float64))
        idx = np.array([e[0] for e in elems], dtype=np.int32)
        if np.any(np.diff(idx) == 0):
            dup = int(idx[np.nonzero(np.diff(idx) == 0)[0][0]])
            raise ValueError(f"Found duplicate indices: {dup}.")
        val = np.array([e[1] for e in elems], dtype=np.float64)
        return SparseVector(size, idx, val)

    @staticmethod
    def zeros(size: int) -> DenseVector:
        return DenseVector(np.zeros(size, dtype=np.float64))

    @staticmethod
    def parse(text: str) -> SparseVector:
        return parse_vector(text)
