"""ctypes loader for the native C++ helpers (``apsim_native.cpp`` beside this
file, a copy of the JAX package's source).

Builds the shared library on first use with g++ (``-ffp-contract=off``, so
the fp64 rescore's sums are the same as the reference package's) into
``build/apsim_tpu_torch/``, keyed by a content hash.  Bound here: the two
rescore entry points and the ETL's tokenizer / hasher (``hash_corpus``,
``crc32``); the source's padding helper serves no ported path.  Without a
compiler the rescore and hashing entry points return None and the caller
takes its NumPy / pure-Python path, and ``crc32`` falls back to
``zlib.crc32`` (the same checksum).
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from ..utils.build import build_shared_lib

__all__ = ["get_lib", "compile_library", "native_available",
           "native_pair_dots", "native_group_dots", "hash_corpus", "crc32"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "apsim_native.cpp")
# no -march=native: the library may be built on one machine and loaded on
# another; with -ffp-contract=off the sums are the same
_CMD = ["g++", "-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = compile_library()
        except (OSError, RuntimeError, TimeoutError) as e:
            print(f"apsim_native build failed ({e}); using NumPy fallback",
                  file=sys.stderr)
            return None
        lib = ctypes.CDLL(so)
        lib.apsim_crc32.restype = ctypes.c_uint32
        lib.apsim_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.apsim_hash_corpus.restype = ctypes.c_int64
        lib.apsim_hash_corpus.argtypes = [
            ctypes.c_char_p, _I64, ctypes.c_int64, ctypes.c_uint32, _I64,
            _I32, _F64, ctypes.c_int64,
        ]
        lib.apsim_pair_dots.restype = None
        lib.apsim_pair_dots.argtypes = [
            _I64, _I32, _F64, _I64, _I32, _F64, _I64, _I64, ctypes.c_int64,
            _F64,
        ]
        lib.apsim_group_dots.restype = None
        lib.apsim_group_dots.argtypes = [
            _I64, _I32, _F64, _I64, _I64, ctypes.c_int64, _F64, _F64,
        ]
        _lib = lib
        return _lib


def compile_library() -> str:
    """Build the library without loading it (``get_lib`` then loads it
    under the same key); raises ``RuntimeError`` when the build fails."""
    return build_shared_lib(_SRC, _CMD, timeout=120)[0]


def native_available() -> bool:
    return get_lib() is not None


def crc32(data: bytes) -> int:
    lib = get_lib()
    if lib is None:
        import zlib

        return zlib.crc32(data)
    return int(lib.apsim_crc32(data, len(data)))


def hash_corpus(docs: list[str], num_features: int):
    """Native HashingTF over a document list -> (indptr, indices, values):
    ASCII-whitespace tokens, CRC32 mod ``num_features``, per-document
    counts in ascending feature order.  None if the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    blobs = [d.encode("utf-8") for d in docs]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    for i, b in enumerate(blobs):
        offsets[i + 1] = offsets[i] + len(b)
    text = b"".join(blobs)
    # worst-case nnz = token count <= bytes/2 + n_docs; start smaller and
    # double when the library reports the buffer too small
    cap = max(int(offsets[-1] // 4) + len(blobs) + 16, 1024)
    while True:
        indptr = np.zeros(len(blobs) + 1, dtype=np.int64)
        indices = np.empty(cap, dtype=np.int32)
        values = np.empty(cap, dtype=np.float64)
        nnz = lib.apsim_hash_corpus(
            text, offsets, len(blobs), num_features, indptr, indices, values,
            cap,
        )
        if nnz >= 0:
            return indptr, indices[:nnz].copy(), values[:nnz].copy()
        cap *= 2


def _check_rows(rows: np.ndarray, indptr, name: str) -> None:
    # the C loops index indptr[row + 1] unchecked — an out-of-range row id
    # (an upstream bug, e.g. a leaked padded row) must raise here instead of
    # reading past the arrays
    if rows.size and (
        int(rows.min()) < 0 or int(rows.max()) >= len(indptr) - 1
    ):
        raise IndexError(
            f"{name} out of range [0, {len(indptr) - 1}): "
            f"min={int(rows.min())}, max={int(rows.max())}"
        )


def native_pair_dots(
    a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, a_rows, b_rows
):
    """Exact fp64 dots of (a_rows[p] of A) · (b_rows[p] of B); None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a_rows = np.ascontiguousarray(a_rows, np.int64)
    b_rows = np.ascontiguousarray(b_rows, np.int64)
    _check_rows(a_rows, a_indptr, "a_rows")
    _check_rows(b_rows, b_indptr, "b_rows")
    out = np.empty(a_rows.size, dtype=np.float64)
    lib.apsim_pair_dots(
        np.ascontiguousarray(a_indptr, np.int64),
        np.ascontiguousarray(a_indices, np.int32),
        np.ascontiguousarray(a_data, np.float64),
        np.ascontiguousarray(b_indptr, np.int64),
        np.ascontiguousarray(b_indices, np.int32),
        np.ascontiguousarray(b_data, np.float64),
        a_rows, b_rows, a_rows.size, out,
    )
    return out


def native_group_dots(indptr, cindices, data, a_rows, b_rows, scratch):
    """Grouped same-matrix fp64 pair dots (see apsim_group_dots in the C
    source): ``a_rows`` MUST be sorted ascending and ``cindices`` must be the
    compact-dim translation of the CSR's indices with values in
    ``[0, len(scratch))``.  ``scratch`` must be all-zero on entry (it is
    restored to all-zero on return).  Returns None if the native library is
    unavailable; bit-identical to ``native_pair_dots`` on the same pairs."""
    lib = get_lib()
    if lib is None:
        return None
    a_rows = np.ascontiguousarray(a_rows, np.int64)
    b_rows = np.ascontiguousarray(b_rows, np.int64)
    indptr = np.ascontiguousarray(indptr, np.int64)
    cindices = np.ascontiguousarray(cindices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    if cindices.size != data.size or len(indptr) < 1 or int(indptr[-1]) > cindices.size:
        raise ValueError("CSR arrays inconsistent")
    _check_rows(a_rows, indptr, "a_rows")
    _check_rows(b_rows, indptr, "b_rows")
    # NOTE cindices range vs scratch is validated ONCE at translation build
    # time (rescore.build_compact) — a per-call scan would be O(corpus nnz)
    # and cost more than the dots themselves
    out = np.empty(a_rows.size, dtype=np.float64)
    lib.apsim_group_dots(
        indptr, cindices, data, a_rows, b_rows, a_rows.size, scratch, out,
    )
    return out
