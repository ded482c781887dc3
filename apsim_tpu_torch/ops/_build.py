"""Build and bind the CUDA kernels of ``csrc/score_bits.cu``
(``score_bits_int8``, ``score_bits_bf16``, ``panel_score_bits_int8``,
``int8_matmul``).

The source has a plain C interface, so it is compiled by ``nvcc`` alone into
a shared library (seconds, where a build against PyTorch's headers takes
minutes) and loaded with ``ctypes``.  The build runs at the first launch,
never at import, into ``build/apsim_tpu_torch/`` keyed by a hash of the
source and flags.  Every failure raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time

from ..utils.build import build_shared_lib

__all__ = ["kernels", "build_info"]

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "score_bits.cu",
)
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels cannot be built"
        )
    return found


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            so, log = build_shared_lib(SRC, [_nvcc()] + FLAGS)
            lib = ctypes.CDLL(so)
            lib.score_bits_int8.restype = _I
            lib.score_bits_int8.argtypes = [
                _P, _P, _P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _I,
                _P, _P, _P, _P, _P,
            ]
            lib.score_bits_bf16.restype = _I
            lib.score_bits_bf16.argtypes = [
                _P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _I,
                _P, _P, _P, _P,
            ]
            lib.panel_score_bits_int8.restype = _I
            lib.panel_score_bits_int8.argtypes = [
                _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float,
                _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
            ]
            lib.int8_matmul.restype = _I
            lib.int8_matmul.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P]
            _info.update(
                library=so, seconds=time.perf_counter() - t0, log=log
            )
            _lib = lib
    return _lib


def build_info() -> dict:
    """``{"library", "seconds", "log"}`` of the build (or load) that
    ``kernels()`` did; empty before the first call."""
    return dict(_info)
