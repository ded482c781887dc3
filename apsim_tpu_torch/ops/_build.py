"""Build and bind the CUDA kernels of ``csrc/score_bits.cu``
(``score_bits_int8``, ``score_bits_bf16``, ``panel_score_bits_int8``,
``int8_matmul``, ``pair_bits_int8``, ``pair_bits_f32``, ``compact_bits``)
and ``peer_copy``, a copy between cards.

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

__all__ = ["kernels", "build_info", "compile_library"]

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
_F = ctypes.c_float
_L = ctypes.c_longlong

# argument types of the C entries (all return int): the arguments each
# wrapper passes, then the stream
ARGTYPES = {
    "score_bits_int8": [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P],
    "score_bits_bf16": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P],
    "panel_score_bits_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                              _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "int8_matmul": [_P, _P, _I, _I, _I, _P, _P, _P],
    "pair_bits_int8": [_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _F,
                       _P, _P, _P, _P],
    "pair_bits_f32": [_P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P],
    "compact_bits": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _L, _L, _P, _P, _P,
                     _P],
    "peer_copy": [_P, _I, _P, _I, _L, _P],
}


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


def compile_library() -> tuple[str, str]:
    """Build the kernel library without loading it: ``(so_path,
    compiler_output)``.  Needs ``nvcc`` but no card or driver, so an image
    build can run it; ``kernels()`` then finds the library under the same
    key (the same source and command) and only loads it."""
    return build_shared_lib(SRC, [_nvcc()] + FLAGS)


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            so, log = compile_library()
            lib = ctypes.CDLL(so)
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.restype = _I
                fn.argtypes = argtypes
            _info.update(
                library=so, seconds=time.perf_counter() - t0, log=log
            )
            _lib = lib
    return _lib


def build_info() -> dict:
    """``{"library", "seconds", "log"}`` of the build (or load) that
    ``kernels()`` did; empty before the first call."""
    return dict(_info)
