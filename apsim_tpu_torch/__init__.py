"""apsim_tpu_torch: the all-pairs similarity engine on PyTorch and CUDA.

The port of the JAX package ``apsim_tpu`` (which stays as its reference) to
PyTorch with hand-written Hopper kernels.  This package imports ``torch``
and never ``jax`` or ``apsim_tpu``: the host-only modules it shares with the
JAX package are copies.  Ported so far: ``Engine.build`` and the exact
thresholded ``Engine.all_pairs`` join, with checkpoint loading.
"""

from .config import AllPairsConfig, load_config
from .engine.engine import Engine
from .engine.output import PairResult, SimilarityOutput
from .vector.batch import CSRMatrix
from .vector.sparse import SparseVector, Vectors

__version__ = "0.1.0"

__all__ = [
    "AllPairsConfig",
    "load_config",
    "Engine",
    "PairResult",
    "SimilarityOutput",
    "SparseVector",
    "Vectors",
    "CSRMatrix",
]
