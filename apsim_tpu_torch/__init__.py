"""apsim_tpu_torch: the all-pairs similarity engine on PyTorch and CUDA.

The port of the JAX package ``apsim_tpu`` (which stays as its reference) to
PyTorch with hand-written Hopper kernels.  This package imports ``torch``
and never ``jax`` or ``apsim_tpu``: the host-only modules it shares with the
JAX package are copies.  Ported so far: ``Engine.build`` and the exact
thresholded ``Engine.all_pairs`` join (the upper-triangle kernels, and the
full-rectangle join for every configuration they refuse), the dense
engine's streaming path (``Engine.insert`` matched online, ``topk``,
``freeze`` and frozen matching, admission and dormant-dim activation;
``OutputBatcher``), the out-of-core
``ChunkedAllPairs.build`` + ``all_pairs`` (block-panel join, and the stripe
join behind it) and its streaming path (``insert`` on the resident, host,
paneled and rebuild routes, ``topk``, ``freeze``), their single-host mesh
variants ``MeshChunkedAllPairs`` (chunk axis sharded; its join only) and
``MeshEngine`` (rows, dims or a 2-D mesh), and
loading each engine from the JAX package's checkpoints.  Entry points run
on the card (``"cuda"``, or a mesh over the cards) unless the caller names
the CPU.
"""

from .config import AllPairsConfig, load_config
from .engine.chunked import ChunkedAllPairs
from .engine.engine import Engine, PendingInsert
from .engine.output import OutputBatcher, PairResult, SimilarityOutput
from .parallel import MeshChunkedAllPairs, MeshEngine, make_mesh
from .vector.batch import CSRMatrix
from .vector.sparse import SparseVector, Vectors

__version__ = "0.1.0"

__all__ = [
    "AllPairsConfig",
    "load_config",
    "Engine",
    "ChunkedAllPairs",
    "MeshChunkedAllPairs",
    "MeshEngine",
    "make_mesh",
    "PendingInsert",
    "OutputBatcher",
    "PairResult",
    "SimilarityOutput",
    "SparseVector",
    "Vectors",
    "CSRMatrix",
]
