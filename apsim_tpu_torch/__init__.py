"""apsim_tpu_torch: the all-pairs similarity engine on PyTorch and CUDA.

The port of the JAX package ``apsim_tpu`` (which stays as its reference) to
PyTorch with hand-written Hopper kernels.  This package imports ``torch``
and never ``jax`` or ``apsim_tpu``: the host-only modules it shares with the
JAX package are copies.  Ported: ``Engine.build`` and the exact
thresholded ``Engine.all_pairs`` join (the upper-triangle kernels, and the
full-rectangle join for every configuration they refuse), the dense
engine's streaming path (``Engine.insert`` matched online, ``topk``,
``freeze`` and frozen matching, admission and dormant-dim activation;
``OutputBatcher``), the out-of-core ``ChunkedAllPairs.build`` +
``all_pairs`` (block-panel join, and the stripe join behind it) and its
streaming path (``insert`` on the resident, host, paneled and rebuild
routes, ``topk``, ``freeze``), the mesh variants ``MeshChunkedAllPairs``
(chunk axis sharded) and ``MeshEngine`` (rows, dims or a 2-D mesh), their
joins and their streaming at any shard count, on one process or over
several (``parallel.init_multihost`` and ``global_mesh`` on
``torch.distributed``); checkpoints (``save`` and ``load`` in the JAX
package's format, so either package restores the other's) and
``profile_dir`` tracing (``torch.profiler``); the ETL (``etl``: TF-IDF
hashing, the vector store); the serving stack (``serve``:
``SimilarityServer``, the newline-JSON ``RpcServer``, the client, and the
replicated op log of ``serve.replica`` that serves one index from several
processes), the load generator (``bench.loadgen``) and the command line
(``python -m apsim_tpu_torch.cli``, ``apsim-torch``; ``serve --replicate``);
the benchmark suite (``bench.suite``, ``cli bench-suite``), the reference
baseline, ``bench.mfu`` with the card's peaks, ``bench.scale.run_scale``
and the join, insert, panel and serve stage probes; the schedule and slab
studies (``bench.tri_probe``, ``bench.mesh_tri_probe``: the full-rectangle
join's triangle against its rectangle, on one device and on a dims mesh;
``bench.ell_probe``: an ELL corpus matched by a row-gather contraction).
Their tests run on the CPU against the JAX studies (``python -m pytest
tests/test_torch_studies.py``); on the card they run in ``chip_smoke.py``
phase 16 or as ``python -m apsim_tpu_torch.bench.<study>``.  Left out on
purpose: the JAX package's TPU workarounds (caps and packed heads,
background prewarm, ``_row_cap_law``, ``utils/jaxsetup.py``,
``PaddedBatch``).  Entry points run on the card (``"cuda"``, or a mesh
over the cards) unless the caller names the CPU.
"""

from .config import AllPairsConfig, load_config
from .engine.chunked import ChunkedAllPairs
from .engine.engine import Engine, PendingInsert
from .engine.output import OutputBatcher, PairResult, SimilarityOutput
from .parallel import MeshChunkedAllPairs, MeshEngine, make_mesh
from .vector.batch import CSRMatrix
from .vector.sparse import (DenseVector, SparseVector, Vectors,
                            parse_vector)

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
    "DenseVector",
    "Vectors",
    "parse_vector",
    "CSRMatrix",
]
