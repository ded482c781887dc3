"""Meshes: the mesh, its collectives, the two mesh engines and the
multi-process bring-up (the counterparts of ``apsim_tpu/parallel/``)."""

from .chunked_mesh import MeshChunkedAllPairs
from .mesh import Mesh, MeshEngine, make_mesh
from .multihost import global_mesh, init_multihost, is_coordinator

__all__ = ["Mesh", "MeshChunkedAllPairs", "MeshEngine", "make_mesh",
           "global_mesh", "init_multihost", "is_coordinator"]
