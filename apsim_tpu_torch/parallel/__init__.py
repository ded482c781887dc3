"""Single-controller meshes: the mesh, its collectives and the two mesh
engines (the counterparts of ``apsim_tpu/parallel/``'s single-host part)."""

from .chunked_mesh import MeshChunkedAllPairs
from .mesh import Mesh, MeshEngine, make_mesh

__all__ = ["Mesh", "MeshChunkedAllPairs", "MeshEngine", "make_mesh"]
