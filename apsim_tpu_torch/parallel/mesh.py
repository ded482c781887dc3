"""The device mesh and the rows-sharded engine: the counterpart of
``apsim_tpu/parallel/mesh.py``.

The mesh is single-controller, as under JAX: one process holds one tensor
per shard, each on its shard's device, and the collectives of
``parallel/collectives.py`` move data between them.  A ``Mesh`` is a 1-D
tuple of ``torch.device``s under the axis name ``AXIS``.  The list may name
one device more than once: ``make_mesh(8, devices=["cpu"] * 8)`` is the CPU
tests' counterpart of JAX's 8 virtual devices, and
``make_mesh(4, devices=["cuda:0"] * 4)`` runs four shards, with their
per-shard kernel launches and their sums, on one card.

``MeshEngine`` is the dense :class:`~apsim_tpu_torch.engine.engine.Engine`
with its index split into contiguous row blocks over the mesh
(``shard_axis="rows"``).  Its join is the rows-sharded kernel path
(``ops/mesh_pallas.py``): every shard quantizes its own rows, the int8 rows
are all-gathered, and each shard runs the cross-panel kernel over its
striped share of the global upper-triangle block schedule.  With one shard
it is ``Engine``, kernel path and all.  The ``"dims"`` and 2-D layouts,
whose multi-device join is the XLA rectangle, are ROADMAP item A and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.engine import Engine, _not_ported
from ..engine.chunked import INT8_NNZ_GATE
from ..ops import mesh_pallas
from ..ops import tri_score as ts
from ..ops.score import new_index_matrix
from ..vector.batch import round_up
from .collectives import sync

__all__ = ["AXIS", "Mesh", "make_mesh", "MeshEngine"]

AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one device per shard, in shard order (a device may
    repeat).  ``devices[0]`` is the lead device, where the collectives
    deliver their results."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(shape: Sequence[int] | int | None = None,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """Mesh of ``shape`` shards over ``devices`` (default: every visible
    CUDA device; with no CUDA this raises, it never falls back to the CPU).
    ``shape`` None or ``()`` takes every device; a mesh larger than the
    device list raises.  An explicit list may repeat a device, which puts
    several shards on it (see the module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= for a CPU mesh"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {d}")
    if shape is None or shape == ():
        dims = (len(devices),)
    elif isinstance(shape, int):
        dims = (shape,)
    else:
        dims = tuple(int(s) for s in shape)
    if len(dims) == 2:
        raise _not_ported("a 2-D (rows x dims) mesh", "item A")
    if len(dims) != 1:
        raise ValueError(f"mesh shape must be 1-D, got {dims}")
    n = dims[0]
    if n < 1 or n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(tuple(devices[:n]))


class MeshEngine(Engine):
    """Dense engine whose index is split into row blocks over a mesh.

    Same public API as :class:`Engine`; construction takes the mesh
    (default: one over the visible cards, ``config.mesh_shape`` may pin a
    smaller one).  With more than one shard the index exists only as
    ``x_blocks``, each row block built on its shard's device (JAX's
    ``P(AXIS, None)``): ``x`` stays None and the capacities come from the
    blocks.  With one shard ``x`` is the index and ``x_blocks == [x]``."""

    def __init__(self, config: AllPairsConfig | None = None,
                 mesh: Mesh | None = None):
        config = config or AllPairsConfig()
        if mesh is None:
            mesh = make_mesh(config.mesh_shape or None)
        self.mesh = mesh
        self.n_shards = mesh.size
        if config.shard_axis == "rows":
            config = config.replace(
                row_bucket=round_up(
                    max(config.row_bucket, config.query_tile),
                    8 * self.n_shards,
                ),
                # the kernel streams K in 128-byte stages: zero columns
                # add nothing, so the index width rounds up to them
                dim_bucket=round_up(config.dim_bucket, ts.K_QUANTUM),
            )
        elif config.shard_axis == "both" or (
                config.shard_axis == "dims" and self.n_shards > 1):
            raise _not_ported(
                f"MeshEngine(shard_axis={config.shard_axis!r}) over "
                f"{self.n_shards} shards (its join is the XLA rectangle)",
                "item A",
            )
        elif config.shard_axis != "dims":
            raise ValueError(f"unknown shard_axis: {config.shard_axis}")
        self.x_blocks: list = []
        super().__init__(config, mesh.devices[0])

    def _sync(self) -> None:
        sync(self.mesh.devices)

    @property
    def row_cap(self) -> int:
        return sum(int(b.shape[0]) for b in self.x_blocks)

    @property
    def dim_cap(self) -> int:
        return int(self.x_blocks[0].shape[1]) if self.x_blocks else 0

    def _new_index(self, compact_csr, row_cap: int, dim_cap: int):
        if self.n_shards == 1:
            x = super()._new_index(compact_csr, row_cap, dim_cap)
            self.x_blocks = [x]
            return x
        if row_cap % self.n_shards:
            raise ValueError(
                f"row_cap {row_cap} does not split over "
                f"{self.n_shards} shards"
            )
        b = row_cap // self.n_shards
        self.x_blocks = []
        for s, dev in enumerate(self.mesh.devices):
            blk = new_index_matrix(b, dim_cap, self.cfg.dtype, dev)
            self._scatter_rows(blk, compact_csr, s * b)
            self.x_blocks.append(blk)
        return None

    # ----------------------------------------------- rows-sharded kernel path
    def _mesh_rows_geom(self):
        """``(tm, tn)`` for the rows-sharded kernel path, or None.  Every
        shard scores its striped schedule from the all-gathered copy, so
        only ``row_cap`` must tile; the ladder is the dense kernel's
        geometries plus (64, 128), the smallest the CUDA kernel takes
        (``tn % 128``), where the JAX package has its CPU-only (64, 64)."""
        if self.cfg.shard_axis != "rows" or not self.x_blocks:
            return None
        if self.row_cap % self.n_shards or self.dim_cap % ts.K_QUANTUM:
            return None
        for tm, tn in ((1024, 512), (512, 512), (256, 256), (64, 128)):
            if self.row_cap % tm == 0 and self.row_cap % tn == 0:
                return tm, tn
        return None

    def _kernel_ok(self) -> bool:
        """One shard: ``Engine``'s test.  More: the int8 rows path only
        (the gate, ``matmul_precision`` and demotion as in ``Engine``);
        "auto" takes it on the card only, under an HBM guard: per device
        the striped 1/n share of the bit-packed hit structure (~row_cap²/14
        bytes) plus one gathered int8 copy of the index."""
        if self.n_shards == 1:
            return super()._kernel_ok()
        mode = self.cfg.use_pallas
        if mode == "off" or not self.x_blocks:
            return False
        if mode != "on" and any(d.type != "cuda" for d in self.mesh.devices):
            return False
        if not (
            self.cfg.pallas_int8
            and not self._int8_off
            and self._max_row_nnz() < INT8_NNZ_GATE
            and self.cfg.matmul_precision != "highest"
        ):
            return False
        if mode != "on":
            n = self.n_shards
            bits_fit = self.row_cap * self.row_cap // (14 * n) <= (1 << 31)
            gather_fit = self.row_cap * self.dim_cap <= (1 << 32)
            if not (bits_fit and gather_fit):
                return False
        return self._mesh_rows_geom() is not None

    def _all_pairs_kernel(self, tau_eff):
        if self.n_shards == 1:
            return super()._all_pairs_kernel(tau_eff)
        self._used_int8 = True
        tm, tn = self._mesh_rows_geom()
        sched = mesh_pallas.rows_schedule(self.row_cap, self.n_shards, tm, tn)
        bi, bj, va = (
            [torch.from_numpy(a[s]).to(dev)
             for s, dev in enumerate(self.mesh.devices)]
            for a in sched
        )
        found = mesh_pallas.mesh_rows_extract_int8(
            self.mesh, self.x_blocks, bi, bj, va, tau_eff, tm, tn,
            timer=self.timer,
        )
        with self.timer.section("d2h"):
            return (np.concatenate([r.cpu().numpy() for r, _ in found]),
                    np.concatenate([c.cpu().numpy() for _, c in found]))

    def shard_layout(self) -> dict:
        """Which row block (or, with one ``"dims"`` shard, dim block) each
        shard owns, keyed by (shard, device): with repeated devices a
        device alone does not name a shard."""
        if self.cfg.shard_axis == "rows":
            key, cap = "row_block", self.row_cap
        else:
            key, cap = "dim_block", self.dim_cap
        block = cap // self.n_shards
        return {
            (i, str(d)): {key: (i * block, (i + 1) * block)}
            for i, d in enumerate(self.mesh.devices)
        }
