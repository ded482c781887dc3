"""The device mesh and the mesh-sharded dense engine: the counterpart of
``apsim_tpu/parallel/mesh.py``.

The mesh is single-controller, as under JAX: one process holds one tensor
per shard, each on its shard's device, and the collectives of
``parallel/collectives.py`` move data between them.  A ``Mesh`` is a tuple
of ``torch.device``s with a shape: 1-D ``(shards,)`` under the axis name
``AXIS``, or 2-D ``(rows, dims)``, row-major.  The list may name one device
more than once: ``make_mesh(8, devices=["cpu"] * 8)`` is the CPU tests'
counterpart of JAX's 8 virtual devices, and
``make_mesh(4, devices=["cuda:0"] * 4)`` runs four shards, with their
per-shard kernel launches and their sums, on one card.

``MeshEngine`` is the dense :class:`~apsim_tpu_torch.engine.engine.Engine`
with its index split into a grid of blocks over the mesh:

  - ``shard_axis="dims"`` (the default, the reference's posting partition):
    contiguous column blocks ``[row_cap, dim_cap / n]``;
  - ``shard_axis="rows"``: contiguous row blocks ``[row_cap / n, dim_cap]``;
  - a 2-D mesh sets ``"both"``: block ``(r, d)`` holds rows block ``r`` and
    columns block ``d``.

The rows layout joins through the rows-sharded kernel path
(``ops/mesh_pallas.py``): every shard quantizes its own rows, the int8 rows
are all-gathered, and each shard runs the cross-panel kernel over its
striped share of the global upper-triangle block schedule.  Every other
case (the dims and 2-D layouts, and a rows mesh whose kernel path is
refused: demoted, gated, ``matmul_precision="highest"``,
``use_pallas="off"``, ``pallas_int8=False``) joins through the rectangle
over the mesh (``ops/mesh_score.py``).  With one shard it is ``Engine``,
kernel path, streaming inserts, top-k and all; with more, ``insert`` and
``topk`` raise (ROADMAP item G.2: the block-wise insert and top-k).
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
from ..ops import mesh_score
from ..ops import tri_score as ts
from ..ops.score import new_index_matrix, score_operand
from ..vector.batch import round_up
from .collectives import sync

__all__ = ["AXIS", "Mesh", "make_mesh", "MeshEngine"]

AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh: one device per shard, in shard order (a device may repeat),
    and its shape, ``(shards,)`` or ``(rows, dims)`` row-major (default:
    1-D over all devices).  ``devices[0]`` is the lead device, where the
    collectives deliver their results."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...] = ()

    def __post_init__(self):
        shape = tuple(self.shape) or (len(self.devices),)
        if len(shape) not in (1, 2) or int(np.prod(shape)) != len(self.devices):
            raise ValueError(
                f"mesh shape {shape} does not hold {len(self.devices)} devices"
            )
        object.__setattr__(self, "shape", shape)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(shape: Sequence[int] | int | None = None,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """Mesh of ``shape`` over ``devices`` (default: every visible CUDA
    device; with no CUDA this raises, it never falls back to the CPU): 1-D
    ``(shards,)`` for one shard axis, 2-D ``(rows, dims)`` given two sizes.
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
    if len(dims) not in (1, 2):
        raise ValueError(f"mesh shape must be 1-D or 2-D, got {dims}")
    n = int(np.prod(dims))
    if min(dims) < 1 or n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(tuple(devices[:n]), dims)


class MeshEngine(Engine):
    """Dense engine whose index is split into blocks over a mesh.

    Same public API as :class:`Engine`; construction takes the mesh
    (default: one over the visible cards, ``config.mesh_shape`` may pin a
    smaller one).  With more than one shard the index exists only as
    ``x_blocks``, the row-major ``grid = (row blocks, dim blocks)`` of
    blocks, each built on its shard's device (JAX's ``P(AXIS, None)``,
    ``P(None, AXIS)`` and ``P("rows", "dims")``): ``x`` stays None and the
    capacities come from the blocks.  With one shard ``x`` is the index and
    ``x_blocks == [x]``."""

    def __init__(self, config: AllPairsConfig | None = None,
                 mesh: Mesh | None = None):
        config = config or AllPairsConfig()
        if mesh is None:
            mesh = make_mesh(config.mesh_shape or None)
        self.mesh = mesh
        self.n_shards = mesh.size
        if len(mesh.shape) == 2:
            # 2-D mesh: rows x dims jointly sharded
            n_row_shards, n_dim_shards = mesh.shape
            self.grid = (n_row_shards, n_dim_shards)
            config = config.replace(
                shard_axis="both",
                dim_bucket=round_up(config.dim_bucket,
                                    ts.K_QUANTUM * n_dim_shards),
                row_bucket=round_up(
                    max(config.row_bucket, config.query_tile),
                    8 * n_row_shards,
                ),
            )
        elif config.shard_axis == "dims":
            self.grid = (1, self.n_shards)
            # column blocks must tile evenly across shards
            config = config.replace(
                dim_bucket=round_up(config.dim_bucket,
                                    ts.K_QUANTUM * self.n_shards)
            )
        elif config.shard_axis == "rows":
            self.grid = (self.n_shards, 1)
            config = config.replace(
                row_bucket=round_up(
                    max(config.row_bucket, config.query_tile),
                    8 * self.n_shards,
                ),
                # the kernel streams K in 128-byte stages: zero columns
                # add nothing, so the index width rounds up to them
                dim_bucket=round_up(config.dim_bucket, ts.K_QUANTUM),
            )
        else:
            raise ValueError(f"unknown shard_axis: {config.shard_axis}")
        self.x_blocks: list = []
        self._block_operands = None  # (key, per-block rectangle operands)
        super().__init__(config, mesh.devices[0])

    def _sync(self) -> None:
        sync(self.mesh.devices)

    @property
    def x(self):
        """The index with one shard (None with more)."""
        return self._x

    @x.setter
    def x(self, val):
        # with one shard the blocks are the index: a grown or rebuilt x
        # must replace them, or row_cap / dim_cap would read a stale block
        Engine.x.fset(self, val)
        if self.n_shards == 1:
            self.x_blocks = [] if val is None else [val]
            self._block_operands = None

    # ------------------------------------------------ streaming (one shard)
    def insert(self, vectors, tau=None, bulk=False, defer=False):
        if self.n_shards > 1:
            raise _not_ported("MeshEngine.insert over more than one shard",
                              "item G.2")
        return super().insert(vectors, tau, bulk, defer)

    def topk(self, queries, k):
        if self.n_shards > 1:
            raise _not_ported("MeshEngine.topk over more than one shard",
                              "item G.2")
        return super().topk(queries, k)

    @property
    def row_cap(self) -> int:
        return sum(int(b.shape[0]) for b in self.x_blocks[::self.grid[1]])

    @property
    def dim_cap(self) -> int:
        return sum(int(b.shape[1]) for b in self.x_blocks[:self.grid[1]])

    def _new_index(self, compact_csr, row_cap: int, dim_cap: int):
        self._block_operands = None
        if self.n_shards == 1:
            x = super()._new_index(compact_csr, row_cap, dim_cap)
            self.x_blocks = [x]
            return x
        nr, nd = self.grid
        if row_cap % nr or dim_cap % nd:
            raise ValueError(
                f"index [{row_cap}, {dim_cap}] does not split over a "
                f"{nr} x {nd} grid of shards"
            )
        hb, wb = row_cap // nr, dim_cap // nd
        self.x_blocks = []
        for s, dev in enumerate(self.mesh.devices):
            r, d = divmod(s, nd)
            blk = new_index_matrix(hb, wb, self.cfg.dtype, dev)
            self._scatter_rows(blk, compact_csr, r * hb, d * wb)
            self.x_blocks.append(blk)
        return None

    # ------------------------------------------------ rectangle over the mesh
    def _rect_blocks(self) -> list:
        """Every block as the rectangle multiplies it
        (``score.score_operand``), cached per index state."""
        key = tuple((id(b), b._version) for b in self.x_blocks)
        if self._block_operands is None or self._block_operands[0] != key:
            self._block_operands = (key, [
                score_operand(b, self.cfg.matmul_precision)
                for b in self.x_blocks
            ])
        return self._block_operands[1]

    def _all_pairs_rect(self, tau_eff):
        if self.n_shards == 1:
            return super()._all_pairs_rect(tau_eff)
        with self.timer.section("operands"):
            blocks = self._rect_blocks()
            self._sync()
        found = mesh_score.mesh_allpairs_extract(
            blocks, self.grid, self.mesh.devices, tau_eff, self._tile(),
            self.cfg.matmul_precision, int(self.cfg.extract_group),
            timer=self.timer,
        )
        with self.timer.section("d2h"):
            return (np.concatenate([r.cpu().numpy() for r, _ in found]),
                    np.concatenate([c.cpu().numpy() for _, c in found]))

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
        """Which row block and/or dim block each shard owns, keyed by
        (shard, device): with repeated devices a device alone does not
        name a shard."""
        nr, nd = self.grid
        hb, wb = self.row_cap // nr, self.dim_cap // nd
        out = {}
        for s, dev in enumerate(self.mesh.devices):
            r, d = divmod(s, nd)
            own = {}
            if self.cfg.shard_axis != "dims":
                own["row_block"] = (r * hb, (r + 1) * hb)
            if self.cfg.shard_axis != "rows":
                own["dim_block"] = (d * wb, (d + 1) * wb)
            out[s, str(dev)] = own
        return out
