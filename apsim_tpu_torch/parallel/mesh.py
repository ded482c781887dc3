"""The device mesh and the mesh-sharded dense engine: the counterpart of
``apsim_tpu/parallel/mesh.py``.

On one process the mesh is single-controller, as under JAX: the process
holds one tensor per shard, each on its shard's device, and the
collectives of ``parallel/collectives.py`` move data between them.  A
mesh from ``multihost.global_mesh`` spans several processes: each shard
names its owning rank, a process holds and computes its own shards only
(None in the per-shard lists for the others'), and the same collectives
cross processes.  A ``Mesh`` is a tuple
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
kernel path, streaming inserts, top-k and all.

With more shards the streaming path (``insert`` with ``defer``, admission,
dormant activation, growth and rollback; ``topk``; ``freeze`` and frozen
matching) is ``Engine``'s with its device steps done block-wise: a batch
row is added to the row block that owns it, its entries split over the
column blocks; an activated entry goes to the block that owns its (row,
col); growth lays the grown grid out with the old contents moved to the
blocks that now own them (capacities follow ``Engine``'s law); the match,
the frozen match and top-k are ``ops/mesh_score.py``'s products (the
query's column blocks on every scoring device, per-block partials summed
over the column blocks).  The bf16 operand copies the products multiply
(``_rect_blocks``) take each batch's rows and activated entries, so a
micro-batch recasts no block.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.engine import Engine
from ..engine.chunked import INT8_NNZ_GATE
from ..ops import mesh_pallas
from ..ops import mesh_score
from ..ops import score as score_ops
from ..ops import tri_score as ts
from ..vector.batch import pack_coo_i32, round_up
from .collectives import share, sync

__all__ = ["AXIS", "Mesh", "make_mesh", "MeshEngine"]

AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh: one device per shard, in shard order (a device may repeat),
    its shape, ``(shards,)`` or ``(rows, dims)`` row-major (default: 1-D
    over all devices), and the ``torch.distributed`` rank that owns each
    shard (default: all 0, one process) with this process's ``rank``.
    A shard's device is named as its owner names it; this process touches
    its own shards only.  The lead device, where the collectives deliver
    their results, is this process's first shard's (``devices[0]`` on one
    process)."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...] = ()
    ranks: Tuple[int, ...] = ()
    rank: int = 0

    def __post_init__(self):
        shape = tuple(self.shape) or (len(self.devices),)
        if len(shape) not in (1, 2) or int(np.prod(shape)) != len(self.devices):
            raise ValueError(
                f"mesh shape {shape} does not hold {len(self.devices)} devices"
            )
        object.__setattr__(self, "shape", shape)
        ranks = tuple(int(r) for r in self.ranks) or (0,) * len(self.devices)
        if len(ranks) != len(self.devices) or self.rank not in ranks:
            raise ValueError(
                f"mesh ranks {ranks} do not give rank {self.rank} a shard "
                f"of {len(self.devices)}"
            )
        object.__setattr__(self, "ranks", ranks)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_procs(self) -> int:
        """Processes owning shards (1 for every ``make_mesh`` mesh)."""
        return len(set(self.ranks))

    def is_local(self, s: int) -> bool:
        return self.ranks[s] == self.rank

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The shards this process owns, in shard order."""
        return tuple(s for s, r in enumerate(self.ranks) if r == self.rank)

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices[s]
                                   for s in self.local_shards))

    @property
    def lead(self) -> torch.device:
        return self.devices[self.local_shards[0]]


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
        super().__init__(config, mesh.lead)

    def _sync(self) -> None:
        sync(self.mesh)

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

    def _local_block(self):
        """This process's first block (None before any build)."""
        return next((b for b in self.x_blocks if b is not None), None)

    @property
    def row_cap(self) -> int:
        b = self._local_block()
        return 0 if b is None else int(b.shape[0]) * self.grid[0]

    @property
    def dim_cap(self) -> int:
        b = self._local_block()
        return 0 if b is None else int(b.shape[1]) * self.grid[1]

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
            if not self.mesh.is_local(s):
                self.x_blocks.append(None)  # another process's block
                continue
            r, d = divmod(s, nd)
            blk = score_ops.new_index_matrix(hb, wb, self.cfg.dtype, dev)
            self._scatter_rows(blk, compact_csr, r * hb, d * wb)
            self.x_blocks.append(blk)
        return None

    # ------------------------------------------------------- block-wise upkeep
    def _block_geom(self):
        """``(nr, nd, hb, wb)``: the grid and the block height and width."""
        nr, nd = self.grid
        return nr, nd, self.row_cap // nr, self.dim_cap // nd

    def _resize_index(self, row_cap: int, dim_cap: int) -> None:
        """The grown grid: ``[row_cap / nr, dim_cap / nd]`` blocks, each
        built on its shard's device and given the part of every old block
        that lies inside it (rows move between row blocks when ``row_cap``
        grows, columns between column blocks when ``dim_cap`` does).  A part
        whose old and new blocks belong to different processes crosses in
        one collective, entered by every process in the same order."""
        if self.n_shards == 1:
            return super()._resize_index(row_cap, dim_cap)
        nr, nd = self.grid
        if row_cap % nr or dim_cap % nd:
            raise ValueError(
                f"index [{row_cap}, {dim_cap}] does not split over a "
                f"{nr} x {nd} grid of shards"
            )
        old, (_, _, ohb, owb) = self.x_blocks, self._block_geom()
        hb, wb = row_cap // nr, dim_cap // nd
        mesh = self.mesh
        blocks = []
        for s, dev in enumerate(mesh.devices):
            r, d = divmod(s, nd)
            blk = (score_ops.new_index_matrix(hb, wb, self.cfg.dtype, dev)
                   if mesh.is_local(s) else None)
            for t, ob in enumerate(old):
                orr, od = divmod(t, nd)
                a0, a1 = max(r * hb, orr * ohb), min((r + 1) * hb,
                                                      (orr + 1) * ohb)
                b0, b1 = max(d * wb, od * owb), min((d + 1) * wb,
                                                    (od + 1) * owb)
                if not (a0 < a1 and b0 < b1):
                    continue
                part = None if ob is None else ob[
                    a0 - orr * ohb:a1 - orr * ohb,
                    b0 - od * owb:b1 - od * owb]
                if mesh.ranks[s] != mesh.ranks[t]:
                    part = share([None if part is None else (part,)],
                                 [mesh.ranks[t]], mesh.lead, mesh,
                                 arity=1)[0][0]
                if blk is not None:
                    blk[a0 - r * hb:a1 - r * hb, b0 - d * wb:b1 - d * wb] = (
                        part.to(dev))
            blocks.append(blk)
        self.x_blocks = blocks
        self._block_operands = None

    def _by_block(self, rows: np.ndarray, cols: np.ndarray):
        """For every block that owns some of the host entries ``(rows,
        cols)`` (global): ``(shard, selection, block rows, block cols)``."""
        nr, nd, hb, wb = self._block_geom()
        owner = (rows // hb) * nd + cols // wb
        for s in np.unique(owner):
            sel = np.flatnonzero(owner == s)
            r, d = divmod(int(s), nd)
            yield int(s), sel, rows[sel] - r * hb, cols[sel] - d * wb

    def _append_batch(self, compact_csr, n0: int) -> None:
        if self.n_shards == 1:
            return super()._append_batch(compact_csr, n0)
        rows = n0 + np.repeat(np.arange(compact_csr.n_rows, dtype=np.int64),
                              np.diff(compact_csr.indptr))
        cols = compact_csr.indices.astype(np.int64)
        for s, sel, br, bc in self._by_block(rows, cols):
            blk = self.x_blocks[s]
            if blk is None:
                continue
            score_ops.append_rows(blk, pack_coo_i32(
                br, bc, compact_csr.data[sel], blk.shape[0]), 0)

    def _scatter_activation(self, act) -> None:
        if self.n_shards == 1:
            return super()._scatter_activation(act)
        rows = np.asarray(act[0], np.int64)
        cols = np.asarray(act[1], np.int64)
        vals = np.asarray(act[2])
        for s, sel, br, bc in self._by_block(rows, cols):
            if self.x_blocks[s] is not None:
                score_ops.scatter_entries(self.x_blocks[s], br, bc,
                                          vals[sel])

    def _blocks_key(self):
        return tuple(None if b is None else (id(b), b._version)
                     for b in self.x_blocks)

    def _kept_bf16(self):
        """The cached bf16 copies of the blocks when the products multiply
        them and they are in step with the blocks; else None (a copy out
        of step is dropped)."""
        if self.n_shards == 1:
            return super()._kept_bf16()
        cached = self._block_operands
        if cached is None or not score_ops.rounds_to_bf16(
                self._local_block(), self.cfg.matmul_precision):
            return None
        if cached[0] != self._blocks_key():
            self._block_operands = None
            return None
        return cached[1]

    def _keep_in_step(self, kept, n0: int, act) -> None:
        """Write the batch's rows ``[n0, n_rows)`` and the activated
        entries of every block into its bf16 copy and re-key the copies;
        each element rounds on its own, so every copy stays equal to a
        fresh cast of its block."""
        if self.n_shards == 1:
            return super()._keep_in_step(kept, n0, act)
        nr, nd, hb, _ = self._block_geom()
        for s, (blk, cp) in enumerate(zip(self.x_blocks, kept)):
            if blk is None:
                continue
            r0 = (s // nd) * hb
            a, b = max(n0, r0) - r0, min(self.n_rows, r0 + hb) - r0
            if a < b:
                cp[a:b] = blk[a:b].to(torch.bfloat16)
        if act is not None:
            for s, _, br, bc in self._by_block(np.asarray(act[0], np.int64),
                                               np.asarray(act[1], np.int64)):
                if kept[s] is None:
                    continue
                r = torch.from_numpy(br).to(kept[s].device)
                c = torch.from_numpy(bc).to(kept[s].device)
                kept[s][r, c] = self.x_blocks[s][r, c].to(torch.bfloat16)
        self._block_operands = (self._blocks_key(), kept)

    # ----------------------------------------------------- products over the grid
    def _rect_blocks(self) -> list:
        """Every block as the products multiply it
        (``score.score_operand``), cached per index state."""
        key = self._blocks_key()
        if self._block_operands is None or self._block_operands[0] != key:
            self._block_operands = (key, [
                None if b is None
                else score_ops.score_operand(b, self.cfg.matmul_precision)
                for b in self.x_blocks
            ])
        return self._block_operands[1]

    def _match_batch(self, n0: int, tau_eff):
        if self.n_shards == 1:
            return super()._match_batch(n0, tau_eff)
        n1 = min(n0 + round_up(self.n_rows - n0, 8), self.row_cap)
        return mesh_score.mesh_match_rows_extract(
            self._rect_blocks(), self.grid, self.mesh, n0, n1,
            self.n_rows, tau_eff, self.cfg.matmul_precision,
            timer=self.timer,
        )

    def _frozen_candidates(self, q, tau_eff):
        if self.n_shards == 1:
            return super()._frozen_candidates(q, tau_eff)
        return mesh_score.mesh_queries_match_extract(
            self._rect_blocks(), self.grid, self.mesh, q,
            self.n_rows, tau_eff, self.cfg.matmul_precision,
        )

    def _topk_scores(self, q, kf: int):
        if self.n_shards == 1:
            return super()._topk_scores(q, kf)
        return mesh_score.mesh_topk_scores(
            self.x_blocks, self.grid, self.mesh, q, self.n_rows, kf)

    def _all_pairs_rect(self, tau_eff):
        if self.n_shards == 1:
            return super()._all_pairs_rect(tau_eff)
        with self.timer.section("operands"):
            blocks = self._rect_blocks()
            self._sync()
        found = mesh_score.mesh_allpairs_extract(
            blocks, self.grid, self.mesh, tau_eff, self._tile(),
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
            [torch.from_numpy(a[s]).to(dev) if self.mesh.is_local(s) else None
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
