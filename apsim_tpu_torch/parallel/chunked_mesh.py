"""Mesh-sharded out-of-core engine: the counterpart of
``apsim_tpu/parallel/chunked_mesh.py``.

The chunk axis of :class:`~apsim_tpu_torch.engine.chunked.ChunkedAllPairs`'
entry buffers is the shard axis: shard s owns a contiguous block of
``n_chunks / n_shards`` dim-chunks (JAX's ``P(AXIS, None)``), the
reference's ``dim % maxShardNum`` posting partition at out-of-core scale.
A row panel's int8 slab is therefore column-sharded, and a panel pair's
score is the exact int32 sum of the shards' partial dots (kernel 4,
``ops/panel_mesh.py``).  The sum, the quantization-bound epilogue and the
bit-packing are one pass of kernel 5 over each card's row slice of the
pair, whose rows of the other cards' partials are copied there first;
each card compacts its slice.  The host side (compact space, shadow CSR, rescore,
the sweeps, checkpoints, the insert's bookkeeping) is inherited; only
placement, the panel geometry and the device ops are rerouted.

The stripe join (``pallas_int8=False``, ``use_pallas="off"``, a tripped
int32 gate) runs sharded too (``ops/chunked_mesh.py``): every shard scores
the stripe over its own chunks and the partial accumulators are summed
before the one epilogue.

Streaming (``insert``, ``defer``, ``topk``, ``freeze`` and frozen
matching, dormant activation) is the single-device engine's with four
device hooks rerouted to ``ops/chunked_mesh.py``: an append gives each
shard the entries of its chunk block, a capacity growth pads each shard's
buffers, and the match and top-k sum the shards' partial scores before the
one epilogue.  As in the JAX package the resident stack, the paneled route
and the host router are off, so every match takes the rebuild route
(``last_route == "device_rebuild"``): each insert densifies every chunk.
The single-slab tier never applies: slabs are shard-split.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AllPairsConfig
from ..engine.chunked import INT8_NNZ_GATE, ChunkedAllPairs
from ..ops import chunked_mesh as cm_ops
from ..ops import panel as panel_ops
from ..ops import panel_mesh
from ..ops import tri_score as ts
from ..vector.batch import round_up
from .collectives import sync
from .mesh import Mesh, make_mesh

__all__ = ["MeshChunkedAllPairs"]


class MeshChunkedAllPairs(ChunkedAllPairs):
    """Out-of-core all-pairs engine over a 1-D mesh.

    Same public API as :class:`ChunkedAllPairs`; ``mesh`` defaults to one
    over the visible cards (``config.mesh_shape`` may pin a smaller one).
    ``_ent`` holds per-shard lists: ``(rows, cols, vals)``, each a list of
    ``[n_chunks / n_shards, chunk_cap]`` tensors on the shards' devices;
    ``_counts_dev`` is a per-shard list too.  ``stats`` adds
    ``shard_entries`` (each shard's entry count, in shard order: the skew
    of the contiguous chunk blocks) and ``peer_copy_bytes`` (the bytes the
    joins copied from one card to another, ``collectives.gather_rows``; 0
    with one card).

    One shard still takes the mesh path (kernel 4, then kernel 5), which
    costs more than ``ChunkedAllPairs``' fused kernel 3: 0.376 s against
    0.335 s for the warm join of ``synthetic_corpus(100000, seed=0)`` on
    8,192- and 16,384-row panels on an NVIDIA H100 80GB HBM3 at a 700 W
    power limit (``chip_smoke.py`` phases 5 and 6)."""

    def __init__(self, config: AllPairsConfig | None = None,
                 mesh: Mesh | None = None, chunk_dim: int = 2048,
                 super_tile: int | None = None,
                 panel_rows: int | None = None):
        config = config or AllPairsConfig()
        if mesh is None:
            mesh = make_mesh(config.mesh_shape or None)
        if len(mesh.shape) != 1:
            raise ValueError(
                "MeshChunkedAllPairs shards the chunk axis: needs a 1-D mesh"
            )
        self.mesh = mesh
        self.n_shards = mesh.size
        super().__init__(config, mesh.lead, chunk_dim, super_tile,
                         panel_rows)
        self.stats.update(shard_entries=[0] * self.n_shards,
                          peer_copy_bytes=0)

    def _sync(self) -> None:
        sync(self.mesh)

    # ------------------------------------------------------------ placement
    def _round_chunks(self, n: int) -> int:
        # the chunk axis must split evenly over the shards
        return round_up(max(n, self.n_shards), self.n_shards)

    def _place(self, rows2d, cols2d, vals2d, counts) -> None:
        self._ent_host = (rows2d, cols2d, vals2d)
        self._ent = tuple(self._split(a) for a in self._ent_host)
        self._counts = np.asarray(counts, np.int64)
        self._counts_dev = self._place_counts(self._counts)
        self._new_corpus()

    def _split(self, a: np.ndarray) -> list:
        """A host array over the chunk axis cut into the shards' blocks,
        each on its shard's device (None for another process's shard)."""
        n_local = a.shape[0] // self.n_shards
        return [torch.from_numpy(np.ascontiguousarray(
                    a[s * n_local:(s + 1) * n_local])).to(dev)
                if self.mesh.is_local(s) else None
                for s, dev in enumerate(self.mesh.devices)]

    def _place_counts(self, counts: np.ndarray) -> list:
        n_local = counts.shape[0] // self.n_shards
        self.stats["shard_entries"] = [
            int(counts[s * n_local:(s + 1) * n_local].sum())
            for s in range(self.n_shards)]
        return self._split(counts.astype(np.int32))

    # -------------------------------------------------------------- streaming
    # the routes the entry buffers' shard split rules out (JAX's
    # ``_match_slab_cache_ok = False``): every match densifies its slabs
    def _match_slabs(self):
        return None

    def _paneled_ok(self) -> bool:
        return False

    def _use_host_match(self, q_ext_indices) -> bool:
        return False

    def _op_append(self, coo5: np.ndarray, tail: bool) -> None:
        cm_ops.mesh_append_entries(self.mesh, *self._ent, coo5)

    def _op_grow(self, new_cap: int):
        return cm_ops.mesh_grow_entry_cap(*self._ent, new_cap,
                                          panel_ops.PAD_ROW)

    def _run_match(self, ccsr, q_base: int, q_rows: int, tau_eff):
        return cm_ops.mesh_match_extract(
            self.mesh, *self._ent, self._local_counts(),
            self._bucket_queries(ccsr, q_rows), q_base, tau_eff,
            self.row_cap, self._chunk_width, q_rows,
            self.cfg.matmul_precision, timer=self.timer,
        )

    def _op_topk(self, q, q_rows: int, kf: int):
        return cm_ops.mesh_topk(
            self.mesh, *self._ent, self._local_counts(), q, self.n_rows,
            self.row_cap, self._chunk_width, q_rows, kf, "highest",
        )

    # ----------------------------------------------------- mesh stripe join
    def _local_counts(self) -> list:
        """Each shard's chunk counts as a host array (no device read)."""
        n_local = self._n_chunks // self.n_shards
        return [self._counts[s * n_local:(s + 1) * n_local]
                for s in range(self.n_shards)]

    def _quantize_entries(self):
        """Per-shard ``q2d`` (chunk-sharded like the entries), the global
        ``aux`` on the lead device, ``max_nnz``."""
        flat = [[None if t is None else t.reshape(-1) for t in self._ent[k]]
                for k in (0, 2)]
        qs, aux, max_nnz = panel_mesh.mesh_quantize_entries(
            self.mesh, flat[0], flat[1], self.row_cap)
        return ([None if q is None else q.reshape(r.shape)
                 for q, r in zip(qs, self._ent[0])], aux, max_nnz)

    def _ent_key(self):
        return (self._ent_gen,) + tuple(None if v is None else v._version
                                        for v in self._ent[2])

    # Stripe budget (bytes) over every fp32 accumulator counted by
    # ``_stripe_accs``.  Measured on an NVIDIA H100 80GB HBM3 at a 700 W
    # power limit (``bench/constants_ab`` and ``bench/stripe_ab``,
    # PERF.md): the wider stripes it allows were the faster, 2.17 s at
    # 8,192 against 2.25 s at 4,096 (100,000 rows, 4 shards on the card);
    # at 499,712 rows 51.2 s at 2,048 against 56.0 s at 1,024 while the
    # lead card formed the sum (peak 24.5 GB), and 37.6 s at 4,096 since
    # no sum is formed (peak 45.9 GB: the counted partials, the chunk
    # loop's product being added in, the index).
    _stripe_acc_budget = 1 << 35  # 32 GiB

    def _stripe_accs(self) -> int:
        """Counted on the busiest card: every local shard's partial, live
        until the epilogue; on one process the row slices of the other
        cards' partials copied in (``ops/chunked_mesh``: each card sums
        its own rows, so no sum is formed; ceil of their rows over a
        partial's); over several processes the sum (``_reduced``) and
        the running sum crossing in.  One shard holds one.  The product
        the chunk loop adds into a partial is not counted, as in the
        single engine: it is the budget's headroom."""
        if self.n_shards == 1:
            return 1
        local = [str(self.mesh.devices[s]) for s in self.mesh.local_shards]
        busiest = max(local.count(d) for d in local)
        if self.mesh.n_procs > 1:
            return busiest + 2
        cards = len(set(local))
        return busiest + -(-(len(local) - busiest) // cards)

    def _op_stripe(self, q0: int, tau_eff, super_tile: int):
        q8 = self._int8_slabs()
        if q8 is not None:
            q2d, aux = q8
            return cm_ops.mesh_stripe_extract_int8(
                self.mesh, self._ent[0], self._ent[1], q2d,
                self._local_counts(), aux, q0, tau_eff, self.row_cap,
                self._chunk_width, super_tile, timer=self.timer,
                stats=self.stats,
            )
        return cm_ops.mesh_stripe_extract(
            self.mesh, *self._ent, self._local_counts(), q0, tau_eff,
            self.row_cap, self._chunk_width, super_tile,
            self.cfg.matmul_precision, timer=self.timer, stats=self.stats,
        )

    # ------------------------------------------------------ mesh panel join
    def _panel_geom(self):
        """``(rb, 64, 128, n_panels, d_cap)`` or None.  Kernel 4 runs per
        shard on ``[rb, d_cap / n_shards]`` slabs at its fixed 64 x 128
        tiles, so a ``panel_rows`` override needs ``rb % 128``.  ``rb`` is
        the single-device engine's cost model (``_pick_panel_rows``) from 512
        rows, over the global width, with the budgets per shard
        (``_slab_bytes``, ``_pair_bytes``).  ``d_cap`` here is ``n_shards``
        slab widths."""
        gkey = (self.n_rows, self._n_chunks, self._chunk_width)
        if self._panel_geom_cache is not None and (
                self._panel_geom_cache[0] == gkey):
            return self._panel_geom_cache[1]
        d_cap = self.n_shards * panel_mesh.slab_width(
            self._n_chunks * self._chunk_width, self.n_shards)
        n = max(self.n_rows, 1)
        rb = self.panel_rows
        if rb is None:
            rb = self._pick_panel_rows(n, d_cap, 512)
        geom = None
        if rb % panel_mesh.MM_TN == 0:
            geom = (rb, panel_mesh.MM_TM, panel_mesh.MM_TN,
                    round_up(n, rb) // rb, d_cap)
        self._panel_geom_cache = (gkey, geom)
        return geom

    # The mesh join's rate for the cost model (``_pick_panel_rows``), in
    # multiply-adds per second: kernel 4, the placement of the partials'
    # row slices and kernel 5 together, (join - pairs *
    # ``_panel_pp_resident``) over padded^2 / 2 * d_cap, measured on an
    # NVIDIA H100 80GB HBM3 at a 700 W power limit with 4 shards on the
    # one card (``bench/constants_ab``, PERF.md): 5.7-6.3e14 at 100,000
    # rows on 8,192-row panels, 5.9-6.1e14 on 16,384, 6.7e14 at 499,712
    # rows on 16,384 (8 shards on the card: 4.6e14).  With one shard a
    # card (``chip_smoke.py --mesh-cards 4``, four such cards) the same
    # joins ran at 5.1e14 (100,000 rows) and 5.5e14 (499,712), within
    # 18.8 % of it, and any rate from 2.8e14 to 1.5e15 gives the same
    # picks (8,192-row panels at 20,000 rows, 16,384 at 100,000 and
    # 499,712), so one rate serves both layouts.  At 100,000 rows 16,384
    # is the faster: 0.40-0.41 s against 0.45-0.47 s on 8,192 (8 shards:
    # 0.50-0.51 against 0.55-0.56).
    _panel_int8_rate = 6.2e14
    # A shard's slab and its int32 ``[rb, rb]`` partial product at most
    # 1 GiB (``_pair_bytes``): on 16,384-row panels the 499,712-row join
    # with 4 shards on one card peaked at 23.2-23.8 GB and took 7.11-7.20
    # s, against 9.41-9.44 s on 8,192-row panels.
    _panel_slab_budget = 1 << 30

    def _slab_bytes(self, rb: int, d_cap: int) -> int:
        return rb * (d_cap // self.n_shards)

    def _pair_bytes(self, rb: int, d_cap: int) -> int:
        """A shard's slab or its int32 ``[rb, rb]`` partial product (kernel
        4's output, which the reduce sums), the larger."""
        return max(self._slab_bytes(rb, d_cap), 4 * rb * rb)

    def _single_slab_ok(self, state) -> bool:
        return False

    def _panel_state(self):
        """Per-shard join state (``panel_mesh.mesh_panel_state``): sorted
        entries with slab-local columns and panel start offsets per shard,
        the global aux tables per panel on the lead device.  None when the
        int32 gate trips."""
        geom = self._panel_geom()
        if geom is None:
            return None
        key = (self._ent_key(), geom)
        cached = self._panel_state_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        rb, _, _, n_panels, d_cap = geom
        with self._stage("quantize_sort"):
            r_s, c_s, q_s, pcounts, aux, max_nnz = (
                panel_mesh.mesh_panel_state(
                    self.mesh, self.row_cap, rb, n_panels, *self._ent,
                    self._counts_dev,
                ))
            state = None
            if max_nnz < INT8_NNZ_GATE:
                starts = []
                for pc in pcounts:
                    st = None
                    if pc is not None:
                        st = np.zeros(n_panels + 1, np.int64)
                        np.cumsum(pc[:n_panels].cpu().numpy(), out=st[1:])
                    starts.append(st)
                padded = n_panels * rb
                if padded > aux.shape[1]:
                    aux = torch.nn.functional.pad(
                        aux, (0, padded - aux.shape[1]))
                state = {
                    "geom": geom, "r_s": r_s, "c_s": c_s, "q_s": q_s,
                    "starts": starts, "d_local": d_cap // self.n_shards,
                    "aux_of": [
                        aux[:, p * rb:(p + 1) * rb].contiguous()
                        for p in range(n_panels)
                    ],
                }
        self._panel_state_cache = (key, state)
        return state

    def _build_slab(self, state, p: int):
        with self._stage("slabs"):
            return panel_mesh.mesh_build_panel_slab(
                state["r_s"], state["c_s"], state["q_s"], state["starts"],
                p, state["geom"][0], state["d_local"],
            )

    def _op_panel_pair(self, state, xi, xj, pi: int, pj: int, tau_eff,
                       tally=None):
        """The pair end to end (``panel_mesh.mesh_panel_pair``, its counts
        checked there), as an already finished pending pair."""
        rb = state["geom"][0]
        return ts.Ready(panel_mesh.mesh_panel_pair(
            self.mesh, xi, xj, state["aux_of"][pi], state["aux_of"][pj],
            pi * rb, pj * rb, tau_eff, timer=self.timer, stats=self.stats,
        ))

    # ---------------------------------------------------------- introspection
    def shard_layout(self) -> dict:
        """Which global dim-chunks each shard owns and how many entries it
        holds, keyed by (shard, device): with repeated devices a device
        alone does not name a shard."""
        if self._ent is None:
            return {}
        n_local = self._n_chunks // self.n_shards
        return {
            (i, str(d)): {
                "chunk_block": (i * n_local, (i + 1) * n_local),
                "n_entries": self.stats["shard_entries"][i],
            }
            for i, d in enumerate(self.mesh.devices)
        }
