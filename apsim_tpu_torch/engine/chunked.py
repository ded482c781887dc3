"""Out-of-core all-pairs engine: the PyTorch counterpart of
``apsim_tpu/engine/chunked.py``.

The dense :class:`~apsim_tpu_torch.engine.engine.Engine` holds
``rows × dim_cap`` floats on the device.  ``ChunkedAllPairs`` keeps only
per-chunk COO entry buffers there (``O(nnz)``) and runs the same exact join
through the block-panel path (``ops/panel.py``):

  1. quantize the entries to int8 per row and sort them by row
     (``ops/chunked.quantize_chunk_entries``, ``ops/panel.sort_entries_by_row``);
  2. densify ``rb``-row panels into int8 slabs ``[rb, d_cap]``;
  3. score every panel pair (I <= J) with the cross-panel CUDA kernel and
     compact its bit-packed hits to exact-length global (row, col) lists;
  4. rescore every candidate in fp64 on the host, so the emitted pair set
     equals the fp64 brute-force oracle.

When all slabs fit ``_panel_resident_bytes`` they stay resident for the
sweep; otherwise a blocked-I rolling sweep keeps ``B`` row panels resident
per scan over the column panels, so each column slab built serves ``B``
panel pairs.  In-flight slabs are bounded by dropping references: torch's
stream-ordered allocator reuses a slab's memory only after the kernels
queued on it.

A configuration the panel kernels refuse (``pallas_int8=False``,
``use_pallas="off"``, a ``panel_rows`` they do not tile, a tripped int32
gate) takes the stripe join (``ops/chunked.chunked_stripe_extract``): one
``super_tile``-wide query stripe at a time against per-chunk slabs, bf16 by
default, fp32 at ``matmul_precision="highest"``, int8 through kernel 4 when
``_int8_stripes`` is set.

``insert`` streams micro-batches matched online against the live index
(index-before-query, so intra-batch pairs come out both ways), with the
component filter, admission pruning and the dormant-dim tier shared with
the dense engine.  A batch is appended to the entry buffers (capacity
doubling, host mirror kept in step) and matched on one of four routes:

  - resident: every chunk slab stays on the device as one stacked
    ``[n_chunks, row_cap, width]`` tensor (bf16, fp32 at "highest") while it
    fits ``match_slab_budget_mb``; inserts set their entries into it, so a
    match is products only;
  - host: beyond the budget, a scipy spGEMM of the fp64 shadow against the
    batch, when the cost model says it is cheaper than the device;
  - paneled: beyond the budget, ``ph``-row panels densified from a
    row-sorted flat COO kept in step with the appends;
  - rebuild: every chunk slab densified per match (the paneled route's
    class opt-out).

Each device route scores through ``score.score_tile`` (fp32 scores) and
keeps ``s >= tau_eff`` by exact-length ``torch.nonzero``; the fp64 rescore
decides the output.  ``topk`` is the provably exact k-nearest query (fetch
grown until the margin proof holds, fp64 re-rank); ``freeze`` turns inserts
into frozen-index matching.

``save`` writes the dense engine's checkpoint plus the ``chunk_*`` arrays
of the JAX package's chunked flavor (the entry buffers' host mirror, the
compact space, the document frequencies, the dormant archive), so either
package restores the other's checkpoint.  ``load`` places a chunked-flavor
checkpoint's arrays as they are and rebuilds any other from its CSR
shadow; the static max-weight map (``set_max_weight_map``) comes back with
it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import AllPairsConfig
from ..index.compact import CompactSpace
from ..ops import chunked as chunked_ops
from ..ops import panel as panel_ops
from ..ops import rescore as rescore_ops
from ..ops import score as score_ops
from ..ops import tri_score as ts
from ..utils.logging import Timer
from ..vector.batch import (CSRMatrix, GrowableCSR, pack_coo_i32,
                            pow2_bucket, round_up)
from .engine import (Engine, _as_csr, _CompletedInsert,
                     assemble_topk, fetch_exact_topk)
from .output import PairResult, SimilarityOutput

__all__ = ["ChunkedAllPairs"]

# the int32 accumulator of the int8 kernels holds 127^2 * max_nnz
INT8_NNZ_GATE = (1 << 30) // (127 * 127)


class ChunkedAllPairs:
    def __init__(self, config: AllPairsConfig | None = None,
                 device: torch.device | str = "cuda", chunk_dim: int = 2048,
                 super_tile: int | None = None,
                 panel_rows: int | None = None):
        self.cfg = config or AllPairsConfig()
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested, no CUDA")
        self.chunk_dim = int(chunk_dim)
        # panel-join row-block override (tests / tuning); None = cost model
        self.panel_rows = None if panel_rows is None else int(panel_rows)
        # query-stripe width of the stripe join: wide stripes amortize the
        # per-chunk slab densify over more query columns; sized by
        # ``_q_super`` unless overridden here
        self.super_tile = None if super_tile is None else int(super_tile)
        self._q8_cache = None  # (key, (q2d, aux)) of the int8 stripes
        self._ent = None  # device (rows2d, cols2d, vals2d) [n_chunks, cap]
        self._ent_gen = 0  # bumped whenever _ent is replaced (_ent_key)
        self._ent_host = None  # host mirror of _ent (checkpoint layout)
        self._mslab = None  # resident match slabs [n_chunks, row_cap, width]
        self._sort_state: dict | None = None  # the paneled match's COO
        # the route of the last match: "resident_slabs", "host_spgemm",
        # "device_paneled" or "device_rebuild"
        self.last_route: str | None = None
        self._counts = None  # np int64 [n_chunks]
        self._counts_dev = None  # device int32 copy
        self._n_chunks = 1
        self._chunk_cap = 0
        self._shadow: GrowableCSR | None = None
        self.ids: List[str] = []
        self.id_to_row: Dict[str, int] = {}
        self._static_max_weights: np.ndarray | None = None
        self.n_rows = 0
        self._max_norm = 0.0
        self._frozen = False
        # per-external-dim document frequencies (the host router's cost)
        self._ext_df: np.ndarray | None = None
        self._compact = CompactSpace(self.cfg.vector_dim, self.cfg.dim_bucket)
        self.max_weights = np.zeros(self.cfg.vector_dim, dtype=np.float64)
        self.stats: Dict[str, float] = {
            "vectors_indexed": 0,
            "candidates_scored": 0,
            "pairs_emitted": 0,
            "insert_batches": 0,
            "dormant_dims": 0,
            "vectors_dropped_admission": 0,
        }
        self.timer = Timer()
        # dormant-dim archive (df==1 dims stay off the device)
        self._dorm_rows = np.empty(0, np.int64)
        self._dorm_dims = np.empty(0, np.int64)
        self._dorm_vals = np.empty(0, np.float64)
        self._dorm_buf = None  # capacity-doubling backing of the three above
        self._dormant_of_ext: np.ndarray | None = None
        self._panel_geom_cache = None
        self._panel_state_cache = None
        self._compact_rescore_cache = None

    # dormant-dim archive, admission, margin policy and device wait shared
    # with the dense engine (one definition each, as in the JAX package:
    # they touch only the compact space, the archive, the max-weight maps
    # and the host CSRs; the mesh subclass's _sync waits for every shard)
    _sync = Engine._sync
    _drop_unmapped = Engine._drop_unmapped
    _archive_dormant = Engine._archive_dormant
    _dormant_hits = Engine._dormant_hits
    _stream_archive_singletons = Engine._stream_archive_singletons
    _dorm_append = Engine._dorm_append
    _admit = Engine._admit
    _margin_rel = Engine._margin_rel
    _margin = Engine._margin
    _tau_eff = Engine._tau_eff
    set_max_weight_map = Engine.set_max_weight_map
    _restore_static_map = Engine._restore_static_map
    # the profile_dir trace around every all_pairs / insert
    _maybe_trace = Engine._maybe_trace

    @property
    def compact(self) -> CompactSpace:
        return self._compact

    def shadow_csr(self) -> CSRMatrix:
        """The fp64 host shadow of every indexed row."""
        return self._shadow.view() if self._shadow is not None else CSRMatrix(
            0, self.cfg.vector_dim, np.zeros(1, np.int64),
            np.empty(0, np.int32), np.empty(0, np.float64),
        )

    # ------------------------------------------------------------------ sizes
    @property
    def row_cap(self) -> int:
        """Slab height: the row count rounded up to a build-time quantum
        (1024-8192 rows, 16,384 above 131,072 rows, 32,768 above 262,144)."""
        n = max(self.n_rows, 1)
        q = min(8192, pow2_bucket(n, 1024))
        if n > 131_072:
            q = 16_384
        if n > 262_144:
            q = 32_768
        return round_up(n, q)

    @property
    def _chunk_width(self) -> int:
        """Slab width covering the largest local dim (``chunk_dim``
        doublings)."""
        need = -(-self._compact.capacity // self._n_chunks)
        w = self.chunk_dim
        while w < need:
            w *= 2
        return w

    def _max_row_nnz(self) -> int:
        """Largest shadow-row nnz (the n in the fp32 accumulation bound)."""
        if self._shadow is None or self._shadow.n_rows == 0:
            return 0
        return int(self._shadow.view().row_nnz().max())

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Timer section that ends with the device idle, so each stage of
        the split holds its own device time."""
        with self.timer.section(name):
            yield
            self._sync()

    # ------------------------------------------------------------------ build
    def build(self, vectors, ids: Sequence[str] | None = None) -> dict:
        t0 = time.time()
        csr, self.ids = _as_csr(vectors, ids, self.cfg.vector_dim)
        self.id_to_row = {v: k for k, v in enumerate(self.ids)}
        self._shadow = GrowableCSR(self.cfg.vector_dim)
        self._shadow.append(csr)
        self._ext_df = np.bincount(
            csr.indices, minlength=self.cfg.vector_dim
        ).astype(np.int64)
        self.n_rows = csr.n_rows
        self._compact = CompactSpace.from_csr(
            csr, self.cfg.dim_bucket,
            min_df=2 if self.cfg.dormant_dims else 1,
        )
        kept = self._archive_dormant(csr)
        # gather-only dim remap: the bucketing below is order-free
        ccols = self._compact.map_cols(kept.indices)
        n_chunks = self._round_chunks(
            max(1, -(-self._compact.n_active // self.chunk_dim))
        )
        self._n_chunks = n_chunks
        rows_of = np.repeat(
            np.arange(kept.n_rows, dtype=np.int32), np.diff(kept.indptr)
        )
        chunk, local = chunked_ops.split_chunks(ccols, n_chunks)
        per = np.bincount(chunk, minlength=n_chunks).astype(np.int64)
        self._chunk_cap = pow2_bucket(
            max(int(per.max()) if per.size else 1, 1), 1024
        )
        rows2d, cols2d, vals2d, counts = chunked_ops.bucket_split_entries(
            rows_of, chunk, local, kept.data, per, self._chunk_cap,
            panel_ops.PAD_ROW,
        )
        self._place(rows2d, cols2d, vals2d, counts)
        # margin bookkeeping (same policy as the dense engine)
        norms = csr.row_norms()
        self._max_norm = float(norms.max()) if norms.size else 0.0
        np.maximum.at(self.max_weights, csr.indices, csr.data)
        self.stats["vectors_indexed"] += csr.n_rows
        self._sync()
        return {
            "n_rows": self.n_rows,
            "row_cap": self.row_cap,
            "n_chunks": n_chunks,
            "chunk_dim": self.chunk_dim,
            "entries": int(csr.indptr[-1]),
            "chunk_cap": self._chunk_cap,
            "build_seconds": time.time() - t0,
        }

    def _round_chunks(self, n: int) -> int:
        """Chunk count for ``n`` needed chunks (the mesh subclass rounds up
        to a multiple of its shard count)."""
        return n

    def _place(self, rows2d, cols2d, vals2d, counts) -> None:
        """Put the entry buffers on the device (host mirror kept) and drop
        every state derived from the previous corpus."""
        self._ent_host = (rows2d, cols2d, vals2d)
        self._ent = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in self._ent_host
        )
        self._counts = np.asarray(counts, np.int64)
        self._counts_dev = self._place_counts(self._counts)
        self._new_corpus()

    def _place_counts(self, counts: np.ndarray):
        """The device copy of the chunk counts (int32; the mesh subclass
        keeps one per shard)."""
        return torch.from_numpy(counts.astype(np.int32)).to(self.device)

    def _new_corpus(self) -> None:
        """Release every state derived from the previous corpus' entry
        buffers (an append keeps the resident stack and the sorted state in
        step instead, and the caches keyed by ``_ent_key`` miss)."""
        self._ent_gen += 1
        self._panel_geom_cache = None
        self._panel_state_cache = None
        self._compact_rescore_cache = None
        self._q8_cache = None
        self._mslab = None
        self._sort_state = None

    # ------------------------------------------------------------ stripe join
    # accumulator budget of the automatic stripe width (bytes): carried
    # over from the JAX package, where it was sized for a TPU v5e; still
    # to recalibrate on the H100
    _stripe_acc_budget = 6 << 30
    # int8 stripes (int8 slabs, kernel 4, int32 accumulator): opt-in; set
    # the attribute True.  Times on the H100 in PERF.md.  An instance also
    # demotes itself when the int32-accumulator gate trips.
    _int8_stripes = False

    def _q_super(self) -> int:
        """Stripe width: the widest power of two, from 1,024 to 8,192,
        whose fp32 accumulator (row_cap x stripe) stays under
        ``_stripe_acc_budget``, clamped to the row capacity (a power of two
        at most 8,192 always divides ``row_cap``), from the current row
        count at every call."""
        if self.super_tile is not None:
            # round DOWN to a power of two that DIVIDES row_cap.  Above
            # 8,192 rows row_cap is a multiple of 8,192 but not a power of
            # two, so a wider power of two (16,384 at row_cap 24,576) may
            # not divide it, and a non-divisor width would score the last
            # stripe against query rows past the slab's end while the
            # epilogue still labels its columns q0 + i: the pairs of those
            # rows would be lost silently
            st = 1
            while st * 2 <= self.super_tile:
                st *= 2
            st = min(st, self.row_cap)
            while self.row_cap % st:
                st //= 2
            return st
        padded = round_up(max(self.n_rows, 1), 8192)
        budget = self._stripe_acc_budget // (4 * padded)
        st = 1024
        while st * 2 <= min(budget, 8192):
            st *= 2
        return min(st, self.row_cap)

    def _quantize_entries(self):
        """``(q2d, aux, max_nnz)`` of the current entry buffers (the mesh
        subclass assembles the per-row maxima and sums across shards)."""
        return chunked_ops.quantize_chunk_entries(
            self._ent[0], self._ent[2], self.row_cap
        )

    def _ent_key(self):
        """State of the entry buffers that a derived cache (the int8
        stripes', the panel join's) was computed from: the generation of
        ``_ent``, bumped whenever the buffers are replaced (a build, a
        capacity growth), and the values buffer's in-place version, bumped
        by every append and activation."""
        return (self._ent_gen, self._ent[2]._version)

    def _int8_slabs(self):
        """Cached ``(q2d int8, aux)`` for the int8 stripes, quantized on
        the device from the current entry buffers; None when int8 stripes
        are off or the int32-accumulator gate refuses them."""
        if not (self._int8_stripes and self.cfg.pallas_int8):
            return None
        key = self._ent_key()
        cached = self._q8_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        q2d, aux, max_nnz = self._quantize_entries()
        if max_nnz >= INT8_NNZ_GATE:
            self._int8_stripes = False  # shadow the class flag
            self._q8_cache = None
            return None
        self._q8_cache = (key, (q2d, aux))
        return self._q8_cache[1]

    def _op_stripe(self, q0: int, tau_eff, super_tile: int):
        """Device candidates ``(rows, cols)`` of the query stripe at
        ``q0``."""
        q8 = self._int8_slabs()
        if q8 is not None:
            q2d, aux = q8
            return chunked_ops.chunked_stripe_extract_int8(
                self._ent[0], self._ent[1], q2d, self._counts, aux, q0,
                tau_eff, self.row_cap, self._chunk_width, super_tile,
                timer=self.timer,
            )
        return chunked_ops.chunked_stripe_extract(
            *self._ent, self._counts, q0, tau_eff, self.row_cap,
            self._chunk_width, super_tile, self.cfg.matmul_precision,
            timer=self.timer,
        )

    def _all_pairs_stripes(self, tau_eff):
        """The stripe join: host (rows, cols) candidate arrays.  A host
        loop over the query stripes; each stripe's lists have exact length,
        so there are no caps to grow and nothing to retry."""
        super_tile = self._q_super()
        found = [self._op_stripe(q0, tau_eff, super_tile)
                 for q0 in range(0, self.n_rows, super_tile)]
        ts.check_pair_count(sum(int(r.numel()) for r, _ in found))
        with self._stage("d2h"):
            return (torch.cat([r for r, _ in found]).cpu().numpy(),
                    torch.cat([c for _, c in found]).cpu().numpy())

    # ------------------------------------------------------------- panel join
    # cost-model calibration, carried over from the JAX package (measured
    # on a TPU v5e): per-panel-pair overhead beyond the int8 work, ~1 ms
    # with all slabs resident, ~30 ms rolling; the int8 rate 390e12 and the
    # 6 GB all-resident threshold below are the same v5e figures.  Still to
    # recalibrate on the H100.
    _panel_pp_resident = 1e-3
    _panel_pp_rolling = 30e-3
    # hard per-slab size guard (bytes); the cost model picks rb below it
    _panel_slab_budget = 1536 << 20
    # sweep budgets (bytes), v5e-sized: resident if ALL slabs fit; the
    # rolling sweep's in-flight slab bound otherwise
    _panel_resident_bytes = 6 << 30
    _panel_sweep_bytes = 10 << 30
    _panel_B_cap = 6  # resident row panels per column scan (rolling)
    # one dense-kernel launch over the whole padded matrix: OPT-IN (on the
    # TPU it measured slower than the sweep)
    _use_single_slab = False

    def _panel_ok(self) -> bool:
        if not self.cfg.pallas_int8 or self.cfg.use_pallas == "off":
            return False
        return self._panel_geom() is not None

    def _panel_geom(self):
        """``(rb, tm, tn, n_panels, d_cap)`` or None when no kernel geometry
        fits.  Tiles: (1024, 512) when ``d_cap`` is a multiple of 2048 (the
        JAX package's rule), else (64, 128), the smallest the CUDA kernel
        takes (``tm % 64``, ``tn % 128``).  ``d_cap`` is rounded up to the
        kernel's 128-byte K stage (zero columns add nothing).  ``rb``, a
        multiple of both tiles, minimizes the JAX package's cost model:
        padded int8 work (padding rows multiply zeros, quadratically)
        against a per-panel-pair overhead."""
        gkey = (self.n_rows, self._n_chunks, self._chunk_width)
        if self._panel_geom_cache is not None and (
                self._panel_geom_cache[0] == gkey):
            return self._panel_geom_cache[1]
        d_cap = round_up(self._n_chunks * self._chunk_width, ts.K_QUANTUM)
        tm, tn = (1024, 512) if d_cap % 2048 == 0 else (64, 128)
        step = max(tm, tn)  # both powers of two: rb % step covers both
        n = max(self.n_rows, 1)
        geom = None
        if self.panel_rows is not None:
            rb = self.panel_rows
            if rb % tm == 0 and rb % tn == 0:
                geom = (rb, tm, tn, round_up(n, rb) // rb, d_cap)
        else:
            budget_rows = max(step, self._panel_slab_budget // d_cap)
            best = None
            rb = step
            while rb <= budget_rows:
                padded = round_up(n, rb)
                np_ = padded // rb
                pairs = np_ * (np_ + 1) // 2
                keep_all = np_ * rb * d_cap <= (6 << 30)
                per_pair = (
                    self._panel_pp_resident if keep_all
                    else self._panel_pp_rolling
                )
                cost = padded * padded / 2 * d_cap / 390e12 + pairs * per_pair
                if best is None or cost < best[0]:
                    best = (cost, rb, padded)
                rb *= 2
            _, rb, padded = best
            geom = (rb, tm, tn, padded // rb, d_cap)
        self._panel_geom_cache = (gkey, geom)
        return geom

    def _panel_state(self):
        """Per-corpus join state: the row-sorted int8 COO, the panels'
        start offsets into it and their aux tables.  None when the
        int32-accumulator gate trips."""
        geom = self._panel_geom()
        if geom is None:
            return None
        key = (self._ent_key(), geom)
        cached = self._panel_state_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        rb, tm, tn, n_panels, d_cap = geom
        with self._stage("quantize_sort"):
            q2d, aux, max_nnz = chunked_ops.quantize_chunk_entries(
                self._ent[0], self._ent[2], self.row_cap
            )
            state = None
            if max_nnz < INT8_NNZ_GATE:
                r_s, gc_s, q_s, pcounts = panel_ops.sort_entries_by_row(
                    self._ent[0], self._ent[1], q2d, self._counts_dev, rb,
                    n_panels,
                )
                del q2d
                starts = np.zeros(n_panels + 1, np.int64)
                np.cumsum(pcounts[:n_panels].cpu().numpy(), out=starts[1:])
                padded = n_panels * rb
                if padded > aux.shape[1]:
                    aux = torch.nn.functional.pad(
                        aux, (0, padded - aux.shape[1])
                    )
                aux_p = aux[:, :padded].contiguous()
                state = {
                    "geom": geom, "r_s": r_s, "gc_s": gc_s, "q_s": q_s,
                    "starts": starts, "aux_p": aux_p,
                    "aux_of": [
                        aux_p[:, p * rb:(p + 1) * rb].contiguous()
                        for p in range(n_panels)
                    ],
                }
        self._panel_state_cache = (key, state)
        return state

    def _build_slab(self, state, p: int):
        rb, _, _, _, d_cap = state["geom"]
        s = state["starts"]
        with self._stage("slabs"):
            return panel_ops.build_panel_slab(
                state["r_s"], state["gc_s"], state["q_s"], int(s[p]),
                int(s[p + 1]), p * rb, rb, d_cap,
            )

    def _panel_schedules(self, state):
        """(diag, off) block schedules as device int32 tensors, cached."""
        if "schedules" not in state:
            rb, tm, tn, _, _ = state["geom"]
            state["schedules"] = tuple(
                tuple(torch.from_numpy(a).to(self.device) for a in grid)
                for grid in (panel_ops.diag_grid(rb, tm, tn),
                             panel_ops.full_grid(rb, rb, tm, tn))
            )
        return state["schedules"]

    def _op_panel_pair(self, state, xi, xj, pi: int, pj: int, tau_eff):
        """One panel pair through the cross-panel kernel: global (row, col)
        candidate lists on the device."""
        rb, tm, tn, _, _ = state["geom"]
        diag, off = self._panel_schedules(state)
        bi, bj = diag if pi == pj else off
        return panel_ops.panel_pair_extract_int8(
            xi, xj, state["aux_of"][pi], state["aux_of"][pj], bi, bj,
            pi * rb, pj * rb, tau_eff, tm, tn, timer=self.timer,
        )

    def _single_slab_ok(self, state) -> bool:
        if not self._use_single_slab:
            return False
        rb, _, _, n_panels, d_cap = state["geom"]
        return n_panels * rb * d_cap <= (6 << 30)

    def _all_pairs_single_slab(self, state, tau_eff):
        """One dense int8 kernel launch over the full padded matrix,
        densified from the sorted COO."""
        rb, _, _, n_panels, d_cap = state["geom"]
        padded = n_panels * rb
        tm, tn = (1024, 512) if padded % 1024 == 0 else (64, 128)
        with self._stage("slabs"):
            full = panel_ops.build_panel_slab(
                state["r_s"], state["gc_s"], state["q_s"], 0,
                int(state["starts"][-1]), 0, padded, d_cap,
            )
        bi, bj = (torch.from_numpy(a).to(self.device)
                  for a in ts.upper_blocks_rect(padded, tm, tn))
        return [ts.allpairs_extract_int8(
            full, state["aux_p"], bi, bj, tau_eff, tm, tn, timer=self.timer
        )]

    def _all_pairs_panel(self, tau_eff):
        """Panel-pair sweep; returns host (rows, cols) candidate arrays, or
        None when the int32 gate refuses the int8 path."""
        state = self._panel_state()
        if state is None:
            return None
        if self._single_slab_ok(state):
            found = self._all_pairs_single_slab(state, tau_eff)
        else:
            found = self._sweep(state, tau_eff)
        with self._stage("d2h"):
            if not found:
                return np.empty(0, np.int64), np.empty(0, np.int64)
            return (torch.cat([f[0] for f in found]).cpu().numpy(),
                    torch.cat([f[1] for f in found]).cpu().numpy())

    def _slab_bytes(self, rb: int, d_cap: int) -> int:
        """Per-device bytes of one int8 panel slab, which the sweep budgets
        are compared against (the mesh subclass: one shard's share)."""
        return rb * d_cap

    def _sweep(self, state, tau_eff) -> list:
        """Every panel pair (I <= J) through ``_op_panel_pair``.  A slab is
        whatever ``_build_slab`` returns (one tensor here, a per-shard list
        in the mesh subclass); the sweep only hands it on."""
        rb, _, _, n_panels, d_cap = state["geom"]
        slab_bytes = self._slab_bytes(rb, d_cap)
        found: list = []
        if n_panels * slab_bytes <= self._panel_resident_bytes:
            # all slabs resident for the whole sweep
            slabs = [self._build_slab(state, p) for p in range(n_panels)]
            for pi in range(n_panels):
                for pj in range(pi, n_panels):
                    found.append(self._op_panel_pair(
                        state, slabs[pi], slabs[pj], pi, pj, tau_eff
                    ))
            return found
        # Blocked-I rolling sweep: B row panels stay resident for one scan
        # over the column panels, so each column slab serves B panel pairs
        # (slab builds fall from ~n_pairs to ~n_pairs / B).  At most B + 1
        # slabs are referenced at a time.
        S = max(3, int(self._panel_sweep_bytes // max(slab_bytes, 1)))
        B = min(max(1, S // 2), self._panel_B_cap, n_panels)
        for i0 in range(0, n_panels, B):
            iblk = range(i0, min(i0 + B, n_panels))
            xis = {p: self._build_slab(state, p) for p in iblk}
            for pj in range(i0, n_panels):
                xj = xis.get(pj)
                if xj is None:
                    xj = self._build_slab(state, pj)
                for pi in iblk:
                    if pi <= pj:
                        found.append(self._op_panel_pair(
                            state, xis[pi], xj, pi, pj, tau_eff
                        ))
                del xj
            xis.clear()
        return found

    # -------------------------------------------------------------- all_pairs
    def all_pairs(self, tau: float | None = None) -> PairResult:
        """Exact thresholded all-pairs cosine join over the chunked index."""
        # release the resident match stack first: the join's own slabs need
        # the memory, and the next match rebuilds the stack lazily
        self._mslab = None
        tau = self.cfg.similarity_threshold if tau is None else float(tau)
        if self.n_rows == 0:
            return PairResult(
                np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64), [],
            )
        with self._maybe_trace(), self.timer.section("all_pairs"):
            tau_eff = self._tau_eff(tau)
            pairs = self._all_pairs_panel(tau_eff) if self._panel_ok() else None
            if pairs is None:  # refused by configuration, geometry or gate
                pairs = self._all_pairs_stripes(tau_eff)
            return self._rescore_pairs(pairs[0], pairs[1], tau)

    def _rescore_pairs(self, i, j, tau: float) -> PairResult:
        """Host fp64 rescore of device candidates — the step that makes the
        emitted pair set exact."""
        with self.timer.section("rescore"):
            i = np.asarray(i, np.int64)
            j = np.asarray(j, np.int64)
            self.stats["candidates_scored"] += int(i.size)
            shadow = self._shadow.view()
            compact = None
            if rescore_ops.grouped_available():
                key = (shadow.n_rows, int(shadow.indptr[-1]))
                cached = self._compact_rescore_cache
                if cached is None or cached[0] != key:
                    cached = (key, rescore_ops.build_compact(
                        shadow.indices, shadow.n_cols
                    ))
                    self._compact_rescore_cache = cached
                compact = cached[1]
            sims = rescore_ops.pair_dots(
                shadow.indptr, shadow.indices, shadow.data,
                i, j, shadow.n_cols, compact=compact,
            )
            keep = sims >= tau
            self.stats["pairs_emitted"] += int(keep.sum())
            return PairResult(i[keep], j[keep], sims[keep], list(self.ids))

    # ------------------------------------------------ entry-buffer appends
    def _append_ccoo(self, rows_of, ccols, vals, tail: bool = True) -> None:
        """Append COO entries (global rows, COMPACT cols, values) to the
        per-chunk buffers: bucket by chunk (a stable sort, ``slot = counts +
        rank``), double the capacity as needed, ship the entries in ONE
        packed int32 copy (chunk / slot / row / local / fp32 bits), set them
        into the buffers, the resident stack and the sorted state, and
        update the host mirror by the same scatter.  ``tail`` marks a
        streamed batch (rows at or above every existing row); ``tail=False``
        a dormant activation (older rows: the sorted state's overflow)."""
        chunk, local = chunked_ops.split_chunks(ccols, self._n_chunks)
        add = np.bincount(chunk, minlength=self._n_chunks).astype(np.int64)
        need = int((self._counts + add).max()) if chunk.size else 0
        while need > self._chunk_cap:
            self._chunk_cap *= 2
            self._grow_entries(self._chunk_cap)
        order = np.argsort(chunk, kind="stable")
        ch = chunk[order]
        starts = np.zeros(self._n_chunks + 1, np.int64)
        np.cumsum(add, out=starts[1:])
        slot = (
            np.arange(chunk.size) - starts[ch] + self._counts[ch]
        ).astype(np.int32)
        coo5 = np.empty((5, chunk.size), np.int32)
        coo5[0] = ch
        coo5[1] = slot
        coo5[2] = np.asarray(rows_of)[order]
        coo5[3] = local[order]
        coo5[4] = np.asarray(vals)[order].astype(np.float32).view(np.int32)
        if chunk.size:
            self._op_append(coo5, tail)
            r, c, v = self._ent_host
            r[ch, slot] = coo5[2]
            c[ch, slot] = coo5[3]
            v[ch, slot] = coo5[4].view(np.float32)
        self._counts = self._counts + add
        self._counts_dev = self._place_counts(self._counts)

    def _op_append(self, coo5: np.ndarray, tail: bool) -> None:
        """Set one packed ``[5, n]`` host batch (sorted by chunk) into the
        entry buffers in one H2D copy and keep the resident stack and the
        sorted state in step.  A stack of another geometry (row capacity or
        chunk width moved) is dropped, not grown: the next match rebuilds
        it, so the card never holds two."""
        coo5 = torch.from_numpy(coo5).to(self.device)
        ch, slot, row, local = coo5[0], coo5[1], coo5[2], coo5[3]
        val = coo5[4].view(torch.float32)
        chunked_ops.append_entries(*self._ent, ch, slot, row, local, val)
        m = self._mslab
        if m is not None:
            if (m.shape[1], m.shape[2]) != (self.row_cap, self._chunk_width):
                self._mslab = None
            else:
                chunked_ops.append_match_slabs(m, ch, row, local, val)
        self._sort_state_append(row, local * self._n_chunks + ch, val, tail)

    def _grow_entries(self, new_cap: int) -> None:
        """Double the per-chunk capacity on the device and in the host
        mirror (new slots carry the pad row)."""
        self._ent = self._op_grow(new_cap)
        self._ent_gen += 1
        r, c, v = self._ent_host
        grow = new_cap - r.shape[1]
        self._ent_host = (
            np.pad(r, ((0, 0), (0, grow)), constant_values=panel_ops.PAD_ROW),
            np.pad(c, ((0, 0), (0, grow))),
            np.pad(v, ((0, 0), (0, grow))),
        )

    def _op_grow(self, new_cap: int):
        """The entry buffers padded to ``new_cap`` slots per chunk."""
        return chunked_ops.grow_entry_cap(
            *self._ent, new_cap=new_cap, pad_row=panel_ops.PAD_ROW
        )

    def _activate_dormant(self, ext_dims: np.ndarray) -> None:
        """Insert-time activation: archived df==1 entries whose dim just got
        a compact column go into the entry buffers (``tail=False``), so
        new x old pairs through those dims score on the device.  The marks
        are cleared only after the append went through."""
        if self._dormant_of_ext is None:
            return
        uniq = np.unique(np.asarray(ext_dims))
        idxs = self._dormant_of_ext[uniq]
        sel = idxs >= 0
        if not sel.any():
            return
        dims, idxs = uniq[sel], idxs[sel]
        cols = self._compact.cols_of(dims).astype(np.int64)
        # this batch's fresh singletons are archived but still unmapped:
        # only dims that just received a compact column activate
        ok = cols >= 0
        if not ok.any():
            return
        dims, idxs, cols = dims[ok], idxs[ok], cols[ok]
        self._append_ccoo(
            self._dorm_rows[idxs], cols, self._dorm_vals[idxs], tail=False
        )
        self._dormant_of_ext[dims] = -1
        self.stats["dormant_dims"] -= int(dims.size)

    # --------------------------------------------------- resident match stack
    def _match_slabs(self):
        """The resident stack for the current geometry, built lazily; None
        when ``n_chunks * row_cap * width * itemsize`` exceeds
        ``match_slab_budget_mb``.  A geometry change drops the old stack
        before the new one is built."""
        if self._ent is None:
            return None
        dt = chunked_ops.slab_dtype(self.cfg.matmul_precision)
        rows, width = self.row_cap, self._chunk_width
        itemsize = 4 if dt == torch.float32 else 2
        budget = int(self.cfg.match_slab_budget_mb) << 20
        if self._n_chunks * rows * width * itemsize > budget:
            self._mslab = None
            return None
        m = self._mslab
        if m is not None and (m.shape[1], m.shape[2]) != (rows, width):
            self._mslab = m = None
        if m is None:
            with self._stage("match_slabs"):
                self._mslab = chunked_ops.build_match_slabs(
                    *self._ent, self._counts, rows, width, dt
                )
        return self._mslab

    # ------------------------------------------------------ paneled match
    # beyond the slab budget (the route's design: ops/chunked.py)
    _paneled_match = True   # class-level opt-out (then: the rebuild route)
    _sort_o_cap = 32768     # overflow region entries (activation spill)
    _paneled_q_cap = 8192   # query width limit ([ph, q] fp32 ~= 1 GB)
    _paneled_ph_cap = 32768  # max panel height (tests shrink it)

    def _paneled_ph(self, row_cap: int | None = None) -> int:
        """Panel height: the largest divisor of row_cap that is at most
        ``_paneled_ph_cap`` and a multiple of 64."""
        rc = self.row_cap if row_cap is None else row_cap
        k = -(-rc // int(self._paneled_ph_cap))
        while rc % k or (rc // k) % 64:
            k += 1
        return rc // k

    def _paneled_ok(self) -> bool:
        return (
            self._paneled_match
            and self._ent is not None
            and self._match_slabs() is None  # the resident route wins
        )

    def _sort_state_get(self) -> dict:
        """The sorted flat-COO state of the current corpus, (re)built
        lazily by one device sort of the entry buffers, with headroom for
        appends and an empty overflow region."""
        st = self._sort_state
        if st is not None:
            return st
        live = int(self._counts.sum())
        cap_s = pow2_bucket(live + max(65536, live // 4), 4096)
        with self._stage("sort_entries"):
            r_s, gc_s, v_s, n = chunked_ops.sort_entries(
                *self._ent, self._counts_dev, cap_s
            )
        o_cap = int(self._sort_o_cap)
        st = {
            "cap_s": cap_s, "n_ent": n, "r_s": r_s, "gc_s": gc_s, "v_s": v_s,
            "r_o": torch.full((o_cap,), panel_ops.PAD_ROW, dtype=torch.int32,
                              device=self.device),
            "gc_o": torch.zeros(o_cap, dtype=torch.int32, device=self.device),
            "v_o": torch.zeros(o_cap, dtype=torch.float32,
                               device=self.device),
            "n_o": 0,
        }
        self._sort_state = st
        return st

    def _sort_state_append(self, rows, gcols, vals, tail: bool) -> None:
        """Keep the sorted state in step with an append (the same device
        batch the entry buffers took).  A full sorted region or overflow
        region drops the state: the next paneled match re-sorts with
        headroom (consolidation)."""
        st = self._sort_state
        if st is None or rows.numel() == 0:
            return
        n, cap = ((st["n_ent"], st["cap_s"]) if tail
                  else (st["n_o"], int(self._sort_o_cap)))
        if n + rows.numel() > cap:
            self._sort_state = None
            return
        chunked_ops.append_sorted(st, rows, gcols, vals, tail)

    def _run_match_paneled(self, ccsr: CSRMatrix, q_base: int, tau_eff):
        """One paneled match: the query batch densified from ONE packed COO
        into ``[q, d_cap]`` (``q`` rounded up to 8 rows), then
        ``paneled_match_extract``."""
        st = self._sort_state_get()
        d_cap = self._n_chunks * self._chunk_width
        nq = ccsr.n_rows
        sdt = chunked_ops.slab_dtype(self.cfg.matmul_precision)
        q_rows = round_up(max(nq, 1), 8)
        qr = np.repeat(np.arange(nq, dtype=np.int64), np.diff(ccsr.indptr))
        coo = pack_coo_i32(qr, ccsr.indices, ccsr.data, q_rows, lo=1)
        qslab = score_ops.densify_rows(coo, q_rows, d_cap, sdt, self.device)
        return chunked_ops.paneled_match_extract(
            st, qslab, q_base, self.n_rows, self._paneled_ph(), tau_eff,
            self.cfg.matmul_precision, timer=self.timer,
        )

    # ------------------------------------------------- host streaming match
    # Beyond the slab budget a device route pays an O(corpus) densify per
    # batch; a scipy spGEMM of the fp64 shadow against the batch yields the
    # same candidate set (cut at tau - 1e-9, both sides fp64) and feeds the
    # same rescore.  The router weighs the spGEMM's corpus walk and its
    # intersections (the batch's document-frequency mass) against the
    # device's per-entry densify cost.
    _host_stream_match = True
    # Cost constants carried over from the JAX package, calibrated there on
    # a TPU v5e and its host; not yet measured for the H100 machine
    # (``bench/ooc.py --stream --router-ab`` measures both routes there).
    _host_ns_per_nnz = 6.0      # corpus-stream term of the spGEMM
    _host_ns_per_flop = 70.0    # per intersection + COO materialization
    _rebuild_ns_per_nnz = 20.0  # device slab densify (per entry)

    def _use_host_match(self, q_ext_indices: np.ndarray) -> bool:
        """Route this batch's match to the host spGEMM?  ``q_ext_indices``
        are the query entries' EXTERNAL dims.  Never while the resident
        stack fits; never without document frequencies."""
        if not self._host_stream_match:
            return False
        if self._ent is None or self._match_slabs() is not None:
            return False
        if self._ext_df is None:
            return False
        nnz = int(self._shadow.view().indptr[-1])
        est_flops = int(self._ext_df[np.asarray(q_ext_indices)].sum())
        host_cost = nnz * self._host_ns_per_nnz + (
            est_flops * self._host_ns_per_flop
        )
        return host_cost < nnz * self._rebuild_ns_per_nnz

    def _host_match_cross(self, q_csr: CSRMatrix, tau: float):
        """Candidates (index_row, query_local) of the whole shadow x the
        queries in fp64, cut at ``tau - 1e-9``."""
        import scipy.sparse as sp

        self.last_route = "host_spgemm"
        with self.timer.section("host_match"):
            shadow = self._shadow.view()
            x = sp.csr_matrix(
                (shadow.data, shadow.indices, shadow.indptr),
                shape=(shadow.n_rows, shadow.n_cols), copy=False,
            )
            q = sp.csr_matrix(
                (q_csr.data, q_csr.indices, q_csr.indptr),
                shape=(q_csr.n_rows, q_csr.n_cols), copy=False,
            )
            c = (x @ q.T).tocoo()
            keep = c.data >= tau - 1e-9
            return c.row[keep].astype(np.int64), c.col[keep].astype(np.int64)

    def _host_match_rows(self, n0: int, tau: float):
        """Host route of ``_match_rows``: the queries are shadow rows
        ``[n0, n_rows)``, already appended, so only the self-pair is
        excluded."""
        rows, qloc = self._host_match_cross(self._shadow_tail(n0), tau)
        nonself = rows != (n0 + qloc)
        return rows[nonself], qloc[nonself]

    def _shadow_tail(self, n0: int) -> CSRMatrix:
        """Shadow rows ``[n0, n_rows)`` as a CSR of their own."""
        sh = self._shadow.view()
        a = int(sh.indptr[n0])
        return CSRMatrix(sh.n_rows - n0, sh.n_cols, sh.indptr[n0:] - a,
                         sh.indices[a:], sh.data[a:])

    # ------------------------------------------------------------ match
    def _match_rows(self, n0: int, tau: float):
        """Cross-match index rows ``[n0, n_rows)`` (already appended)
        against the whole index: host (index_row, query_local) arrays."""
        sub = self._shadow_tail(n0)
        if self._use_host_match(sub.indices):
            return self._host_match_rows(n0, tau)
        # unmapped query dims only reach the excluded self-pair: dormant
        # dims and fresh singletons belong to one row each
        ccsr = self._compact.map_csr(self._drop_unmapped(sub), extend=False)
        return self._match_ccsr(ccsr, n0, self._tau_eff(tau))

    def _match_width_limit(self) -> int:
        """Largest power-of-two query width (at least 256) whose fp32
        ``[row_cap, width]`` match accumulator stays under 6 GB."""
        budget = (6 << 30) // (4 * self.row_cap)
        w = 256
        while w * 2 <= budget:
            w *= 2
        return w

    def _bucket_queries(self, ccsr: CSRMatrix, q_rows: int):
        """The compact query CSR bucketed by chunk, ``(rows2d, cols2d,
        vals2d, counts)``: the three buffers in ONE int32 copy to the
        device, the counts on the host."""
        rows_of = np.repeat(
            np.arange(ccsr.n_rows, dtype=np.int64), np.diff(ccsr.indptr)
        )
        chunk, _ = chunked_ops.split_chunks(ccsr.indices, self._n_chunks)
        per = np.bincount(chunk, minlength=self._n_chunks)
        q_cap = max(int(per.max()) if per.size else 1, 1)
        r2, c2, v2, cnts = chunked_ops.bucket_entries(
            rows_of, ccsr.indices.astype(np.int64), ccsr.data,
            self._n_chunks, q_cap, q_rows,
        )
        pk = torch.from_numpy(np.stack([r2, c2, v2.view(np.int32)])).to(
            self.device)
        return pk[0], pk[1], pk[2].view(torch.float32), cnts

    def _run_match(self, ccsr: CSRMatrix, q_base: int, q_rows: int, tau_eff):
        """One device match on the resident route, else the rebuild
        route: device (index_row, query_local)."""
        q = self._bucket_queries(ccsr, q_rows)
        mslab = self._match_slabs()
        if mslab is not None:
            return chunked_ops.cached_match_extract(
                mslab, q, q_base, tau_eff, q_rows, self.cfg.matmul_precision,
                timer=self.timer,
            )
        return chunked_ops.chunked_match_extract(
            *self._ent, self._counts, q, q_base, tau_eff, self.row_cap,
            self._chunk_width, q_rows, self.cfg.matmul_precision,
            timer=self.timer,
        )

    def _match_ccsr(self, ccsr: CSRMatrix, q_base: int, tau_eff):
        """Match a compact query CSR against the whole index in sub-batches
        of the route's width limit (the whole batch is indexed before any
        match, so intra-batch pairs surface whatever the split).  Returns
        host (index_row, query_local)."""
        nq = ccsr.n_rows
        paneled = self._paneled_ok()
        limit = (int(self._paneled_q_cap) if paneled
                 else self._match_width_limit())
        self.last_route = (
            "device_paneled" if paneled
            else "resident_slabs" if self._match_slabs() is not None
            else "device_rebuild")

        def run_one(part: CSRMatrix, base: int):
            if paneled:
                r, l = self._run_match_paneled(part, base, tau_eff)
            else:
                q_rows = min(round_up(max(part.n_rows, 1), 8), limit)
                r, l = self._run_match(part, base, q_rows, tau_eff)
            with self.timer.section("d2h"):
                return r.cpu().numpy(), l.cpu().numpy()

        rows_all, loc_all = [], []
        for s in range(0, max(nq, 1), limit):
            e = min(s + limit, nq)
            a, b = int(ccsr.indptr[s]), int(ccsr.indptr[e])
            part = CSRMatrix(e - s, ccsr.n_cols, ccsr.indptr[s:e + 1] - a,
                             ccsr.indices[a:b], ccsr.data[a:b])
            # q_base + s keeps the self-pair exclusion on the part's rows
            r, l = run_one(part, q_base + s)
            rows_all.append(r)
            loc_all.append(l + s)
        return np.concatenate(rows_all), np.concatenate(loc_all)

    # ----------------------------------------------------------------- insert
    def insert(self, vectors, tau: float | None = None, bulk: bool = False,
               defer: bool = False):
        """Streaming micro-batch insert matched online against the live
        chunked index, in the order of the dense engine's ``insert``:
        component filter (``index_threshold``) and admission pruning unless
        ``bulk``; a frozen engine only matches; an insert before any build
        builds and matches the batch against itself; otherwise the batch
        joins the index first and then queries it, so intra-batch pairs
        come out both ways.  ``defer=True`` returns an object whose
        ``result()`` gives the output (the insert itself is synchronous)."""
        with self._maybe_trace(), self.timer.section("insert"):
            out = self._insert_impl(vectors, tau, bulk)
        return _CompletedInsert(out) if defer else out

    def _insert_impl(self, vectors, tau, bulk: bool) -> SimilarityOutput:
        tau = self.cfg.similarity_threshold if tau is None else float(tau)
        filtered = []
        with self.timer.section("admit"):
            for vid, vec in vectors:
                if not bulk:
                    if self.cfg.index_threshold > 0:
                        vec = vec.filter_values_above(self.cfg.index_threshold)
                    if not self._admit(vec, tau):
                        self.stats["vectors_dropped_admission"] += 1
                        continue
                filtered.append((vid, vec))
        if not filtered:
            return SimilarityOutput({}, time.time())
        csr, new_ids = _as_csr(filtered, None, self.cfg.vector_dim)
        if self._shadow is None:
            if self._frozen:
                # frozen before anything was indexed: nothing to match and
                # nothing may be indexed
                return SimilarityOutput({}, time.time())
            self.build(csr, new_ids)
            return self._emit(self._match_rows(0, tau), new_ids, 0, tau)
        if self._frozen:
            return self._match_external(csr, new_ids, tau)
        n0 = self.n_rows
        with self.timer.section("prepare"):
            self.stats["insert_batches"] += 1
            self.stats["vectors_indexed"] += csr.n_rows
            # host bookkeeping first: the margin covers the batch's norms
            norms = csr.row_norms()
            if norms.size:
                self._max_norm = max(self._max_norm, float(norms.max()))
            np.maximum.at(self.max_weights, csr.indices, csr.data)
            self._shadow.append(csr)
            if self._ext_df is not None:
                np.add.at(self._ext_df, csr.indices, 1)
            self.ids.extend(new_ids)
            for k, vid in enumerate(new_ids):
                self.id_to_row[vid] = n0 + k
            self.n_rows = n0 + csr.n_rows
            # fresh df==1 dims stay archived; promoted dims mint columns
            keep_csr = self._stream_archive_singletons(csr, n0)
        with self._stage("append"):
            self._activate_dormant(csr.indices)
            ccsr = self._compact.map_csr(keep_csr, extend=False)
            rows_of = n0 + np.repeat(
                np.arange(csr.n_rows, dtype=np.int64), np.diff(ccsr.indptr)
            )
            self._append_ccoo(rows_of, ccsr.indices, ccsr.data)
        return self._emit(self._match_rows(n0, tau), new_ids, n0, tau)

    def _emit(self, pairs, qids: List[str], n0: int, tau: float):
        """fp64 rescore of the candidates (index_row, query_local) of the
        batch whose first row is ``n0``, shaped as {query: {row id: sim}}."""
        rows, qlocal = pairs
        if len(rows) == 0:
            return SimilarityOutput({}, time.time())
        with self.timer.section("rescore"):
            shadow = self._shadow.view()
            self.stats["candidates_scored"] += len(rows)
            rows = np.asarray(rows, np.int64)
            qlocal = np.asarray(qlocal, np.int64)
            sims = rescore_ops.pair_dots(
                shadow.indptr, shadow.indices, shadow.data, rows,
                qlocal + n0, shadow.n_cols,
            )
            out: Dict[str, Dict[str, float]] = {}
            keep = sims >= tau
            for r, q, s in zip(rows[keep], qlocal[keep], sims[keep]):
                out.setdefault(qids[int(q)], {})[self.ids[int(r)]] = float(s)
            self.stats["pairs_emitted"] += sum(len(v) for v in out.values())
        return SimilarityOutput(out, time.time())

    def _match_external(self, csr: CSRMatrix, qids, tau: float):
        """Frozen-index matching: queries are scored, not indexed.  Query
        norms beyond the index's widen the margin for this match only."""
        qn = csr.row_norms()
        saved = self._max_norm
        if qn.size:
            self._max_norm = max(saved, float(qn.max()))
        try:
            tau_eff = self._tau_eff(tau)
        finally:
            self._max_norm = saved
        if self._use_host_match(csr.indices):
            # the spGEMM walks the whole shadow: archived dormant entries
            # are in it, so no _dormant_hits patch
            rows, qlocal = self._host_match_cross(csr, tau)
        else:
            ccsr = self._compact.map_csr(self._drop_unmapped(csr),
                                         extend=False)
            # q_base past every row: no self-pair exclusion can trigger
            rows, qlocal = self._match_ccsr(ccsr, self.n_rows, tau_eff)
            # queries sharing a dormant dim with an archived row: the device
            # score missed that contribution, so the rows join explicitly
            extra_q, extra_r = self._dormant_hits(csr)
            if extra_q.size:
                rows = np.concatenate([rows, extra_r])
                qlocal = np.concatenate([qlocal, extra_q])
        out: Dict[str, Dict[str, float]] = {}
        with self.timer.section("rescore"):
            if len(rows):
                shadow = self._shadow.view()
                rows = np.asarray(rows, np.int64)
                qlocal = np.asarray(qlocal, np.int64)
                sims = rescore_ops.cross_pair_dots(
                    shadow.indptr, shadow.indices, shadow.data, shadow.n_cols,
                    csr.indptr, csr.indices, csr.data, qlocal, rows,
                )
                keep = sims >= tau
                for r, ql, s in zip(rows[keep], qlocal[keep], sims[keep]):
                    out.setdefault(qids[int(ql)], {})[self.ids[int(r)]] = (
                        float(s))
        return SimilarityOutput(out, time.time())

    # ----------------------------------------------------------------- freeze
    def freeze(self) -> None:
        """Stop index updates, keep answering queries: inserts become
        frozen-index matches."""
        self._frozen = True

    def unfreeze(self) -> None:
        self._frozen = False

    @property
    def frozen(self) -> bool:
        return self._frozen

    # ------------------------------------------------------------------- topk
    def topk(self, queries, k: int) -> Dict[str, list]:
        """k nearest neighbours per query over the chunked index, with the
        dense engine's provably exact fetch and fp64 re-rank
        (``Engine.topk``).  Batches wider than ``_match_width_limit`` are
        split (the ``[q, row_cap]`` fp32 score block is budgeted like the
        match's); the parts are independent and exact."""
        queries = list(queries)
        limit = self._match_width_limit()
        out: Dict[str, list] = {}
        for s in range(0, len(queries), limit):
            out.update(self._topk_impl(queries[s:s + limit], k))
        return out

    def _op_topk(self, q, q_rows: int, kf: int):
        """Device top ``kf`` per query: against the resident stack when it
        fits (scored at its dtype), else fp32 slabs at "highest"."""
        mslab = self._match_slabs()
        if mslab is not None:
            return chunked_ops.cached_topk(
                mslab, q, self.n_rows, q_rows, kf, self.cfg.matmul_precision,
            )
        return chunked_ops.chunked_topk(
            *self._ent, self._counts, q, self.n_rows, self.row_cap,
            self._chunk_width, q_rows, kf, "highest",
        )

    def _topk_impl(self, queries, k: int):
        if self.n_rows == 0:
            return {qid: [] for qid, _ in queries}
        qcsr, qids = _as_csr(list(queries), None, self.cfg.vector_dim)
        nq = len(qids)
        ccsr = self._compact.map_csr(self._drop_unmapped(qcsr), extend=False)
        q_rows = round_up(nq, 8)
        k_eff = min(k, self.n_rows)
        with self.timer.section("topk_fetch"):
            q = self._bucket_queries(ccsr, q_rows)

            def fetch(kf: int):
                s, r = self._op_topk(q, q_rows, kf)
                return s[:nq].cpu().numpy(), r[:nq].cpu().numpy()

            q_norms = qcsr.row_norms()
            qmax = float(q_norms.max()) if q_norms.size else 0.0
            # the device-error bound of the fetch proof: fp32 slabs at
            # "highest" on the rebuild route; the resident stack scores at
            # its dtype, so a bf16 stack takes the bf16 margin
            mslab = self._match_slabs()
            fp32_path = mslab is None or mslab.dtype == torch.float32
            rel = self._margin_rel("highest" if fp32_path else "default")
            m = rel * max(self._max_norm * qmax, 1.0)
            rows, k_fetch = fetch_exact_topk(fetch, self.n_rows, k_eff, 2 * m)
        with self.timer.section("topk_rescore"):
            shadow = self._shadow.view()
            qi_idx = np.repeat(np.arange(nq), k_fetch)
            cand_idx = rows.reshape(-1).astype(np.int64)
            # rows reachable only through a dormant dim join explicitly
            extra_q, extra_r = self._dormant_hits(qcsr)
            if extra_q.size:
                qi_idx = np.concatenate([qi_idx, extra_q])
                cand_idx = np.concatenate([cand_idx, extra_r])
            sims = rescore_ops.cross_pair_dots(
                shadow.indptr, shadow.indices, shadow.data, shadow.n_cols,
                qcsr.indptr, qcsr.indices, qcsr.data, qi_idx, cand_idx,
            )
        with self.timer.section("topk_assemble"):
            return assemble_topk(qids, qi_idx, cand_idx, sims, k_eff,
                                 self.ids)

    # ------------------------------------------------------------- checkpoint
    # The dense engine's on-disk format (one atomic npz of the host shadow
    # + ids), so checkpoints are interchangeable across engine flavors.
    save = Engine.save

    def _extra_npz(self) -> dict:
        """Chunked-flavor checkpoint extras, key for key and dtype for
        dtype those of the JAX package: the host mirror of the per-chunk
        entry buffers and every host structure the build pass derives, so
        ``restore`` is a device placement instead of a rebuild.  All keys
        are ``chunk_``-prefixed; other flavors ignore them."""
        if self._ent_host is None:
            return {}
        rows2d, cols2d, vals2d = self._ent_host
        dorm_map = self._dormant_of_ext
        has_map = dorm_map is not None
        return {
            "chunk_rows2d": rows2d,
            "chunk_cols2d": cols2d,
            "chunk_vals2d": vals2d,
            "chunk_counts": self._counts,
            "chunk_geom": np.array(
                [self._n_chunks, self._chunk_cap, self.chunk_dim,
                 int(self.cfg.dormant_dims)], np.int64,
            ),
            "chunk_ext_of_col": self._compact.ext_of_col,
            "chunk_base": np.array(
                [self._compact._base, self._compact.dim_bucket], np.int64
            ),
            "chunk_ext_df": (np.empty(0, np.int64) if self._ext_df is None
                             else self._ext_df),
            "chunk_max_norm": np.array([self._max_norm], np.float64),
            "chunk_dorm_rows": self._dorm_rows,
            "chunk_dorm_dims": self._dorm_dims,
            "chunk_dorm_vals": self._dorm_vals,
            # _dormant_of_ext stored sparse (dims with a live archive slot);
            # an int32 over vector_dim would be 4 MB of mostly -1
            "chunk_dorm_map_dims": (
                np.nonzero(dorm_map >= 0)[0] if has_map
                else np.empty(0, np.int64)
            ),
            "chunk_dorm_map_idx": (
                dorm_map[dorm_map >= 0] if has_map
                else np.empty(0, np.int32)
            ),
            "chunk_dorm_has_map": np.array([int(has_map)], np.int64),
        }

    def restore(self, path: str) -> None:
        """Restore this (empty) engine from a checkpoint of either package
        and either flavor.  A chunked checkpoint's entry-buffer layout
        (``chunk_*`` arrays) is placed as it is; a dense-flavor checkpoint,
        or one whose geometry differs from this engine's (``chunk_dim``,
        dormancy), is rebuilt from its CSR shadow."""
        if self.n_rows:
            raise RuntimeError("restore() on a non-empty engine")
        csr, ids, max_weights, ckpt_cfg = Engine.read_checkpoint(path)
        if int(ckpt_cfg["vector_dim"]) != self.cfg.vector_dim:
            raise ValueError(
                f"checkpoint vector_dim {ckpt_cfg['vector_dim']} != engine "
                f"config vector_dim {self.cfg.vector_dim} ({path})"
            )
        if csr.n_rows:
            z = np.load(os.path.join(path, "index.npz"))
            if self._fast_restorable(z):
                self._fast_restore(csr, ids, z)
            else:
                self.build(csr, ids)
        # merge the stored maxima with the build-recomputed ones
        self.max_weights = np.maximum(self.max_weights, max_weights)
        self._restore_static_map(path)

    def _fast_restorable(self, z) -> bool:
        if "chunk_geom" not in z:
            return False  # dense-flavor or pre-extras checkpoint
        n_chunks, _, chunk_dim, dormant = (int(v) for v in z["chunk_geom"])
        return (chunk_dim == self.chunk_dim
                and dormant == int(self.cfg.dormant_dims)
                # a mesh subclass needs n_chunks divisible by its shards
                and self._round_chunks(n_chunks) == n_chunks)

    def _fast_restore(self, csr: CSRMatrix, ids, z) -> None:
        """Place the checkpointed entry buffers; skip every build pass."""
        n_chunks, chunk_cap, _, _ = (int(v) for v in z["chunk_geom"])
        self.ids = list(ids)
        self.id_to_row = {v: k for k, v in enumerate(self.ids)}
        self._shadow = GrowableCSR(self.cfg.vector_dim)
        self._shadow.append(csr)
        self.n_rows = csr.n_rows
        self._n_chunks = n_chunks
        self._chunk_cap = chunk_cap
        self._ext_df = z["chunk_ext_df"]
        if self._ext_df.size == 0:  # saved without document frequencies
            self._ext_df = None
        base, dim_bucket = (int(v) for v in z["chunk_base"])
        cs = CompactSpace(self.cfg.vector_dim, dim_bucket)
        cs.ext_of_col = z["chunk_ext_of_col"].astype(np.int64)
        cs._col_of_ext[cs.ext_of_col] = np.arange(
            cs.n_active, dtype=np.int32
        )
        cs._base = base
        self._compact = cs
        self._dorm_rows = z["chunk_dorm_rows"]
        self._dorm_dims = z["chunk_dorm_dims"]
        self._dorm_vals = z["chunk_dorm_vals"]
        self._dorm_buf = None
        if int(z["chunk_dorm_has_map"][0]):
            m = np.full(self.cfg.vector_dim, -1, np.int32)
            m[z["chunk_dorm_map_dims"]] = z["chunk_dorm_map_idx"]
            self._dormant_of_ext = m
            self.stats["dormant_dims"] = int(z["chunk_dorm_map_dims"].size)
        else:
            self._dormant_of_ext = None
        self._place(z["chunk_rows2d"], z["chunk_cols2d"], z["chunk_vals2d"],
                    z["chunk_counts"])
        self._max_norm = float(z["chunk_max_norm"][0])
        self.stats["vectors_indexed"] += csr.n_rows

    @classmethod
    def load(cls, path: str, config: AllPairsConfig | None = None,
             **kw) -> "ChunkedAllPairs":
        """Engine restored from a checkpoint written by ``Engine.save`` or
        ``ChunkedAllPairs.save`` of either package; ``kw`` goes to the
        constructor (``device``, ``chunk_dim``, ... ; the mesh subclass:
        ``mesh``)."""
        eng = cls(Engine.checkpoint_engine_config(path, config), **kw)
        eng.restore(path)
        return eng
