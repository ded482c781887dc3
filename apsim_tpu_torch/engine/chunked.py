"""Out-of-core all-pairs engine: the PyTorch counterpart of
``apsim_tpu/engine/chunked.py`` (the batch-join slice).

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

``load`` reads the JAX package's checkpoints: a chunked-flavor checkpoint's
``chunk_*`` arrays are placed as they are, any other is rebuilt from its CSR
shadow.  ``insert``, ``topk``, ``freeze`` and ``save`` are not ported yet
and raise ``NotImplementedError``.
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
from ..ops import tri_score as ts
from ..utils.logging import Timer
from ..vector.batch import CSRMatrix, GrowableCSR, pow2_bucket, round_up
from .engine import Engine, _as_csr, _not_ported
from .output import PairResult

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
        if self.cfg.profile_dir:
            raise _not_ported("profile_dir tracing", "item I")
        self.chunk_dim = int(chunk_dim)
        # panel-join row-block override (tests / tuning); None = cost model
        self.panel_rows = None if panel_rows is None else int(panel_rows)
        # query-stripe width of the stripe join: wide stripes amortize the
        # per-chunk slab densify over more query columns; sized by
        # ``_q_super`` unless overridden here
        self.super_tile = None if super_tile is None else int(super_tile)
        self._q8_cache = None  # (key, (q2d, aux)) of the int8 stripes
        self._ent = None  # device (rows2d, cols2d, vals2d) [n_chunks, cap]
        self._ent_host = None  # host mirror of _ent (checkpoint layout)
        self._counts = None  # np int64 [n_chunks]
        self._counts_dev = None  # device int32 copy
        self._n_chunks = 1
        self._chunk_cap = 0
        self._shadow: GrowableCSR | None = None
        self.ids: List[str] = []
        self.n_rows = 0
        self._max_norm = 0.0
        self._compact = CompactSpace(self.cfg.vector_dim, self.cfg.dim_bucket)
        self.max_weights = np.zeros(self.cfg.vector_dim, dtype=np.float64)
        self.stats: Dict[str, float] = {
            "vectors_indexed": 0,
            "candidates_scored": 0,
            "pairs_emitted": 0,
            "dormant_dims": 0,
        }
        self.timer = Timer()
        # dormant-dim archive (df==1 dims stay off the device)
        self._dorm_rows = np.empty(0, np.int64)
        self._dorm_dims = np.empty(0, np.int64)
        self._dorm_vals = np.empty(0, np.float64)
        self._dormant_of_ext: np.ndarray | None = None
        self._panel_geom_cache = None
        self._panel_state_cache = None
        self._compact_rescore_cache = None

    # dormant-dim archive, margin policy and device wait shared with the
    # dense engine (one definition each, as in the JAX package; the mesh
    # subclass's _sync waits for every shard's device)
    _sync = Engine._sync
    _drop_unmapped = Engine._drop_unmapped
    _archive_dormant = Engine._archive_dormant
    _margin_rel = Engine._margin_rel
    _margin = Engine._margin
    _tau_eff = Engine._tau_eff

    @property
    def compact(self) -> CompactSpace:
        return self._compact

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
        self._shadow = GrowableCSR(self.cfg.vector_dim)
        self._shadow.append(csr)
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
        self._counts_dev = torch.from_numpy(
            self._counts.astype(np.int32)
        ).to(self.device)
        self._panel_geom_cache = None
        self._panel_state_cache = None
        self._compact_rescore_cache = None
        self._q8_cache = None

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
        """Identity and version of the values buffer the int8 cache was
        quantized from (a tensor updated in place keeps its identity)."""
        v = self._ent[2]
        return (id(v), v._version)

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
        cached = self._panel_state_cache
        if cached is not None and cached[0] == geom:
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
        self._panel_state_cache = (geom, state)
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
        tau = self.cfg.similarity_threshold if tau is None else float(tau)
        if self.n_rows == 0:
            return PairResult(
                np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64), [],
            )
        with self.timer.section("all_pairs"):
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

    # ------------------------------------------------------- not ported yet
    def insert(self, vectors, tau=None, bulk=False, defer=False):
        raise _not_ported("chunked streaming insert", "item B")

    def topk(self, queries, k):
        raise _not_ported("chunked topk", "item B")

    def freeze(self) -> None:
        raise _not_ported("chunked freeze", "item B")

    def save(self, path: str) -> None:
        raise _not_ported("chunked save", "item C")

    # ------------------------------------------------------------- checkpoint
    def restore(self, path: str) -> None:
        """Restore this (empty) engine from a JAX-package checkpoint of
        either flavor.  A chunked checkpoint's entry-buffer layout
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
        self._shadow = GrowableCSR(self.cfg.vector_dim)
        self._shadow.append(csr)
        self.n_rows = csr.n_rows
        self._n_chunks = n_chunks
        self._chunk_cap = chunk_cap
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
        """Engine restored from a checkpoint written by the JAX package's
        ``Engine.save`` or ``ChunkedAllPairs.save``; ``kw`` goes to the
        constructor (``device``, ``chunk_dim``, ... ; the mesh subclass:
        ``mesh``)."""
        eng = cls(Engine.checkpoint_engine_config(path, config), **kw)
        eng.restore(path)
        return eng
