"""Single-device all-pairs similarity engine (the PyTorch counterpart of
``apsim_tpu/engine/engine.py``).

One object holds:

  - a dense index matrix ``x [row_cap, dim_cap]`` on one device (the card,
    ``"cuda"``, unless the caller names another; no fallback to the CPU),
    over compact frequency-ordered columns (the inverted-index replacement);
  - a host float64 CSR shadow (exact rescoring, checkpoints);
  - running per-dimension max weights (admission pruning).

``build`` fills the index; ``all_pairs`` is the exact thresholded cosine
join: a kernel pass over the upper-triangle blocks keeps a proven candidate
superset at ``tau_eff`` and the host fp64 rescore makes the emitted pair set
equal the fp64 brute-force oracle.  An index the kernels refuse
(``use_pallas="off"``, ``matmul_precision="highest"``, capacities they do
not tile) takes the full-rectangle join of ``ops/score.allpairs_extract``.

``insert`` streams micro-batches matched online against the live index
(index-before-query, so intra-batch pairs come out both ways), with the
reference's component filter and admission pruning, dormant-dim
activation and a rollback on device failure; ``defer=True`` leaves the
candidates' D2H copy and fp64 rescore to ``PendingInsert.result``.
``topk`` is the provably exact k-nearest query (device fetch grown until
the margin proof holds, then an fp64 re-rank); ``freeze`` turns inserts
into frozen-index matching.  ``save`` writes the JAX package's checkpoint
format (one atomic ``index.npz`` from the host shadow, ``meta.json``
beside it), so a checkpoint written by either package restores in the
other; ``load`` reads it, the static max-weight map included.  With
``profile_dir`` set, every ``all_pairs`` and ``insert`` writes a
``torch.profiler`` trace there.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import AllPairsConfig
from ..index.compact import CompactSpace
from ..ops import rescore as rescore_ops
from ..ops import score as score_ops
from ..ops import tri_score
from ..utils.logging import Timer, get_logger, profile_trace
from ..vector.batch import CSRMatrix, pack_coo_i32, round_up
from ..vector.sparse import SparseVector
from .output import PairResult, SimilarityOutput

__all__ = ["Engine", "BuildStats", "PendingInsert", "assemble_topk",
           "fetch_exact_topk", "plain_stats"]


class BuildStats(dict):
    pass


def plain_stats(stats: dict) -> dict:
    """``stats`` with every NumPy or torch scalar as a Python number, so
    it survives ``json.dumps`` (checkpoints, the ``stats`` RPC)."""
    return {k: v.item() if hasattr(v, "item") else v
            for k, v in stats.items()}


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to apsim_tpu_torch yet (ROADMAP.md, queue 1, "
        f"{item}); use the JAX package apsim_tpu for it"
    )


def _as_csr(
    vectors: Sequence[Tuple[str, SparseVector]] | CSRMatrix,
    ids: Sequence[str] | None,
    vector_dim: int,
) -> Tuple[CSRMatrix, List[str]]:
    if isinstance(vectors, CSRMatrix):
        csr = vectors
        out_ids = list(ids) if ids is not None else [str(i) for i in range(csr.n_rows)]
    else:
        out_ids = [vid for vid, _ in vectors]
        csr = CSRMatrix.from_vectors([v for _, v in vectors], vector_dim)
    if len(out_ids) != csr.n_rows:
        raise ValueError("ids length mismatch")
    return csr, out_ids


class _CompletedInsert:
    """Already-finished insert result (frozen, empty and dropped batches)."""

    def __init__(self, out: SimilarityOutput):
        self._out = out

    def result(self) -> SimilarityOutput:
        return self._out


class PendingInsert:
    """Deferred completion of a streaming insert.

    When ``insert`` returns, the batch is in the index and its match has
    run on the device (``torch.nonzero`` waits for it); the candidates'
    D2H copy and the fp64 rescore are left to :meth:`result`, which a
    caller can run after handing the next batch to the engine (the
    server's ingest pipelining).  Safe across later inserts: the
    candidates are rows and columns of this insert's index state, and the
    rescore reads shadow rows that later inserts only append to."""

    def __init__(self, eng: "Engine", rows: torch.Tensor, cols: torch.Tensor,
                 tau: float):
        self._e = (eng, rows, cols, tau)
        self._out: SimilarityOutput | None = None

    def result(self) -> SimilarityOutput:
        if self._out is None:
            eng, rows, cols, tau = self._e
            with eng.timer.section("d2h"):
                rows, cols = rows.cpu().numpy(), cols.cpu().numpy()
            with eng.timer.section("rescore"):
                self._out = eng._emit_query_results(cols, rows, tau)
            self._e = None
        return self._out


def assemble_topk(qids, qi_idx, cand_idx, sims, k_eff: int, ids):
    """Group flat (query, candidate, sim) triples per query, dedup
    candidates (dormant-hit extras may repeat a fetched row) and return the
    fp64-ranked top ``k_eff`` per query id.  One stable argsort over the
    flat arrays instead of a per-query boolean mask — O(total·log total),
    not O(nq·total)."""
    out = {}
    qi_idx = np.asarray(qi_idx)
    order = np.argsort(qi_idx, kind="stable")
    qs = qi_idx[order]
    bounds = np.searchsorted(qs, np.arange(len(qids) + 1))
    for qi, qid in enumerate(qids):
        sel = order[bounds[qi] : bounds[qi + 1]]
        rr, ss = np.asarray(cand_idx)[sel], np.asarray(sims)[sel]
        uniq, first = np.unique(rr, return_index=True)
        rr, ss = uniq, ss[first]
        top = np.argsort(-ss, kind="stable")[:k_eff]
        out[qid] = [(ids[int(rr[t])], float(ss[t])) for t in top]
    return out


def fetch_exact_topk(fetch, n_rows: int, k_eff: int, margin: float):
    """Grow the candidate fetch until it provably contains the true top-k.

    ``fetch(k_fetch) -> (dev_scores [nq, k_fetch], rows [nq, k_fetch])``
    returns the device's top ``k_fetch`` per query, scores descending.  The
    fetched set is sufficient for query q once
    ``dev_scores[q, -1] < dev_scores[q, k_eff-1] - margin`` with
    ``margin = 2m`` (see Engine.topk docstring for the bound), because every
    unfetched candidate scores at most the minimum fetched score.  Fetching
    all ``n_rows`` is trivially sufficient.  Depths double, so at most
    O(log n) device calls happen, and only on adversarially tie-dense
    corpora.  The stop test is a strict ``<``, so the arbitrary order in
    which ``torch.topk`` returns tied scores cannot end the growth early.

    Returns ``(rows, k_fetch)`` of the final sufficient fetch.
    """
    k_fetch = min(n_rows, max(4 * k_eff, k_eff + 64))
    while True:
        scores, rows = fetch(k_fetch)
        if k_fetch >= n_rows:
            return rows, k_fetch
        cutoff = scores[:, k_eff - 1] - margin
        if bool(np.all(scores[:, -1] < cutoff)):
            return rows, k_fetch
        k_fetch = min(n_rows, 2 * k_fetch)


class Engine:
    def __init__(self, config: AllPairsConfig | None = None,
                 device: torch.device | str = "cuda"):
        self.cfg = config or AllPairsConfig()
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested, no CUDA")
        self.compact = CompactSpace(self.cfg.vector_dim, self.cfg.dim_bucket)
        self.x = None  # device [row_cap, dim_cap] (property: see below)
        self.n_rows = 0
        self.ids: List[str] = []
        self.id_to_row: Dict[str, int] = {}
        # host fp64 shadow (external dim space): growable CSR arrays with
        # capacity doubling — appends are O(batch), not O(corpus)
        self._sh_indptr = np.zeros(1, dtype=np.int64)
        self._sh_rows = 0
        self._sh_indices = np.empty(0, dtype=np.int32)
        self._sh_data = np.empty(0, dtype=np.float64)
        self._sh_nnz = 0
        self._scipy_cache: tuple | None = None
        self._compact_cache: tuple | None = None
        self.max_weights = np.zeros(self.cfg.vector_dim, dtype=np.float64)
        # corpus-wide maxima installed by set_max_weight_map (admission)
        self._static_max_weights: np.ndarray | None = None
        self._max_norm = 0.0  # largest row L2 norm seen (margin scaling)
        self._frozen = False
        self.stats: Dict[str, float] = {
            "vectors_indexed": 0,
            "vectors_dropped_admission": 0,
            "candidates_scored": 0,
            "candidate_pairs": 0,  # device candidates sent to the rescore
            "pairs_emitted": 0,
            "insert_batches": 0,
            "dormant_dims": 0,
            # the JAX package's dispatch-path mix: its fused 1- and 2-tile
            # append+match windows and the separate scatter + match; the
            # port's insert is always the last (keys kept for its stats RPC)
            "insert_fused": 0,
            "insert_fused2": 0,
            "insert_slowpath": 0,
        }
        self.timer = Timer()  # per-stage wall timings
        # int8 scoring state: demoted-to-bf16 flag + whether the last
        # all_pairs actually scored at int8 (drives the demotion check)
        self._int8_off = False
        self._used_int8 = False
        # dormant-dim archive: df==1 dims are kept OFF the device index (they
        # cannot contribute to any i != j pair) and their single (row, value)
        # entry lives here until an insert shares the dim (activation)
        self._dorm_rows = np.empty(0, np.int64)
        self._dorm_dims = np.empty(0, np.int64)
        self._dorm_vals = np.empty(0, np.float64)
        self._dorm_buf = None  # capacity-doubling backing of the three above
        self._dormant_of_ext: np.ndarray | None = None

    # ------------------------------------------------------------------ sizes
    @property
    def x(self):
        """The device index matrix."""
        return self._x

    @x.setter
    def x(self, val):
        # drop the derived int8/bf16 operand copies with the index they came
        # from, so a replaced index never pins them
        self._x = val
        self._bf16_cache = None
        self._int8_cache = None

    @property
    def row_cap(self) -> int:
        return 0 if self.x is None else int(self.x.shape[0])

    @property
    def dim_cap(self) -> int:
        return 0 if self.x is None else int(self.x.shape[1])

    def _tile(self) -> int:
        return int(self.cfg.query_tile)

    def _row_quantum(self) -> int:
        # row capacity stays a multiple of both the packing unit (8) and
        # the query tile
        return round_up(max(self.cfg.row_bucket, self._tile()), self._tile())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _margin(self, tau: float) -> float:
        """Device-error superset margin.

        The base margins are *relative* error bounds for a single dot
        product (bf16 mantissa rounding ≲ 2e-3 of ``‖a‖·‖b‖``; fp32
        accumulate ≲ 1e-6), scaled by the largest pairwise norm product so
        thresholding stays lossless for unnormalized corpora too (the
        reference's HBase path stores unnormalized TF-IDF — SURVEY.md
        fine-print #1)."""
        scale = max(self._max_norm * self._max_norm, 1.0)
        return self._margin_rel() * scale

    def _max_row_nnz(self) -> int:
        """Largest SHADOW row nnz — an upper bound on any device row's nnz
        (the device may hold fewer entries: dormant dims)."""
        if self._sh_rows == 0:
            return 0
        return int(
            np.diff(self._sh_indptr[: self._sh_rows + 1]).max()
        )

    def _margin_rel(self, precision: str | None = None) -> float:
        """Relative device-error bound for one dot product (unscaled).

        THE margin policy: the chunked engine aliases this (and ``_margin``
        / ``_tau_eff``), so the exactness guarantee cannot diverge between
        engine flavors."""
        if precision is None:
            precision = self.cfg.matmul_precision
        # fp32-highest path: |err| <= (n+2)·2^-24·Σ|a_i b_i|
        # <= (n+2)·2^-24·‖a‖·‖b‖ — n·eps for a sequential sum over n
        # overlapping nonzeros (XLA's tree orders are tighter) plus 2·eps
        # for the fp64→fp32 operand casts.  Scaling by the corpus' max row
        # nnz makes this a PROOF, not an empirical calibration;
        # rescore_margin stays as the config floor.
        m = max(
            self.cfg.rescore_margin,
            (self._max_row_nnz() + 2) * 2.0 ** -24,
        )
        if self.cfg.dtype != "float32":
            m = max(m, rescore_ops.default_margin(self.cfg.dtype))
        if precision != "highest":
            # single-pass bf16 MXU: BOTH operands round to bf16 (2^-8
            # relative each), so worst-case |err| <= ~2^-7 * sum|a_i b_i|
            # <= 0.008 * ||a||*||b|| (observed ~1e-3 on normalized Enron
            # TF-IDF); 2e-2 relative gives ~2.5x worst-case headroom
            m = max(m, 2e-2)
        return m

    def _tau_eff(self, tau: float) -> np.float32:
        m = self._margin(tau)
        if tau - m < score_ops.MIN_TAU_EFF and not getattr(
            self, "_warned_low_tau", False
        ):
            # the raw-score device paths test ``score >= tau_eff`` with a
            # non-negative threshold, so a margin >= tau cannot be
            # expressed: a true pair whose device score rounds to <= 0 is
            # not in the candidate superset (reachable with unnormalized
            # corpora at bf16, or tau below ~2e-2 of the norm scale).  The
            # int8 Pallas paths are immune (their error bound is added back
            # device-side).  Warn ONCE instead of failing: tiny-tau "all
            # overlapping pairs" queries are legitimate, and the pairs at
            # risk have |sim| <= margin.  Documented in PARITY.md.
            self._warned_low_tau = True
            get_logger().warning(
                "tau=%g is below the device-error margin %.4g (row norms "
                "up to %.4g, precision=%r): pairs with similarity within "
                "the margin of zero may be missed on non-int8 score paths. "
                "L2-normalize the vectors, raise tau, or set "
                "matmul_precision='highest' for a tighter margin.",
                tau, m, self._max_norm, self.cfg.matmul_precision,
            )
        return np.float32(max(tau - m, score_ops.MIN_TAU_EFF))

    def _note_norms(self, csr: CSRMatrix) -> None:
        norms = csr.row_norms()
        if norms.size:
            self._max_norm = max(self._max_norm, float(norms.max()))

    # ------------------------------------------------------------------ build
    def build(
        self,
        vectors: Sequence[Tuple[str, SparseVector]] | CSRMatrix,
        ids: Sequence[str] | None = None,
    ) -> BuildStats:
        """Bulk index build (the LoadData/HBase path — no admission pruning,
        no component filter, matching WriteWorkerActor.scala:132-161)."""
        t0 = time.time()
        csr, new_ids = _as_csr(vectors, ids, self.cfg.vector_dim)
        if self.n_rows:
            raise RuntimeError("build() on a non-empty engine")
        self.compact = CompactSpace.from_csr(
            csr, self.cfg.dim_bucket,
            min_df=2 if self.cfg.dormant_dims else 1,
        )
        compact_csr = self.compact.map_csr(self._archive_dormant(csr))
        row_cap = round_up(max(csr.n_rows, 1), self._row_quantum())
        dim_cap = self.compact.capacity
        self.x = self._new_index(compact_csr, row_cap, dim_cap)
        self.n_rows = csr.n_rows
        self.ids = list(new_ids)
        self.id_to_row = {v: k for k, v in enumerate(self.ids)}
        self._append_shadow(csr)
        np.maximum.at(self.max_weights, csr.indices, csr.data)
        self._note_norms(csr)
        self.stats["vectors_indexed"] += csr.n_rows
        self._sync()
        return BuildStats(
            n_rows=self.n_rows,
            n_active_dims=self.compact.n_active,
            row_cap=row_cap,
            dim_cap=dim_cap,
            build_seconds=time.time() - t0,
        )

    def _new_index(self, compact_csr: CSRMatrix, row_cap: int,
                   dim_cap: int) -> torch.Tensor | None:
        """The built index on the device.  The mesh engine overrides this
        to build per-shard row blocks, each on its own device."""
        x = score_ops.new_index_matrix(
            row_cap, dim_cap, self.cfg.dtype, self.device
        )
        self._scatter_rows(x, compact_csr)
        return x

    @staticmethod
    def _scatter_rows(x: torch.Tensor, compact_csr: CSRMatrix,
                      row0: int = 0, col0: int = 0) -> None:
        """Chunked flat-COO scatter of the block of the compact CSR that
        starts at ``(row0, col0)`` and has ``x``'s shape into the fresh
        device matrix ``x``: one O(nnz) packed H2D copy and one in-place
        scatter per ~4M-entry chunk.  (The mesh engine's blocks; the whole
        index is the block at (0, 0).)"""
        ip = compact_csr.indptr
        r0 = min(row0, compact_csr.n_rows)
        r1 = min(row0 + x.shape[0], compact_csr.n_rows)
        base = int(ip[r0])
        rows_all = np.repeat(
            np.arange(r1 - r0, dtype=np.int64), np.diff(ip[r0:r1 + 1])
        )
        nnz = rows_all.size
        whole_width = col0 == 0 and x.shape[1] >= compact_csr.n_cols
        chunk = 1 << 22  # ~48 MB of packed COO per copy
        for s in range(0, nnz, chunk):
            e = min(s + chunk, nnz)
            rows = rows_all[s:e]
            cols = compact_csr.indices[base + s:base + e]
            vals = compact_csr.data[base + s:base + e]
            if not whole_width:
                own = (cols >= col0) & (cols < col0 + x.shape[1])
                rows, cols, vals = rows[own], cols[own] - col0, vals[own]
            score_ops.scatter_coo(x, pack_coo_i32(rows, cols, vals,
                                                  x.shape[0]))

    def _append_shadow(self, csr: CSRMatrix) -> None:
        nnz = int(csr.indptr[-1])
        need_rows = self._sh_rows + csr.n_rows + 1
        if need_rows > self._sh_indptr.size:
            cap = max(self._sh_indptr.size * 2, need_rows, 1024)
            grown = np.zeros(cap, dtype=np.int64)
            grown[: self._sh_rows + 1] = self._sh_indptr[: self._sh_rows + 1]
            self._sh_indptr = grown
        need_nnz = self._sh_nnz + nnz
        if need_nnz > self._sh_indices.size:
            cap = max(self._sh_indices.size * 2, need_nnz, 4096)
            gi = np.empty(cap, dtype=np.int32)
            gi[: self._sh_nnz] = self._sh_indices[: self._sh_nnz]
            gd = np.empty(cap, dtype=np.float64)
            gd[: self._sh_nnz] = self._sh_data[: self._sh_nnz]
            self._sh_indices, self._sh_data = gi, gd
        base = self._sh_indptr[self._sh_rows]
        self._sh_indptr[
            self._sh_rows + 1 : self._sh_rows + csr.n_rows + 1
        ] = base + csr.indptr[1:]
        self._sh_indices[self._sh_nnz : self._sh_nnz + nnz] = csr.indices[:nnz]
        self._sh_data[self._sh_nnz : self._sh_nnz + nnz] = csr.data[:nnz]
        self._sh_rows += csr.n_rows
        self._sh_nnz += nnz

    def shadow_csr(self) -> CSRMatrix:
        """Host fp64 CSR over the external dim space (exact oracle view).
        Returns views into the growable arrays — treat as read-only."""
        return CSRMatrix(
            self._sh_rows,
            self.cfg.vector_dim,
            self._sh_indptr[: self._sh_rows + 1],
            self._sh_indices[: self._sh_nnz],
            self._sh_data[: self._sh_nnz],
        )

    def _shadow_scipy(self):
        """Cached prebuilt scipy matrix for bulk rescores (keyed by corpus
        state; construction costs O(corpus nnz))."""
        key = (self._sh_rows, self._sh_nnz)
        if self._scipy_cache is None or self._scipy_cache[0] != key:
            sh = self.shadow_csr()
            self._scipy_cache = (
                key,
                rescore_ops.as_scipy(
                    sh.indptr, sh.indices, sh.data, sh.n_cols
                ),
            )
        return self._scipy_cache[1]

    def _shadow_compact(self):
        """Cached compact-dim translation of the shadow CSR for the grouped
        native rescore (keyed by corpus state like the scipy cache)."""
        if not rescore_ops.grouped_available():
            return None  # pair_dots would discard it (no native lib)
        key = (self._sh_rows, self._sh_nnz)
        if self._compact_cache is None or self._compact_cache[0] != key:
            sh = self.shadow_csr()
            self._compact_cache = (
                key,
                rescore_ops.build_compact(sh.indices, sh.n_cols),
            )
        return self._compact_cache[1]

    # -------------------------------------------------------------- all_pairs
    def all_pairs(self, tau: float | None = None) -> PairResult:
        """Exact thresholded all-pairs cosine join over the current index.

        Device pass keeps candidates at ``tau - margin`` (fused score +
        threshold + bitpack per tile); host fp64 rescore decides the final
        set — identical to the float64 brute-force oracle by construction.
        """
        tau = self.cfg.similarity_threshold if tau is None else float(tau)
        if self.n_rows == 0:
            return PairResult(
                np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64), [],
            )
        with self._maybe_trace(), self.timer.section("all_pairs"):
            return self._all_pairs_timed(tau)

    def _maybe_trace(self):
        """A ``torch.profiler`` trace into ``profile_dir`` when it is set
        (the card's activity too on a CUDA engine); no-op otherwise."""
        if not self.cfg.profile_dir:
            return contextlib.nullcontext()
        return profile_trace(self.cfg.profile_dir,
                             cuda=self.device.type == "cuda")

    def _all_pairs_timed(self, tau: float) -> PairResult:
        tau_eff = self._tau_eff(tau)
        with self.timer.section("score_extract"):
            if self._kernel_ok():
                i, j = self._all_pairs_kernel(tau_eff)
            else:
                # full rectangle: the demotion check must not act on it
                self._used_int8 = False
                i, j = self._all_pairs_rect(tau_eff)
        self.stats["candidates_scored"] += self.n_rows * self.n_rows
        self.stats["candidate_pairs"] += len(i)
        with self.timer.section("rescore"):
            res = self._finalize_pairs(i, j, tau)
        # adaptive int8 demotion: the quantization bound is a proven superset
        # on ANY data, but if a corpus makes it admit vastly more candidates
        # than the true result, the extraction/fetch/rescore tax outweighs
        # the 2x tensor-core rate — fall back to bf16 (narrower margin) from
        # the next call on
        if self._used_int8 and len(i) > max(16 * res.n_pairs, 1_000_000):
            self._int8_off = True
            self._int8_cache = None  # release the q8+aux device copies now
            get_logger().info(
                "int8 bound admitted %d candidates for %d pairs; "
                "demoting this engine to bf16 scoring", len(i), res.n_pairs,
            )
        return res

    def _kernel_ok(self) -> bool:
        """Use the upper-triangle kernels for all_pairs?  They need
        tile-aligned capacities and the default (bf16-margin) precision;
        auto mode also caps the bit-packed hit structure
        (~row_cap²/14 bytes) at 2 GB."""
        mode = self.cfg.use_pallas
        if mode == "off":
            return False
        aligned = (
            self.row_cap % 256 == 0
            and self.dim_cap % 2048 == 0
            and self.cfg.matmul_precision != "highest"
        )
        fits = self.row_cap * self.row_cap // 14 <= (1 << 31)  # ≤ 2 GB
        on_device = self.x is not None and self.x.device.type in ("cuda", "cpu")
        if mode == "on":
            return aligned
        return aligned and on_device and fits

    def _operands(self, use_int8: bool):
        """The scorer's operands, cached per index state.  A torch tensor
        updated in place keeps its identity, so the cache key is the
        index's identity AND its version counter."""
        key = (id(self.x), self.x._version)
        if use_int8:
            if self._int8_cache is None or self._int8_cache[0] != key:
                self._int8_cache = (key, tri_score.quantize_rows(self.x))
            return self._int8_cache[1]
        if self._bf16_cache is None or self._bf16_cache[0] != key:
            self._bf16_cache = (key, self.x.to(torch.bfloat16))
        return self._bf16_cache[1]

    def _tiles(self) -> Tuple[int, int]:
        # asymmetric tiles cut blocked operand re-reads; pick the largest
        # geometry the row capacity tiles evenly
        if self.row_cap % 1024 == 0:
            return 1024, 512
        if self.row_cap % 512 == 0:
            return 512, 512
        return 256, 256

    def _all_pairs_kernel(self, tau_eff) -> Tuple[np.ndarray, np.ndarray]:
        tm, tn = self._tiles()
        bi, bj = tri_score.upper_blocks_rect(self.row_cap, tm, tn)
        bi = torch.from_numpy(bi).to(self.device)
        bj = torch.from_numpy(bj).to(self.device)
        # int8 path: 2x tensor-core rate + half the operand bytes, per-pair
        # quantization bound in the epilogue; gated on the int32-accumulator
        # safety bound D <= 127^2 * max_nnz
        use_int8 = (
            bool(self.cfg.pallas_int8)
            and not self._int8_off
            and self._max_row_nnz() < ((1 << 30) // (127 * 127))
        )
        self._used_int8 = use_int8
        with self.timer.section("operands"):
            ops = self._operands(use_int8)
            self._sync()
        if use_int8:
            rows, cols = tri_score.allpairs_extract_int8(
                *ops, bi, bj, tau_eff, tm, tn, timer=self.timer
            )
        else:
            rows, cols = tri_score.allpairs_extract_bf16(
                ops, bi, bj, tau_eff, tm, tn, timer=self.timer
            )
        with self.timer.section("d2h"):
            return rows.cpu().numpy(), cols.cpu().numpy()

    def _rect_operand(self) -> torch.Tensor:
        """The index as the rectangle multiplies it: the cached bf16 copy
        on the card at the default precision, else the index itself
        (``score.score_operand``'s rule, cached per index state)."""
        if score_ops.rounds_to_bf16(self.x, self.cfg.matmul_precision):
            return self._operands(False)
        return self.x

    def _all_pairs_rect(self, tau_eff) -> Tuple[np.ndarray, np.ndarray]:
        """Candidates of the full-rectangle join (``score.allpairs_extract``,
        ``mode="upper"``): every index the kernels refuse."""
        with self.timer.section("operands"):
            xo = self._rect_operand()
            self._sync()
        rows, cols = score_ops.allpairs_extract(
            xo, tau_eff, self._tile(), "upper", self.cfg.matmul_precision,
            int(self.cfg.extract_group), timer=self.timer,
        )
        with self.timer.section("d2h"):
            return rows.cpu().numpy(), cols.cpu().numpy()

    def _finalize_pairs(self, i: np.ndarray, j: np.ndarray, tau: float) -> PairResult:
        if i.size == 0:
            return PairResult(i, j, np.empty(0, np.float64), list(self.ids))
        shadow = self.shadow_csr()
        sims = rescore_ops.pair_dots(
            shadow.indptr, shadow.indices, shadow.data, i, j, shadow.n_cols,
            mat_fn=self._shadow_scipy,
            compact=self._shadow_compact(),
        )
        keep = sims >= tau
        i, j, sims = i[keep], j[keep], sims[keep]
        self.stats["pairs_emitted"] += i.size
        return PairResult(i, j, sims, list(self.ids))

    # ----------------------------------------------------------------- insert
    def insert(
        self,
        vectors: Sequence[Tuple[str, SparseVector]],
        tau: float | None = None,
        bulk: bool = False,
        defer: bool = False,
    ) -> "SimilarityOutput | PendingInsert":
        """Streaming micro-batch insert matched online against the live index.

        Reproduces the reference streaming path semantics in order:
          1. drop components with ``value <= index_threshold``
             (WriteWorkerActor.scala:192, fine-print #5);
          2. max-weight admission pruning at the entry
             (EntryProxyActor.scala:81-93) — configurable: the reference's
             all-1.0 stub, real running max weights, or off;
          3. index-before-query: the batch joins the index first, then every
             batch vector queries, so intra-batch pairs surface symmetrically
             (IndexingWorkerActor.scala:123-132, fine-print #2);
          4. when frozen (benchmark mode), skip indexing but keep querying
             (IndexingWorkerActor.scala:143-144).

        ``bulk=True`` is the LoadData/HBase ingest path: it skips the
        component filter and admission pruning (both live on the VectorIOMsg
        path only — WriteWorkerActor.scala:185-202 vs :153-161) but still
        matches online.  ``defer=True`` returns an object whose ``result()``
        gives the output (``PendingInsert``)."""
        with self._maybe_trace(), self.timer.section("insert"):
            return self._insert_impl(vectors, tau, bulk, defer)

    def _insert_impl(self, vectors, tau, bulk, defer):
        tau = self.cfg.similarity_threshold if tau is None else float(tau)
        self.stats["insert_batches"] += 1
        filtered: List[Tuple[str, SparseVector]] = []
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
            empty = SimilarityOutput({}, time.time())
            return _CompletedInsert(empty) if defer else empty
        csr, new_ids = _as_csr(filtered, None, self.cfg.vector_dim)

        if self._frozen:
            out = self._match_external(csr, new_ids, tau)
            return _CompletedInsert(out) if defer else out

        n0 = self.n_rows
        dorm0 = self._dorm_rows.size  # archive rollback point (see below)
        with self.timer.section("prepare"):
            keep_csr = self._stream_archive_singletons(csr, n0)
            self._grow_for(csr, extend=False)
            act = self._activate_dormant(csr.indices, collect=True)
            compact_csr = self.compact.map_csr(keep_csr, extend=False)
            # host bookkeeping first so the error margin (tau_eff) already
            # covers the batch's norms before any device scoring
            self.n_rows = n0 + csr.n_rows
            for k, vid in enumerate(new_ids):
                self.id_to_row[vid] = n0 + k
            self.ids.extend(new_ids)
            self._append_shadow(csr)
            np.maximum.at(self.max_weights, csr.indices, csr.data)
            self._note_norms(csr)
            self.stats["vectors_indexed"] += csr.n_rows

        try:
            return self._insert_device_phase(act, compact_csr, n0, tau, defer)
        except Exception:
            # device failure after the host commit: roll back to the
            # pre-batch state so the caller's drop/retry sees a consistent
            # engine (no phantom rows) — see _recover_insert
            self._recover_insert(n0, csr.n_rows, dorm0)
            raise

    def _insert_device_phase(self, act, compact_csr, n0, tau, defer):
        """Append the batch (and any activated dormant entries) to the
        index, then match the batch's rows against it.  The bf16 copy the
        products multiply (``_rect_operand``), when it exists and is in
        step with ``x``, takes the same rows and entries, so a micro-batch
        never pays an O(index) recast."""
        tau_eff = self._tau_eff(tau)
        kept = self._kept_bf16()
        self.stats["insert_slowpath"] += 1
        with self.timer.section("append"):
            if act is not None:
                self._scatter_activation(act)
                self._commit_activation(act)
            self._append_batch(compact_csr, n0)
            if kept is not None:
                self._keep_in_step(kept, n0, act)
            self._sync()
        rows, cols = self._match_batch(n0, tau_eff)
        self.stats["candidates_scored"] += self.n_rows * (self.n_rows - n0)
        pending = PendingInsert(self, rows, cols, tau)
        return pending if defer else pending.result()

    def _append_batch(self, compact_csr: CSRMatrix, n0: int) -> None:
        """Add the batch's compact rows into the index at rows ``n0`` on
        (the mesh engine: into the blocks that own them)."""
        rows_b = np.repeat(
            np.arange(compact_csr.n_rows, dtype=np.int64),
            np.diff(compact_csr.indptr),
        )
        coo = pack_coo_i32(rows_b, compact_csr.indices, compact_csr.data,
                           self.row_cap - n0)
        score_ops.append_rows(self.x, coo, n0)

    def _match_batch(self, n0: int, tau_eff):
        """Device ``(rows, cols)`` candidates of the index rows ``[n0,
        n_rows)`` (the batch just appended) against the live index; the
        query height is rounded up to 8 rows."""
        xo = self._rect_operand()
        n1 = min(n0 + round_up(self.n_rows - n0, 8), self.row_cap)
        return score_ops.match_rows_extract(
            xo, xo[n0:n1], n0, self.n_rows, tau_eff,
            self.cfg.matmul_precision, timer=self.timer,
        )

    def _kept_bf16(self) -> torch.Tensor | None:
        """The cached bf16 copy of the index when the products multiply it
        (``score.rounds_to_bf16``) and it is in step with ``x``; else None.
        A copy out of step is dropped."""
        cached = self._bf16_cache
        if cached is None or not score_ops.rounds_to_bf16(
                self.x, self.cfg.matmul_precision):
            return None
        if cached[0] != (id(self.x), self.x._version):
            self._bf16_cache = None
            return None
        return cached[1]

    def _keep_in_step(self, kept: torch.Tensor, n0: int, act) -> None:
        """Write the rows ``[n0, n_rows)`` and the activated entries of
        ``x`` into its bf16 copy and re-key the copy to ``x``'s version.
        Each element rounds to bf16 on its own, so the copy stays equal to
        a fresh ``x.to(torch.bfloat16)`` bit for bit."""
        kept[n0:self.n_rows] = self.x[n0:self.n_rows].to(torch.bfloat16)
        if act is not None:
            r = torch.from_numpy(np.asarray(act[0], np.int64)).to(self.device)
            c = torch.from_numpy(np.asarray(act[1], np.int64)).to(self.device)
            kept[r, c] = self.x[r, c].to(torch.bfloat16)
        self._bf16_cache = ((id(self.x), self.x._version), kept)

    def _recover_insert(self, n0: int, n_batch: int,
                        dorm0: int | None = None) -> None:
        """Roll back a failed micro-batch insert: truncate host bookkeeping
        to the pre-batch state and rebuild the device index from the shadow
        (a failure inside the append can leave ``x`` half-written).  Without
        this, a device failure left PHANTOM rows — present in the shadow/ids
        but absent from every device result.  max_weights and the norm
        margin are NOT rolled back: both are upper bounds, so keeping the
        dropped batch's contribution is conservative.  Only safe when
        nothing was appended after the failed batch; otherwise state is left
        as it is."""
        if self.n_rows != n0 + n_batch:
            return  # later inserts landed; cannot roll back safely
        if dorm0 is not None and self._dorm_rows.size > dorm0:
            # roll back this batch's dormant-archive appends too: a stale
            # entry references a rolled-back row, so a later _dormant_hits
            # would emit candidate rows >= n_rows (out-of-range into the
            # shadow/ids) and a later activation would scatter the value
            # into a device row owned by a DIFFERENT re-inserted vector
            dims_added = self._dorm_dims[dorm0:]
            self._dormant_of_ext[dims_added] = -1
            self._dorm_rows = self._dorm_rows[:dorm0]
            self._dorm_dims = self._dorm_dims[:dorm0]
            self._dorm_vals = self._dorm_vals[:dorm0]
            self.stats["dormant_dims"] -= int(dims_added.size)
        row_cap, dim_cap = self.row_cap, self.dim_cap
        self.n_rows = n0
        del self.ids[n0:]
        self.id_to_row = {v: k for k, v in enumerate(self.ids)}
        # truncate the growable shadow arrays (O(1): tail reused on append)
        self._sh_rows = n0
        self._sh_nnz = int(self._sh_indptr[n0])
        self._scipy_cache = None
        self._compact_cache = None
        self.stats["vectors_indexed"] -= n_batch
        shadow = self.shadow_csr()
        compact_csr = self.compact.map_csr(
            self._drop_unmapped(shadow), extend=False
        )
        self.x = self._new_index(compact_csr, row_cap, dim_cap)
        # the rebuild just scattered EVERY mapped shadow entry — including
        # archived entries whose dim this batch promoted (compact.extend is
        # not rolled back).  Their archive marks are now stale: a later
        # activation would scatter the value a SECOND time, inflating that
        # row's device score beyond the margin and breaking topk's exact
        # fetch.  Commit (clear) the marks of every mapped dim now.
        if self._dormant_of_ext is not None:
            marked = np.nonzero(self._dormant_of_ext >= 0)[0]
            if marked.size:
                mapped = self.compact.cols_of(marked) >= 0
                n_clear = int(mapped.sum())
                if n_clear:
                    self._dormant_of_ext[marked[mapped]] = -1
                    self.stats["dormant_dims"] -= n_clear

    # -------------------------------------------------------------- admission
    def set_max_weight_map(self, weights: np.ndarray) -> None:
        """Install precomputed corpus-wide per-dim max weights (the
        ``<table>_MAX`` statistic) for exact ``admission="real"`` pruning —
        the thing the reference computes (HBaseUpLoader.scala:113-123) but
        never loads back."""
        if weights.shape != (self.cfg.vector_dim,):
            raise ValueError("max weight map must cover vector_dim")
        self._static_max_weights = np.asarray(weights, dtype=np.float64)

    def _admit(self, vec: SparseVector, tau: float) -> bool:
        """Upper-bound admission: dot(max_weights|support, v) >= tau
        (EntryProxyActor.scala:81-93).

        "real" with a static corpus map (``set_max_weight_map``) is exactly
        lossless: the bound covers every corpus vector.  Without one, the
        running-maxima bound is made self-inclusive (``max(m_d, v_d)``) so it
        still dominates the similarity against everything seen so far — but a
        *later* vector with larger weights can in principle form a pair with
        an already-dropped one; use the static map when strict losslessness
        against future inserts matters (documented in PARITY.md).
        """
        mode = self.cfg.admission
        if mode == "off" or vec.nnz == 0:
            return vec.nnz > 0
        if mode == "real":
            static = self._static_max_weights
            if static is not None:
                # the static map covers the STORED corpus; streamed vectors
                # may exceed it, so fold in the running maxima (and the
                # vector itself) — otherwise a heavy streamed v1 followed by
                # a light v2 could drop v2 despite cos(v1, v2) >= tau,
                # breaking the "exactly lossless" contract
                bound = np.maximum(
                    static[vec.indices],
                    np.maximum(self.max_weights[vec.indices], vec.values),
                )
                admit = float(np.dot(bound, vec.values)) >= tau
            else:
                bound = np.maximum(self.max_weights[vec.indices], vec.values)
                admit = float(np.dot(bound, vec.values)) >= tau
            if not admit:
                # record the dropped vector's weights so future bounds
                # account for it
                np.maximum.at(self.max_weights, vec.indices, vec.values)
            return admit
        # "ones": the reference's stub map (all weights 1.0)
        return float(np.sum(vec.values)) >= tau

    # ------------------------------------------------------ streaming growth
    def _stream_archive_singletons(
        self, csr: CSRMatrix, row_offset: int
    ) -> CSRMatrix:
        """Streaming analog of the build-time dormant tier: a brand-new dim
        seen exactly ONCE (once in this batch, never before, not already
        archived) cannot contribute to any i≠j pair yet, so its single entry
        is archived host-side instead of minting a compact column — without
        this, long streams inflate dim_cap far past the build path's.  Dims
        appearing ≥2× in the batch, or whose archived partner just arrived,
        are promoted (extended; `_activate_dormant` then moves the archived
        entry onto the device).  Returns the csr filtered to device-bound
        entries; the caller's shadow append keeps every entry, so exactness
        is untouched.
        """
        if not self.cfg.dormant_dims:
            self.compact.extend(csr.indices)
            return csr
        cols = self.compact.cols_of(csr.indices)
        newm = cols < 0
        if not newm.any():
            return csr
        if self._dormant_of_ext is None:
            self._dormant_of_ext = np.full(
                self.cfg.vector_dim, -1, np.int32
            )
        uniq, counts = np.unique(csr.indices[newm], return_counts=True)
        in_archive = self._dormant_of_ext[uniq] >= 0
        promote = uniq[(counts >= 2) | in_archive]
        singles = uniq[(counts == 1) & ~in_archive]
        if promote.size:
            self.compact.extend(promote)
        if singles.size == 0:
            return csr
        mark = np.zeros(self.cfg.vector_dim, bool)
        mark[singles] = True
        sel = mark[csr.indices]
        row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
        arch_dims = csr.indices[sel].astype(np.int64)
        base = self._dorm_append(
            (row_offset + row_of[sel]).astype(np.int64),
            arch_dims,
            csr.data[sel].astype(np.float64),
        )
        self._dormant_of_ext[arch_dims] = base + np.arange(
            arch_dims.size, dtype=np.int32
        )
        self.stats["dormant_dims"] += int(arch_dims.size)
        keep = ~sel
        row_counts = np.zeros(csr.n_rows, np.int64)
        np.add.at(row_counts, row_of[keep], 1)
        indptr = np.zeros(csr.n_rows + 1, np.int64)
        np.cumsum(row_counts, out=indptr[1:])
        return CSRMatrix(
            csr.n_rows, csr.n_cols, indptr, csr.indices[keep],
            csr.data[keep],
        )

    def _dorm_append(self, rows, dims, vals) -> int:
        """Amortized append to the dormant archive (capacity-doubling
        buffers, exposed as views — per-batch cost O(batch), not
        O(archive)); returns the first new archive index."""
        n0 = self._dorm_rows.size
        need = n0 + rows.size
        buf = self._dorm_buf
        if buf is None or need > buf[0].size:
            cap = 1024
            while cap < need:
                cap *= 2
            buf = (
                np.empty(cap, np.int64),
                np.empty(cap, np.int64),
                np.empty(cap, np.float64),
            )
            buf[0][:n0] = self._dorm_rows
            buf[1][:n0] = self._dorm_dims
            buf[2][:n0] = self._dorm_vals
            self._dorm_buf = buf
        buf[0][n0:need] = rows
        buf[1][n0:need] = dims
        buf[2][n0:need] = vals
        self._dorm_rows = buf[0][:need]
        self._dorm_dims = buf[1][:need]
        self._dorm_vals = buf[2][:need]
        return n0

    def _grow_for(self, csr: CSRMatrix, extend: bool = True) -> None:
        """Make room for ``csr``'s rows and the compact space's columns:
        the row capacity doubles from the row quantum, the column capacity
        is ``CompactSpace.capacity`` (the JAX package's law, so ``row_cap``
        and ``dim_cap`` equal its own after any stream and stay tiled for
        the kernels)."""
        if extend:
            self.compact.extend(csr.indices)
        need_rows = round_up(self.n_rows + csr.n_rows, self._row_quantum())
        new_row_cap = self.row_cap
        while new_row_cap < need_rows:
            new_row_cap = max(new_row_cap * 2, self._row_quantum())
        new_dim_cap = self.compact.capacity
        if (new_row_cap, new_dim_cap) != (self.row_cap, self.dim_cap):
            self._resize_index(new_row_cap, new_dim_cap)

    def _resize_index(self, row_cap: int, dim_cap: int) -> None:
        """A ``[row_cap, dim_cap]`` index holding the current one in its
        top-left corner (a zero one before any build)."""
        if self.x is None:
            self.x = score_ops.new_index_matrix(
                row_cap, dim_cap, self.cfg.dtype, self.device
            )
        else:
            self.x = score_ops.grow(self.x, row_cap, dim_cap)

    # ------------------------------------------------------- frozen matching
    def _match_external(
        self, csr: CSRMatrix, qids: List[str], tau: float
    ) -> SimilarityOutput:
        """Frozen-index matching: queries are scored but not indexed."""
        if self.row_cap == 0:
            return SimilarityOutput({}, time.time())
        qn = csr.row_norms()
        if qn.size and float(qn.max()) > self._max_norm:
            # widen the margin for out-of-distribution query norms
            saved, self._max_norm = self._max_norm, float(qn.max())
        else:
            saved = None
        try:
            compact = self.compact.map_csr(
                self._drop_unmapped(csr), extend=False
            )
            tau_eff = self._tau_eff(tau)
        finally:
            if saved is not None:
                self._max_norm = saved
        with self.timer.section("frozen_product"):
            rows, qcols = self._frozen_candidates(
                self._dense_queries(compact), tau_eff)
            rows, qcols = rows.cpu().numpy(), qcols.cpu().numpy()
        self.stats["candidates_scored"] += self.n_rows * len(qids)
        # queries sharing a dormant dim with an indexed row: the device score
        # missed that contribution — add those rows as explicit candidates
        extra_q, extra_r = self._dormant_hits(csr)
        if extra_q.size:
            rows = np.concatenate([rows, extra_r])
            qcols = np.concatenate([qcols, extra_q])
        # exact fp64 rescore via the native cross-pair path
        shadow = self.shadow_csr()
        out: Dict[str, Dict[str, float]] = {}
        with self.timer.section("frozen_rescore"):
            if len(rows):
                rows_a = np.asarray(rows, np.int64)
                qcols_a = np.asarray(qcols, np.int64)
                sims = rescore_ops.cross_pair_dots(
                    shadow.indptr, shadow.indices, shadow.data, shadow.n_cols,
                    csr.indptr, csr.indices, csr.data, qcols_a, rows_a,
                )
                keep = sims >= tau
                for r, qc, s in zip(rows_a[keep], qcols_a[keep], sims[keep]):
                    out.setdefault(qids[int(qc)], {})[self.ids[int(r)]] = (
                        float(s))
        self.stats["pairs_emitted"] += sum(len(v) for v in out.values())
        return SimilarityOutput(out, time.time())

    def _frozen_candidates(self, q: torch.Tensor, tau_eff):
        """Device ``(index rows, query rows)`` of every live index row
        against the dense queries ``q`` with a score ``>= tau_eff``."""
        return score_ops.queries_match_extract(
            self._rect_operand()[: self.n_rows], q, tau_eff,
            self.cfg.matmul_precision,
        )

    def _dense_queries(self, compact: CSRMatrix) -> torch.Tensor:
        """The query batch densified on the (lead) device in the index's
        dtype, from one packed COO."""
        rows_b = np.repeat(
            np.arange(compact.n_rows, dtype=np.int64),
            np.diff(compact.indptr),
        )
        coo = pack_coo_i32(rows_b, compact.indices, compact.data,
                           compact.n_rows)
        return score_ops.densify_rows(
            coo, compact.n_rows, self.dim_cap,
            score_ops.index_dtype(self.cfg.dtype), self.device)

    # ------------------------------------------------- dormant dim activation
    def _activate_dormant(self, ext_dims: np.ndarray, collect: bool = False):
        """Insert-time activation: dims of the incoming batch that were
        dormant just received compact columns; their archived entries must
        now live on the device so new×old pairs through those dims score
        correctly.  With ``collect=True`` the (rows, compact cols, vals,
        dims) arrays are RETURNED for the caller to scatter in its device
        phase."""
        if self._dormant_of_ext is None:
            return None
        uniq = np.unique(np.asarray(ext_dims))
        idxs = self._dormant_of_ext[uniq]
        sel = idxs >= 0
        if not sel.any():
            return None
        dims, idxs = uniq[sel], idxs[sel]
        cols = self.compact.cols_of(dims).astype(np.int64)
        # still-unmapped archived dims (this batch's fresh singletons) stay
        # archived — only dims that just received a compact column activate
        ok = cols >= 0
        if not ok.any():
            return None
        dims, idxs, cols = dims[ok], idxs[ok], cols[ok]
        rows = self._dorm_rows[idxs]
        vals = self._dorm_vals[idxs]
        # NOTE: the archive marks are NOT cleared here — the caller commits
        # them (``_commit_activation``) after the device call that scatters
        # the entries succeeds.  Clearing first would silently lose the
        # entries if anything raises in between; the opposite failure mode
        # (entries scattered but still marked → a later activation adds them
        # again) only inflates device scores, which the margin/rescore
        # contract absorbs as a superset.
        act = (rows, cols, vals, dims)
        if collect:
            return act
        self._scatter_activation(act)
        self._commit_activation(act)
        return None

    def _commit_activation(self, act) -> None:
        dims = act[3]
        self._dormant_of_ext[dims] = -1
        self.stats["dormant_dims"] -= int(dims.size)

    def _scatter_activation(self, act) -> None:
        """Add the activated entries into their (older) rows of the index;
        ``score.scatter_entries`` refuses a repeated (row, col)."""
        score_ops.scatter_entries(self.x, act[0], act[1], act[2])

    def _dormant_hits(self, csr: CSRMatrix) -> Tuple[np.ndarray, np.ndarray]:
        """External-query correction: unique (query_idx, index_row) pairs
        that share a dormant dim — the device score misses that contribution,
        so these rows must join the rescore candidate set explicitly."""
        if self._dormant_of_ext is None or self._dorm_dims.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        look = self._dormant_of_ext[csr.indices]
        hit = look >= 0
        if not hit.any():
            return np.empty(0, np.int64), np.empty(0, np.int64)
        row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
        q = row_of[hit].astype(np.int64)
        r = self._dorm_rows[look[hit]]
        key = q * (self.n_rows + 1) + r
        _, first = np.unique(key, return_index=True)
        return q[first], r[first]

    def _emit_query_results(
        self, qrows: np.ndarray, crows: np.ndarray, tau: float
    ) -> SimilarityOutput:
        """qrows: query row index (batch member), crows: candidate row index;
        exact-rescore and shape into the reference's query->candidates map."""
        if qrows.size == 0:
            return SimilarityOutput({}, time.time())
        shadow = self.shadow_csr()
        # mat_fn (not an eager mat): with the native merge available the
        # scipy matrix is never touched, and eagerly rebuilding it here would
        # cost O(corpus nnz) on EVERY streaming batch (the cache key changes
        # per insert).  No compact= either, for the same reason.
        sims = rescore_ops.pair_dots(
            shadow.indptr, shadow.indices, shadow.data, qrows, crows,
            shadow.n_cols, mat_fn=self._shadow_scipy,
        )
        keep = sims >= tau
        out: Dict[str, Dict[str, float]] = {}
        for q, c, s in zip(qrows[keep], crows[keep], sims[keep]):
            out.setdefault(self.ids[int(q)], {})[self.ids[int(c)]] = float(s)
        self.stats["pairs_emitted"] += int(keep.sum())
        return SimilarityOutput(out, time.time())

    # ------------------------------------------------------------------- topk
    def topk(
        self,
        queries: Sequence[Tuple[str, SparseVector]],
        k: int,
    ) -> Dict[str, List[Tuple[str, float]]]:
        """k nearest cosine neighbors per query over the static index.

        Reported scores are exact float64 and the RESULT SET is provably
        exact (up to ties at the k-th true score, where any valid selection
        is returned): the device ranks candidates, we fetch the top
        ``k_fetch`` and keep growing ``k_fetch`` until the margin condition
        ``min(fetched device scores) < (k-th fetched device score) − 2m``
        holds, where ``m`` bounds the device scoring error.  Proof sketch:
        every true-top-k member c has ``dev(c) ≥ true(c) − m ≥ t* − m``
        where ``t*`` is the k-th largest true score, and ``t* ≥ dev_k − m``
        since the k best-by-device candidates all have true score
        ``≥ dev_k − m``; hence ``dev(c) ≥ dev_k − 2m`` and c is fetched once
        every candidate scoring above that cutoff is.  The fetched set is
        then rescored in float64 and re-ranked — the same
        superset-then-exact-rescore contract as the thresholded join.
        Device scoring always runs at "highest" precision here (a true fp32
        product, TF32 off: ``score.true_fp32_matmul``) so the margin (and
        thus the fetch depth) stays small even in bf16 index mode.
        """
        if self.n_rows == 0:
            return {qid: [] for qid, _ in queries}
        k_eff = min(k, self.n_rows)
        csr, qids = _as_csr(list(queries), None, self.cfg.vector_dim)
        nq = len(qids)
        if nq == 0:
            return {}
        compact = self.compact.map_csr(self._drop_unmapped(csr), extend=False)
        q = self._dense_queries(compact)

        def fetch(kf: int):
            s, r = self._topk_scores(q, kf)
            return s.cpu().numpy(), r.cpu().numpy()

        q_norms = csr.row_norms()
        qmax = float(q_norms.max()) if q_norms.size else 0.0
        m = self._margin_rel("highest") * max(self._max_norm * qmax, 1.0)
        with self.timer.section("topk_fetch"):
            rows, k_fetch = fetch_exact_topk(fetch, self.n_rows, k_eff, 2 * m)
        # exact fp64 rescore of the fetched candidates (queries vs shadow;
        # no stacked copy of the corpus); rows reachable only through a
        # dormant dim join the candidate set explicitly (the device score
        # missed that contribution, so the margin bound alone can't cover them)
        with self.timer.section("topk_rescore"):
            shadow = self.shadow_csr()
            qi_idx = np.repeat(np.arange(nq), k_fetch)
            cand_idx = rows.reshape(-1).astype(np.int64)
            extra_q, extra_r = self._dormant_hits(csr)
            if extra_q.size:
                qi_idx = np.concatenate([qi_idx, extra_q])
                cand_idx = np.concatenate([cand_idx, extra_r])
            sims = rescore_ops.cross_pair_dots(
                shadow.indptr, shadow.indices, shadow.data, shadow.n_cols,
                csr.indptr, csr.indices, csr.data, qi_idx, cand_idx,
            )
        with self.timer.section("topk_assemble"):
            return assemble_topk(qids, qi_idx, cand_idx, sims, k_eff,
                                 self.ids)

    def _topk_scores(self, q: torch.Tensor, kf: int):
        """Device top ``kf`` true fp32 scores per dense query and their
        index rows, descending."""
        xs = self.x[: round_up(self.n_rows, 8)]
        return score_ops.topk_scores(xs, q, self.n_rows, kf, "highest")

    # ----------------------------------------------------------------- freeze
    def freeze(self) -> None:
        """Benchmark freeze: stop index updates, keep serving queries
        (the ReceiveTimeout branch, IndexingWorkerActor.scala:143-144)."""
        self._frozen = True

    def unfreeze(self) -> None:
        self._frozen = False

    @property
    def frozen(self) -> bool:
        return self._frozen

    # ------------------------------------------------------------ dormant dims
    def _drop_unmapped(self, csr: CSRMatrix) -> CSRMatrix:
        """Remove components in dims absent from the device index."""
        mapped = self.compact.cols_of(csr.indices) >= 0
        if mapped.all():
            return csr
        row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
        counts = np.zeros(csr.n_rows, dtype=np.int64)
        np.add.at(counts, row_of[mapped], 1)
        indptr = np.zeros(csr.n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRMatrix(
            csr.n_rows, csr.n_cols, indptr, csr.indices[mapped], csr.data[mapped]
        )

    def _archive_dormant(self, csr: CSRMatrix) -> CSRMatrix:
        """Archive build entries in dims the compact space left unmapped
        (df==1: no i≠j pair can use them) and return the filtered CSR.  The
        shadow CSR keeps EVERY entry, so the fp64 rescore — and thus the
        emitted pair set — is unaffected; only the device matmul K shrinks."""
        self._dorm_rows = np.empty(0, np.int64)
        self._dorm_dims = np.empty(0, np.int64)
        self._dorm_vals = np.empty(0, np.float64)
        self._dorm_buf = None
        self._dormant_of_ext = None
        self.stats["dormant_dims"] = 0
        mapped = self.compact.cols_of(csr.indices) >= 0
        if mapped.all():
            return csr
        keep = ~mapped
        row_of = np.repeat(np.arange(csr.n_rows), csr.row_nnz())
        self._dorm_rows = row_of[keep].astype(np.int64)
        self._dorm_dims = csr.indices[keep].astype(np.int64)
        self._dorm_vals = csr.data[keep].astype(np.float64)
        self._dormant_of_ext = np.full(self.cfg.vector_dim, -1, np.int32)
        # df==1 ⇒ each dormant dim has exactly one archived entry
        self._dormant_of_ext[self._dorm_dims] = np.arange(
            self._dorm_dims.size, dtype=np.int32
        )
        self.stats["dormant_dims"] = int(self._dorm_dims.size)
        return self._drop_unmapped(csr)

    # ------------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        """Checkpoint = host CSR shadow + id table + max-weight maps +
        stats, in the JAX package's format (either package restores the
        other's).  Written from the host shadow, never from device tensors.

        Crash-safe: all restore state lives in ONE npz (meta embedded as a
        JSON string) swapped into place with ``os.replace``; ``meta.json``
        is a human-readable mirror written second, so a crash at any point
        leaves either the old or the new snapshot, never a torn mix."""
        os.makedirs(path, exist_ok=True)
        shadow = self.shadow_csr()
        meta = {
            "ids": self.ids,
            "n_rows": self.n_rows,
            "config": {
                "vector_dim": self.cfg.vector_dim,
                "similarity_threshold": self.cfg.similarity_threshold,
                "dtype": self.cfg.dtype,
            },
            "stats": plain_stats(self.stats),
        }
        static = self._static_max_weights
        npz_tmp = os.path.join(path, ".index.npz.tmp")
        with open(npz_tmp, "wb") as f:
            # the compact column order is not stored: restore re-derives it
            # from the CSR (df-ordered), as every reader does.  Uncompressed:
            # fp64 TF-IDF data hardly compresses, and zlib would dominate
            np.savez(
                f,
                indptr=shadow.indptr,
                indices=shadow.indices,
                data=shadow.data,
                max_weights=self.max_weights,
                static_max_weights=(np.empty(0) if static is None
                                    else static),
                shape=np.array([shadow.n_rows, shadow.n_cols], np.int64),
                meta_json=np.array(json.dumps(meta)),
                **self._extra_npz(),
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(npz_tmp, os.path.join(path, "index.npz"))
        meta_tmp = os.path.join(path, ".meta.json.tmp")
        with open(meta_tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        os.replace(meta_tmp, os.path.join(path, "meta.json"))

    def _extra_npz(self) -> dict:
        """Flavor-specific checkpoint arrays (the chunked engine stores its
        entry-buffer mirror here so restore skips the build pass).  Every
        reader ignores keys it does not know."""
        return {}

    @staticmethod
    def read_checkpoint(path: str):
        """Host-only read of a checkpoint of either package: (csr, ids,
        max_weights, config_dict)."""
        z = np.load(os.path.join(path, "index.npz"))
        if "meta_json" in z:  # self-contained snapshot (atomic save path)
            meta = json.loads(str(z["meta_json"]))
        else:  # older checkpoints kept meta only in meta.json
            with open(
                os.path.join(path, "meta.json"), "r", encoding="utf-8"
            ) as f:
                meta = json.load(f)
        n_rows, n_cols = (int(v) for v in z["shape"])
        csr = CSRMatrix(n_rows, n_cols, z["indptr"], z["indices"], z["data"])
        return csr, meta["ids"], z["max_weights"], meta["config"]

    @staticmethod
    def read_checkpoint_config(path: str) -> dict:
        """Config dict only — NpzFile members load lazily per access, so
        this skips the corpus arrays."""
        z = np.load(os.path.join(path, "index.npz"))
        if "meta_json" in z:
            return json.loads(str(z["meta_json"]))["config"]
        with open(
            os.path.join(path, "meta.json"), "r", encoding="utf-8"
        ) as f:
            return json.load(f)["config"]

    @staticmethod
    def checkpoint_engine_config(
        path: str, config: AllPairsConfig | None = None
    ) -> AllPairsConfig:
        """``config``, or the checkpoint's vector_dim, threshold and dtype
        over the defaults (the config every ``load`` builds its engine
        with)."""
        if config is not None:
            return config
        ckpt_cfg = Engine.read_checkpoint_config(path)
        return AllPairsConfig().replace(
            vector_dim=int(ckpt_cfg["vector_dim"]),
            similarity_threshold=float(ckpt_cfg["similarity_threshold"]),
            dtype=str(ckpt_cfg["dtype"]),
        )

    def restore(self, path: str) -> None:
        """Rebuild this (empty) engine from a checkpoint."""
        csr, ids, max_weights, ckpt_cfg = Engine.read_checkpoint(path)
        if int(ckpt_cfg["vector_dim"]) != self.cfg.vector_dim:
            raise ValueError(
                f"checkpoint vector_dim {ckpt_cfg['vector_dim']} != engine "
                f"config vector_dim {self.cfg.vector_dim} ({path})"
            )
        self._restore_arrays(csr, ids, max_weights)
        self._restore_static_map(path)

    def _restore_static_map(self, path: str) -> None:
        """The static max-weight map a checkpoint carries
        (``set_max_weight_map``; the JAX package's ``save`` writes it as
        ``static_max_weights``, empty when none was installed)."""
        z = np.load(os.path.join(path, "index.npz"))
        if "static_max_weights" in z and z["static_max_weights"].size:
            self._static_max_weights = z["static_max_weights"]

    def _restore_arrays(self, csr: CSRMatrix, ids, max_weights) -> None:
        if self.n_rows:
            raise RuntimeError("restore() on a non-empty engine")
        if csr.n_rows:
            self.build(csr, ids)
        # merge, don't overwrite: build() recomputed maxima from the corpus,
        # while the stored map may additionally record admission-dropped
        # vectors' weights
        if max_weights is not None:
            self.max_weights = np.maximum(self.max_weights, max_weights)

    @classmethod
    def load(cls, path: str, config: AllPairsConfig | None = None,
             **kw) -> "Engine":
        """Engine rebuilt from a checkpoint written by ``save`` of either
        package; ``kw`` goes to the constructor (``device``; the
        mesh subclass: ``mesh``)."""
        eng = cls(cls.checkpoint_engine_config(path, config), **kw)
        eng.restore(path)
        return eng

    @classmethod
    def from_numpy(cls, indptr, indices, data, n_cols: int, ids=None,
                   max_weights=None, config: AllPairsConfig | None = None,
                   **kw) -> "Engine":
        """Engine built from host CSR arrays (the arrays a checkpoint
        holds), so a caller can hand both packages the same corpus;
        ``kw`` goes to the constructor."""
        cfg = config or AllPairsConfig().replace(vector_dim=int(n_cols))
        if cfg.vector_dim != int(n_cols):
            raise ValueError(
                f"n_cols {n_cols} != config vector_dim {cfg.vector_dim}"
            )
        indptr = np.asarray(indptr, np.int64)
        csr = CSRMatrix(
            indptr.size - 1, int(n_cols), indptr,
            np.asarray(indices, np.int32), np.asarray(data, np.float64),
        )
        eng = cls(cfg, **kw)
        eng._restore_arrays(csr, ids, max_weights)
        return eng
