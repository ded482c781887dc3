"""Single-device all-pairs similarity engine (the PyTorch counterpart of
``apsim_tpu/engine/engine.py``; the batch-join slice).

One object holds:

  - a dense index matrix ``x [row_cap, dim_cap]`` on one device (the card,
    ``"cuda"``, unless the caller names another; no fallback to the CPU),
    over compact frequency-ordered columns (the inverted-index replacement);
  - a host float64 CSR shadow (exact rescoring, checkpoints);
  - per-dimension max weights.

``build`` fills the index; ``all_pairs`` is the exact thresholded cosine
join: a kernel pass over the upper-triangle blocks keeps a proven candidate
superset at ``tau_eff`` and the host fp64 rescore makes the emitted pair set
equal the fp64 brute-force oracle.  An index the kernels refuse
(``use_pallas="off"``, ``matmul_precision="highest"``, capacities they do
not tile) takes the full-rectangle join of ``ops/score.allpairs_extract``.
``load`` reads the JAX package's ``index.npz`` checkpoints.  Streaming
``insert``, ``topk``, ``freeze`` and ``save`` are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

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
from ..utils.logging import Timer, get_logger
from ..vector.batch import CSRMatrix, pack_coo_i32, round_up
from ..vector.sparse import SparseVector
from .output import PairResult

__all__ = ["Engine", "BuildStats"]


class BuildStats(dict):
    pass


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


class Engine:
    def __init__(self, config: AllPairsConfig | None = None,
                 device: torch.device | str = "cuda"):
        self.cfg = config or AllPairsConfig()
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested, no CUDA")
        if self.cfg.profile_dir:
            raise _not_ported("profile_dir tracing", "item I")
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
        self._max_norm = 0.0  # largest row L2 norm seen (margin scaling)
        self.stats: Dict[str, float] = {
            "vectors_indexed": 0,
            "candidates_scored": 0,
            "candidate_pairs": 0,  # device candidates sent to the rescore
            "pairs_emitted": 0,
            "dormant_dims": 0,
        }
        self.timer = Timer()  # per-stage wall timings
        # int8 scoring state: demoted-to-bf16 flag + whether the last
        # all_pairs actually scored at int8 (drives the demotion check)
        self._int8_off = False
        self._used_int8 = False
        # dormant-dim archive: df==1 dims are kept OFF the device index (they
        # cannot contribute to any i != j pair); their single (row, value)
        # entry lives here for the insert path to activate
        self._dorm_rows = np.empty(0, np.int64)
        self._dorm_dims = np.empty(0, np.int64)
        self._dorm_vals = np.empty(0, np.float64)
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
        with self.timer.section("all_pairs"):
            return self._all_pairs_timed(tau)

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

    # ------------------------------------------------------- not ported yet
    def insert(self, vectors, tau=None, bulk=False, defer=False):
        raise _not_ported("streaming insert", "item B")

    def topk(self, queries, k):
        raise _not_ported("topk", "item B")

    def freeze(self) -> None:
        raise _not_ported("freeze", "item B")

    def save(self, path: str) -> None:
        raise _not_ported("save", "item C")

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
    @staticmethod
    def read_checkpoint(path: str):
        """Host-only read of a JAX-package checkpoint: (csr, ids,
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
        """Engine rebuilt from a checkpoint written by the JAX package's
        ``Engine.save``; ``kw`` goes to the constructor (``device``; the
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
