"""Chunked-sparse entry buffers (the parts of ``apsim_tpu/ops/chunked.py``
that the out-of-core batch join needs).

The chunked engine keeps its index as per-chunk COO entry buffers
``rows/cols/vals [n_chunks, chunk_cap]`` plus a count per chunk, never as a
dense ``[rows, dims]`` matrix.  Chunk assignment interleaves the
frequency-ranked compact dims (``chunk = col % n_chunks``,
``local = col // n_chunks``) so chunk loads are balanced.  Unused slots carry
the pad row ``2^30``, which no slab reaches.

The host bucketing (``split_chunks``, ``bucket_entries``,
``bucket_split_entries``) is a copy of the JAX package's; the per-row int8
quantization of the entries (``quantize_chunk_entries``) is torch and runs on
the buffers' device.

The stripe join (``chunked_stripe_extract``, ``chunked_stripe_extract_int8``)
is the fallback of every configuration the panel kernels refuse: one
``super_tile``-wide query stripe at a time, each chunk densified into a
``[row_cap, chunk_dim]`` slab (``densify_chunk``) and multiplied with its own
query rows into a ``[row_cap, super_tile]`` accumulator, then one
threshold + bit-pack pass over the stripe's live rows (kernel 6, or kernel 5
on the int8 stripes, ``ops/panel_mesh.py``) and the exact-length compaction
of ``tri_score.compact_bits``.

The streaming ops serve ``ChunkedAllPairs.insert``, ``topk`` and frozen
matching.  Entry-buffer upkeep: ``append_entries`` (an in-place set at
(chunk, slot)) and ``grow_entry_cap``.  The resident match slabs
(``build_match_slabs``, ``append_match_slabs``): every chunk densified into
one stacked ``[n_chunks, row_cap, width]`` tensor kept across inserts.
The match: ``chunk_scores`` is the one ``Σ_c slab_c · qslab_cᵀ`` loop behind
``chunked_match_extract`` (index slabs densified per call),
``cached_match_extract`` (the resident stack), ``chunked_topk`` and
``cached_topk``; ``match_extract`` is its one epilogue (threshold,
self-pair exclusion, exact-length ``torch.nonzero``).  Beyond the slab
budget the paneled match scores ``ph``-row panels densified from a
row-sorted flat COO (``sort_entries``, ``append_sorted``,
``paneled_match_extract``).  Every product is ``score.score_tile``, so every
score is fp32.  None of these has caps, a packed head or shape buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from . import panel as panel_ops
from . import score as score_ops
from . import tri_score as ts

__all__ = [
    "split_chunks",
    "bucket_entries",
    "bucket_split_entries",
    "quantize_chunk_entries",
    "densify_chunk",
    "stripe_query_rows",
    "stripe_scores",
    "stripe_dots_int8",
    "stripe_live_rows",
    "stripe_candidates",
    "join_epilogue_bits",
    "int8_join_epilogue",
    "chunked_stripe_extract",
    "chunked_stripe_extract_int8",
    "append_entries",
    "grow_entry_cap",
    "slab_dtype",
    "build_match_slabs",
    "append_match_slabs",
    "chunk_scores",
    "match_extract",
    "chunked_match_extract",
    "cached_match_extract",
    "chunked_topk",
    "cached_topk",
    "sort_entries",
    "append_sorted",
    "paneled_match_extract",
]


def split_chunks(cols: np.ndarray, n_chunks: int):
    """(chunk, local) of compact columns — interleaved assignment.

    Kept in the input's integer dtype: fresh int64 copies of 100M+-entry
    arrays are page-fault-bound, and every consumer takes int32."""
    cols = np.asarray(cols)
    return cols % n_chunks, cols // n_chunks


def bucket_entries(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_chunks: int,
    chunk_cap: int, pad_row: int,
):
    """Host-side: bucket COO entries into per-chunk 2-D buffers.

    Returns ``(rows2d, cols2d, vals2d, counts)`` with shapes
    ``[n_chunks, chunk_cap]`` / ``[n_chunks]``; unused slots carry
    ``row == pad_row``.  Entries land contiguously in slots
    ``[0, counts[c])`` preserving input order (the panel sort's
    ``pos < counts`` validity mask relies on front-contiguity)."""
    chunk, local = split_chunks(cols, n_chunks)
    counts = np.bincount(chunk, minlength=n_chunks).astype(np.int64)
    return bucket_split_entries(
        rows, chunk, local, vals, counts, chunk_cap, pad_row
    )


def bucket_split_entries(
    rows: np.ndarray, chunk: np.ndarray, local: np.ndarray,
    vals: np.ndarray, counts: np.ndarray, chunk_cap: int, pad_row: int,
):
    """``bucket_entries`` with the (chunk, local, counts) split precomputed
    — callers that size ``chunk_cap`` from the counts reuse the same pass."""
    n_chunks = counts.size
    rows = np.asarray(rows)
    vals = np.asarray(vals)
    if counts.size and int(counts.max()) > chunk_cap:
        raise ValueError("chunk_cap too small")
    rows2d = np.full((n_chunks, chunk_cap), pad_row, np.int32)
    cols2d = np.zeros((n_chunks, chunk_cap), np.int32)
    vals2d = np.zeros((n_chunks, chunk_cap), np.float32)
    for c in range(n_chunks):
        sel = np.flatnonzero(chunk == c)
        k = sel.size
        rows2d[c, :k] = rows[sel]
        cols2d[c, :k] = local[sel]
        vals2d[c, :k] = vals[sel]
    return rows2d, cols2d, vals2d, counts


def quantize_chunk_entries(rows2d: torch.Tensor, vals2d: torch.Tensor,
                           row_cap: int):
    """Per-row symmetric int8 quantization of the chunk entries.

    Returns ``(q2d int8 [n_chunks, chunk_cap], aux f32 [3, row_cap],
    max_nnz int)``: per row ``α = max|v|/127``, ``q = round(v/α)``, and the
    bound ingredients ``aux = [α, α·L1(q), nnz]`` — the same quantities as
    the dense ``quantize_rows``, computed over the entries of each row.
    ``max_nnz`` feeds the int32-accumulator gate.  All-zero rows get α = 0,
    so both their score and their bound are zero.

    Bit-identical to the JAX package's function: the JAX scatters drop the
    pad rows (row 2^30) with ``mode="drop"``; torch has no such mode, so the
    pad entries are filtered out first.  XLA compiles ``mx / 127.0`` to a
    multiply by the fp32 reciprocal, and so does this; ``v / div`` divides
    by a tensor and stays a true division.  L1(q) and nnz are sums of
    integers below 2^24, exact in any order."""
    flat_r = rows2d.reshape(-1)
    flat_v = vals2d.reshape(-1)
    live = flat_r < row_cap
    r_live = flat_r[live].long()
    absv = flat_v.abs()
    mx = torch.zeros(row_cap, dtype=torch.float32, device=flat_v.device)
    mx.scatter_reduce_(0, r_live, absv[live], reduce="amax")
    alpha = torch.where(mx > 0, mx * (1.0 / 127.0), 0.0).to(torch.float32)
    a_e = alpha[flat_r.clamp(max=row_cap - 1).long()]
    div = torch.where(a_e > 0, a_e, 1.0)
    q = (flat_v / div).round_().clamp_(-127, 127).to(torch.int8)
    l1q = torch.zeros_like(mx).index_add_(
        0, r_live, q[live].abs().to(torch.float32)
    )
    nnz = torch.zeros_like(mx).index_add_(
        0, r_live, (flat_v[live] != 0).to(torch.float32)
    )
    aux = torch.stack([alpha, alpha * l1q, nnz])
    max_nnz = int(nnz.max()) if row_cap else 0
    return q.reshape(rows2d.shape), aux, max_nnz


# ------------------------------------------------------------- stripe join


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:  # each stage of the split holds its own device time
        torch.cuda.synchronize(t.device)


def densify_chunk(rows2d, cols2d, vals2d, counts, c: int, cap_rows: int,
                  chunk_dim: int, dtype=torch.float32):
    """One ``[cap_rows, chunk_dim]`` slab of ``dtype`` from chunk ``c``'s
    entry buffer (``apsim_tpu/ops/chunked.py:_densify_chunk``).

    A scatter **set**: the entries of a chunk are unique (one per (row,
    external dim), and the interleaved local mapping is injective within a
    chunk), so an assignment into zeros in the target dtype rounds each
    value once and equals the JAX scatter.  Only the slots
    ``[0, counts[c])`` are read; a row at or past ``cap_rows`` there (a pad
    row) is dropped as JAX's ``mode="drop"`` drops it, by landing in one
    spare row that the returned view leaves out: ``index_put_`` has no drop
    mode, and a boolean filter would wait for the device on every chunk.
    ``counts`` may be a host array (no device read) or a tensor.
    ``chunk_dim`` may exceed the largest local dim (the int8 stripes pad it
    to the kernel's K quantum)."""
    k = int(counts[c])
    r = rows2d[c, :k].long()
    slab = torch.zeros((cap_rows + 1, chunk_dim), dtype=dtype,
                       device=rows2d.device)
    slab.index_put_((torch.where(r < cap_rows, r, cap_rows),
                     cols2d[c, :k].long()), vals2d[c, :k].to(dtype))
    return slab[:cap_rows]


def stripe_query_rows(slab, q0: int, super_tile: int, quantum: int = 1):
    """The stripe's query rows ``slab[q0:q0 + super_tile]``: a view, or,
    where ``super_tile`` is not a multiple of ``quantum``, a zero-padded
    copy of the next multiple (zero rows add zero dots, which the caller
    slices away)."""
    q = slab[q0:q0 + super_tile]
    pad = -super_tile % quantum
    if pad:
        q = torch.cat([q, q.new_zeros((pad, slab.shape[1]))])
    return q


def stripe_scores(rows2d, cols2d, vals2d, counts, q0: int, row_cap: int,
                  chunk_dim: int, super_tile: int, precision: str = "default",
                  timer=None):
    """fp32 scores ``[row_cap, super_tile]`` of one query stripe: the sum
    over the buffers' chunks of ``slab @ slab[q0:q0 + super_tile]^T``.

    Slabs are bf16 unless ``precision == "highest"`` (fp32), on either
    device: the values round to bf16 once, as in the JAX package.  Every
    product is ``score.score_tile``: fp32 accumulation and an fp32 result
    (a true fp32 product at ``"highest"``), so only operand rounding enters
    the 2e-2 margin.  Stages "slabs" (densify) and "kernel" (product and
    accumulate)."""
    sdt = torch.float32 if precision == "highest" else torch.bfloat16
    acc = None
    for c in range(rows2d.shape[0]):
        with ts._section(timer, "slabs"):
            slab = densify_chunk(rows2d, cols2d, vals2d, counts, c, row_cap,
                                 chunk_dim, sdt)
            _sync(slab)
        with ts._section(timer, "kernel"):
            part = score_ops.score_tile(
                slab, stripe_query_rows(slab, q0, super_tile), precision)
            acc = part if acc is None else acc.add_(part)
            del part, slab
            _sync(acc)
    if acc is None:
        acc = torch.zeros((row_cap, super_tile), dtype=torch.float32,
                          device=rows2d.device)
    return acc


def stripe_dots_int8(rows2d, cols2d, q2d, counts, q0: int, row_cap: int,
                     chunk_dim: int, super_tile: int, timer=None):
    """Exact int32 dots ``[row_cap, super_tile]`` of one query stripe over
    int8 slabs: per chunk one ``panel_mesh.int8_matmul`` (kernel 4 on the
    card, its plain version on the CPU), summed in int32.

    Kernel 4 takes ``m % 64``, ``n % 128``, ``d % 128`` and 16-byte-aligned
    operands, met here by a stated rule: the slab's width is padded with
    zero columns to a multiple of 128 (they add nothing to an integer
    dot, and row starts stay 16-byte aligned), the query rows are a row
    slice of the slab, zero-padded to a multiple of 128 rows where
    ``super_tile`` is not one (the extra columns of the product are sliced
    away), and a ``row_cap`` that is not a multiple of 64 is refused."""
    # ops/panel_mesh.py imports the mesh collectives, and through them the
    # engines that import this module: bind kernel 4 at call time
    from .panel_mesh import MM_TM, MM_TN, int8_matmul

    if row_cap % MM_TM:
        raise ValueError(
            f"int8 stripes need row_cap % {MM_TM} == 0 (kernel 4's row "
            f"quantum), got {row_cap}"
        )
    width = -(-chunk_dim // ts.K_QUANTUM) * ts.K_QUANTUM
    acc = None
    for c in range(rows2d.shape[0]):
        with ts._section(timer, "slabs"):
            slab = densify_chunk(rows2d, cols2d, q2d, counts, c, row_cap,
                                 width, torch.int8)
            _sync(slab)
        with ts._section(timer, "kernel"):
            part = int8_matmul(
                slab, stripe_query_rows(slab, q0, super_tile, MM_TN)
            )[:, :super_tile]
            acc = part if acc is None else acc.add_(part)
            del part, slab
            _sync(acc)
    if acc is None:
        acc = torch.zeros((row_cap, super_tile), dtype=torch.int32,
                          device=rows2d.device)
    return acc


def stripe_live_rows(row_cap: int, q0: int, tile: int) -> int:
    """Rows of the stripe at ``q0`` that can hold a hit: a hit needs
    ``row < q0 + col`` with ``col < tile``, so no row from ``q0 + tile - 1``
    on has one.  Rounded up to the stripe's compaction unit (whole 512-row
    cells where ``row_cap`` takes the pre-level, else 64-row
    super-groups) and capped at ``row_cap``: the rows below it are left
    out of the epilogue, and their bits would all be zero."""
    unit = ts.SUPER2 if row_cap % ts.SUPER2 == 0 else ts.SUPER
    return min(row_cap, -(-(q0 + tile) // unit) * unit)


def stripe_candidates(placed, bounds, devices, aux, q0: int, tile: int,
                      row_cap: int, tau_eff, lead, timer=None):
    """Candidates ``(rows, cols)`` (int64, exact length, on ``lead``) of
    one stripe from row slices of its live rows (``stripe_live_rows``):
    ``placed[k]`` the partials of rows ``bounds[k]`` on ``devices[k]``.
    Each device runs kernel 6 (fp32 scores, ``aux`` None) or kernel 5 (int32
    dots, with ``aux``'s rows of the slice and its columns ``[q0, q0 +
    tile)``) and compacts its bits; the lists are those of one ``(row_cap,
    tile)`` block at ``bj = q0 // tile``, in its order
    (``panel_mesh.pair_candidates``).  Stages "epilogue" and "compact"."""
    # ops/panel_mesh.py imports the mesh collectives, and through them the
    # engines that import this module: bind the kernels at call time
    from .panel_mesh import pair_candidates

    aux_j = None if aux is None else aux[:, q0:q0 + tile]
    return pair_candidates(placed, bounds, devices, aux, aux_j, 0, q0,
                           row_cap, tau_eff, lead, timer, cols=tile)


def join_epilogue_bits(s, q0: int, tau_eff, timer=None):
    """Candidates ``(rows, cols)`` (device int64, exact length) of one fp32
    score stripe ``s [row_cap, tile]``: ``s >= tau_eff`` in the strict
    upper triangle (``row < q0 + col``), thresholded and bit-packed by
    kernel 6 over the stripe's live rows, then compacted."""
    row_cap, tile = s.shape
    live = stripe_live_rows(row_cap, q0, tile)
    return stripe_candidates([[s[:live]]], [(0, live)], [s.device], None, q0,
                             tile, row_cap, tau_eff, s.device, timer)


def int8_join_epilogue(d, aux, q0: int, tau_eff, timer=None):
    """Candidates of one exact int32 dot stripe ``d [row_cap, tile]``: the
    per-pair quantization bound and the strict-upper mask on global rows
    and columns (kernel 5, the bound of ``panel.int8_bound_mask``), with
    ``aux`` the f32 ``[3, row_cap]`` table and its columns ``[q0, q0 +
    tile)`` for the query side.  Used by the single-device int8 stripes and
    by the mesh's over several processes (where ``d`` is the exact sum of
    the shards' partial dots)."""
    row_cap, tile = d.shape
    live = stripe_live_rows(row_cap, q0, tile)
    return stripe_candidates([[d[:live]]], [(0, live)], [d.device], aux, q0,
                             tile, row_cap, tau_eff, d.device, timer)


def chunked_stripe_extract(rows2d, cols2d, vals2d, counts, q0: int, tau_eff,
                           row_cap: int, chunk_dim: int, super_tile: int,
                           precision: str = "default", timer=None):
    """Candidates of one ``super_tile``-wide query stripe of the
    upper-triangle join over chunked COO entries
    (``apsim_tpu/ops/chunked.py:chunked_stripe_extract`` without caps and
    head): ``stripe_scores`` then ``join_epilogue_bits``."""
    s = stripe_scores(rows2d, cols2d, vals2d, counts, q0, row_cap, chunk_dim,
                      super_tile, precision, timer)
    return join_epilogue_bits(s, q0, tau_eff, timer)


def chunked_stripe_extract_int8(rows2d, cols2d, q2d, counts, aux, q0: int,
                                tau_eff, row_cap: int, chunk_dim: int,
                                super_tile: int, timer=None):
    """int8 variant: int8 slabs from ``quantize_chunk_entries``' ``q2d``,
    exact int32 accumulation through kernel 4 (``stripe_dots_int8``), the
    per-pair quantization bound in the epilogue (``int8_join_epilogue``;
    the dense int8 kernel's proof)."""
    d = stripe_dots_int8(rows2d, cols2d, q2d, counts, q0, row_cap, chunk_dim,
                         super_tile, timer)
    return int8_join_epilogue(d, aux, q0, tau_eff, timer)


# ------------------------------------------------------------ streaming


def append_entries(rows2d, cols2d, vals2d, chunk, slot, row, local, val):
    """Set new entries at ``(chunk, slot)`` of the entry buffers, in place
    (``apsim_tpu/ops/chunked.py:append_entries_packed``).  The index tensors
    lie on the buffers' device and hold exactly the new entries: the JAX
    op's pow2 padding and its ``chunk == n_chunks`` drop entries have no
    counterpart, since ``index_put_`` has no drop mode."""
    idx = (chunk.long(), slot.long())
    rows2d.index_put_(idx, row)
    cols2d.index_put_(idx, local)
    vals2d.index_put_(idx, val)


def grow_entry_cap(rows2d, cols2d, vals2d, new_cap: int, pad_row: int):
    """Capacity-doubling copy of the per-chunk buffers: the old slots in
    front, new slots carrying ``pad_row`` (rows) and zeros."""
    n_chunks, old = rows2d.shape

    def grown(a, fill):
        out = torch.full((n_chunks, new_cap), fill, dtype=a.dtype,
                         device=a.device)
        out[:, :old] = a
        return out

    return grown(rows2d, pad_row), grown(cols2d, 0), grown(vals2d, 0.0)


def slab_dtype(precision: str) -> torch.dtype:
    """Match-slab dtype: fp32 at ``"highest"``, else bf16 (``_slab_dtype``
    of the JAX engine)."""
    return torch.float32 if precision == "highest" else torch.bfloat16


def build_match_slabs(rows2d, cols2d, vals2d, counts, row_cap: int,
                      width: int, dtype):
    """Every chunk densified into one stacked ``[n_chunks, row_cap, width]``
    tensor of ``dtype``: the resident form of the streaming match.  Each
    layer is ``densify_chunk``'s slab, so the two routes round alike."""
    n_chunks = rows2d.shape[0]
    stack = torch.empty((n_chunks, row_cap, width), dtype=dtype,
                        device=rows2d.device)
    for c in range(n_chunks):
        stack[c] = densify_chunk(rows2d, cols2d, vals2d, counts, c, row_cap,
                                 width, dtype)
    return stack


def _check_unique(keys: torch.Tensor, what: str) -> None:
    """Refuse repeated scatter targets: a set would keep an arbitrary one of
    them, where the JAX scatter assumes ``unique_indices``."""
    if torch.unique(keys).numel() != keys.numel():
        raise ValueError(f"{what}: repeated (row, col) entries")


def append_match_slabs(stack, chunk, row, local, val) -> None:
    """Set a batch's ``(chunk, row, local)`` entries into the resident stack
    in place (``append_match_slabs_packed``), each value rounded once to the
    stack's dtype as ``build_match_slabs`` rounds it.  Raises
    ``ValueError`` on a repeated target."""
    _, row_cap, width = stack.shape
    chunk, row, local = chunk.long(), row.long(), local.long()
    _check_unique((chunk * row_cap + row) * width + local,
                  "append_match_slabs")
    stack.index_put_((chunk, row, local), val.to(stack.dtype))


def chunk_scores(slab_of, q, n_chunks: int, width: int, q_rows: int,
                 sdt, precision: str, queries_lead: bool = False,
                 timer=None):
    """``Σ_c slab_c · qslab_cᵀ``: fp32 ``[row_cap, q_rows]`` scores, or
    ``[q_rows, row_cap]`` with ``queries_lead`` (top-k), the counterpart of
    ``_chunk_score_loop``.  ``slab_of(c)`` is the index side of chunk ``c``
    (``densify_chunk`` or a layer of the resident stack); ``q`` is the
    chunk-bucketed query batch ``(rows2d, cols2d, vals2d, counts)``,
    densified per chunk in ``sdt``.  Every product is ``score.score_tile``
    (fp32 result whatever the operands), accumulated in fp32.  With a
    ``Timer`` each chunk's densifies are timed as "slabs" and its product
    and accumulate as "product", each stage ending with the device idle."""
    acc = None
    for c in range(n_chunks):
        with ts._section(timer, "slabs"):
            slab = slab_of(c)
            qslab = densify_chunk(*q, c, q_rows, width, sdt)
            if timer is not None:
                _sync(slab)
        with ts._section(timer, "product"):
            a, b = (qslab, slab) if queries_lead else (slab, qslab)
            part = score_ops.score_tile(a, b, precision)
            acc = part if acc is None else acc.add_(part)
            del part, slab, qslab
            if timer is not None:
                _sync(acc)
    return acc


def match_extract(s, q_base: int, tau_eff, timer=None):
    """Candidates of a match score block ``s [rows, q]``: device int64
    ``(index rows, query locals)`` of every cell with ``s >= tau_eff``
    except the batch's own cells (row ``q_base + j`` against column ``j``),
    exact length (``torch.nonzero``).  ``q_base`` is relative to the
    block's first row and may be negative (a panel below the batch).  The
    one epilogue of every match route, in place of ``match_epilogue_bits``
    and ``match_epilogue``.  With a ``Timer`` the ``nonzero``, which
    returns once the device has caught up, is timed as "compact_sync"."""
    m = s >= float(tau_eff)
    j0, j1 = max(0, -q_base), min(s.shape[1], s.shape[0] - q_base)
    if j0 < j1:
        j = torch.arange(j0, j1, device=s.device)
        m[q_base + j, j] = False
    with ts._section(timer, "compact_sync"):
        hit = torch.nonzero(m)
    return hit[:, 0], hit[:, 1]


def _scored_extract(score, q_base: int, tau_eff, timer):
    """``score()`` timed as "product", ``match_extract`` as "compact"."""
    with ts._section(timer, "product"):
        s = score()
        _sync(s)
    with ts._section(timer, "compact"):
        return match_extract(s, q_base, tau_eff, timer)


def chunked_match_extract(rows2d, cols2d, vals2d, counts, q, q_base: int,
                          tau_eff, row_cap: int, width: int, q_rows: int,
                          precision: str = "default", timer=None):
    """Streaming match of a chunk-bucketed query batch against the whole
    index, each chunk slab densified from the entry buffers per call (the
    rebuild route)."""
    sdt = slab_dtype(precision)
    return _scored_extract(lambda: chunk_scores(
        lambda c: densify_chunk(rows2d, cols2d, vals2d, counts, c, row_cap,
                                width, sdt),
        q, rows2d.shape[0], width, q_rows, sdt, precision,
    ), q_base, tau_eff, timer)


def cached_match_extract(stack, q, q_base: int, tau_eff, q_rows: int,
                         precision: str = "default", timer=None):
    """``chunked_match_extract`` against the resident stack: the same slab
    values, the same products, the same epilogue."""
    n_chunks, _, width = stack.shape
    return _scored_extract(lambda: chunk_scores(
        lambda c: stack[c], q, n_chunks, width, q_rows, stack.dtype,
        precision,
    ), q_base, tau_eff, timer)


def _topk(s, n_rows: int, k: int):
    s[:, n_rows:] = -float("inf")
    return torch.topk(s, k, dim=1)


def chunked_topk(rows2d, cols2d, vals2d, counts, q, n_rows: int,
                 row_cap: int, width: int, q_rows: int, k: int,
                 precision: str = "highest"):
    """Top ``k`` fp32 scores per query row and their index rows, descending
    (``(scores [q_rows, k], rows [q_rows, k])``), slabs densified from the
    entry buffers; rows ``>= n_rows`` are masked to ``-inf``."""
    sdt = slab_dtype(precision)
    s = chunk_scores(
        lambda c: densify_chunk(rows2d, cols2d, vals2d, counts, c, row_cap,
                                width, sdt),
        q, rows2d.shape[0], width, q_rows, sdt, precision, queries_lead=True)
    return _topk(s, n_rows, k)


def cached_topk(stack, q, n_rows: int, q_rows: int, k: int,
                precision: str = "default"):
    """``chunked_topk`` against the resident stack, scored at the stack's
    dtype (the engine widens its fetch margin for a bf16 stack)."""
    n_chunks, _, width = stack.shape
    s = chunk_scores(lambda c: stack[c], q, n_chunks, width, q_rows,
                     stack.dtype, precision, queries_lead=True)
    return _topk(s, n_rows, k)


# ---------------------------------------------------- paneled match
# Beyond the slab budget the index is kept as ONE row-sorted flat COO
# (global compact col = local * n_chunks + chunk, fp32 values), extended in
# place: a streamed batch's rows lie at or above every existing row, so its
# row-sorted entries extend the tail; a dormant activation's entries (new
# columns of older rows) go to an unsorted overflow region.  The match
# densifies one ``ph``-row panel at a time from its sorted slice (found by
# ``searchsorted``) and the overflow entries of its rows, and multiplies it
# with the query slab, so the score block is ``[ph, q]``.


def sort_entries(rows2d, cols2d, vals2d, counts, cap_s: int):
    """Row-sorted flat COO of the live entries, in buffers of ``cap_s``
    (``sort_entries_fp``): ``(rows, gcols, vals, n_live)``; slots past
    ``n_live`` carry row ``panel.PAD_ROW``.  ``counts`` is the device
    counts tensor; the caller guarantees ``cap_s >= n_live``."""
    n_chunks, cap = rows2d.shape
    dev = rows2d.device
    valid = (torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
             < counts.to(torch.int32)[:, None])
    chunk_of = torch.arange(n_chunks, dtype=torch.int32,
                            device=dev)[:, None].expand(n_chunks, cap)
    r = rows2d[valid]
    gc = cols2d[valid] * n_chunks + chunk_of[valid]
    v = vals2d[valid]
    order = torch.argsort(r, stable=True)
    n = r.numel()
    r_s = torch.full((cap_s,), panel_ops.PAD_ROW, dtype=torch.int32,
                     device=dev)
    gc_s = torch.zeros(cap_s, dtype=torch.int32, device=dev)
    v_s = torch.zeros(cap_s, dtype=torch.float32, device=dev)
    r_s[:n], gc_s[:n], v_s[:n] = r[order], gc[order], v[order]
    return r_s, gc_s, v_s, n


def append_sorted(state: dict, rows, gcols, vals, tail: bool) -> None:
    """Write a batch's entries into the sorted state in place
    (``append_sorted_packed``): with ``tail`` row-sorted onto the sorted
    region (the batch's rows are at or above every existing row), else
    into the overflow region, where repeated ``(row, col)`` targets are
    refused.  The caller guarantees the capacity."""
    if tail:
        order = torch.argsort(rows, stable=True)
        rows, gcols, vals = rows[order], gcols[order], vals[order]
        keys = ("r_s", "gc_s", "v_s", "n_ent")
    else:
        _check_unique((rows.long() << 32) + gcols.long(), "append_sorted")
        keys = ("r_o", "gc_o", "v_o", "n_o")
    off, n = state[keys[3]], rows.numel()
    for key, a in zip(keys[:3], (rows, gcols, vals)):
        state[key][off:off + n] = a
    state[keys[3]] = off + n


def paneled_match_extract(state: dict, qslab, q_base: int, n_rows: int,
                          ph: int, tau_eff, precision: str = "default",
                          timer=None):
    """Streaming match of a dense query slab ``qslab [q, d_cap]`` (slab
    dtype, compact columns) against the sorted state, one ``ph``-row panel
    at a time (``paneled_match_extract_bits`` without its packed header,
    caps or ``lax.cond``): panels at or past ``n_rows`` are skipped; a live
    panel's slab ``[ph, d_cap]`` takes its sorted slice and the overflow
    entries of its rows, each value rounded once to the slab dtype, then
    ``score_tile`` and ``match_extract`` with the panel's row offset.
    Returns device int64 ``(index rows, query locals)``; stages "product"
    (slab and product) and "compact"."""
    dev = qslab.device
    n_ent, n_o = state["n_ent"], state["n_o"]
    r_s = state["r_s"][:n_ent]
    gc_s, v_s = state["gc_s"][:n_ent], state["v_s"][:n_ent]
    r_o = state["r_o"][:n_o]
    gc_o, v_o = state["gc_o"][:n_o], state["v_o"][:n_o]
    n_live = -(-n_rows // ph)
    starts = torch.searchsorted(
        r_s, torch.arange(n_live + 1, dtype=torch.int32, device=dev) * ph
    ).tolist()
    found = []
    for p in range(n_live):
        row0 = p * ph
        with ts._section(timer, "product"):
            slab = torch.zeros((ph, qslab.shape[1]), dtype=qslab.dtype,
                               device=dev)
            a, b = starts[p], starts[p + 1]
            slab.index_put_(((r_s[a:b] - row0).long(), gc_s[a:b].long()),
                            v_s[a:b].to(qslab.dtype))
            if n_o:
                ok = (r_o >= row0) & (r_o < row0 + ph)
                slab.index_put_(((r_o[ok] - row0).long(), gc_o[ok].long()),
                                v_o[ok].to(qslab.dtype))
            s = score_ops.score_tile(slab, qslab, precision)
            del slab
            _sync(s)
        with ts._section(timer, "compact"):
            rows, cols = match_extract(s, q_base - row0, tau_eff, timer)
            found.append((rows + row0, cols))
            del s
    if not found:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, empty.clone()
    return (torch.cat([r for r, _ in found]), torch.cat([c for _, c in found]))
