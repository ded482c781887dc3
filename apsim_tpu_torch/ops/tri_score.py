"""Upper-triangle all-pairs scoring: the counterpart of
``apsim_tpu/ops/pallas_score.py``.

The dense join scores only the upper-triangle blocks ``(bi, bj)`` of
``X·Xᵀ`` (``upper_blocks_rect``) and fuses threshold, triangle mask and
bit-packing into the score epilogue, so no score tile reaches device memory.
Per block p the kernels write

  gb   [n_blocks, tm/8, tn]  uint8 — bit o of byte (g, c) is row g·8+o
  g64  [n_blocks, tm/64, tn] uint8 — 64-row super-group any-hit
  cnt  [n_blocks, 3]         int32 — (pairs, hit groups, hit supers)

(the TPU's ``[8, 128]`` count tile was TPU tiling; the compaction only reads
these three lanes).  ``compact_bits`` turns that structure into the exact
list of hit (row, col) pairs.

Two scorers, each a wrapper that launches a CUDA kernel
(``csrc/score_bits.cu``) for a CUDA tensor and runs the plain PyTorch version
beside it for a CPU tensor — never one in place of the other:

  ``score_bits_int8``  int8 rows, per-pair quantization bound (the default)
  ``score_bits_bf16``  bf16 rows, fp32 accumulation

Both kernels (and the cross-panel kernel and the int8 matmul of
``ops/panel.py`` and ``ops/panel_mesh.py``) are one design: a TMA ring and
``wgmma`` over thread-block tiles chosen by shape (``thread_block_tile``),
walked through a live-first sub-tile list (``tile_list``).

``LAUNCHES`` counts the kernel launches of each wrapper, and
``LAUNCHES_BY_CARD`` the same launches by the index of the card they ran
on (a mesh over several cards launches on each).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ._build import kernels

__all__ = [
    "GROUP", "SUPER", "SUPER2", "LAUNCHES", "LAUNCHES_BY_CARD",
    "zero_launches", "check_tiles", "upper_blocks_rect",
    "quantize_rows", "thread_block_tile", "live_subtiles", "tile_list",
    "check_aligned", "next_tile_counter",
    "score_bits_int8", "score_bits_bf16",
    "score_bits_int8_plain", "score_bits_bf16_plain", "int8_bound_value",
    "int8_scores",
    "bf16_scores", "bitpack_mask", "epilogue_rows", "bitpack_row_chunks",
    "unpack_bits",
    "check_pair_count", "compact_bits",
    "allpairs_extract_int8", "allpairs_extract_bf16",
]

GROUP = 8  # rows per bit-packed byte (fixed: the uint8 width)
SUPER = 64  # rows per level-0 super-group (8 group bytes)
SUPER2 = 512  # rows per pre-level cell (reduced from g64 at compaction time)
K_QUANTUM = 128  # the kernels stream K in 128-byte stages per row
COL_QUANTUM = 128  # columns of the smallest CUDA thread-block tile
THREAD_BLOCK_TILES = ((128, 256), (64, 128))  # of kernels 1-4

# kernel launches per wrapper (only a launch of the CUDA kernel counts);
# ``panel_score_bits_int8`` is the cross-panel wrapper of ``ops/panel.py``,
# ``int8_matmul`` the per-shard partial dot of ``ops/panel_mesh.py``, and
# ``pair_bits_int8`` and ``pair_bits_f32`` the summed-partial epilogues
# there (the mesh panel pair's; the int8 and the bf16 / fp32 stripes')
LAUNCHES = {"score_bits_int8": 0, "score_bits_bf16": 0,
            "panel_score_bits_int8": 0, "int8_matmul": 0,
            "pair_bits_int8": 0, "pair_bits_f32": 0}
# the same launches keyed by wrapper, then by card index
LAUNCHES_BY_CARD = {name: {} for name in LAUNCHES}


def zero_launches() -> None:
    """Set every count of ``LAUNCHES`` and ``LAUNCHES_BY_CARD`` to zero."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCHES_BY_CARD[name].clear()


def check_tiles(rows_i: int, rows_j: int, dim: int, tm: int, tn: int,
                tk: int) -> None:
    """Reject tiles that do not divide the operands exactly: a floored grid
    would silently drop trailing rows/columns from a lossless join."""
    if rows_i % tm or rows_j % tn or dim % tk:
        raise ValueError(
            f"kernel tiles must divide operands exactly: "
            f"rows {rows_i} % tm {tm}, cols {rows_j} % tn {tn}, "
            f"dim {dim} % tk {tk}"
        )


def upper_blocks_rect(
    row_cap: int, tm: int, tn: int
) -> tuple[np.ndarray, np.ndarray]:
    """Block schedule for rectangular tiles: include (bi, bj) iff the block
    contains some strict-upper pair (min_row < max_col)."""
    n_ti, n_tj = row_cap // tm, row_cap // tn
    bi, bj = np.meshgrid(np.arange(n_ti), np.arange(n_tj), indexing="ij")
    keep = (bi * tm) < ((bj + 1) * tn - 1)
    return bi[keep].astype(np.int32), bj[keep].astype(np.int32)


# --------------------------------------------------------------- int8 rows
#
# Per-row symmetric quantization x_i = α_i (q_i + e_i), α_i = max|x_i|/127,
# q int8, |e| ≤ 0.5 and e = 0 off-support.  The epilogue rescales and
# thresholds with a PER-PAIR quantization-error upper bound
#
#   |x_i·x_j − α_iα_j D| ≤ 0.5(α_j b_i + α_i b_j) + 0.25 α_iα_j min(n_i, n_j)
#
# where D = Σ q_i q_j (int32), b_i = α_i L1(q_i), n_i = nnz(x_i) — so
# candidates at ``s_hat + bound ≥ tau_eff`` form a PROVEN superset and the
# host fp64 rescore keeps the emitted pair set exact.  int32 accumulator
# safety: D ≤ 127²·max_nnz — the engine gates this path on
# max_nnz < 2^30/127².


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, aux f32 [3, rows]): per-row symmetric int8 quantization with
    the bound ingredients (aux rows: α, α·L1(q), nnz).  Bit-identical to the
    JAX package's ``quantize_rows``: ``torch.round`` rounds half to even like
    ``jnp.round``, and L1(q) and nnz are exact sums.

    All-zero (padded/invalid) rows get α = 0, which zeroes BOTH their
    rescaled score and their error bound, so the epilogue's
    ``s_hat + bound >= tau_eff`` test excludes them.  (With an α = 1
    fallback a padded row's bound is ``0.5·α_j·L1(q_j)`` ≈ the partner row's
    L1 ≫ tau, and every padded×real pair leaks through as a candidate.)"""
    s = x.abs().amax(dim=1)
    # XLA compiles the JAX source's ``s / 127.0`` (a division by a
    # constant) to a multiply by the fp32 reciprocal; so does this
    alpha = torch.where(s > 0, s * (1.0 / 127.0), 0.0).to(torch.float32)
    div = torch.where(s > 0, alpha, 1.0)
    # one full-size fp32 temporary, rounded, clamped and then reused for
    # L1(q) in place (three out-of-place passes would hold three copies)
    t = x / div[:, None]
    t.round_().clamp_(-127, 127)
    q = t.to(torch.int8)
    l1q = t.abs_().sum(dim=1)
    nnz = (x != 0).sum(dim=1, dtype=torch.float32)
    return q, torch.stack([alpha, alpha * l1q, nnz])


def thread_block_tile(rows: int, cols: int) -> tuple[int, int]:
    """The kernels' thread-block tile for block tiles ``(rows, cols)``
    (``(tm, tn)`` of the score kernels 1-3, int8 and bf16 alike; ``(m, n)``
    of kernel 4): 128 x 256 (two consumer warpgroups) where it divides
    them, else 64 x 128 (one).  ``csrc/score_bits.cu`` makes the same
    choice from the same shapes."""
    for bm, bn in THREAD_BLOCK_TILES:
        if rows % bm == 0 and cols % bn == 0:
            return bm, bn
    raise ValueError(
        f"no thread-block tile divides ({rows}, {cols}): rows must be "
        f"a multiple of 64 and columns of 128"
    )


def live_subtiles(bi, bj, tm: int, tn: int, off=(0, 0), valid=None):
    """The score kernels' tile list: int32 ids ``(p * tm/BM + cm) *
    tn/BN + cn`` of every thread-block sub-tile of the block list, for the
    ``thread_block_tile(tm, tn)`` thread-block tile ``(BM, BN)``, the live ones
    first and each part in block-list order.  A sub-tile is live when its
    block is valid and its smallest global row (local plus ``off[0]``) lies
    below its largest global column (local plus ``off[1]``).  The kernel's
    persistent thread blocks draw from the list in order, so the live tiles
    spread evenly over them; a dead tile only writes its zero bytes.  Built
    with torch ops on the block list's device, no host round trip."""
    bm, bn = thread_block_tile(tm, tn)
    sub_m, sub_n = tm // bm, tn // bn
    ids = torch.arange(bi.numel() * sub_m * sub_n, device=bi.device)
    p = ids // (sub_m * sub_n)
    row0 = off[0] + bi.long()[p] * tm + (ids // sub_n) % sub_m * bm
    col_last = off[1] + bj.long()[p] * tn + (ids % sub_n) * bn + bn - 1
    live = row0 < col_last
    if valid is not None:
        live &= valid[p] != 0
    return torch.argsort((~live).to(torch.int32), stable=True).to(torch.int32)


_TILE_LISTS: dict = {}  # launch key -> (bi, bj, valid, tiles)
_TILE_LISTS_MAX = 32


def tile_list(bi, bj, tm: int, tn: int, off, valid, rows_i: int,
              rows_j: int):
    """``live_subtiles`` for one launch over ``rows_i`` x ``rows_j``
    operands, cached: a join launches the same block list many times, and
    building the list costs a dozen small device ops of host time.  The
    key holds the block tensors' identities and versions (the entry keeps
    the tensors alive, so an identity is not reused while it is cached)
    and the offset difference ``off[1] - off[0]`` clamped to
    ``[-rows_j, rows_i]``, outside which no sub-tile's liveness changes, so
    every off-diagonal panel pair of a join shares one entry."""
    delta = min(max(int(off[1]) - int(off[0]), -rows_j), rows_i)
    key = (id(bi), bi._version, id(bj), bj._version, id(valid),
           None if valid is None else valid._version, delta, tm, tn)
    hit = _TILE_LISTS.get(key)
    if hit is None:
        tiles = live_subtiles(bi, bj, tm, tn, (0, delta), valid)
        hit = (bi, bj, valid, tiles)
        if len(_TILE_LISTS) >= _TILE_LISTS_MAX:
            _TILE_LISTS.pop(next(iter(_TILE_LISTS)))
        _TILE_LISTS[key] = hit
    return hit[3]


def check_aligned(*ops) -> None:
    """The kernels load their operands with TMA, which needs a
    16-byte-aligned base (the row stride, a multiple of 128 bytes, is
    aligned by the K quantum): refuse a view that starts elsewhere."""
    for op in ops:
        if op.data_ptr() % 16:
            raise ValueError(
                f"operand data must start on a 16-byte boundary, got an "
                f"offset of {op.data_ptr() % 16} bytes (copy the view with "
                f".clone())"
            )


def _check_operands(x, bi, bj, tm: int, tn: int, dtype, row_bytes: int,
                    xj=None):
    """Validate ``x`` (and the column operand ``xj``, default ``x``) and the
    block list for the kernels' tiling; raise on anything they refuse."""
    xj = x if xj is None else xj
    for op in (x, xj):
        if op.dtype != dtype or op.dim() != 2 or not op.is_contiguous():
            raise ValueError(
                f"operand must be a contiguous 2-D {dtype} tensor, got "
                f"{op.dtype} {tuple(op.shape)}"
            )
    if xj.shape[1] != x.shape[1] or xj.device != x.device:
        raise ValueError("row and column operands differ in width or device")
    check_tiles(x.shape[0], xj.shape[0], row_bytes, tm, tn, K_QUANTUM)
    if tm % SUPER or tn % COL_QUANTUM:
        raise ValueError(
            f"tm must be a multiple of {SUPER} and tn of {COL_QUANTUM}, "
            f"got ({tm}, {tn})"
        )
    for name, b in (("bi", bi), ("bj", bj)):
        if b.dtype != torch.int32 or b.dim() != 1 or b.device != x.device:
            raise ValueError(f"{name} must be 1-D int32 on {x.device}")
    if bi.shape != bj.shape:
        raise ValueError("bi and bj differ in length")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _outputs(n: int, tm: int, tn: int, device):
    return (
        torch.empty((n, tm // GROUP, tn), dtype=torch.uint8, device=device),
        torch.empty((n, tm // SUPER, tn), dtype=torch.uint8, device=device),
        torch.zeros((n, 3), dtype=torch.int32, device=device),
    )


def next_tile_counter(device) -> torch.Tensor:
    """The kernels' dynamic tile counter: one int32, zero."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _launch(name: str, x: torch.Tensor, args) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(kernels(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    card = LAUNCHES_BY_CARD[name]
    card[x.device.index] = card.get(x.device.index, 0) + 1


def score_bits_int8(xq, aux, bi, bj, tau_eff, tm: int = 1024, tn: int = 512):
    """(gb, g64, cnt) of the int8 scorer over the block list (bi, bj)."""
    _check_operands(xq, bi, bj, tm, tn, torch.int8, xq.shape[1])
    row_cap, dim_cap = xq.shape
    if (aux.dtype != torch.float32 or tuple(aux.shape) != (3, row_cap)
            or not aux.is_contiguous() or aux.device != xq.device):
        raise ValueError(f"aux must be contiguous f32 [3, {row_cap}]")
    check_aligned(xq)
    if xq.device.type == "cpu":
        return score_bits_int8_plain(xq, aux, bi, bj, tau_eff, tm, tn)
    gb, g64, cnt = _outputs(bi.numel(), tm, tn, xq.device)
    tiles = tile_list(bi, bj, tm, tn, (0, 0), None, row_cap, row_cap)
    nxt = next_tile_counter(xq.device)
    _launch("score_bits_int8", xq, (
        xq.data_ptr(), aux.data_ptr(), tiles.data_ptr(), bi.data_ptr(),
        bj.data_ptr(), float(tau_eff), row_cap, dim_cap, bi.numel(), tm, tn,
        gb.data_ptr(), g64.data_ptr(), cnt.data_ptr(), nxt.data_ptr(),
    ))
    return gb, g64, cnt


def score_bits_bf16(x, bi, bj, tau_eff, tm: int = 1024, tn: int = 512):
    """(gb, g64, cnt) of the bf16 scorer over the block list (bi, bj)."""
    _check_operands(x, bi, bj, tm, tn, torch.bfloat16, 2 * x.shape[1])
    check_aligned(x)
    if x.device.type == "cpu":
        return score_bits_bf16_plain(x, bi, bj, tau_eff, tm, tn)
    gb, g64, cnt = _outputs(bi.numel(), tm, tn, x.device)
    row_cap, dim_cap = x.shape
    tiles = tile_list(bi, bj, tm, tn, (0, 0), None, row_cap, row_cap)
    nxt = next_tile_counter(x.device)
    _launch("score_bits_bf16", x, (
        x.data_ptr(), tiles.data_ptr(), bi.data_ptr(), bj.data_ptr(),
        float(tau_eff), row_cap, dim_cap, bi.numel(), tm, tn,
        gb.data_ptr(), g64.data_ptr(), cnt.data_ptr(), nxt.data_ptr(),
    ))
    return gb, g64, cnt


# ------------------------------------------------------ plain PyTorch versions


def _block_chunks(n_blocks: int, tm: int, tn: int, dim: int):
    """Block ranges whose fp64 operand copies stay near 1 GiB."""
    per = ((tm + tn) * dim + tm * tn) * 8
    step = max(1, (1 << 30) // per)
    for s in range(0, n_blocks, step):
        yield s, min(s + step, n_blocks)


def _panels(xi, xj, bi, bj, tm: int, tn: int, s: int, e: int, dtype):
    dim = xi.shape[1]
    a = xi.view(xi.shape[0] // tm, tm, dim)[bi[s:e].long()].to(dtype)
    b = xj.view(xj.shape[0] // tn, tn, dim)[bj[s:e].long()].to(dtype)
    return a, b


def int8_bound_value(d, ai, bi_b, ci, aj, bj_b, cj):
    """The int8 epilogue's ``s_hat + bound`` for raw int32 dots ``d`` and
    broadcastable aux rows (α, α·L1(q), nnz) of the row side ``i`` and the
    column side ``j``, in the JAX kernels' operation order
    (``pallas_score.py:478-483``, ``panel.py:int8_bound_mask``).  The one
    definition of the bound for every plain int8 scorer of the port."""
    s_hat = d.to(torch.float32) * (ai * aj)
    bound = (
        0.5 * (aj * bi_b + ai * bj_b)
        + 0.25 * (ai * aj) * torch.minimum(ci, cj)
    )
    return s_hat + bound


def int8_scores(xq, aux, bi, bj, tm: int, tn: int, xj=None, auxj=None):
    """Yield ``(s, e, v)`` for chunks of blocks: ``v [e-s, tm, tn]`` f32 is
    the int8 epilogue's ``s_hat + bound`` of ``xq``'s row tiles ``bi``
    against the column operand's (``xj``/``auxj``, default ``xq``/``aux``)
    row tiles ``bj``.  ``D`` is a float64 product of the int8 values, exact
    because |D| < 2^30 under the engines' gate."""
    xj = xq if xj is None else xj
    auxj = aux if auxj is None else auxj
    aux_i = aux.view(3, xq.shape[0] // tm, tm)
    aux_j = auxj.view(3, xj.shape[0] // tn, tn)
    for s, e in _block_chunks(bi.numel(), tm, tn, xq.shape[1]):
        a, b = _panels(xq, xj, bi, bj, tm, tn, s, e, torch.float64)
        d = torch.bmm(a, b.transpose(1, 2)).to(torch.int32)
        del a, b
        ii, jj = bi[s:e].long(), bj[s:e].long()
        ai, bi_b, ci = (aux_i[r][ii][:, :, None] for r in range(3))
        aj, bj_b, cj = (aux_j[r][jj][:, None, :] for r in range(3))
        yield s, e, int8_bound_value(d, ai, bi_b, ci, aj, bj_b, cj)


def bf16_scores(x, bi, bj, tm: int, tn: int):
    """Yield ``(s, e, acc)`` for chunks of blocks: the fp32 scores of the
    bf16 operands, upcast and multiplied in fp32 (TF32 off)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the fp32 reference product needs TF32 off")
    for s, e in _block_chunks(bi.numel(), tm, tn, x.shape[1]):
        a, b = _panels(x, x, bi, bj, tm, tn, s, e, torch.float32)
        yield s, e, torch.bmm(a, b.transpose(1, 2))


def bitpack_mask(mi: torch.Tensor):
    """Bit-pack a bool hit mask ``mi [n, tm, tn]`` into ``(gb, g64, cnt)``
    exactly as the JAX package's ``bitpack_mask`` + count epilogue."""
    n, tm, tn = mi.shape
    w = (1 << torch.arange(GROUP, dtype=torch.int32, device=mi.device))
    gbi = (mi.view(n, tm // GROUP, GROUP, tn).to(torch.int32)
           * w.view(1, 1, GROUP, 1)).sum(dim=2)
    g_any = gbi != 0
    g64 = g_any.view(n, tm // SUPER, SUPER // GROUP, tn).any(dim=2)
    cnt = torch.stack(
        [mi.sum(dim=(1, 2)), g_any.sum(dim=(1, 2)), g64.sum(dim=(1, 2))], 1
    )
    return gbi.to(torch.uint8), g64.to(torch.uint8), cnt.to(torch.int32)


EPILOGUE_CELLS = 1 << 23  # rectangle cells per eager epilogue chunk


def epilogue_rows(n_rows: int, n_cols: int, cells: int = EPILOGUE_CELLS) -> int:
    """Rows per eager epilogue chunk of an ``[n_rows, n_cols]`` rectangle:
    a multiple of 64 (whole super-groups) that keeps the chunk's f32 and
    int32 temporaries near ``cells`` cells."""
    rows = max(SUPER, cells // max(n_cols, 1) // SUPER * SUPER)
    return min(rows, n_rows)


def bitpack_row_chunks(mask_of, n_rows: int, n_cols: int, step: int, device):
    """``bitpack_mask`` of one ``[n_rows, n_cols]`` rectangle whose hit mask
    is made ``step`` rows at a time: ``mask_of(r0, r1)`` returns the bool
    mask of rows ``[r0, r1)``, so neither the mask nor ``bitpack_mask``'s
    int32 temporary ever spans the rectangle.  ``step`` and ``n_rows`` are
    multiples of 64 (whole super-groups).  Returns ``(gb, g64, cnt)`` as one
    block, the counts summed in int64: a rectangle of 2^31 cells cannot
    wrap them."""
    if step % SUPER or n_rows % SUPER:
        raise ValueError(
            f"rows {n_rows} and step {step} must be multiples of {SUPER}")
    gb = torch.empty((1, n_rows // GROUP, n_cols), dtype=torch.uint8,
                     device=device)
    g64 = torch.empty((1, n_rows // SUPER, n_cols), dtype=torch.uint8,
                      device=device)
    cnt = torch.zeros((1, 3), dtype=torch.int64, device=device)
    for r0 in range(0, n_rows, step):
        r1 = min(r0 + step, n_rows)
        b, b64, c = bitpack_mask(mask_of(r0, r1)[None])
        gb[:, r0 // GROUP:r1 // GROUP] = b
        g64[:, r0 // SUPER:r1 // SUPER] = b64
        cnt += c
    return gb, g64, cnt


def _plain_bits(chunks, bi, bj, tau_eff, tm: int, tn: int, device,
                off=(0, 0), valid=None):
    """Threshold, strict global upper triangle (local coordinates plus the
    offsets ``off = (row0, col0)``), per-block ``valid`` flag, bit-pack."""
    gb, g64, cnt = _outputs(bi.numel(), tm, tn, device)
    ar_m = torch.arange(tm, device=device)
    ar_n = torch.arange(tn, device=device)
    for s, e, v in chunks:
        rows = off[0] + bi[s:e].long()[:, None] * tm + ar_m
        cols = off[1] + bj[s:e].long()[:, None] * tn + ar_n
        mi = (v >= tau_eff) & (rows[:, :, None] < cols[:, None, :])
        if valid is not None:
            mi &= (valid[s:e] != 0)[:, None, None]
        gb[s:e], g64[s:e], cnt[s:e] = bitpack_mask(mi)
    return gb, g64, cnt


def score_bits_int8_plain(xq, aux, bi, bj, tau_eff, tm: int = 1024,
                          tn: int = 512):
    """Plain PyTorch version of the int8 kernel (same outputs)."""
    return _plain_bits(
        int8_scores(xq, aux, bi, bj, tm, tn), bi, bj, float(tau_eff), tm, tn,
        xq.device,
    )


def score_bits_bf16_plain(x, bi, bj, tau_eff, tm: int = 1024, tn: int = 512):
    """Plain PyTorch version of the bf16 kernel (same outputs)."""
    return _plain_bits(
        bf16_scores(x, bi, bj, tm, tn), bi, bj, float(tau_eff), tm, tn,
        x.device,
    )


def unpack_bits(gb: torch.Tensor) -> torch.Tensor:
    """bool ``[n, tm, tn]`` hit mask of a ``gb [n, tm/8, tn]`` byte tile."""
    n, g, tn = gb.shape
    sh = torch.arange(GROUP, dtype=torch.int32, device=gb.device)
    bits = (gb.to(torch.int32)[:, :, None, :] >> sh.view(1, 1, GROUP, 1)) & 1
    return bits.bool().reshape(n, g * GROUP, tn)


# -------------------------------------------------------------- compaction


def check_pair_count(total: int) -> None:
    """Refuse a join with 2^31 - 1 or more candidates (``total`` is a
    Python int from int64 sums, so it cannot have wrapped)."""
    if total >= 2**31 - 1:
        raise ValueError(
            "join produced >= 2^31 candidate pairs; raise the threshold — "
            "fetching/rescoring that many pairs is beyond the engine's "
            "design envelope"
        )


def compact_bits(gb, g64, cnt, bi, bj, tm: int, tn: int,
                 pre_level: bool | None = None, timer=None):
    """Exact (row, col) int64 lists of every hit in the bit-packed structure.

    Three levels, as the JAX package's ``_compact_bits``: hit supers (64
    rows) → hit group bytes within them → hit bits within those, each a
    ``torch.nonzero`` over the previous level's hits; with ``tm`` a multiple
    of 512 a pre-level first reduces ``g64`` to 512-row cells and scans
    those.  The lists come in the order of the scan: by 512-row cell (with
    the pre-level) or 64-row super, then column, then row.  ``pre_level``
    overrides the choice: the row slices of a taller block pass the block's
    own (their heights whole 512-row cells when it is True), so that their
    lists, concatenated in slice order, are the block's.  Eager PyTorch
    sizes ``nonzero`` by its result, so no capacity or retry is needed:
    each level's length must equal the kernel's count total, and a
    mismatch raises.  With a ``Timer``, each call that returns only once
    the device has caught up (the counts' ``tolist`` and every
    ``nonzero``) is timed as "compact_sync": the rest of the caller's
    "compact" is host time."""
    n_blocks = bi.shape[0]
    sums = cnt.sum(dim=0, dtype=torch.int64)
    with _section(timer, "compact_sync"):
        total, groups, supers = sums.tolist()
    check_pair_count(total)
    if pre_level is None:
        pre_level = (tm // SUPER) % (SUPER2 // SUPER) == 0
    elif pre_level and tm % SUPER2:
        raise ValueError(f"a pre-level needs whole {SUPER2}-row cells, got "
                         f"tm = {tm}")
    if pre_level:
        # pre-level: scan the 8x smaller 512-row any-hit domain, then
        # gather the g64 bytes under its hits
        r8 = SUPER2 // SUPER
        per00 = (tm // SUPER2) * tn
        g4 = g64.view(n_blocks, tm // SUPER2, r8, tn)
        any00 = g4.amax(dim=2).reshape(-1)
        with _section(timer, "compact_sync"):
            b00 = torch.nonzero(any00).squeeze(1)
        p00, rem00 = b00 // per00, b00 % per00
        s00, c00 = rem00 // tn, rem00 % tn
        bytes00 = g4[p00, s00, :, c00].reshape(-1)
        with _section(timer, "compact_sync"):
            f0 = torch.nonzero(bytes00).squeeze(1)
        slot00, o00 = f0 // r8, f0 % r8
        p0 = p00[slot00]
        s0 = s00[slot00] * r8 + o00  # super index within block
        c0 = c00[slot00]  # column within block
    else:
        per0 = (tm // SUPER) * tn
        with _section(timer, "compact_sync"):
            b0 = torch.nonzero(g64.reshape(-1)).squeeze(1)
        p0, rem0 = b0 // per0, b0 % per0
        s0, c0 = rem0 // tn, rem0 % tn
    # level 1: hit group bytes within each hit super (8 bytes each)
    gb4 = gb.view(n_blocks, tm // SUPER, SUPER // GROUP, tn)
    bytes0 = gb4[p0, s0, :, c0].reshape(-1)
    with _section(timer, "compact_sync"):
        f1 = torch.nonzero(bytes0).squeeze(1)
    slot1, o1 = f1 // (SUPER // GROUP), f1 % (SUPER // GROUP)
    byte1 = bytes0[f1].to(torch.int32)
    # level 2: hit bits (rows) within each hit group byte
    sh = torch.arange(GROUP, dtype=torch.int32, device=gb.device)
    bits2 = ((byte1[:, None] >> sh) & 1).reshape(-1)
    with _section(timer, "compact_sync"):
        f2 = torch.nonzero(bits2).squeeze(1)
    slot2, o2 = f2 // GROUP, f2 % GROUP
    found = (s0.numel(), f1.numel(), f2.numel())
    if found != (supers, groups, total):
        raise RuntimeError(
            f"compaction found (supers, groups, pairs) = {found}, the "
            f"kernel counted {(supers, groups, total)}"
        )
    sl = slot1[slot2]
    g = s0[sl] * (SUPER // GROUP) + o1[slot2]  # group index within block
    blk = p0[sl]
    row = bi[blk].long() * tm + g * GROUP + o2
    col = bj[blk].long() * tn + c0[sl]
    return row, col


def _section(timer, name: str):
    return timer.section(name) if timer is not None else contextlib.nullcontext()


def _extract(score, compact_args, x, timer):
    with _section(timer, "kernel"):
        gb, g64, cnt = score()
        if x.is_cuda:  # the stage split must not bill the kernel to compaction
            torch.cuda.synchronize(x.device)
    with _section(timer, "compact"):
        return compact_bits(gb, g64, cnt, *compact_args, timer=timer)


def allpairs_extract_int8(xq, aux, bi, bj, tau_eff, tm: int = 1024,
                          tn: int = 512, timer=None):
    """Upper-triangle candidate pairs ``(row, col)`` of the int8 scorer
    (``allpairs_extract_pallas_int8``'s counterpart).  With a ``Timer``,
    the score and compaction stages are timed as "kernel" and "compact"."""
    return _extract(
        lambda: score_bits_int8(xq, aux, bi, bj, tau_eff, tm, tn),
        (bi, bj, tm, tn), xq, timer,
    )


def allpairs_extract_bf16(x, bi, bj, tau_eff, tm: int = 1024, tn: int = 512,
                          timer=None):
    """Upper-triangle candidate pairs ``(row, col)`` of the bf16 scorer
    (``allpairs_extract_pallas``'s counterpart)."""
    return _extract(
        lambda: score_bits_bf16(x, bi, bj, tau_eff, tm, tn),
        (bi, bj, tm, tn), x, timer,
    )
