"""Block-panel join for the out-of-core engine: the counterpart of
``apsim_tpu/ops/panel.py``.

The chunked engine has no resident dense index.  Its join:

  1. flattens the per-chunk entry buffers and sorts them by row once per
     join (``sort_entries_by_row``), so each row panel is one contiguous
     slice of the sorted COO;
  2. densifies each ``rb``-row panel into an int8 slab ``[rb, d_cap]``
     (``build_panel_slab``);
  3. scores every panel pair (I <= J) over its ``[rb x rb]`` rectangle with
     the cross-panel kernel (``panel_score_bits_int8``: the dense int8
     kernel with the panels' global row origins added to rows and columns,
     so the strict-upper mask and the counts are global), then compacts the
     bit-packed hits to exact-length global (row, col) lists
     (``panel_pair_extract_int8``).

The candidate set is a proven superset at ``tau_eff`` (the dense int8
kernel's quantization bound) and the host fp64 rescore decides the pair
set.

``panel_score_bits_int8`` launches the CUDA kernel of
``csrc/score_bits.cu`` for CUDA tensors (counted in
``tri_score.LAUNCHES``) and runs its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tri_score as ts

__all__ = [
    "int8_bound_mask",
    "full_grid",
    "diag_grid",
    "sort_entries_by_row",
    "build_panel_slab",
    "panel_score_bits_int8",
    "panel_score_bits_int8_plain",
    "panel_pair_extract_int8",
]

PAD_ROW = 1 << 30  # row of unused entry slots: sorts past every panel


def int8_bound_mask(d, auxi, auxj, rows, cols, tau_eff):
    """Quantization-bound admit mask over one int32 score rectangle.

    ``d [m, n]`` is the raw int8 dot block, ``auxi``/``auxj`` the ``[3, m]``
    / ``[3, n]`` (α, α·L1(q), nnz) tables, ``rows``/``cols`` the GLOBAL
    coordinates of each cell.  Admits the cells whose dequantized score
    plus the per-pair error bound reaches ``tau_eff``, in the strict upper
    triangle.  The bound is ``tri_score.int8_bound_value``, shared with
    every plain int8 scorer of the port."""
    v = ts.int8_bound_value(
        d, auxi[0][:, None], auxi[1][:, None], auxi[2][:, None],
        auxj[0][None, :], auxj[1][None, :], auxj[2][None, :],
    )
    return (v >= tau_eff) & (rows < cols)


def full_grid(rb_i: int, rb_j: int, tm: int, tn: int):
    """All (bi, bj) tiles of an off-diagonal panel rectangle (every global
    pair there satisfies row < col, so every tile is live)."""
    bi, bj = np.meshgrid(
        np.arange(rb_i // tm), np.arange(rb_j // tn), indexing="ij"
    )
    return bi.reshape(-1).astype(np.int32), bj.reshape(-1).astype(np.int32)


def diag_grid(rb: int, tm: int, tn: int):
    """Tiles of a diagonal panel pair that contain some strict-upper pair —
    exactly the dense kernel's schedule."""
    return ts.upper_blocks_rect(rb, tm, tn)


def sort_entries_by_row(rows2d, cols2d, q2d, counts, rb: int,
                        n_panels: int):
    """Row-sorted flat COO from the per-chunk entry buffers.

    Returns ``(rows_s, gcols_s, q_s, panel_counts)``: entries sorted by
    global row (unused slots carry row 2^30 and sort to the tail), columns
    mapped back from (chunk, local) to global compact ids
    (``local · n_chunks + chunk``), the int8 values in the same order, and
    the int32 per-panel entry counts (the last bucket counts the unused
    slots).  The sort is stable, as ``jnp.argsort`` is, so the output is
    bit-identical to the JAX package's."""
    n_chunks, cap = rows2d.shape
    dev = rows2d.device
    pos = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = pos[None, :] < counts.to(torch.int32)[:, None]
    r = torch.where(valid, rows2d, PAD_ROW).reshape(-1)
    chunk_of = torch.arange(n_chunks, dtype=torch.int32, device=dev)
    gc = (cols2d * n_chunks + chunk_of[:, None]).reshape(-1)
    order = torch.argsort(r, stable=True)
    r_s = r[order]
    gc_s = gc[order]
    q_s = q2d.reshape(-1)[order]
    pan = torch.clamp(r_s // rb, max=n_panels).long()
    pcounts = torch.bincount(pan, minlength=n_panels + 1).to(torch.int32)
    return r_s, gc_s, q_s, pcounts


def build_panel_slab(r_s, gc_s, q_s, start: int, end: int, row0: int,
                     rb: int, d_cap: int):
    """Densify one row panel: int8 slab ``[rb, d_cap]`` from the sorted COO
    slice ``[start, end)``.  Eager torch slices the panel's entries exactly
    (the JAX function reads a fixed-size window and lets the scatter drop
    what lies outside the panel); entries whose row lies outside
    ``[row0, row0 + rb)`` are filtered all the same, since ``index_put_``
    has no drop mode.  (row, column) entries are unique — one per CSR
    entry — so an assignment into zeros equals the JAX scatter-set."""
    r = r_s[start:end]
    ok = (r >= row0) & (r < row0 + rb)
    slab = torch.zeros((rb, d_cap), dtype=torch.int8, device=r_s.device)
    slab.index_put_(
        ((r[ok] - row0).long(), gc_s[start:end][ok].long()),
        q_s[start:end][ok],
    )
    return slab


def _check_aux(aux, rows: int, device) -> None:
    if (aux.dtype != torch.float32 or tuple(aux.shape) != (3, rows)
            or not aux.is_contiguous() or aux.device != device):
        raise ValueError(f"aux must be contiguous f32 [3, {rows}] on {device}")


def panel_score_bits_int8(xi, xj, auxi, auxj, bi, bj, off, tau_eff,
                          tm: int, tn: int, valid=None):
    """(gb, g64, cnt) of the cross-panel int8 scorer over one panel pair's
    block list.  ``xi [rb_i, d_cap]`` / ``xj [rb_j, d_cap]`` int8 slabs,
    ``auxi``/``auxj`` their f32 ``[3, rb]`` tables, ``bi``/``bj`` int32
    local tile ids, ``off = (row0_I, row0_J)`` the panels' global row
    origins, ``valid`` an optional int32 per-block flag (0 blanks the
    block).  Replaces ``apsim_tpu/ops/panel.py:panel_score_bits_int8``
    (Pallas ``_kernel_int8_cross``)."""
    ts._check_operands(xi, bi, bj, tm, tn, torch.int8, xi.shape[1], xj)
    _check_aux(auxi, xi.shape[0], xi.device)
    _check_aux(auxj, xj.shape[0], xi.device)
    if valid is not None and (valid.dtype != torch.int32
                              or valid.shape != bi.shape
                              or valid.device != xi.device):
        raise ValueError("valid must be int32 shaped like bi, on the device")
    row0, col0 = (int(o) for o in off)
    ts.check_aligned(xi, xj)
    if xi.device.type == "cpu":
        return panel_score_bits_int8_plain(
            xi, xj, auxi, auxj, bi, bj, (row0, col0), tau_eff, tm, tn, valid
        )
    gb, g64, cnt = ts._outputs(bi.numel(), tm, tn, xi.device)
    tiles = ts.tile_list(bi, bj, tm, tn, (row0, col0), valid, xi.shape[0],
                         xj.shape[0])
    nxt = ts.next_tile_counter(xi.device)
    ts._launch("panel_score_bits_int8", xi, (
        xi.data_ptr(), xj.data_ptr(), auxi.data_ptr(), auxj.data_ptr(),
        tiles.data_ptr(), bi.data_ptr(), bj.data_ptr(),
        None if valid is None else valid.data_ptr(), row0, col0,
        float(tau_eff), xi.shape[0], xj.shape[0], xi.shape[1], bi.numel(),
        tm, tn, gb.data_ptr(), g64.data_ptr(), cnt.data_ptr(),
        nxt.data_ptr(),
    ))
    return gb, g64, cnt


def panel_score_bits_int8_plain(xi, xj, auxi, auxj, bi, bj, off, tau_eff,
                                tm: int, tn: int, valid=None):
    """Plain PyTorch version of the cross-panel kernel (same outputs)."""
    return ts._plain_bits(
        ts.int8_scores(xi, auxi, bi, bj, tm, tn, xj, auxj), bi, bj,
        float(tau_eff), tm, tn, xi.device, off, valid,
    )


def panel_pair_extract_int8(xi, xj, auxi, auxj, bi, bj, row0: int,
                            col0: int, tau_eff, tm: int, tn: int,
                            timer=None):
    """One panel pair end to end: the cross kernel, then the exact-length
    three-level compaction on globalized block ids (``bi + row0 // tm``,
    ``bj + col0 // tn``), so the (row, col) int64 lists it returns are
    global.  With a ``Timer``, the stages are timed as "kernel" and
    "compact"."""
    return ts._extract(
        lambda: panel_score_bits_int8(
            xi, xj, auxi, auxj, bi, bj, (row0, col0), tau_eff, tm, tn
        ),
        (bi + row0 // tm, bj + col0 // tn, tm, tn), xi, timer,
    )
