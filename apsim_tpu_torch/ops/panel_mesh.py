"""Mesh-sharded block-panel join: the counterpart of
``apsim_tpu/ops/panel_mesh.py``.

The mesh chunked engine shards the chunk axis of its entry buffers, so a row
panel's int8 slab is column-sharded: shard s densifies ``[rb, d_local]``
from its own entries, and a panel pair's score is the sum of the shards'
int8 partial dots (kernel 4, ``int8_matmul``, once per shard), an exact
int32 sum.  The quantization-bound epilogue runs where the rows live: the
pair's ``rb`` rows are cut into one contiguous slice per distinct device of
the mesh, each device receives its slice's rows of the other devices'
partials (``collectives.gather_rows``), and kernel 5 (``pair_bits_int8``)
sums the partials of each cell, applies the bound and bit-packs in one
pass, after which each device compacts its slice; the candidate lists meet
on the lead device in slice order.  With every shard on one device there
is one slice and the kernel reads the partials in place.  On a mesh over
several processes the int32 sum still ends on the last shard's process
(``collectives.psum``), which runs kernel 5 on it alone.  The per-pair
bound proof of the dense kernel (``ops/tri_score.py``) carries over
unchanged.

Kernel 6 (``pair_bits_f32``) is kernel 5's body with an fp32 sum (left to
right, the order of ``collectives.psum``'s chain) and a plain threshold:
the epilogue of the bf16 and fp32 stripe joins (``ops/chunked.py``,
``ops/chunked_mesh.py``), which cut a stripe's live rows into slices the
same way and compact them through ``pair_candidates``.

The functions work on per-shard lists (one tensor per shard, on its
device; None for a shard another process owns, on a mesh over several
processes); the only data movement between shards is through
``parallel/collectives.py``.  ``int8_matmul``, ``pair_bits_int8`` and
``pair_bits_f32`` launch the CUDA kernels of ``csrc/score_bits.cu`` for
CUDA tensors (counted in ``tri_score.LAUNCHES``) and run their plain
PyTorch versions for CPU tensors.  The JAX function's
``optimization_barrier`` (a TPU compile workaround) and its caps / packed
head (exact-length compaction needs none) have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.collectives import (gather_rows, pmax, psum, share,
                                   sum_home, sync)
from . import panel as panel_ops
from . import tri_score as ts

__all__ = [
    "int8_matmul",
    "int8_matmul_plain",
    "mesh_quantize_entries",
    "mesh_panel_state",
    "mesh_build_panel_slab",
    "mesh_panel_pair",
    "MeshPendingPair",
    "pair_bits_int8",
    "pair_bits_int8_plain",
    "pair_bits_f32",
    "pair_bits_f32_plain",
    "pair_candidates",
    "row_slices",
    "card_slices",
    "slab_width",
]

MM_TM, MM_TN = ts.THREAD_BLOCK_TILES[-1]  # kernel 4's smallest thread-block tile
EPILOGUE_CELLS = ts.EPILOGUE_CELLS  # rectangle cells per plain epilogue chunk
PAIR_MAX_PARTS = 64  # partials kernels 5 and 6 sum per cell at most


def _check_mm(xi: torch.Tensor, xj: torch.Tensor) -> None:
    for op in (xi, xj):
        if op.dtype != torch.int8 or op.dim() != 2 or not op.is_contiguous():
            raise ValueError(
                f"int8_matmul operands must be contiguous 2-D int8 tensors, "
                f"got {op.dtype} {tuple(op.shape)}"
            )
    if xi.shape[1] != xj.shape[1] or xi.device != xj.device:
        raise ValueError("int8_matmul operands differ in width or device")
    if xi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xi.device}")


def int8_matmul(xi: torch.Tensor, xj: torch.Tensor) -> torch.Tensor:
    """``xi [m, d] · xj [n, d]ᵀ`` as int32 ``[m, n]``: kernel 4, which
    replaces ``apsim_tpu/ops/panel_mesh.py:_int8_matmul`` (Pallas
    ``_mm_kernel``).  The kernel takes ``m % 64 == 0``, ``n % 128 == 0`` and
    ``d % 128 == 0`` (zero columns padded on add nothing to an integer dot)
    and operands that start on a 16-byte boundary (TMA loads them);
    anything else is refused on either device.  It runs 128 x 256
    thread-block tiles where they divide ``(m, n)``, else 64 x 128
    (``tri_score.thread_block_tile``)."""
    _check_mm(xi, xj)
    m, d = xi.shape
    n = xj.shape[0]
    if m % MM_TM or n % MM_TN or d % ts.K_QUANTUM:
        raise ValueError(
            f"int8_matmul needs m % {MM_TM}, n % {MM_TN} and "
            f"d % {ts.K_QUANTUM} == 0, got m={m}, n={n}, d={d}"
        )
    ts.check_aligned(xi, xj)
    if xi.device.type == "cpu":
        return int8_matmul_plain(xi, xj)
    out = torch.empty((m, n), dtype=torch.int32, device=xi.device)
    nxt = ts.next_tile_counter(xi.device)
    ts._launch("int8_matmul", xi, (
        xi.data_ptr(), xj.data_ptr(), m, n, d, out.data_ptr(), nxt.data_ptr(),
    ))
    return out


def int8_matmul_plain(xi: torch.Tensor, xj: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 4, any shapes: a float64 product of
    the int8 values, exact because |D| < 2^30 under the engines' gate (torch
    has no int32 ``matmul`` on CUDA), in blocks whose fp64 operand copies
    stay near 1 GiB each."""
    _check_mm(xi, xj)
    m, d = xi.shape
    n = xj.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=xi.device)
    step = max(1, (1 << 27) // max(d, 1))
    for c0 in range(0, n, step):
        b = xj[c0:c0 + step].double()
        for r0 in range(0, m, step):
            out[r0:r0 + step, c0:c0 + step] = (
                xi[r0:r0 + step].double() @ b.T).to(torch.int32)
    return out


def mesh_quantize_entries(mesh, flat_r, flat_v, row_cap: int):
    """Per-row symmetric int8 quantization of SHARDED entries
    (``apsim_tpu/ops/chunked_mesh.py:mesh_quantize_chunk_entries``):
    ``flat_r`` / ``flat_v`` hold each shard's flat row ids and fp32 values
    on its device (None for another process's shard); unused slots carry a
    row ``>= row_cap``.

    Returns ``(q, aux, max_nnz)``: per shard the int8 values in the same
    order (None for another process's), ``aux`` the global f32 ``[3,
    row_cap]`` (α, α·L1(q), nnz) on the lead device of every process,
    ``max_nnz`` an int.  A row's entries are split over the shards, so its
    maximum comes from ``pmax`` and its L1 and nnz from ``psum`` (exact:
    integers below 2^24).  Bit-identical to the JAX function: rows out of
    range are filtered out of the scatters (torch has no drop mode), and
    ``mx / 127.0`` is a multiply by the fp32 reciprocal, as XLA compiles
    it.  All-zero rows get α = 0."""
    lead = mesh.lead
    mine = [s for s, r in enumerate(flat_r) if r is not None]
    live = {s: flat_r[s] < row_cap for s in mine}
    mxs = [None] * len(flat_r)
    for s in mine:
        r, v, ok = flat_r[s], flat_v[s], live[s]
        mx = torch.zeros(row_cap, dtype=torch.float32, device=r.device)
        mx.scatter_reduce_(0, r[ok].long(), v[ok].abs(), reduce="amax")
        mxs[s] = mx
    mx = pmax(mxs, lead, mesh)
    alpha = torch.where(mx > 0, mx * (1.0 / 127.0), 0.0).to(torch.float32)
    qs, l1qs, nnzs = ([None] * len(flat_r) for _ in range(3))
    for s in mine:
        r, v, ok = flat_r[s], flat_v[s], live[s]
        dev = r.device
        a_e = alpha.to(dev)[r.clamp(max=row_cap - 1).long()]
        div = torch.where(a_e > 0, a_e, 1.0)
        q = (v / div).round_().clamp_(-127, 127).to(torch.int8)
        r_live = r[ok].long()
        l1qs[s] = (torch.zeros(row_cap, dtype=torch.float32, device=dev)
                   .index_add_(0, r_live, q[ok].abs().to(torch.float32)))
        nnzs[s] = (torch.zeros(row_cap, dtype=torch.float32, device=dev)
                   .index_add_(0, r_live, (v[ok] != 0).to(torch.float32)))
        qs[s] = q
    l1q = psum(l1qs, lead, mesh, exact=True)
    nnz = psum(nnzs, lead, mesh, exact=True)
    aux = torch.stack([alpha, alpha * l1q, nnz])
    max_nnz = int(nnz.max()) if row_cap else 0
    return qs, aux, max_nnz


def mesh_panel_state(mesh, row_cap: int, rb: int, n_panels: int, rows2d,
                     cols2d, vals2d, counts):
    """Per-shard join state from the per-shard entry buffers (lists of
    ``[n_local, cap]`` tensors and ``[n_local]`` counts, one per shard;
    None for another process's shard).

    Returns ``(r_s, c_s, q_s, pcounts, aux, max_nnz)``: per shard the
    entries sorted by row (stable), their SLAB-LOCAL columns
    (``local_dim · n_local + local_chunk``, a bijection onto
    ``[0, d_cap / n_shards)``), their int8 values and the int32 per-panel
    counts (last bucket: unused slots), None for another process's shard;
    ``aux`` and ``max_nnz`` from ``mesh_quantize_entries`` over the slots
    below each chunk's count."""
    n_sh = len(rows2d)
    mine = [s for s in range(n_sh) if rows2d[s] is not None]
    flat_r, flat_v = [None] * n_sh, [None] * n_sh
    for s in mine:
        dev = rows2d[s].device
        cap = rows2d[s].shape[1]
        pos = torch.arange(cap, dtype=torch.int32, device=dev)
        valid = pos[None, :] < counts[s].to(torch.int32)[:, None]
        flat_r[s] = torch.where(valid, rows2d[s],
                                panel_ops.PAD_ROW).reshape(-1)
        flat_v[s] = torch.where(valid, vals2d[s], 0.0).reshape(-1)
    qs, aux, max_nnz = mesh_quantize_entries(mesh, flat_r, flat_v, row_cap)
    r_s, c_s, q_s, pcounts = ([None] * n_sh for _ in range(4))
    for s in mine:
        r, q = flat_r[s], qs[s]
        dev = r.device
        n_local = rows2d[s].shape[0]
        chunk_of = torch.arange(n_local, dtype=torch.int32, device=dev)
        c_slab = (cols2d[s] * n_local + chunk_of[:, None]).reshape(-1)
        order = torch.argsort(r, stable=True)
        rs = r[order]
        r_s[s] = rs
        c_s[s] = c_slab[order]
        q_s[s] = q[order]
        pan = torch.clamp(rs // rb, max=n_panels).long()
        pcounts[s] = torch.bincount(pan, minlength=n_panels + 1).to(
            torch.int32)
    return r_s, c_s, q_s, pcounts, aux, max_nnz


def mesh_build_panel_slab(r_s, c_s, q_s, starts, p: int, rb: int,
                          d_local: int):
    """Panel ``p``'s column-sharded int8 slab: per shard ``[rb, d_local]``
    on that shard's device (None for another process's), densified from
    its sorted entries ``[starts[s][p], starts[s][p + 1])`` by
    ``panel.build_panel_slab`` (an exact slice plus the row-range filter,
    as ``index_put_`` has no drop mode)."""
    return [
        None if r is None else panel_ops.build_panel_slab(
            r, c, q, int(st[p]), int(st[p + 1]), p * rb, rb, d_local)
        for r, c, q, st in zip(r_s, c_s, q_s, starts)
    ]


def _epilogue_rows(rows: int, cols: int | None = None) -> int:
    """Rows per chunk of the plain epilogue over a ``[rows, cols]`` slice
    (default square): a multiple of 64 (whole super-groups) that keeps
    the chunk's f32 temporaries near ``EPILOGUE_CELLS`` cells."""
    return ts.epilogue_rows(rows, rows if cols is None else cols,
                            EPILOGUE_CELLS)


def _rows_contiguous(t: torch.Tensor) -> bool:
    """A 2-D tensor whose rows are each one run of memory (a row stride
    apart, as a column slice of a wider tensor): what kernels 5 and 6
    read."""
    return t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1)


def _check_parts(parts, dtype, name: str) -> tuple:
    """``(rows, cols)`` of the partials of kernel 5 or 6 (``name``); raise
    on anything it refuses."""
    if not 1 <= len(parts) <= PAIR_MAX_PARTS:
        raise ValueError(f"{name} sums 1 to {PAIR_MAX_PARTS} partials, got "
                         f"{len(parts)}")
    if parts[0].dim() != 2:
        raise ValueError(f"{name} partials must be 2-D")
    rows, cols = parts[0].shape
    dev = parts[0].device
    for p in parts:
        if (p.dtype != dtype or tuple(p.shape) != (rows, cols)
                or not _rows_contiguous(p) or p.device != dev):
            raise ValueError(
                f"{name} partials must be {dtype} [{rows}, {cols}] tensors "
                f"with contiguous rows on {dev}, got {p.dtype} "
                f"{tuple(p.shape)} on {p.device}")
    if rows % ts.SUPER:
        raise ValueError(f"{name} needs rows % {ts.SUPER} == 0, got {rows}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return rows, cols


def _check_offsets(row0: int, col0: int, rows: int, cols: int) -> None:
    if min(row0, col0) < 0 or max(row0 + rows, col0 + cols) >= 2**31:
        raise ValueError(f"global offsets ({row0}, {col0}) out of range")


def _check_pair(parts, aux_i, aux_j) -> tuple:
    """``(rows, cols)`` of kernel 5's operands; raise on anything it
    refuses."""
    rows, cols = _check_parts(parts, torch.int32, "pair_bits_int8")
    dev = parts[0].device
    for name, aux, n in (("aux_i", aux_i, rows), ("aux_j", aux_j, cols)):
        if (aux.dtype != torch.float32 or tuple(aux.shape) != (3, n)
                or not _rows_contiguous(aux) or aux.device != dev):
            raise ValueError(f"{name} must be f32 [3, {n}] with contiguous "
                             f"rows on {dev}")
    return rows, cols


def _pair_outputs(rows: int, cols: int, dev) -> tuple:
    """Kernels 5 and 6's ``gb``, ``g64`` (every byte written) and zeroed
    int64 counts."""
    return (torch.empty((1, rows // ts.GROUP, cols), dtype=torch.uint8,
                        device=dev),
            torch.empty((1, rows // ts.SUPER, cols), dtype=torch.uint8,
                        device=dev),
            torch.zeros((1, 3), dtype=torch.int64, device=dev))


def _part_arrays(parts) -> tuple:
    """The partials' addresses and row strides as host arrays, which the C
    entry copies into the kernel's parameters (nothing is copied to the
    card first); keep them alive over the launch."""
    n = len(parts)
    return ((ctypes.c_void_p * n)(*(p.data_ptr() for p in parts)),
            (ctypes.c_longlong * n)(*(p.stride(0) for p in parts)))


def pair_bits_int8(parts, aux_i, aux_j, row0: int, col0: int, tau_eff):
    """``(gb, g64, cnt)`` of one row slice of a rectangle: kernel 5, which
    replaces the epilogue XLA fuses behind the int8 products: behind
    ``_int8_matmul`` in ``apsim_tpu/ops/panel_mesh.py:mesh_panel_pair`` and
    in the int8 stripes (``apsim_tpu/ops/chunked.py:int8_join_epilogue``)
    (``psum``, ``int8_bound_mask``, ``bitpack_mask`` and the counts).

    ``parts``: the shards' int32 ``[rows, cols]`` partial dots of the
    slice, all on one device, each with contiguous rows (a column slice of
    a wider product is read in place); ``aux_i`` / ``aux_j`` the f32 ``[3,
    rows]`` / ``[3, cols]`` (α, α·L1(q), nnz) tables, also with contiguous
    rows; ``(row0, col0)`` the global row and column of the slice's cell
    (0, 0).  A cell is a hit when the quantization bound of its summed dot
    reaches ``tau_eff`` and its global row lies below its global column.
    Returns ``gb [1, rows/8, cols]`` and ``g64 [1, rows/64, cols]`` uint8
    and ``cnt [1, 3]`` int64, as ``tri_score.bitpack_row_chunks`` lays
    them out; ``rows % 64 == 0``.  A CPU slice runs
    ``pair_bits_int8_plain``; a CUDA one launches the kernel (counted in
    ``tri_score.LAUNCHES["pair_bits_int8"]``) or raises."""
    rows, cols = _check_pair(parts, aux_i, aux_j)
    _check_offsets(row0, col0, rows, cols)
    dev = parts[0].device
    if dev.type == "cpu":
        return pair_bits_int8_plain(parts, aux_i, aux_j, row0, col0,
                                    tau_eff)
    gb, g64, cnt = _pair_outputs(rows, cols, dev)
    ptrs, lds = _part_arrays(parts)
    ts._launch("pair_bits_int8", parts[0], (
        ctypes.addressof(ptrs), ctypes.addressof(lds), len(parts),
        aux_i.data_ptr(), aux_i.stride(0), aux_j.data_ptr(), aux_j.stride(0),
        rows, cols, int(row0), int(col0), float(tau_eff), gb.data_ptr(),
        g64.data_ptr(), cnt.data_ptr(),
    ))
    return gb, g64, cnt


def pair_bits_int8_plain(parts, aux_i, aux_j, row0: int, col0: int,
                         tau_eff):
    """Plain PyTorch version of kernel 5 (same outputs): the int32 sum of
    the partials, ``panel.int8_bound_mask`` on global coordinates and
    ``tri_score.bitpack_row_chunks``, in row chunks of whole super-groups
    that bound the f32 temporaries (``EPILOGUE_CELLS``)."""
    rows, cols = _check_pair(parts, aux_i, aux_j)
    dev = parts[0].device
    col_ids = col0 + torch.arange(cols, dtype=torch.int64, device=dev)

    def mask_of(r0: int, r1: int):
        d = parts[0][r0:r1]
        for p in parts[1:]:
            d = d + p[r0:r1]
        row_ids = row0 + torch.arange(r0, r1, dtype=torch.int64, device=dev)
        return panel_ops.int8_bound_mask(
            d, aux_i[:, r0:r1], aux_j, row_ids[:, None], col_ids[None, :],
            tau_eff,
        )

    return ts.bitpack_row_chunks(mask_of, rows, cols,
                                 _epilogue_rows(rows, cols), dev)


def pair_bits_f32(parts, row0: int, col0: int, tau_eff):
    """``(gb, g64, cnt)`` of one row slice of a score stripe: kernel 6,
    which replaces the epilogue XLA builds behind the bf16 and fp32 stripe
    products (``apsim_tpu/ops/chunked.py:join_epilogue_bits``, and its
    ``psum`` in ``apsim_tpu/ops/chunked_mesh.py:mesh_stripe_extract``).

    ``parts``: the shards' fp32 ``[rows, cols]`` partial scores of the
    slice, all on one device, each with contiguous rows; a cell's sum is
    taken left to right, ``((p0 + p1) + p2) + ...``, the order of
    ``collectives.psum``'s one-process chain, so it is bit for bit the sum
    that chain forms.  A cell is a hit when its sum reaches ``tau_eff``
    (rounded to fp32) and its global row ``row0 + r`` lies below its global
    column ``col0 + c``.  Outputs as ``pair_bits_int8``'s; ``rows % 64 ==
    0``.  A CPU slice runs ``pair_bits_f32_plain``; a CUDA one launches the
    kernel (counted in ``tri_score.LAUNCHES["pair_bits_f32"]``) or
    raises."""
    rows, cols = _check_parts(parts, torch.float32, "pair_bits_f32")
    _check_offsets(row0, col0, rows, cols)
    dev = parts[0].device
    if dev.type == "cpu":
        return pair_bits_f32_plain(parts, row0, col0, tau_eff)
    gb, g64, cnt = _pair_outputs(rows, cols, dev)
    ptrs, lds = _part_arrays(parts)
    ts._launch("pair_bits_f32", parts[0], (
        ctypes.addressof(ptrs), ctypes.addressof(lds), len(parts), rows,
        cols, int(row0), int(col0), float(tau_eff), gb.data_ptr(),
        g64.data_ptr(), cnt.data_ptr(),
    ))
    return gb, g64, cnt


def pair_bits_f32_plain(parts, row0: int, col0: int, tau_eff):
    """Plain PyTorch version of kernel 6 (same outputs): the partials added
    left to right, ``sum >= tau_eff`` and the strict-upper mask on global
    coordinates, ``tri_score.bitpack_row_chunks`` in row chunks of whole
    super-groups (``tri_score.epilogue_rows``)."""
    rows, cols = _check_parts(parts, torch.float32, "pair_bits_f32")
    dev = parts[0].device
    tau = float(tau_eff)
    col_ids = col0 + torch.arange(cols, dtype=torch.int64, device=dev)

    def mask_of(r0: int, r1: int):
        s = parts[0][r0:r1]
        for p in parts[1:]:
            s = s + p[r0:r1]
        row_ids = row0 + torch.arange(r0, r1, dtype=torch.int64, device=dev)
        return (s >= tau) & (row_ids[:, None] < col_ids[None, :])

    return ts.bitpack_row_chunks(mask_of, rows, cols,
                                 ts.epilogue_rows(rows, cols), dev)


def row_slices(rb: int, n: int) -> list:
    """``n`` contiguous row slices ``(a, b)`` of an ``rb``-row rectangle, in
    order, differing by at most one unit (so some are empty when ``rb`` has
    fewer units than ``n``): whole 512-row cells when ``rb`` is a multiple
    of 512, else whole 64-row super-groups, so that ``compact_bits`` scans
    each slice as it scans the whole rectangle (``pair_candidates``)."""
    unit = ts.SUPER2 if rb % ts.SUPER2 == 0 else ts.SUPER
    units = rb // unit
    cuts = [k * units // n * unit for k in range(n + 1)]
    return list(zip(cuts, cuts[1:]))


def card_slices(devices, rows: int) -> tuple:
    """``(bounds, cards)``: the non-empty ``row_slices`` of a ``rows``-row
    rectangle, one for each distinct device of ``devices`` in order, and
    those devices."""
    cards = list(dict.fromkeys(devices))
    kept = [(ab, dev) for ab, dev in zip(row_slices(rows, len(cards)), cards)
            if ab[1] > ab[0]]
    return [ab for ab, _ in kept], [dev for _, dev in kept]


def pair_candidates(placed, bounds, devices, aux_i, aux_j, row0: int,
                    col0: int, rb: int, tau_eff, lead, timer=None,
                    cols: int | None = None):
    """Global (row, col) int64 candidate lists of one rectangle from its
    row slices, on ``lead``: slice ``k`` holds rows ``bounds[k] = (a, b)``
    of the rectangle, ``placed[k]`` the partials of those rows on
    ``devices[k]`` (``collectives.gather_rows``, waited for).  The
    rectangle is a panel pair (``rb`` rows and columns) or a stripe
    (``rb`` the stripe's row capacity, ``cols`` its width, the slices its
    live rows).  ``aux_i`` holds the rectangle's rows of the (α, α·L1(q),
    nnz) table and ``aux_j`` its columns', or both are None (fp32 scores).
    ``MeshPendingPair`` over these slices with no copy in flight, finished
    at once, each slice's counts checked as it is compacted."""
    def on(t):
        return None if t is None else {dev: t.to(dev) for dev in devices}

    return MeshPendingPair(placed, [[]] * len(bounds), bounds, devices,
                           on(aux_i), on(aux_j), row0, col0, rb, tau_eff,
                           lead, timer, cols=cols).result()


def mesh_panel_pair(mesh, xis, xjs, aux, row0: int, col0: int, tau_eff,
                    timer=None, stats=None, tally=None):
    """One panel pair launched: a pending pair whose ``result()`` gives the
    global (row, col) int64 candidate lists on the lead device.

    ``aux`` maps each of this process's devices to the global f32 ``[3,
    n_panels * rb]`` (α, α·L1(q), nnz) table on it; the pair reads rows
    ``[row0, row0 + rb)`` and ``[col0, col0 + rb)`` of it.  Here kernel 4
    runs on every shard's slab pair (stage "kernel": the launches alone)
    and each distinct device's row slice of every shard's int32 partial
    is sent to it by ``collectives.gather_rows`` without a wait ("reduce":
    the peer copies' launch, none with every shard on one device), so the
    copies run while the next pair's kernel 4 does; ``result()`` is
    ``MeshPendingPair``'s.  The JAX function replicates its epilogue over
    the whole ``[rb, rb]`` rectangle on every device; here each device
    computes only its own rows.  The counts are summed in int64, so a
    rectangle with 2^31 hits cannot wrap (``compact_bits`` then refuses
    it).  On a mesh over several processes each process launches kernel 4
    for its own shards (None in ``xis`` / ``xjs`` for the others') and
    the pair finishes here (``ts.Ready``): the exact int32 ``psum`` ends
    on the last shard's process ("reduce"), which runs kernel 5 on the
    sum as one slice (``pair_candidates``), and the candidate lists cross
    to the others.  ``stats`` counts the peer copies' bytes
    (``gather_rows``); with a ``tally`` the check of the decoded counts is
    left to it."""
    rb = next(x for x in xis if x is not None).shape[0]
    with ts._section(timer, "kernel"):
        parts = [None if a is None else int8_matmul(a, b)
                 for a, b in zip(xis, xjs)]
        if mesh.n_procs > 1:
            sync(mesh)
    if mesh.n_procs > 1:
        return ts.Ready(_summed_pair(mesh, parts, aux, row0, col0, rb,
                                     tau_eff, timer))
    bounds, devices = card_slices(mesh.devices, rb)
    with ts._section(timer, "reduce"):
        placed, copied = gather_rows(parts, bounds, devices, stats,
                                     wait=False)
    aux_i = {dev: t[:, row0:row0 + rb] for dev, t in aux.items()}
    aux_j = {dev: t[:, col0:col0 + rb] for dev, t in aux.items()}
    return MeshPendingPair(placed, copied, bounds, devices, aux_i, aux_j,
                           row0, col0, rb, tau_eff, mesh.lead, timer, tally)


def _summed_pair(mesh, parts, aux, row0: int, col0: int, rb: int, tau_eff,
                 timer):
    """The pair over several processes, from its shards' partials: the
    int32 sum on the home process, kernel 5 and the compaction there, the
    lists on every process's lead device."""
    home = sum_home(mesh)
    dev = mesh.devices[home] if mesh.is_local(home) else mesh.lead
    with ts._section(timer, "reduce"):
        d = psum(parts, dev, mesh, exact=True, to=home)
        del parts
        sync([dev])
    found = None
    if d is not None:
        found = pair_candidates([[d]], [(0, rb)], [dev],
                                aux[dev][:, row0:row0 + rb],
                                aux[dev][:, col0:col0 + rb], row0, col0, rb,
                                tau_eff, dev, timer)
        del d
    return share([found], [mesh.ranks[home]], mesh.lead, mesh)[0]


class MeshPendingPair:
    """One rectangle (a panel pair or a stripe, as ``pair_candidates``
    takes it) cut into row slices whose partials are placed on their
    devices, or on their way (``copied[k]``: the events of the copies into
    slice ``k``, ``gather_rows(..., wait=False)``), and whose epilogue is
    not queued.  ``aux_i`` / ``aux_j`` map each device to the rectangle's
    rows / columns of the (α, α·L1(q), nnz) table there, or are None (fp32
    scores).

    ``result()``, called once the next pair's kernel 4 is queued, orders
    the rest on the cards: each device's stream waits for the copies into
    it (events, no host wait), runs kernel 5 over its row slice (kernel 6
    without aux) and starts its counts' copy to pinned host memory
    (``tri_score.PendingPair``), every device before any wait; then one
    wait for the counts ("epilogue"), kernel 7 on each device with the
    whole rectangle's scan (the pre-level of ``rb`` rows; ``row_slices``'
    cuts) and the lists moved to the lead device in slice order
    ("compact"), so they equal the whole rectangle's, in order.  A card's
    stream thus runs kernel 4 of the next pair while the copies of this
    one land.  The check of what kernel 7 decoded goes to ``tally``, or
    runs at each compaction without one."""

    def __init__(self, placed, copied, bounds, devices, aux_i, aux_j,
                 row0: int, col0: int, rb: int, tau_eff, lead, timer=None,
                 tally=None, cols: int | None = None):
        self.placed, self.copied = placed, copied
        self.aux_i, self.aux_j = aux_i, aux_j
        self.bounds, self.devices = bounds, devices
        self.row0, self.col0, self.rb, self.tau_eff = row0, col0, rb, tau_eff
        self.cols = rb if cols is None else cols
        self.lead, self.timer, self.tally = lead, timer, tally
        self.done = False

    def _epilogue(self, k: int) -> ts.PendingPair:
        """Kernel 5 (or 6) over slice ``k`` behind its copies, its counts
        on their way to the host."""
        (a, b), dev = self.bounds[k], self.devices[k]
        for done in self.copied[k]:
            torch.cuda.current_stream(dev).wait_event(done)
        r0 = self.row0 + a
        if self.aux_i is None:
            bits = pair_bits_f32(self.placed[k], r0, self.col0, self.tau_eff)
        else:
            bits = pair_bits_int8(self.placed[k], self.aux_i[dev][:, a:b],
                                  self.aux_j[dev], r0, self.col0,
                                  self.tau_eff)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        pre = (self.rb // ts.SUPER) % (ts.SUPER2 // ts.SUPER) == 0
        return ts.PendingPair(bits, (zero, zero, b - a, self.cols, pre),
                              self.timer, self.tally)

    def result(self):
        with ts._section(self.timer, "epilogue"):
            slices = [self._epilogue(k) for k in range(len(self.bounds))]
            self.placed = self.copied = None
            counts = [s.counts() for s in slices]
        with ts._section(self.timer, "compact"):
            found_r, found_c = [], []
            for s, n, (a, _) in zip(slices, counts, self.bounds):
                r, c = s.compact(n)
                found_r.append((r + (self.row0 + a)).to(self.lead))
                found_c.append((c + self.col0).to(self.lead))
            self.done = True
            if len(found_r) == 1:
                return found_r[0], found_c[0]
            return torch.cat(found_r), torch.cat(found_c)


def slab_width(d_cap: int, n_shards: int) -> int:
    """A shard's slab width: its ``d_cap / n_shards`` columns rounded up to
    the kernel's 128-byte K stage."""
    return -(-(d_cap // n_shards) // ts.K_QUANTUM) * ts.K_QUANTUM
