"""Mesh-sharded block-panel join: the counterpart of
``apsim_tpu/ops/panel_mesh.py``.

The mesh chunked engine shards the chunk axis of its entry buffers, so a row
panel's int8 slab is column-sharded: shard s densifies ``[rb, d_local]``
from its own entries, a panel pair's score is the sum of the shards' int8
partial dots (kernel 4, ``int8_matmul``, once per shard), the int32 sum is
exact, and the quantization-bound epilogue and the compaction run once on
the summed rectangle.  The per-pair bound proof of the dense kernel
(``ops/tri_score.py``) carries over unchanged.

The functions work on per-shard lists (one tensor per shard, on its
device); the only data movement between shards is through
``parallel/collectives.py``.  ``int8_matmul`` launches the CUDA kernel of
``csrc/score_bits.cu`` for CUDA tensors (counted in
``tri_score.LAUNCHES["int8_matmul"]``) and runs its plain PyTorch version
for CPU tensors.  The JAX function's ``optimization_barrier`` (a TPU compile
workaround) and its caps / packed head (exact-length compaction needs none)
have no counterpart.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import pmax, psum, sync
from . import panel as panel_ops
from . import tri_score as ts

__all__ = [
    "int8_matmul",
    "int8_matmul_plain",
    "mesh_quantize_entries",
    "mesh_panel_state",
    "mesh_build_panel_slab",
    "mesh_panel_pair",
    "slab_width",
]

MM_TM, MM_TN = ts.THREAD_BLOCK_TILES[-1]  # kernel 4's smallest thread-block tile
EPILOGUE_CELLS = ts.EPILOGUE_CELLS  # rectangle cells per epilogue chunk


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
    on its device; unused slots carry a row ``>= row_cap``.

    Returns ``(q, aux, max_nnz)``: per shard the int8 values in the same
    order, ``aux`` the global f32 ``[3, row_cap]`` (α, α·L1(q), nnz) on the
    lead device, ``max_nnz`` an int.  A row's entries are split over the
    shards, so its maximum comes from ``pmax`` and its L1 and nnz from
    ``psum``.  Bit-identical to the JAX function: rows out of range are
    filtered out of the scatters (torch has no drop mode), and
    ``mx / 127.0`` is a multiply by the fp32 reciprocal, as XLA compiles
    it.  All-zero rows get α = 0."""
    lead = mesh.devices[0]
    live = [r < row_cap for r in flat_r]
    mxs = []
    for r, v, ok in zip(flat_r, flat_v, live):
        mx = torch.zeros(row_cap, dtype=torch.float32, device=r.device)
        mx.scatter_reduce_(0, r[ok].long(), v[ok].abs(), reduce="amax")
        mxs.append(mx)
    mx = pmax(mxs, lead)
    alpha = torch.where(mx > 0, mx * (1.0 / 127.0), 0.0).to(torch.float32)
    qs, l1qs, nnzs = [], [], []
    for r, v, ok in zip(flat_r, flat_v, live):
        dev = r.device
        a_e = alpha.to(dev)[r.clamp(max=row_cap - 1).long()]
        div = torch.where(a_e > 0, a_e, 1.0)
        q = (v / div).round_().clamp_(-127, 127).to(torch.int8)
        r_live = r[ok].long()
        l1qs.append(torch.zeros(row_cap, dtype=torch.float32, device=dev)
                    .index_add_(0, r_live, q[ok].abs().to(torch.float32)))
        nnzs.append(torch.zeros(row_cap, dtype=torch.float32, device=dev)
                    .index_add_(0, r_live, (v[ok] != 0).to(torch.float32)))
        qs.append(q)
    l1q = psum(l1qs, lead)
    nnz = psum(nnzs, lead)
    aux = torch.stack([alpha, alpha * l1q, nnz])
    max_nnz = int(nnz.max()) if row_cap else 0
    return qs, aux, max_nnz


def mesh_panel_state(mesh, row_cap: int, rb: int, n_panels: int, rows2d,
                     cols2d, vals2d, counts):
    """Per-shard join state from the per-shard entry buffers (lists of
    ``[n_local, cap]`` tensors and ``[n_local]`` counts, one per shard).

    Returns ``(r_s, c_s, q_s, pcounts, aux, max_nnz)``: per shard the
    entries sorted by row (stable), their SLAB-LOCAL columns
    (``local_dim · n_local + local_chunk``, a bijection onto
    ``[0, d_cap / n_shards)``), their int8 values and the int32 per-panel
    counts (last bucket: unused slots); ``aux`` and ``max_nnz`` from
    ``mesh_quantize_entries`` over the slots below each chunk's count."""
    n_sh = len(rows2d)
    flat_r, flat_v = [], []
    for s in range(n_sh):
        dev = rows2d[s].device
        cap = rows2d[s].shape[1]
        pos = torch.arange(cap, dtype=torch.int32, device=dev)
        valid = pos[None, :] < counts[s].to(torch.int32)[:, None]
        flat_r.append(
            torch.where(valid, rows2d[s], panel_ops.PAD_ROW).reshape(-1))
        flat_v.append(torch.where(valid, vals2d[s], 0.0).reshape(-1))
    qs, aux, max_nnz = mesh_quantize_entries(mesh, flat_r, flat_v, row_cap)
    r_s, c_s, q_s, pcounts = [], [], [], []
    for s in range(n_sh):
        r, q = flat_r[s], qs[s]
        dev = r.device
        n_local = rows2d[s].shape[0]
        chunk_of = torch.arange(n_local, dtype=torch.int32, device=dev)
        c_slab = (cols2d[s] * n_local + chunk_of[:, None]).reshape(-1)
        order = torch.argsort(r, stable=True)
        rs = r[order]
        r_s.append(rs)
        c_s.append(c_slab[order])
        q_s.append(q[order])
        pan = torch.clamp(rs // rb, max=n_panels).long()
        pcounts.append(
            torch.bincount(pan, minlength=n_panels + 1).to(torch.int32))
    return r_s, c_s, q_s, pcounts, aux, max_nnz


def mesh_build_panel_slab(r_s, c_s, q_s, starts, p: int, rb: int,
                          d_local: int):
    """Panel ``p``'s column-sharded int8 slab: per shard ``[rb, d_local]``
    on that shard's device, densified from its sorted entries
    ``[starts[s][p], starts[s][p + 1])`` by ``panel.build_panel_slab`` (an
    exact slice plus the row-range filter, as ``index_put_`` has no drop
    mode)."""
    return [
        panel_ops.build_panel_slab(r, c, q, int(st[p]), int(st[p + 1]),
                                   p * rb, rb, d_local)
        for r, c, q, st in zip(r_s, c_s, q_s, starts)
    ]


def _epilogue_rows(rb: int) -> int:
    """Rows per epilogue chunk: a multiple of 64 (whole super-groups) that
    keeps the chunk's f32 temporaries near ``EPILOGUE_CELLS`` cells."""
    return ts.epilogue_rows(rb, rb, EPILOGUE_CELLS)


def mesh_panel_pair(mesh, xis, xjs, aux_i, aux_j, row0: int, col0: int,
                    tau_eff, timer=None):
    """One panel pair end to end: global (row, col) int64 candidate lists
    on the lead device.

    In order: kernel 4 on every shard's slab pair (stage "kernel"); the
    exact int32 ``psum`` onto the lead device ("reduce");
    ``panel.int8_bound_mask`` over the ``[rb, rb]`` rectangle on global
    coordinates, then ``tri_score.bitpack_mask`` ("epilogue"), in row chunks
    of whole super-groups that bound the f32 temporaries; the exact-length
    ``tri_score.compact_bits`` on one ``(rb, rb)`` block with global block
    ids ``(row0 // rb, col0 // rb)`` ("compact").  The JAX function
    replicates the epilogue on every device; this computes it once.  The
    counts are summed in int64, so a rectangle with 2^31 hits cannot wrap
    (``compact_bits`` then refuses it)."""
    lead = mesh.devices[0]
    rb = xis[0].shape[0]
    devices = [x.device for x in xis]
    with ts._section(timer, "kernel"):
        parts = [int8_matmul(a, b) for a, b in zip(xis, xjs)]
        sync(devices)
    with ts._section(timer, "reduce"):
        d = psum(parts, lead)
        del parts
        sync([lead])
    with ts._section(timer, "epilogue"):
        cols = col0 + torch.arange(rb, dtype=torch.int64, device=lead)

        def mask_of(r0: int, r1: int):
            rows = row0 + torch.arange(r0, r1, dtype=torch.int64,
                                       device=lead)
            return panel_ops.int8_bound_mask(
                d[r0:r1], aux_i[:, r0:r1], aux_j, rows[:, None],
                cols[None, :], tau_eff,
            )

        gb, g64, cnt = ts.bitpack_row_chunks(
            mask_of, rb, rb, _epilogue_rows(rb), lead)
        del d
        sync([lead])
    with ts._section(timer, "compact"):
        bi = torch.tensor([row0 // rb], dtype=torch.int32, device=lead)
        bj = torch.tensor([col0 // rb], dtype=torch.int32, device=lead)
        return ts.compact_bits(gb, g64, cnt, bi, bj, rb, rb)


def slab_width(d_cap: int, n_shards: int) -> int:
    """A shard's slab width: its ``d_cap / n_shards`` columns rounded up to
    the kernel's 128-byte K stage."""
    return -(-(d_cap // n_shards) // ts.K_QUANTUM) * ts.K_QUANTUM
