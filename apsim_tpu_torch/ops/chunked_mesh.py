"""The chunked engine's device ops over a mesh: the counterpart of
``apsim_tpu/ops/chunked_mesh.py``.

The mesh chunked engine shards the chunk axis of its entry buffers: shard
s holds chunks ``[s * n_local, (s + 1) * n_local)`` on its device, and
every function here takes the buffers as per-shard lists.  A score over
the whole index is therefore a sum over shards: every shard runs the chunk
loop of ``ops/chunked.py`` over its own chunks into a partial fp32 (or
exact int32, kernel 4) block on its device, the partials are summed onto
the lead device (``psum``), and the one epilogue runs there.  The int32 sum
is exact in any order; the fp32 sum adds one rounding per shard to a row's
accumulation, inside the engine's margin like any other order of the same
additions.  The JAX functions replicate the epilogue on every device; this
computes it once.

  - the stripe join: ``mesh_stripe_extract`` (bf16 or fp32 slabs) and
    ``mesh_stripe_extract_int8``;
  - streaming: ``mesh_match_extract`` (a chunk-bucketed query batch against
    the whole index, every slab densified per call: the engine's rebuild
    route, the only one on the mesh), ``mesh_topk`` (true fp32 products at
    "highest"), ``mesh_append_entries`` and ``mesh_grow_entry_cap``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import psum, sync
from . import chunked as chunked_ops
from . import tri_score as ts

__all__ = ["mesh_stripe_extract", "mesh_stripe_extract_int8",
           "mesh_match_extract", "mesh_topk",
           "mesh_append_entries", "mesh_grow_entry_cap"]


def _summed(mesh, parts, timer):
    with ts._section(timer, "reduce"):
        total = psum(parts, mesh.devices[0])
        sync(mesh.devices)
    return total


def mesh_stripe_extract(mesh, rows2d, cols2d, vals2d, counts, q0: int,
                        tau_eff, row_cap: int, chunk_dim: int,
                        super_tile: int, precision: str = "default",
                        timer=None):
    """Candidates ``(rows, cols)`` (int64, exact length, on the lead
    device) of one query stripe; the buffers are per-shard lists, ``counts``
    a per-shard list of host arrays or tensors.  Stages "slabs", "kernel",
    "reduce", "epilogue", "compact"."""
    parts = [
        chunked_ops.stripe_scores(r, c, v, n, q0, row_cap, chunk_dim,
                                  super_tile, precision, timer)
        for r, c, v, n in zip(rows2d, cols2d, vals2d, counts)
    ]
    s = _summed(mesh, parts, timer)
    del parts
    return chunked_ops.join_epilogue_bits(s, q0, tau_eff, timer)


def mesh_stripe_extract_int8(mesh, rows2d, cols2d, q2d, counts, aux, q0: int,
                             tau_eff, row_cap: int, chunk_dim: int,
                             super_tile: int, timer=None):
    """int8 variant: per-shard int8 slabs and exact int32 partial dots
    (kernel 4, one launch per local chunk), the exact ``psum``, then the
    shared per-pair quantization-bound epilogue with the global ``aux``
    (on the lead device)."""
    parts = [
        chunked_ops.stripe_dots_int8(r, c, q, n, q0, row_cap, chunk_dim,
                                     super_tile, timer)
        for r, c, q, n in zip(rows2d, cols2d, q2d, counts)
    ]
    d = _summed(mesh, parts, timer)
    del parts
    return chunked_ops.int8_join_epilogue(d, aux, q0, tau_eff, timer)


# ------------------------------------------------------------ streaming


def _split_queries(mesh, q, n_local: int) -> list:
    """A chunk-bucketed query batch ``(rows2d, cols2d, vals2d, counts)``
    (``ChunkedAllPairs._bucket_queries``: buffers on the lead device,
    counts on the host) cut into each shard's chunk block on its device."""
    r2, c2, v2, cnts = q
    out = []
    for s, dev in enumerate(mesh.devices):
        sl = slice(s * n_local, (s + 1) * n_local)
        out.append((r2[sl].to(dev), c2[sl].to(dev), v2[sl].to(dev),
                    cnts[sl]))
    return out


def _partial_scores(mesh, rows2d, cols2d, vals2d, counts, q, width: int,
                    row_cap: int, q_rows: int, precision: str,
                    queries_lead: bool, timer):
    """Every shard's ``chunk_scores`` over its own chunks (slabs densified
    from its buffers), summed on the lead device ("reduce")."""
    sdt = chunked_ops.slab_dtype(precision)
    qs = _split_queries(mesh, q, rows2d[0].shape[0])
    parts = []
    for r, c, v, n, qq in zip(rows2d, cols2d, vals2d, counts, qs):
        parts.append(chunked_ops.chunk_scores(
            lambda k, r=r, c=c, v=v, n=n: chunked_ops.densify_chunk(
                r, c, v, n, k, row_cap, width, sdt),
            qq, r.shape[0], width, q_rows, sdt, precision, queries_lead,
            timer))
    del qs
    return _summed(mesh, parts, timer)


def mesh_match_extract(mesh, rows2d, cols2d, vals2d, counts, q, q_base: int,
                       tau_eff, row_cap: int, width: int, q_rows: int,
                       precision: str = "default", timer=None):
    """Streaming match of a chunk-bucketed query batch ``q`` against the
    whole sharded index (``mesh_match_extract`` of the JAX package without
    caps and head): each shard's partial fp32 ``[row_cap, q_rows]`` block,
    the ``psum`` on the lead device, then ``chunked.match_extract`` once
    there (threshold, the batch's own cells excluded on ``q_base``, exact
    length).  ``counts``: per-shard host arrays.  Returns device int64
    ``(index rows, query locals)`` on the lead device.  Stages "slabs",
    "product", "reduce", "compact"."""
    s = _partial_scores(mesh, rows2d, cols2d, vals2d, counts, q, width,
                        row_cap, q_rows, precision, False, timer)
    with ts._section(timer, "compact"):
        return chunked_ops.match_extract(s, q_base, tau_eff)


def mesh_topk(mesh, rows2d, cols2d, vals2d, counts, q, n_rows: int,
              row_cap: int, width: int, q_rows: int, k: int,
              precision: str = "highest"):
    """Top ``k`` scores per query row and their index rows, descending
    (``(scores [q_rows, k], rows [q_rows, k])`` on the lead device): the
    shards' partial ``[q_rows, row_cap]`` scores summed, rows ``>= n_rows``
    masked to ``-inf``, one ``torch.topk``.  At ``"highest"`` the slabs are
    fp32 and every product is a true fp32 one (``score.score_tile``)."""
    s = _partial_scores(mesh, rows2d, cols2d, vals2d, counts, q, width,
                        row_cap, q_rows, precision, True, None)
    return chunked_ops._topk(s, n_rows, k)


def mesh_append_entries(mesh, rows2d, cols2d, vals2d, coo5: np.ndarray):
    """Set a packed ``[5, n]`` host batch (chunk / slot / row / local /
    fp32 value bits, global chunk ids) into the per-shard buffers in
    place: each shard takes the entries of its own chunk block, localized,
    in one H2D copy.  The selection is made on the host before the scatter
    (torch has no drop mode for the foreign entries)."""
    n_local = rows2d[0].shape[0]
    owner = coo5[0] // n_local
    for s, dev in enumerate(mesh.devices):
        own = owner == s
        if not own.any():
            continue
        part = np.ascontiguousarray(coo5[:, own])
        part[0] -= s * n_local
        p = torch.from_numpy(part).to(dev)
        chunked_ops.append_entries(rows2d[s], cols2d[s], vals2d[s], p[0],
                                   p[1], p[2], p[3], p[4].view(torch.float32))


def mesh_grow_entry_cap(rows2d, cols2d, vals2d, new_cap: int, pad_row: int):
    """Every shard's buffers padded to ``new_cap`` slots on its own device
    (``chunked.grow_entry_cap`` per shard; no data crosses shards).
    Returns the three per-shard lists."""
    grown = [chunked_ops.grow_entry_cap(r, c, v, new_cap, pad_row)
             for r, c, v in zip(rows2d, cols2d, vals2d)]
    return tuple(list(t) for t in zip(*grown))
