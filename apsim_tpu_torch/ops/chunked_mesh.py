"""The chunked engine's device ops over a mesh: the counterpart of
``apsim_tpu/ops/chunked_mesh.py``.

The mesh chunked engine shards the chunk axis of its entry buffers: shard
s holds chunks ``[s * n_local, (s + 1) * n_local)`` on its device, and
every function here takes the buffers as per-shard lists.  A score over
the whole index is therefore a sum over shards: every shard runs the chunk
loop of ``ops/chunked.py`` over its own chunks into a partial fp32 (or
exact int32, kernel 4) block on its device.  The stripe join sums them
where the rows live: each device receives its row slice of every partial
and kernel 6 (kernel 5 on int32 dots) sums, thresholds and bit-packs it in
one pass, so no stripe-sized sum is formed.  The streaming ops sum the
partials onto the lead device (``psum``), and their one epilogue runs
there.  The int32 sum is exact in any order; the fp32 sum runs left to
right in shard order (the kernel's order too) and adds one rounding per
shard to a row's accumulation, inside the engine's margin like any other
order of the same additions.  The JAX functions replicate the epilogue on
every device; this computes it once.  On a mesh over several processes
each process holds and scores its own shards; the fp32 sum runs in shard
order across them (bit for bit the one-process sum) and ends on the last
shard's process, which runs the epilogue and shares its outputs, as does
the int32 sum.

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

from ..parallel.collectives import gather_rows, psum, share, sum_home, sync
from . import chunked as chunked_ops
from . import tri_score as ts

__all__ = ["mesh_stripe_extract", "mesh_stripe_extract_int8",
           "mesh_match_extract", "mesh_topk",
           "mesh_append_entries", "mesh_grow_entry_cap"]


def _reduced(mesh, parts, epilogue, timer):
    """``epilogue`` (a tuple of tensors out) of the sum of the shards'
    partials ``parts``, on every process: the sum ("reduce") on the home
    shard's process, which runs the epilogue; its outputs then cross to
    the others (on one process nothing crosses)."""
    home = sum_home(mesh)
    with ts._section(timer, "reduce"):
        total = psum(parts, mesh.lead, mesh, to=home)
        sync(mesh)
    out = None if total is None else epilogue(total)
    del total
    return share([out], [mesh.ranks[home]], mesh.lead, mesh)[0]


def _stripe_where_rows_live(mesh, parts, aux, q0: int, tau_eff, timer,
                            stats=None):
    """Candidates of one stripe from the shards' partials (fp32 scores,
    ``aux`` None; or int32 dots) without a stripe-sized sum.

    One process: the stripe's live rows (``chunked.stripe_live_rows``) are
    cut into one slice per distinct device of the mesh
    (``panel_mesh.card_slices``), each device receives its slice's rows of
    every shard's partial (``collectives.gather_rows``, "reduce": views
    where a partial is already there, so nothing is copied with every
    shard on one device), runs kernel 6 (or kernel 5) over them and
    compacts (``chunked.stripe_candidates``, "epilogue" and "compact");
    the lists meet on the lead device in slice order.  Several processes:
    the sum runs in shard order to the home shard's process (``_reduced``;
    bit for bit the one-process sum), which runs the same kernel on it
    alone.  ``stats`` counts the peer copies' bytes (``gather_rows``)."""
    from .panel_mesh import card_slices  # see chunked.stripe_candidates

    if mesh.n_procs > 1:
        def epilogue(total):
            if aux is None:
                return chunked_ops.join_epilogue_bits(total, q0, tau_eff,
                                                      timer)
            return chunked_ops.int8_join_epilogue(total, aux, q0, tau_eff,
                                                  timer)
        return _reduced(mesh, parts, epilogue, timer)
    row_cap, tile = parts[0].shape
    bounds, devices = card_slices(
        mesh.devices, chunked_ops.stripe_live_rows(row_cap, q0, tile))
    with ts._section(timer, "reduce"):
        placed = gather_rows(parts, bounds, devices, stats)
        del parts
        sync(devices)
    return chunked_ops.stripe_candidates(placed, bounds, devices, aux, q0,
                                         tile, row_cap, tau_eff, mesh.lead,
                                         timer)


def mesh_stripe_extract(mesh, rows2d, cols2d, vals2d, counts, q0: int,
                        tau_eff, row_cap: int, chunk_dim: int,
                        super_tile: int, precision: str = "default",
                        timer=None, stats=None):
    """Candidates ``(rows, cols)`` (int64, exact length, on the lead
    device) of one query stripe; the buffers are per-shard lists (None for
    another process's shard), ``counts`` a per-shard list of host arrays
    or tensors.  Every shard's fp32 partial scores, then kernel 6 where
    the rows live (``_stripe_where_rows_live``).  Stages "slabs",
    "kernel", "reduce", "epilogue", "compact"."""
    parts = [
        None if r is None else chunked_ops.stripe_scores(
            r, c, v, n, q0, row_cap, chunk_dim, super_tile, precision, timer)
        for r, c, v, n in zip(rows2d, cols2d, vals2d, counts)
    ]
    return _stripe_where_rows_live(mesh, parts, None, q0, tau_eff, timer,
                                   stats)


def mesh_stripe_extract_int8(mesh, rows2d, cols2d, q2d, counts, aux, q0: int,
                             tau_eff, row_cap: int, chunk_dim: int,
                             super_tile: int, timer=None, stats=None):
    """int8 variant: per-shard int8 slabs and exact int32 partial dots
    (kernel 4, one launch per local chunk), then kernel 5 where the rows
    live with the global ``aux`` (on the lead device)."""
    parts = [
        None if r is None else chunked_ops.stripe_dots_int8(
            r, c, q, n, q0, row_cap, chunk_dim, super_tile, timer)
        for r, c, q, n in zip(rows2d, cols2d, q2d, counts)
    ]
    return _stripe_where_rows_live(mesh, parts, aux, q0, tau_eff, timer,
                                   stats)


# ------------------------------------------------------------ streaming


def _split_queries(mesh, q, n_local: int) -> list:
    """A chunk-bucketed query batch ``(rows2d, cols2d, vals2d, counts)``
    (``ChunkedAllPairs._bucket_queries``: buffers on the lead device,
    counts on the host) cut into each shard's chunk block on its device
    (None for another process's shard)."""
    r2, c2, v2, cnts = q
    out = []
    for s, dev in enumerate(mesh.devices):
        if not mesh.is_local(s):
            out.append(None)
            continue
        sl = slice(s * n_local, (s + 1) * n_local)
        out.append((r2[sl].to(dev), c2[sl].to(dev), v2[sl].to(dev),
                    cnts[sl]))
    return out


def _partial_scores(mesh, rows2d, cols2d, vals2d, counts, q, width: int,
                    row_cap: int, q_rows: int, precision: str,
                    queries_lead: bool, timer) -> list:
    """Every shard's ``chunk_scores`` over its own chunks (slabs densified
    from its buffers); None for another process's shard."""
    sdt = chunked_ops.slab_dtype(precision)
    n_local = next(r for r in rows2d if r is not None).shape[0]
    qs = _split_queries(mesh, q, n_local)
    parts = []
    for r, c, v, n, qq in zip(rows2d, cols2d, vals2d, counts, qs):
        if r is None:
            parts.append(None)
            continue
        parts.append(chunked_ops.chunk_scores(
            lambda k, r=r, c=c, v=v, n=n: chunked_ops.densify_chunk(
                r, c, v, n, k, row_cap, width, sdt),
            qq, r.shape[0], width, q_rows, sdt, precision, queries_lead,
            timer))
    return parts


def mesh_match_extract(mesh, rows2d, cols2d, vals2d, counts, q, q_base: int,
                       tau_eff, row_cap: int, width: int, q_rows: int,
                       precision: str = "default", timer=None):
    """Streaming match of a chunk-bucketed query batch ``q`` against the
    whole sharded index (``mesh_match_extract`` of the JAX package without
    caps and head): each shard's partial fp32 ``[row_cap, q_rows]`` block,
    the ``psum``, then ``chunked.match_extract`` once (threshold, the
    batch's own cells excluded on ``q_base``, exact length).  ``counts``:
    per-shard host arrays.  Returns device int64 ``(index rows, query
    locals)`` on the lead device.  Stages "slabs", "product", "reduce",
    "compact"."""
    parts = _partial_scores(mesh, rows2d, cols2d, vals2d, counts, q, width,
                            row_cap, q_rows, precision, False, timer)

    def extract(s):
        with ts._section(timer, "compact"):
            return chunked_ops.match_extract(s, q_base, tau_eff, timer)

    return _reduced(mesh, parts, extract, timer)


def mesh_topk(mesh, rows2d, cols2d, vals2d, counts, q, n_rows: int,
              row_cap: int, width: int, q_rows: int, k: int,
              precision: str = "highest"):
    """Top ``k`` scores per query row and their index rows, descending
    (``(scores [q_rows, k], rows [q_rows, k])`` on the lead device): the
    shards' partial ``[q_rows, row_cap]`` scores summed, rows ``>= n_rows``
    masked to ``-inf``, one ``torch.topk``.  At ``"highest"`` the slabs are
    fp32 and every product is a true fp32 one (``score.score_tile``)."""
    parts = _partial_scores(mesh, rows2d, cols2d, vals2d, counts, q, width,
                            row_cap, q_rows, precision, True, None)
    return _reduced(mesh, parts,
                    lambda s: tuple(chunked_ops._topk(s, n_rows, k)), None)


def mesh_append_entries(mesh, rows2d, cols2d, vals2d, coo5: np.ndarray):
    """Set a packed ``[5, n]`` host batch (chunk / slot / row / local /
    fp32 value bits, global chunk ids) into the per-shard buffers in
    place: each shard of this process takes the entries of its own chunk
    block, localized, in one H2D copy.  The selection is made on the host
    before the scatter (torch has no drop mode for the foreign entries)."""
    n_local = next(r for r in rows2d if r is not None).shape[0]
    owner = coo5[0] // n_local
    for s, dev in enumerate(mesh.devices):
        own = owner == s
        if rows2d[s] is None or not own.any():
            continue
        part = np.ascontiguousarray(coo5[:, own])
        part[0] -= s * n_local
        p = torch.from_numpy(part).to(dev)
        chunked_ops.append_entries(rows2d[s], cols2d[s], vals2d[s], p[0],
                                   p[1], p[2], p[3], p[4].view(torch.float32))


def mesh_grow_entry_cap(rows2d, cols2d, vals2d, new_cap: int, pad_row: int):
    """Every shard's buffers padded to ``new_cap`` slots on its own device
    (``chunked.grow_entry_cap`` per shard; no data crosses shards; None
    stays None for another process's shard).  Returns the three per-shard
    lists."""
    grown = [(None, None, None) if r is None else
             chunked_ops.grow_entry_cap(r, c, v, new_cap, pad_row)
             for r, c, v in zip(rows2d, cols2d, vals2d)]
    return tuple(list(t) for t in zip(*grown))
