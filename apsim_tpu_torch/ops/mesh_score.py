"""The dense engine's products over a mesh: the full-rectangle join
(``score.allpairs_extract``) and the streaming match, frozen match and
top-k on an index held as a grid of blocks.

Under JAX the mesh engine calls the single-device ops on a sharded array
and GSPMD places the work; the port's single-controller mesh
(``parallel/mesh.py``) spells the same decomposition out.  The index is an
``(nr, nd)`` grid of blocks, block ``(r, d)`` holding rows block ``r`` and
columns block ``d`` on its shard's device: ``(n, 1)`` is the rows layout,
``(1, n)`` the dims layout (the reference's posting partition), anything
else the 2-D ``"both"`` layout.  Every product here is ``block_scores``:

  1. the query's column block ``d`` is put on every device that scores
     against it: index rows are copied from the row shard(s) that own them
     (``gather_rows``, an ``all_gather``), external queries are sliced;
  2. every row block with live rows scores them against the query, one
     partial fp32 product per column block (``score.score_tile``);
  3. the ``nd`` partials of a row block are summed (``psum``) on that row
     block's first device: with ``nd == 1`` there is no sum.

Then each caller's epilogue runs per row block, with the block's row
offset added: the join's threshold + strict-upper mask, the streaming
match's threshold + self-pair exclusion (``chunked.match_extract``), the
frozen match's threshold, top-k's per-block ``torch.topk`` and merge.

The summed score differs from one device's only in the order of its fp32
additions: each partial is an fp32 sum over a subset of the row's terms,
and the sum of the partials is one more fp32 addition per column block, so
the error stays inside the engine's margin by the same proof
(``Engine._margin_rel``: ``(max_nnz + 2) * 2^-24`` counts one rounding per
addition, in any order).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_gather, psum, sync
from . import chunked as chunked_ops
from . import score as score_ops
from . import tri_score as ts

__all__ = ["gather_rows", "block_scores", "mesh_allpairs_extract",
           "mesh_match_rows_extract", "mesh_queries_match_extract",
           "mesh_topk_scores"]


def gather_rows(blocks, grid, q0: int, q1: int, d: int, dev):
    """Index rows ``[q0, q1)`` of column block ``d``, copied from the row
    blocks that own them onto ``dev`` (``all_gather``)."""
    nd = grid[1]
    hb = int(blocks[0].shape[0])
    return all_gather([blocks[o * nd + d][max(q0 - o * hb, 0):q1 - o * hb]
                       for o in range(q0 // hb, (q1 - 1) // hb + 1)], 0, dev)


def block_scores(blocks, grid, devices, q_of, row_limit: int,
                 precision: str, queries_lead: bool = False, timer=None,
                 stage: str = "kernel") -> dict:
    """fp32 scores of every row block's live rows against a query,
    summed over the column blocks: ``{r: s}`` for each row block ``r`` with
    rows below ``row_limit``, ``s`` of its rows ``[r * hb, min((r + 1) *
    hb, row_limit))`` on ``devices[r * nd]``, ``[rows, q]`` (or ``[q,
    rows]`` with ``queries_lead``).  ``q_of(dev, d)`` gives the query's
    column block ``d`` on ``dev``.  Stages "gather", ``stage`` (the
    products) and "reduce", each ending with every device idle."""
    nr, nd = grid
    hb = int(blocks[0].shape[0])
    live = [r for r in range(nr) if r * hb < row_limit]
    with ts._section(timer, "gather"):
        q = {}
        for r in live:
            for d in range(nd):
                dev = devices[r * nd + d]
                if (dev, d) not in q:
                    q[dev, d] = q_of(dev, d)
        sync(devices)
    with ts._section(timer, stage):
        parts = {}
        for r in live:
            parts[r] = []
            for d in range(nd):
                a = blocks[r * nd + d][:row_limit - r * hb]
                b = q[devices[r * nd + d], d]
                parts[r].append(score_ops.score_tile(
                    *((b, a) if queries_lead else (a, b)), precision))
        sync(devices)
    del q
    with ts._section(timer, "reduce"):
        sums = {r: psum(parts.pop(r), devices[r * nd]) for r in live}
        sync(devices)
    return sums


def _on_lead(found, devices):
    """Per-block ``(rows, cols)`` lists concatenated on the lead device."""
    lead = devices[0]
    if not found:
        empty = torch.empty(0, dtype=torch.int64, device=lead)
        return empty, empty.clone()
    return (torch.cat([r.to(lead) for r, _ in found]),
            torch.cat([c.to(lead) for _, c in found]))


def mesh_allpairs_extract(blocks, grid, devices, tau_eff, tile: int,
                          precision: str = "highest", group: int = 8,
                          timer=None):
    """Upper-triangle candidates of the whole index: a list of device int64
    ``(rows, cols)`` pairs with global coordinates and exact lengths, one
    per (query tile, live row block), each on its row block's first device.

    ``blocks`` is the row-major list of the grid's operand blocks
    (``score.score_operand`` already applied), ``grid = (nr, nd)``,
    ``devices`` the mesh's devices in the same order.  Buckets and checks
    are ``score.allpairs_extract``'s (``mode="upper"``): only row blocks
    with rows below a bucket's end are scored.  One host synchronization
    (``nonzero``) per query tile and live row block.  Stages: "gather",
    "kernel", "reduce", "compact"."""
    nr, nd = grid
    hb = int(blocks[0].shape[0])
    row_cap = nr * hb
    if row_cap % tile:
        raise ValueError(f"row_cap {row_cap} not a multiple of tile {tile}")
    if tile % group:
        raise ValueError(f"tile {tile} not a multiple of group {group}")
    tau_eff = float(tau_eff)
    found, total = [], 0
    for tb0, tb1 in score_ops.upper_buckets(row_cap // tile):
        prefix = tb1 * tile
        for t in range(tb0, tb1):
            q0 = t * tile
            sums = block_scores(
                blocks, grid, devices,
                lambda dev, d: gather_rows(blocks, grid, q0, q0 + tile, d,
                                           dev),
                prefix, precision, timer=timer)
            with ts._section(timer, "compact"):
                for r in list(sums):
                    s = sums.pop(r)
                    rows = r * hb + torch.arange(s.shape[0], device=s.device)
                    cols = q0 + torch.arange(tile, device=s.device)
                    hit = torch.nonzero(
                        (s >= tau_eff) & (rows[:, None] < cols[None, :]))
                    del s
                    total += hit.shape[0]
                    ts.check_pair_count(total)
                    found.append((hit[:, 0] + r * hb, hit[:, 1] + q0))
    return found


def mesh_match_rows_extract(blocks, grid, devices, n0: int, n1: int,
                            n_rows: int, tau_eff, precision: str,
                            timer=None):
    """Candidates of a streamed batch against the index it has just joined
    (``score.match_rows_extract`` over the grid): the query is the index
    rows ``[n0, n1)`` (``n1 - n0`` rounded up to 8; rows past ``n_rows``
    are zero), every live row scores against it, and each row block keeps
    ``s >= tau_eff`` except the batch's own cells.  Device int64 ``(rows,
    cols)`` on the lead device, ``cols`` as global row ids (``>= n0``).
    Stages "gather", "product", "reduce", "compact"."""
    hb = int(blocks[0].shape[0])
    sums = block_scores(
        blocks, grid, devices,
        lambda dev, d: gather_rows(blocks, grid, n0, n1, d, dev),
        n_rows, precision, timer=timer, stage="product")
    with ts._section(timer, "compact"):
        found = []
        for r, s in sums.items():
            rows, cols = chunked_ops.match_extract(s, n0 - r * hb, tau_eff)
            found.append((rows + r * hb, cols + n0))
        del sums
        return _on_lead(found, devices)


def _query_blocks(q, grid, width: int):
    """``q_of`` for dense external queries ``q [nq, dim_cap]``: column
    block ``d`` sliced and moved to the scoring device."""
    return lambda dev, d: q[:, d * width:(d + 1) * width].to(dev)


def mesh_queries_match_extract(blocks, grid, devices, q, n_rows: int,
                               tau_eff, precision: str):
    """Frozen-index match over the grid (``score.queries_match_extract``):
    device int64 ``(index rows, query rows)`` on the lead device of every
    live index row against the dense queries ``q [nq, dim_cap]`` (on the
    lead device, ``score.densify_rows``) with ``s >= tau_eff``."""
    hb, wb = (int(n) for n in blocks[0].shape)
    sums = block_scores(blocks, grid, devices, _query_blocks(q, grid, wb),
                        n_rows, precision)
    found = []
    for r, s in sums.items():
        hit = torch.nonzero(s >= float(tau_eff))
        found.append((hit[:, 0] + r * hb, hit[:, 1]))
    del sums
    return _on_lead(found, devices)


def mesh_topk_scores(blocks, grid, devices, q, n_rows: int, k: int):
    """Top ``k`` true fp32 scores per dense query and their index rows,
    descending (``(scores [nq, k], rows [nq, k])`` on the lead device;
    ``score.topk_scores`` at ``"highest"`` over the grid): each row block's
    partials summed over the column blocks, its own top ``min(k, rows)``,
    then one ``torch.topk`` over the blocks' lists.  Every true top-k
    member is in its block's list, so the merge holds a true top ``k``;
    ``torch.topk`` orders ties arbitrarily, which the caller's fetch
    (``fetch_exact_topk``, a strict ``<`` stop) and fp64 re-rank absorb."""
    hb, wb = (int(n) for n in blocks[0].shape)
    sums = block_scores(blocks, grid, devices, _query_blocks(q, grid, wb),
                        n_rows, "highest", queries_lead=True)
    lead = devices[0]
    vals, rows = [], []
    for r, s in sums.items():
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        vals.append(v.to(lead))
        rows.append((i + r * hb).to(lead))
    del sums
    v, pick = torch.topk(torch.cat(vals, dim=1), k, dim=1)
    return v, torch.gather(torch.cat(rows, dim=1), 1, pick)
