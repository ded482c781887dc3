"""The dense engine's products over a mesh: the full-rectangle join
(``score.allpairs_extract``) and the streaming match, frozen match and
top-k on an index held as a grid of blocks.

Under JAX the mesh engine calls the single-device ops on a sharded array
and GSPMD places the work; the port's mesh (``parallel/mesh.py``) spells
the same decomposition out.  The index is an
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

On a mesh over several processes each process scores the blocks it
owns; a query block crosses only to the processes that score against it,
a row block's partials are summed in shard order across processes (bit
for bit the one-process sum) on the process of its last column block,
which runs the epilogue, and the epilogue's lists cross to every process.

The summed score differs from one device's only in the order of its fp32
additions: each partial is an fp32 sum over a subset of the row's terms,
and the sum of the partials is one more fp32 addition per column block, so
the error stays inside the engine's margin by the same proof
(``Engine._margin_rel``: ``(max_nnz + 2) * 2^-24`` counts one rounding per
addition, in any order).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_gather, as_mesh, psum, share, sync
from . import chunked as chunked_ops
from . import score as score_ops
from . import tri_score as ts

__all__ = ["gather_rows", "block_scores", "mesh_allpairs_extract",
           "mesh_match_rows_extract", "mesh_queries_match_extract",
           "mesh_topk_scores"]


def _block_shape(blocks):
    """``(hb, wb)``: every block has the same shape; this process holds at
    least one."""
    return tuple(int(n) for n in next(
        b for b in blocks if b is not None).shape)


def gather_rows(blocks, grid, q0: int, q1: int, d: int, dev, mesh=None,
                need=None):
    """Index rows ``[q0, q1)`` of column block ``d``, copied from the row
    blocks that own them onto ``dev`` (``all_gather``).  On a mesh over
    several processes: on the processes owning a shard of ``need``, None
    elsewhere."""
    nd = grid[1]
    hb = _block_shape(blocks)[0]
    own = range(q0 // hb, (q1 - 1) // hb + 1)
    shards = [o * nd + d for o in own]
    parts = [None if blocks[s] is None
             else blocks[s][max(q0 - o * hb, 0):q1 - o * hb]
             for o, s in zip(own, shards)]
    return all_gather(parts, 0, dev, mesh, shards, need)


def _home(mesh, r: int, nd: int) -> int:
    """The shard whose device holds row block ``r``'s sum: its first on
    one process, its last across processes (where the shard-order chain
    of ``psum`` ends)."""
    return r * nd + (nd - 1 if mesh.n_procs > 1 else 0)


def block_scores(blocks, grid, devices, q_of, row_limit: int,
                 precision: str, queries_lead: bool = False, timer=None,
                 stage: str = "kernel") -> dict:
    """fp32 scores of every row block's live rows against a query,
    summed over the column blocks: ``{r: s}`` for each row block ``r`` with
    rows below ``row_limit`` whose sum this process holds, ``s`` of its
    rows ``[r * hb, min((r + 1) * hb, row_limit))`` on the device of shard
    ``_home(r)``, ``[rows, q]`` (or ``[q, rows]`` with ``queries_lead``).
    ``devices`` is the mesh (or, on one process, its device list);
    ``q_of(dev, d, need)`` gives the query's column block ``d`` on
    ``dev``, ``need`` the shards that score against it.  On a mesh over
    several processes a process scores its own blocks and holds the sums
    whose home shard it owns.  Stages "gather", ``stage`` (the products)
    and "reduce", each ending with this process's devices idle."""
    mesh = as_mesh(devices)
    devices = mesh.devices
    nr, nd = grid
    hb = _block_shape(blocks)[0]
    live = [r for r in range(nr) if r * hb < row_limit]
    multi = mesh.n_procs > 1
    with ts._section(timer, "gather"):
        q = {}
        if not multi:
            for r in live:
                for d in range(nd):
                    dev = devices[r * nd + d]
                    if (dev, d) not in q:
                        q[dev, d] = q_of(dev, d, None)
        else:  # one collective per column block, entered by every process
            for d in range(nd):
                need = [r * nd + d for r in live]
                qd = q_of(mesh.lead, d, need)
                for s in need:
                    if mesh.is_local(s) and (devices[s], d) not in q:
                        q[devices[s], d] = qd.to(devices[s])
        sync(mesh)
    with ts._section(timer, stage):
        parts = {}
        for r in live:
            parts[r] = []
            for d in range(nd):
                s = r * nd + d
                if blocks[s] is None:
                    parts[r].append(None)
                    continue
                a = blocks[s][:row_limit - r * hb]
                b = q[devices[s], d]
                parts[r].append(score_ops.score_tile(
                    *((b, a) if queries_lead else (a, b)), precision))
        sync(mesh)
    del q
    with ts._section(timer, "reduce"):
        sums = {}
        for r in live:
            home = _home(mesh, r, nd)
            s = psum(parts.pop(r), mesh.devices[home] if mesh.is_local(home)
                     else mesh.lead, mesh,
                     list(range(r * nd, (r + 1) * nd)), to=home)
            if s is not None:
                sums[r] = s
        sync(mesh)
    return sums


def _shared(mesh, grid, found: dict, keys):
    """The per-key outputs ``found`` (computed where each key's row block
    has its home) on every process, in ``keys`` order; a key is ``(...,
    r)`` with its row block last."""
    nd = grid[1]
    owners = [mesh.ranks[_home(mesh, k[-1], nd)] for k in keys]
    return share([found.get(k) for k in keys], owners, mesh.lead, mesh)


def _on_lead(found, devices):
    """Per-block ``(rows, cols)`` lists concatenated on the lead device."""
    lead = as_mesh(devices).lead
    if not found:
        empty = torch.empty(0, dtype=torch.int64, device=lead)
        return empty, empty.clone()
    return (torch.cat([r.to(lead) for r, _ in found]),
            torch.cat([c.to(lead) for _, c in found]))


def _live(grid, hb: int, row_limit: int):
    return [r for r in range(grid[0]) if r * hb < row_limit]


def mesh_allpairs_extract(blocks, grid, devices, tau_eff, tile: int,
                          precision: str = "highest", group: int = 8,
                          timer=None, mode: str = "upper"):
    """Candidates of the whole index: a list of device int64 ``(rows,
    cols)`` pairs with global coordinates and exact lengths, one per
    (query tile, live row block), each on its row block's first device (on
    the lead device for a pair from another process).

    ``blocks`` is the row-major list of the grid's operand blocks
    (``score.score_operand`` already applied; None for another process's),
    ``grid = (nr, nd)``, ``devices`` the mesh (or its device list).
    Buckets, modes and checks are ``score.allpairs_extract``'s:
    ``mode="upper"`` keeps the strict upper triangle and scores only the
    row blocks with rows below a bucket's end; ``mode="all"`` scores every
    live row block against every tile (one bucket over ``row_cap``) and
    keeps every thresholded cell, self and symmetric pairs too.  One host
    synchronization (``nonzero``) per query tile and live row block.
    Stages: "gather", "kernel", "reduce", "compact"."""
    mesh = as_mesh(devices)
    nr, nd = grid
    hb = _block_shape(blocks)[0]
    row_cap = nr * hb
    if row_cap % tile:
        raise ValueError(f"row_cap {row_cap} not a multiple of tile {tile}")
    if tile % group:
        raise ValueError(f"tile {tile} not a multiple of group {group}")
    if mode not in ("upper", "all"):
        raise ValueError(f"unknown mode: {mode}")
    upper = mode == "upper"
    n_tiles = row_cap // tile
    tau_eff = float(tau_eff)
    found, keys, total = {}, [], 0
    for tb0, tb1 in (score_ops.upper_buckets(n_tiles) if upper
                     else [(0, n_tiles)]):
        prefix = tb1 * tile
        for t in range(tb0, tb1):
            q0 = t * tile
            sums = block_scores(
                blocks, grid, mesh,
                lambda dev, d, need: gather_rows(
                    blocks, grid, q0, q0 + tile, d, dev, mesh, need),
                prefix, precision, timer=timer)
            keys += [(t, r) for r in _live(grid, hb, prefix)]
            with ts._section(timer, "compact"):
                for r in list(sums):
                    s = sums.pop(r)
                    m = s >= tau_eff
                    if upper:
                        rows = r * hb + torch.arange(s.shape[0],
                                                     device=s.device)
                        cols = q0 + torch.arange(tile, device=s.device)
                        m &= rows[:, None] < cols[None, :]
                    hit = torch.nonzero(m)
                    del s, m
                    total += hit.shape[0]
                    ts.check_pair_count(total)
                    found[t, r] = (hit[:, 0] + r * hb, hit[:, 1] + q0)
    out = _shared(mesh, grid, found, keys)
    if mesh.n_procs > 1:
        ts.check_pair_count(sum(int(r.numel()) for r, _ in out))
    return out


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
    mesh = as_mesh(devices)
    hb = _block_shape(blocks)[0]
    sums = block_scores(
        blocks, grid, mesh,
        lambda dev, d, need: gather_rows(blocks, grid, n0, n1, d, dev, mesh,
                                         need),
        n_rows, precision, timer=timer, stage="product")
    with ts._section(timer, "compact"):
        found = {}
        for r, s in sums.items():
            rows, cols = chunked_ops.match_extract(s, n0 - r * hb, tau_eff)
            found[(r,)] = (rows + r * hb, cols + n0)
        del sums
        keys = [(r,) for r in _live(grid, hb, n_rows)]
        return _on_lead(_shared(mesh, grid, found, keys), mesh)


def _query_blocks(q, grid, width: int):
    """``q_of`` for dense external queries ``q [nq, dim_cap]`` (the same
    on every process): column block ``d`` sliced and moved to the scoring
    device."""
    return lambda dev, d, need: q[:, d * width:(d + 1) * width].to(dev)


def mesh_queries_match_extract(blocks, grid, devices, q, n_rows: int,
                               tau_eff, precision: str):
    """Frozen-index match over the grid (``score.queries_match_extract``):
    device int64 ``(index rows, query rows)`` on the lead device of every
    live index row against the dense queries ``q [nq, dim_cap]`` (on the
    lead device, ``score.densify_rows``) with ``s >= tau_eff``."""
    mesh = as_mesh(devices)
    hb, wb = _block_shape(blocks)
    sums = block_scores(blocks, grid, mesh, _query_blocks(q, grid, wb),
                        n_rows, precision)
    found = {}
    for r, s in sums.items():
        hit = torch.nonzero(s >= float(tau_eff))
        found[(r,)] = (hit[:, 0] + r * hb, hit[:, 1])
    del sums
    keys = [(r,) for r in _live(grid, hb, n_rows)]
    return _on_lead(_shared(mesh, grid, found, keys), mesh)


def mesh_topk_scores(blocks, grid, devices, q, n_rows: int, k: int):
    """Top ``k`` true fp32 scores per dense query and their index rows,
    descending (``(scores [nq, k], rows [nq, k])`` on the lead device;
    ``score.topk_scores`` at ``"highest"`` over the grid): each row block's
    partials summed over the column blocks, its own top ``min(k, rows)``,
    then one ``torch.topk`` over the blocks' lists.  Every true top-k
    member is in its block's list, so the merge holds a true top ``k``;
    ``torch.topk`` orders ties arbitrarily, which the caller's fetch
    (``fetch_exact_topk``, a strict ``<`` stop) and fp64 re-rank absorb."""
    mesh = as_mesh(devices)
    hb, wb = _block_shape(blocks)
    sums = block_scores(blocks, grid, mesh, _query_blocks(q, grid, wb),
                        n_rows, "highest", queries_lead=True)
    found = {}
    for r, s in sums.items():
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        found[(r,)] = (v, i + r * hb)
    del sums
    keys = [(r,) for r in _live(grid, hb, n_rows)]
    lead = mesh.lead
    lists = _shared(mesh, grid, found, keys)
    v, pick = torch.topk(torch.cat([v.to(lead) for v, _ in lists], dim=1),
                         k, dim=1)
    rows = torch.cat([i.to(lead) for _, i in lists], dim=1)
    return v, torch.gather(rows, 1, pick)
