"""The full-rectangle join over a mesh: ``score.allpairs_extract`` on an
index held as a grid of blocks.

Under JAX the mesh engine calls the single-device ``allpairs_extract`` on a
sharded array and GSPMD places the work; the port's single-controller mesh
(``parallel/mesh.py``) spells the same decomposition out.  The index is an
``(nr, nd)`` grid of blocks, block ``(r, d)`` holding rows block ``r`` and
columns block ``d`` on its shard's device: ``(n, 1)`` is the rows layout,
``(1, n)`` the dims layout (the reference's posting partition), anything
else the 2-D ``"both"`` layout.  Per query tile:

  1. the tile's column block ``d`` is copied from the row shard(s) that own
     its rows to every device that scores against it (``all_gather``);
  2. every row block that reaches below the tile's bucket prefix scores its
     own rows against the tile, one partial fp32 product per column block
     (``score.score_tile``);
  3. the ``nd`` partials of a row block are summed (``psum``) on that row
     block's first device: with ``nd == 1`` there is no sum;
  4. one threshold + strict-upper mask + ``torch.nonzero`` per row block,
     with the block's row offset added.

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
from . import score as score_ops
from . import tri_score as ts

__all__ = ["mesh_allpairs_extract"]


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
        live = [r for r in range(nr) if r * hb < prefix]
        for t in range(tb0, tb1):
            q0 = t * tile
            owners = range(q0 // hb, (q0 + tile - 1) // hb + 1)
            with ts._section(timer, "gather"):
                q = {}
                for r in live:
                    for d in range(nd):
                        dev = devices[r * nd + d]
                        if (dev, d) not in q:
                            q[dev, d] = all_gather(
                                [blocks[o * nd + d][max(q0 - o * hb, 0):
                                                    q0 + tile - o * hb]
                                 for o in owners], 0, dev)
                sync(devices)
            with ts._section(timer, "kernel"):
                parts = {
                    r: [score_ops.score_tile(
                        blocks[r * nd + d][:prefix - r * hb],
                        q[devices[r * nd + d], d], precision)
                        for d in range(nd)]
                    for r in live
                }
                sync(devices)
            del q
            with ts._section(timer, "reduce"):
                sums = {r: psum(parts[r], devices[r * nd]) for r in live}
                del parts
                sync(devices)
            with ts._section(timer, "compact"):
                for r in live:
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
