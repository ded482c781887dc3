"""Rows-sharded mesh join: the counterpart of ``apsim_tpu/ops/mesh_pallas.py``.

With ``shard_axis="rows"`` each shard owns a contiguous row block of the
dense index.  Every shard quantizes its own rows (row-local, so the α = 0
rule for padded rows holds), the int8 rows and their aux tables are
all-gathered, and each shard runs the cross-panel kernel (kernel 3,
``panel.panel_score_bits_int8``, with zero offsets) over its share of the
GLOBAL upper-triangle block schedule, reading both operands from the
gathered copy.  The schedule is striped round-robin (shard d takes blocks
d, d+n, d+2n, ...), so shards are balanced to one block and only
``row_cap`` must tile.  No sum crosses shards; each shard's hits compact to
exact-length global (row, col) lists.

Exactness is the dense kernel's contract: int8 scores plus the per-pair
quantization bound form a proven candidate superset at ``tau_eff``, and the
host fp64 rescore decides the pair set.
"""

from __future__ import annotations

import numpy as np

from ..parallel.collectives import all_gather, sync
from . import panel as panel_ops
from . import tri_score as ts

__all__ = ["rows_schedule", "mesh_rows_extract_int8"]


def rows_schedule(row_cap: int, n_dev: int, tm: int, tn: int):
    """Per-shard block schedules ``(bi, bj, valid) [n_dev, max_blocks]``
    int32: the global upper-triangle tile schedule striped round-robin over
    the shards, padded with ``valid = 0``.  A copy of the JAX function."""
    bi, bj = ts.upper_blocks_rect(row_cap, tm, tn)
    mx = -(-bi.size // n_dev)
    bi_a = np.zeros((n_dev, mx), np.int32)
    bj_a = np.zeros((n_dev, mx), np.int32)
    va_a = np.zeros((n_dev, mx), np.int32)
    for d in range(n_dev):
        sl_i, sl_j = bi[d::n_dev], bj[d::n_dev]
        bi_a[d, : sl_i.size] = sl_i
        bj_a[d, : sl_j.size] = sl_j
        va_a[d, : sl_i.size] = 1
    return bi_a, bj_a, va_a


def mesh_rows_extract_int8(mesh, x_blocks, bi, bj, valid, tau_eff, tm: int,
                           tn: int, timer=None):
    """The whole upper-triangle join over a rows-sharded index.

    ``x_blocks`` holds each shard's row block (on its device), ``bi`` /
    ``bj`` / ``valid`` each shard's int32 schedule (``rows_schedule``) on
    that device.  In order: ``quantize_rows`` per shard, ``all_gather`` of
    q and aux (stage "operands"); kernel 3 per shard on the gathered copy
    ("kernel", one launch per shard); exact-length compaction ("compact").
    Returns one ``(row, col)`` int64 pair of global candidate lists per
    shard.  Shards on one device share one gathered copy; shards on
    distinct devices each hold their own, as under JAX."""
    devices = list(mesh.devices)
    with ts._section(timer, "operands"):
        qa = [ts.quantize_rows(x) for x in x_blocks]
        gathered = {
            dev: (all_gather([q for q, _ in qa], 0, dev),
                  all_gather([a for _, a in qa], 1, dev).contiguous())
            for dev in dict.fromkeys(devices)
        }
        del qa
        sync(devices)
    with ts._section(timer, "kernel"):
        bits = []
        for s, dev in enumerate(devices):
            qg, auxg = gathered[dev]
            bits.append(panel_ops.panel_score_bits_int8(
                qg, qg, auxg, auxg, bi[s], bj[s], (0, 0), tau_eff, tm, tn,
                valid=valid[s],
            ))
        sync(devices)
    with ts._section(timer, "compact"):
        return [ts.compact_bits(gb, g64, cnt, bi[s], bj[s], tm, tn)
                for s, (gb, g64, cnt) in enumerate(bits)]
