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
exact-length global (row, col) lists.  On a mesh over several processes
each process quantizes and scores its own shards only; the int8 rows and
the candidate lists cross processes.

Exactness is the dense kernel's contract: int8 scores plus the per-pair
quantization bound form a proven candidate superset at ``tau_eff``, and the
host fp64 rescore decides the pair set.
"""

from __future__ import annotations

import numpy as np

from ..parallel.collectives import all_gather, share, sync
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
    that device; on a mesh over several processes the other processes'
    entries are None.  In order: ``quantize_rows`` per shard, ``all_gather``
    of q and aux (stage "operands"); kernel 3 per shard on the gathered
    copy ("kernel", one launch per shard of this process); exact-length
    compaction ("compact").  Returns one ``(row, col)`` int64 pair of
    global candidate lists per shard, every shard's on every process (on
    the lead device where they came from another process).  Shards on one
    device share one gathered copy; shards on distinct devices each hold
    their own, as under JAX."""
    devices = list(mesh.devices)
    mine = mesh.local_shards
    with ts._section(timer, "operands"):
        qa = {s: ts.quantize_rows(x_blocks[s]) for s in mine}
        q_parts = [qa[s][0] if s in qa else None for s in range(mesh.size)]
        a_parts = [qa[s][1] if s in qa else None for s in range(mesh.size)]
        del qa
        if mesh.n_procs == 1:
            gathered = {
                dev: (all_gather(q_parts, 0, dev),
                      all_gather(a_parts, 1, dev).contiguous())
                for dev in dict.fromkeys(devices)
            }
        else:  # across processes once, then to this process's devices
            qg = all_gather(q_parts, 0, mesh.lead, mesh)
            ag = all_gather(a_parts, 1, mesh.lead, mesh).contiguous()
            gathered = {dev: (qg.to(dev), ag.to(dev))
                        for dev in mesh.local_devices}
        del q_parts, a_parts
        sync(mesh)
    with ts._section(timer, "kernel"):
        bits = {}
        for s in mine:
            qg, auxg = gathered[devices[s]]
            bits[s] = panel_ops.panel_score_bits_int8(
                qg, qg, auxg, auxg, bi[s], bj[s], (0, 0), tau_eff, tm, tn,
                valid=valid[s],
            )
        sync(mesh)
    with ts._section(timer, "compact"):
        found = [ts.compact_bits(*bits.pop(s), bi[s], bj[s], tm, tn,
                                 timer=timer)
                 if s in bits else None for s in range(mesh.size)]
        return share(found, mesh.ranks, mesh.lead, mesh)
