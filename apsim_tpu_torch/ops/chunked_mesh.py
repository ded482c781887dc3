"""The stripe join over a mesh: the counterpart of the stripe functions of
``apsim_tpu/ops/chunked_mesh.py``.

The mesh chunked engine shards the chunk axis of its entry buffers, so one
query stripe's score is a sum over shards: every shard runs the chunk loop
of ``ops/chunked.py`` over its own chunks into a partial
``[row_cap, super_tile]`` accumulator on its device (fp32 from bf16 or fp32
slabs, or exact int32 through kernel 4), the partials are summed onto the
lead device (``psum``), and the one epilogue and compaction run there.  The
int32 sum is exact in any order; the fp32 sum adds one rounding per shard
to a row's accumulation, inside the engine's margin like any other order
of the same additions.  The JAX functions replicate the epilogue on every
device; this computes it once.
"""

from __future__ import annotations

from ..parallel.collectives import psum, sync
from . import chunked as chunked_ops
from . import tri_score as ts

__all__ = ["mesh_stripe_extract", "mesh_stripe_extract_int8"]


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
