"""The mesh engines' collectives, over per-shard tensor lists.

The port's mesh is single-controller (``parallel/mesh.py``): one process
holds one tensor per shard, each on its shard's device, where the JAX
package runs ``jax.lax`` collectives inside ``shard_map``.  These three
functions are the only code that moves data between shards (and ``sync``
the only one that waits for them), so a
multi-process backend (``torch.distributed`` over NCCL) replaces them here
and nowhere else.

Every sum they take is exact in any order: the int32 partial dots of the
panel join are bounded by the int8 gate (|D| <= 127^2 * max_nnz < 2^30 for
every partial sum, since a partial sum is the dot over a subset of a row's
entries), and the f32 ``l1q`` / ``nnz`` summands are integers with
``l1q <= 127 * nnz < 2^24`` under the same gate.  So the results are
bit-identical to ``jax.lax.psum`` / ``pmax`` / ``all_gather``.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["psum", "pmax", "all_gather", "sync"]


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Sum of the shards' tensors, on ``device`` (the mesh's lead device).
    A one-shard sum is that shard's tensor, moved (no copy when it is
    already there)."""
    out = parts[0].to(device)
    if len(parts) == 1:
        return out
    out = out + parts[1].to(device)
    for p in parts[2:]:
        out += p.to(device)
    return out


def pmax(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Elementwise maximum of the shards' tensors, on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(device))
    return out


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               device) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` in shard order
    (``jax.lax.all_gather(..., tiled=True)``), on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def sync(devices: Sequence[torch.device]) -> None:
    """Wait for every CUDA device among ``devices`` (each once)."""
    for dev in dict.fromkeys(d for d in devices if d.type == "cuda"):
        torch.cuda.synchronize(dev)
