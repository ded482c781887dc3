"""Multi-process bring-up over ``torch.distributed``: the counterpart of
``apsim_tpu/parallel/multihost.py``.

The reference joins nodes into an Akka cluster via seed nodes
(conf/akka.conf:10-15).  Here every process dials the coordinator's
``torch.distributed`` store, after which ``global_mesh`` lays one mesh over
the devices of every process, in rank order, and the same
:class:`~apsim_tpu_torch.parallel.mesh.MeshEngine` and
:class:`~apsim_tpu_torch.parallel.chunked_mesh.MeshChunkedAllPairs` code
runs in each: every process holds and computes its own shards, and the
collectives of ``parallel/collectives.py`` cross processes.  The host side
(the shadow CSR, the id maps, the maxima) is whole in every process, as in
the JAX engine.  Processes advance in lockstep: each must make the same
engine calls in the same order, which ``serve/replica.py``'s op log
arranges for a served index.

Placement is static, as under JAX: hosts run the ingest service
(``serve/``) and share one global mesh.
"""

from __future__ import annotations

import os

import torch

from .mesh import Mesh, make_mesh

__all__ = ["init_multihost", "global_mesh", "is_coordinator"]


def _dist():
    import torch.distributed as dist

    return dist


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the multi-process group (idempotent; a no-op without a
    coordinator address).

    Arguments default to torch's own variables, as ``torchrun`` sets them:
    ``MASTER_ADDR`` and ``MASTER_PORT`` for the coordinator's
    ``HOST:PORT``, ``WORLD_SIZE``, ``RANK``.  ``backend`` defaults to
    ``nccl`` when this process has CUDA and ``gloo`` otherwise; it is
    never switched after a failure (NCCL refuses two ranks on one card:
    name ``gloo`` for them)."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return  # one process: nothing to join
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    dist = _dist()
    if dist.is_initialized():
        return  # a second init_process_group would raise
    if num_processes is None or process_id is None:
        raise ValueError("init_multihost needs the process count and this "
                         "process's rank (or WORLD_SIZE and RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
    )


def _local_devices(devices):
    """This process's devices: ``devices`` as given, else its card
    (``LOCAL_RANK``, else its rank, modulo the visible cards); without
    CUDA this raises, it never falls back to the CPU."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "global_mesh: no CUDA device; pass devices= for a CPU mesh"
        )
    local = int(os.environ.get("LOCAL_RANK", _dist().get_rank()))
    return [torch.device("cuda", local % torch.cuda.device_count())]


def global_mesh(shape=None, devices=None) -> Mesh:
    """A mesh over every device of every joined process, in rank order.

    ``devices`` are this process's (default: its card; see
    ``_local_devices``), which may repeat a device to put several shards
    on it.  Outside a process group this is ``make_mesh(shape, devices)``
    (every visible card by default).  ``shape`` as ``make_mesh``'s; every
    process must own a shard of it."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(shape, devices=devices)
    local = _local_devices(devices)
    if local[0].type == "cuda" and dist.get_backend() == "nccl":
        torch.cuda.set_device(local[0])
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [str(d) for d in local])
    all_devices, ranks = [], []
    for r, names in enumerate(per_rank):
        all_devices += [torch.device(n) for n in names]
        ranks += [r] * len(names)
    n = make_mesh(shape, devices=all_devices)
    k = n.size
    return Mesh(n.devices, n.shape, tuple(ranks[:k]), dist.get_rank())


def is_coordinator() -> bool:
    """Rank 0 (and a process outside any group)."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return True
    return dist.get_rank() == 0
