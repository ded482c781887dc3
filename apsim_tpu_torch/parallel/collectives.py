"""The mesh engines' collectives, over per-shard tensor lists.

The port's mesh (``parallel/mesh.py``) holds one tensor per shard, each on
its shard's device, where the JAX package runs ``jax.lax`` collectives
inside ``shard_map``.  These functions are the only code that moves data
between shards (and ``sync`` the only one that waits for them).

**One process** (every mesh ``make_mesh`` gives): the lists hold every
shard's tensor and the results land on the device named.  Every sum is
exact in any order where the mesh engines take it exact: the int32 partial
dots of the panel join are bounded by the int8 gate (|D| <= 127^2 * max_nnz
< 2^30 for every partial sum, since a partial sum is the dot over a subset
of a row's entries), and the f32 ``l1q`` / ``nnz`` summands are integers
with ``l1q <= 127 * nnz < 2^24`` under the same gate.  The fp32 partial
scores are added left to right in shard order.

**Several processes** (a mesh from ``multihost.global_mesh``, whose shards
belong to different ranks of the ``torch.distributed`` world): pass the
mesh and the parts' shard ids; a list holds this process's shards' tensors
and None for the others'.  Every process must call the same collectives in
the same order with the same shard ids, which the engines derive from
host state every process holds.  Results:

  - ``psum(exact=True)`` for every process and ``pmax``: each process
    reduces its own parts, then one ``all_reduce``; every process
    receives the whole result.
  - every other ``psum`` (fp32 partial scores; any sum that one
    process's epilogue consumes): a chain in shard order.
    The owner of the first run of parts adds them left to right and
    broadcasts the running sum to the owner of the next run, which adds
    its own, and so on: the same additions in the same order as on one
    process, so the sum is bit for bit the single-process one (-0.0 and
    denormals included; a broadcast moves bits, not values).  The last
    owner broadcasts the sum to every process, or keeps it when ``to``
    names its shard.
  - ``all_gather`` and ``share``: each owner broadcasts its parts, packed
    into one byte buffer, after one ``all_reduce`` of their shapes.

Only ``broadcast`` and ``all_reduce`` are used, the two collectives every
backend runs.  With ``gloo`` the tensors travel through host memory
(copied there and back explicitly); with ``nccl`` they stay on the card.
A collective that fails raises; nothing is retried on another route.
``TRAFFIC`` counts the cross-process calls, their payload bytes (per
process) and their seconds (each call ends with its devices idle).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

__all__ = ["psum", "pmax", "all_gather", "gather_rows", "share", "sync",
           "as_mesh", "sum_home", "TRAFFIC", "reset_traffic"]

TRAFFIC = {"calls": 0, "bytes": 0, "seconds": 0.0}

# dtypes a part may have; a shape exchange names them by position
_DTYPES = (torch.float32, torch.int32, torch.int64, torch.int8, torch.uint8,
           torch.bfloat16, torch.float64, torch.bool, torch.float16,
           torch.int16)
_MAX_DIMS = 4
_ALIGN = 16  # byte alignment of each part inside a packed buffer


def reset_traffic() -> None:
    TRAFFIC.update(calls=0, bytes=0, seconds=0.0)


def as_mesh(devices):
    """A ``Mesh`` as it is; a device sequence as a one-process mesh."""
    from .mesh import Mesh

    if isinstance(devices, Mesh):
        return devices
    return Mesh(tuple(torch.device(d) for d in devices))


def _multi(mesh) -> bool:
    return mesh is not None and mesh.n_procs > 1


def sum_home(mesh) -> int:
    """The shard on whose device a sum over every shard ends: the lead's
    on one process, the last shard's across processes (where the
    shard-order chain of ``psum`` ends)."""
    return mesh.size - 1 if _multi(mesh) else 0


def _dist():
    import torch.distributed as dist

    return dist


def _wire(device) -> torch.device:
    """Where a collective's tensors live: host memory under ``gloo``, the
    device itself under ``nccl``."""
    if _dist().get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device(device)


def _idle(devices) -> None:
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class _Call:
    """One cross-process call: its devices idle at both ends, its payload
    and its seconds added to ``TRAFFIC``."""

    def __init__(self, device, nbytes: int = 0):
        self.device, self.nbytes = device, nbytes

    def __enter__(self):
        _idle([self.device])
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _idle([self.device])
        TRAFFIC["calls"] += 1
        TRAFFIC["bytes"] += int(self.nbytes)
        TRAFFIC["seconds"] += time.perf_counter() - self.t0
        return False


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` where the backend moves it: pinned host memory
    under ``gloo`` for a CUDA tensor (torch caches pinned blocks, and the
    copies run at the link's rate), else ``t``'s own device."""
    wire = _wire(t.device)
    if wire.type == "cpu" and t.is_cuda:
        w = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return w.copy_(t)
    return t.to(wire, copy=True)


def _all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced over every process (a fresh tensor on ``t``'s
    device)."""
    dist = _dist()
    with _Call(t.device, t.numel() * t.element_size()):
        w = _staged(t)
        dist.all_reduce(w, op=getattr(dist.ReduceOp, op))
        return w.to(t.device)


def _broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` (meaningful on ``src``) on every process, same device."""
    dist = _dist()
    with _Call(t.device, t.numel() * t.element_size()):
        w = _staged(t)
        dist.broadcast(w, src=src)
        return w.to(t.device)


def _shapes(parts, owners, device):
    """``(dtype, shape)`` of every part on every process: each owner
    writes its parts' entries, one ``all_reduce`` sums the table."""
    me = _dist().get_rank()
    table = torch.zeros((len(parts), 2 + _MAX_DIMS), dtype=torch.int64)
    for i, (p, o) in enumerate(zip(parts, owners)):
        if o != me:
            continue
        if p.dim() > _MAX_DIMS:
            raise ValueError(f"a shared part has {p.dim()} dims")
        table[i, 0] = _DTYPES.index(p.dtype) + 1
        table[i, 1] = p.dim()
        table[i, 2:2 + p.dim()] = torch.tensor(p.shape)
    table = _all_reduce(table.to(device), "SUM").cpu().tolist()
    return [(_DTYPES[int(row[0]) - 1], tuple(int(n) for n in row[2:2 + row[1]]))
            for row in table]


def _nbytes(dtype, shape) -> int:
    n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
        (), dtype=dtype).element_size()
    return -(-n // _ALIGN) * _ALIGN


def _exchange(parts, owners, device, need=None):
    """Every part on ``device`` in every process of ``need`` (default:
    all), None elsewhere.  ``parts[i]`` is this process's tensor where
    ``owners[i]`` is its rank.  An owner's parts travel in one broadcast
    of one packed byte buffer; an owner that is the only process in
    ``need`` sends nothing."""
    dist = _dist()
    me, world = dist.get_rank(), dist.get_world_size()
    need = set(range(world)) if need is None else set(need)
    out = [None] * len(parts)
    if all(need <= {o} for o in owners):  # nobody needs another's part
        for i, o in enumerate(owners):
            if o == me and me in need:
                out[i] = parts[i].to(device)
        return out if me in need else None
    meta = _shapes(parts, owners, device)
    for g in dict.fromkeys(owners):
        idx = [i for i, o in enumerate(owners) if o == g]
        if need <= {g}:
            if me == g:
                for i in idx:
                    out[i] = parts[i].to(device)
            continue
        sizes = [_nbytes(*meta[i]) for i in idx]
        buf = torch.zeros(sum(sizes), dtype=torch.uint8, device=device)
        offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        if me == g:
            for i, a in zip(idx, offs):
                flat = parts[i].to(device).contiguous().reshape(-1)
                raw = flat.view(torch.uint8)
                buf[a:a + raw.numel()] = raw
        buf = _broadcast(buf, g)
        if me in need:
            for i, a in zip(idx, offs):
                dtype, shape = meta[i]
                n = _nbytes(dtype, shape)
                cells = int(np.prod(shape, dtype=np.int64))
                out[i] = buf[a:a + n].view(dtype)[:cells].reshape(shape)
    return out if me in need else None


def _owners(mesh, shards, n: int):
    shards = range(n) if shards is None else shards
    return [mesh.ranks[s] for s in shards]


def psum(parts: Sequence, device, mesh=None, shards=None,
         exact: bool = False, to: int | None = None):
    """Sum of the shards' tensors, on ``device``.

    One process: a one-shard sum is that shard's tensor, moved (no copy
    when it is already there); more shards add left to right.  Several
    processes (``mesh`` and the parts' ``shards``): a sum for every
    process that is ``exact`` (int32, or fp32 of integers below 2^24) is
    pre-summed per process and all-reduced; any other runs the
    shard-order chain (module docstring), whose result lands on every
    process, or only on the owner of shard ``to`` (None elsewhere): one
    copy of the sum crosses each hop, half an all-reduce's traffic."""
    if not _multi(mesh):
        out = parts[0].to(device)
        if len(parts) == 1:
            return out
        out = out + parts[1].to(device)
        for p in parts[2:]:
            out += p.to(device)
        return out
    me = mesh.rank
    owners = _owners(mesh, shards, len(parts))
    if exact and to is None:
        local = _local_reduce(parts, owners, device, torch.add, 0)
        return _all_reduce(local, "SUM")
    runs = []  # (owner, part indices) in shard order
    for i, o in enumerate(owners):
        if runs and runs[-1][0] == o:
            runs[-1][1].append(i)
        else:
            runs.append((o, [i]))
    dest = None if to is None else {mesh.ranks[to]}
    acc = None
    for k, (o, idx) in enumerate(runs):
        if me == o:
            for i in idx:
                p = parts[i].to(device)
                acc = p if acc is None else acc + p
        last = k == len(runs) - 1
        if last and (dest is None or dest != {o}):
            shown = [acc] if me == o else [None]
            got = _exchange(shown, [o], device, dest)
            acc = None if got is None else got[0]
        elif not last and runs[k + 1][0] != o:
            nxt = runs[k + 1][0]
            got = _exchange([acc] if me == o else [None], [o], device, {nxt})
            acc = got[0] if me == nxt else None
    if dest is not None and me not in dest:
        return None
    return acc


def pmax(parts: Sequence, device, mesh=None, shards=None):
    """Elementwise maximum of the shards' tensors, on ``device`` (exact in
    any order: each process's own maximum, then one ``all_reduce``)."""
    if not _multi(mesh):
        out = parts[0].to(device)
        for p in parts[1:]:
            out = torch.maximum(out, p.to(device))
        return out
    owners = _owners(mesh, shards, len(parts))
    local = _local_reduce(parts, owners, device, torch.maximum,
                          -float("inf"))
    return _all_reduce(local, "MAX")


def _local_reduce(parts, owners, device, op, identity) -> torch.Tensor:
    """This process's parts reduced by ``op`` (a fresh tensor on
    ``device``); a process owning none holds ``identity`` in their shape,
    which a shape exchange gives, entered by every process when the
    owners (which every process knows) leave some process out."""
    dist = _dist()
    me = dist.get_rank()
    meta = None
    if set(range(dist.get_world_size())) - set(owners):
        meta = _shapes(parts, owners, device)
    mine = [p for p, o in zip(parts, owners) if o == me]
    if not mine:
        dtype, shape = meta[0]
        return torch.full(shape, identity, dtype=dtype, device=device)
    local = mine[0].to(device, copy=True)
    for p in mine[1:]:
        local = op(local, p.to(device))
    return local


def all_gather(parts: Sequence, dim: int, device, mesh=None, shards=None,
               need=None):
    """The shards' tensors concatenated along ``dim`` in shard order
    (``jax.lax.all_gather(..., tiled=True)``), on ``device``.  Several
    processes: on every process whose rank owns a shard of ``need`` (a
    set of shard ids; default every process), None elsewhere."""
    if not _multi(mesh):
        return torch.cat([p.to(device) for p in parts], dim=dim)
    owners = _owners(mesh, shards, len(parts))
    ranks = None if need is None else {mesh.ranks[s] for s in need}
    got = _exchange(list(parts), owners, device, ranks)
    return None if got is None else torch.cat(got, dim=dim)


_PEER_STREAMS: dict = {}  # (source card, destination card) -> stream


def _peer_stream(src: torch.device, dst: torch.device):
    """A side stream on the source card of one (source, destination) card
    pair, made once, so that no copy waits for work queued on either
    card's current stream after it."""
    key = (src.index, dst.index)
    if key not in _PEER_STREAMS:
        _PEER_STREAMS[key] = torch.cuda.Stream(src)
    return _PEER_STREAMS[key]


def _peer_copy(dst: torch.Tensor, src: torch.Tensor, stream) -> None:
    """Queue the copy of ``src`` into contiguous ``dst`` (another card) on
    ``stream``, a stream of ``src``'s card: one asynchronous peer copy of
    the runtime (``peer_copy`` of ``csrc/score_bits.cu``), the copy
    engines' work that torch's ``copy_`` between cards queues, without its
    events and stream switches.  A ``src`` that is not contiguous (the
    rows of a column slice of a wider tensor) is first made so on its own
    card, on ``stream``."""
    from ..ops._build import kernels

    if not src.is_contiguous():
        with torch.cuda.stream(stream):
            src = src.contiguous()
    rc = kernels().peer_copy(dst.data_ptr(), dst.device.index,
                             src.data_ptr(), src.device.index,
                             src.numel() * src.element_size(),
                             stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"peer copy failed: CUDA error {rc}")


def gather_rows(parts: Sequence, bounds: Sequence, devices: Sequence,
                stats: dict | None = None, wait: bool = True):
    """The shards' tensors cut into row slices, each slice on its own
    device (one process): for slice ``k``, rows ``bounds[k] = (a, b)`` of
    every part, in shard order, on ``devices[k]``.  A part already there
    gives a view; any other crosses as a copy of its rows.  A
    reduce-scatter by rows
    that leaves the adds to the reader: each row of each part travels
    once, to the one device that sums it.  With a ``stats`` dict, the
    bytes of every copy from one card to another are added to
    ``stats["peer_copy_bytes"]`` (a view adds nothing).

    Copies between cards run at once, each (source, destination) pair on
    a side stream of its own (``_peer_stream``) that first waits for both
    cards' current streams; each destination's current stream then waits
    for its copies, so work queued there afterwards reads them.  With
    ``wait=False`` no stream waits: the result is ``(slices, events)``,
    ``events[k]`` the copies' completion events on slice ``k``'s
    destination (empty where nothing crossed), and the caller makes that
    device's stream wait for them before it reads the slice
    (``torch.cuda.current_stream(dev).wait_event``), so work queued there
    meanwhile runs beside the copies."""
    out, events, marks = [], [], {}

    def mark(dev):
        """An event at the end of ``dev``'s current stream, made once."""
        if dev not in marks:
            marks[dev] = torch.cuda.current_stream(dev).record_event()
        return marks[dev]

    for (a, b), dev in zip(bounds, devices):
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        row, copied = [], []
        for p in parts:
            part = p[a:b]
            if part.device == dev or "cpu" in (dev.type, part.device.type):
                row.append(part.to(dev))
                continue
            stream = _peer_stream(part.device, dev)
            stream.wait_event(mark(part.device))
            stream.wait_event(mark(dev))  # ``got``'s memory is free there
            got = torch.empty(part.shape, dtype=part.dtype, device=dev)
            _peer_copy(got, part, stream)
            part.record_stream(stream)  # the source's memory stays until then
            copied.append(stream.record_event())
            if stats is not None:
                stats["peer_copy_bytes"] += got.numel() * got.element_size()
            row.append(got)
        out.append(row)
        events.append((dev, copied))
    if not wait:
        return out, [copied for _, copied in events]
    for dev, copied in events:
        for done in copied:
            torch.cuda.current_stream(dev).wait_event(done)
    return out


def share(outs: Sequence, owners: Sequence[int], device, mesh=None,
          arity: int = 2) -> list:
    """Per-item outputs computed where they are owned, on every process:
    ``outs[i]`` is a tuple of ``arity`` tensors on the process of rank
    ``owners[i]`` (None elsewhere).  One process: ``outs`` as given."""
    if not _multi(mesh):
        return list(outs)
    flat, flat_owners = [], []
    for o, own in zip(outs, owners):
        for k in range(arity):
            flat.append(None if o is None else o[k])
            flat_owners.append(own)
    got = _exchange(flat, flat_owners, device)
    return [tuple(got[i * arity:(i + 1) * arity]) for i in range(len(outs))]


def sync(devices) -> None:
    """Wait for every CUDA device among ``devices`` (each once); a mesh
    names its shards' devices on this process only."""
    if hasattr(devices, "local_devices"):
        devices = devices.local_devices
    _idle(devices)
