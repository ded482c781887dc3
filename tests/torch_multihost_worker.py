"""Worker process of the multi-process ``torch.distributed`` tests of the
PyTorch port (``tests/test_torch_multihost.py``; pytest does not collect
it).

Each of the two (or ``world``) processes owns 4 (8 / world) CPU shards;
together they form one 8-shard global mesh over a ``gloo`` group.  Every
process builds the same corpus (the 86 vectors of
``tests/multihost_worker.py``) and runs every step in the same order;
each also runs the same steps on a one-process 8-shard mesh of its own,
and every result of the global mesh must equal that mesh's bit for bit
(candidate lists, insert outputs, top-k lists) and the fp64 oracle's pair
set.

Usage: python torch_multihost_worker.py <coordinator_port> <rank> <mode>
[<world>] with mode ``dims`` or ``rows`` (the cluster steps) or
``collectives`` (two processes).
"""

import sys

port, rank, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
world = int(sys.argv[4]) if len(sys.argv) > 4 else 2
per = 8 // world

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from apsim_tpu_torch.parallel import (  # noqa: E402
    global_mesh,
    init_multihost,
    is_coordinator,
    make_mesh,
)

torch.set_num_threads(2)  # two processes share the test machine
init_multihost(f"127.0.0.1:{port}", num_processes=world, process_id=rank,
               backend="gloo")
assert dist.get_world_size() == world and dist.get_backend() == "gloo"
MESH = global_mesh((8,), devices=["cpu"] * per)
assert MESH.ranks == tuple(r for r in range(world) for _ in range(per))
assert MESH.local_shards == tuple(range(per * rank, per * rank + per))
ONE = make_mesh(8, devices=["cpu"] * 8)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def collectives() -> None:
    """psum / pmax / all_gather / share across the two ranks against the
    one-process results, bit for bit: fp32 partials with -0.0, denormals,
    values of mixed sign and magnitude."""
    from apsim_tpu_torch.parallel import collectives as co

    rng = np.random.default_rng(17)
    parts = []
    for s in range(8):
        a = rng.standard_normal((33, 7)).astype(np.float32)
        a[rng.random(a.shape) < 0.2] = -0.0
        a[rng.random(a.shape) < 0.1] = np.float32(1.4e-42) * rng.choice(
            [-1.0, 1.0])
        a *= np.float32(10.0) ** rng.integers(-6, 7, a.shape).astype(
            np.float32)
        a[0, :3] = -0.0  # -0.0 in every part: the sum must stay -0.0
        a[1, :] = np.float32(1.4e-42) * (s - 3.5)  # denormals only
        parts.append(torch.from_numpy(a))
    mine = [p if MESH.is_local(s) else None for s, p in enumerate(parts)]
    want = co.psum(parts, "cpu")
    got = co.psum(mine, "cpu", MESH, list(range(8)))
    assert np.array_equal(bits(got), bits(want))
    assert (bits(want) == bits(torch.tensor(-0.0))).any()  # -0.0 survives
    # the chain ends where ``to`` names, and nowhere else
    for to in (3, 7):
        got = co.psum(mine, "cpu", MESH, list(range(8)), to=to)
        assert (got is None) == (not MESH.is_local(to))
        if got is not None:
            assert np.array_equal(bits(got), bits(want))
    # sums over a subset of the shards, each run ending on either rank
    for sub in ([2, 3, 4], [5, 6], [0, 1], [1, 4, 6, 7]):
        want = co.psum([parts[s] for s in sub], "cpu")
        got = co.psum([mine[s] for s in sub], "cpu", MESH, sub)
        assert np.array_equal(bits(got), bits(want)), sub
    ints = [torch.from_numpy(rng.integers(-2**26, 2**26, (9, 5)).astype(
        np.int32)) for _ in range(8)]
    imine = [t if MESH.is_local(s) else None for s, t in enumerate(ints)]
    assert torch.equal(co.psum(imine, "cpu", MESH, exact=True),
                       co.psum(ints, "cpu"))
    assert torch.equal(co.pmax(mine, "cpu", MESH), co.pmax(parts, "cpu"))
    # reductions over shards of one rank: the other rank holds none and
    # takes their shape from the exchange both enter
    for sub in ([0, 1], [5, 6]):
        assert torch.equal(
            co.psum([imine[s] for s in sub], "cpu", MESH, sub, exact=True),
            co.psum([ints[s] for s in sub], "cpu"))
        assert torch.equal(co.pmax([mine[s] for s in sub], "cpu", MESH, sub),
                           co.pmax([parts[s] for s in sub], "cpu"))
    assert torch.equal(co.all_gather(mine, 0, "cpu", MESH),
                       co.all_gather(parts, 0, "cpu"))
    out = co.share([(p, p[:3]) if p is not None else None for p in mine],
                   list(MESH.ranks), "cpu", MESH)
    for (a, b), p in zip(out, parts):
        assert np.array_equal(bits(a), bits(p))
        assert np.array_equal(bits(b), bits(p[:3]))


def corpus():
    from apsim_tpu_torch.vector.batch import CSRMatrix
    from apsim_tpu_torch.vector.sparse import SparseVector

    rng = np.random.default_rng(5)
    vecs = []
    for _ in range(80):
        nnz = int(rng.integers(4, 10))
        dims = np.sort(rng.choice(500, nnz, replace=False)).astype(np.int32)
        vals = rng.random(nnz) + 0.1
        vals /= np.linalg.norm(vals)
        vecs.append(SparseVector(500, dims, vals))
    for i in range(6):  # a non-trivial pair set: exact duplicates
        vecs.append(vecs[i])
    return vecs, CSRMatrix.from_vectors(vecs, 500)


def oracle(csr, tau: float) -> set:
    dense = csr.to_dense()
    s = dense @ dense.T
    oi, oj = np.nonzero(np.triu(s >= tau, k=1))
    return set(zip(oi.tolist(), oj.tolist()))


def index_pairs(res) -> set:
    return set(zip(res.i.tolist(), res.j.tolist()))


def candidates(eng) -> tuple:
    tau_eff = eng._tau_eff(0.5)
    if hasattr(eng, "_panel_ok"):
        pairs = (eng._all_pairs_panel(tau_eff) if eng._panel_ok()
                 else eng._all_pairs_stripes(tau_eff))
    else:
        pairs = (eng._all_pairs_kernel(tau_eff) if eng._kernel_ok()
                 else eng._all_pairs_rect(tau_eff))
    return tuple(np.asarray(p) for p in pairs)


def same_steps(make, vecs, csr, label: str) -> None:
    """Build, join, stream, top-k, frozen match on the global mesh and on
    the one-process mesh; every result equal."""
    from apsim_tpu_torch.vector.batch import CSRMatrix

    engines = [make(MESH), make(ONE)]
    want = oracle(csr, 0.5)
    assert len(want) >= 6, len(want)
    for e in engines:
        e.build(csr)
    res = [e.all_pairs(0.5) for e in engines]
    assert index_pairs(res[0]) == index_pairs(res[1]) == want, label
    c0, c1 = candidates(engines[0]), candidates(engines[1])
    assert all(np.array_equal(a, b) for a, b in zip(c0, c1)), label
    # stream 56 more rows in batches of 1, 7 and 48 (the dense mesh's
    # row capacity grows past 128: rows move between row blocks, some
    # across the two processes)
    rng = np.random.default_rng(9)
    extra = [vecs[int(i)] for i in rng.integers(0, len(vecs), 56)]
    n0, k = len(vecs), 0
    for bs in (1, 7, 48):
        batch = [(f"x{n0 + k + i}", v) for i, v in enumerate(
            extra[k:k + bs])]
        outs = [e.insert(batch, tau=0.5).output for e in engines]
        assert outs[0] == outs[1] and outs[0], (label, bs)
        k += bs
    assert engines[0].row_cap == engines[1].row_cap
    every = CSRMatrix.from_vectors(vecs + extra, 500)
    res = [e.all_pairs(0.5) for e in engines]
    assert index_pairs(res[0]) == index_pairs(res[1]) == oracle(every, 0.5)
    c0, c1 = candidates(engines[0]), candidates(engines[1])
    assert all(np.array_equal(a, b) for a, b in zip(c0, c1)), label
    queries = [(f"q{i}", vecs[i]) for i in range(0, 86, 5)]
    tops = [e.topk(queries, 4) for e in engines]
    assert tops[0] == tops[1], label
    for e in engines:
        e.freeze()
    fro = [e.insert(queries[:6], tau=0.5).output for e in engines]
    assert fro[0] == fro[1] and all(fro[0].values()), label
    assert engines[0].n_rows == len(vecs) + len(extra)


def same_join(make, csr, label: str) -> None:
    """Build and join on the global mesh and on the one-process mesh: the
    candidate lists equal, the pair sets the oracle's."""
    engines = [make(MESH), make(ONE)]
    for e in engines:
        e.build(csr)
    res = [e.all_pairs(0.5) for e in engines]
    assert index_pairs(res[0]) == index_pairs(res[1]) == oracle(csr, 0.5)
    c0, c1 = candidates(engines[0]), candidates(engines[1])
    assert c0[0].size and all(
        np.array_equal(a, b) for a, b in zip(c0, c1)), label


def cluster(shard_axis: str) -> int:
    from apsim_tpu_torch import AllPairsConfig
    from apsim_tpu_torch.parallel import MeshChunkedAllPairs, MeshEngine
    from apsim_tpu_torch.parallel.collectives import TRAFFIC

    vecs, csr = corpus()
    # "on": the rows mesh's kernel path (kernel 3, its plain version on
    # the CPU); "auto" takes it on the card only
    cfg = AllPairsConfig(
        vector_dim=500, query_tile=32, row_bucket=32, dim_bucket=64,
        shard_axis=shard_axis, use_pallas="on",
    )
    same_steps(lambda m: MeshEngine(cfg, mesh=m), vecs, csr,
               f"MeshEngine {shard_axis}")
    if shard_axis == "dims":
        same_steps(lambda m: MeshChunkedAllPairs(cfg, mesh=m, chunk_dim=16),
                   vecs, csr, "MeshChunkedAllPairs")
        # the stripe joins: fp32 partial stripes, and int8 stripes (kernel
        # 4's plain version here) with exact int32 partials
        off = cfg.replace(use_pallas="off")
        same_join(lambda m: MeshChunkedAllPairs(off, mesh=m, chunk_dim=16),
                  csr, "fp32 stripes")

        def int8_stripes(m):
            e = MeshChunkedAllPairs(off, mesh=m, chunk_dim=16)
            e._int8_stripes = True
            return e

        same_join(int8_stripes, csr, "int8 stripes")
    else:
        # the rows layout's rectangle join, and a 2-D mesh: row block r
        # on rank r, its 4 column blocks summed within the rank
        same_join(lambda m: MeshEngine(cfg.replace(use_pallas="off"),
                                       mesh=m), csr, "rows rectangle")
        grid = global_mesh((2, 4), devices=["cpu"] * per)
        same_join(lambda m: MeshEngine(cfg, mesh=grid if m is MESH else
                                       make_mesh((2, 4), ["cpu"] * 8)),
                  csr, "2-D mesh")
    assert TRAFFIC["calls"] > 0 and TRAFFIC["bytes"] > 0
    return len(oracle(csr, 0.5))


if mode == "collectives":
    collectives()
    n = 0
else:
    n = cluster(mode)
if is_coordinator():
    print(f"TORCH_MULTIHOST_OK mode={mode} pairs={n}", flush=True)
dist.destroy_process_group()
