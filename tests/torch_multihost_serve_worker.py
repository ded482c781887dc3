"""Worker of the two-process serving test of the PyTorch port
(``tests/test_torch_multihost.py``; pytest does not collect it).

Rank 0: joins the two-process ``gloo`` group, wraps a ``MeshEngine`` over
the global mesh (4 CPU shards a rank, dims layout) in the replicated op
log (``serve/replica.py``, listening on a port the system picks, sent to
rank 1 through the group), runs the public ``RpcServer`` and drives it as
a client over TCP: streaming inserts, then an ``all_pairs`` that must equal
the fp64 oracle.

Rank 1: joins the group and replays the op log; its replay is the
matching entry into every collective of the global mesh, and it must end
with the same corpus.

Usage: python torch_multihost_serve_worker.py <coordinator_port> <rank>
"""

import sys

port, rank = sys.argv[1], int(sys.argv[2])

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from apsim_tpu_torch import AllPairsConfig  # noqa: E402
from apsim_tpu_torch.parallel import (  # noqa: E402
    MeshEngine,
    global_mesh,
    init_multihost,
)
from apsim_tpu_torch.serve.replica import OpLogLeader, follow  # noqa: E402
from apsim_tpu_torch.vector.batch import CSRMatrix  # noqa: E402
from apsim_tpu_torch.vector.sparse import SparseVector  # noqa: E402

torch.set_num_threads(2)  # two processes share the test machine
init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
               backend="gloo")

rng = np.random.default_rng(7)
vecs = []
for _ in range(60):
    nnz = int(rng.integers(4, 10))
    dims = np.sort(rng.choice(400, nnz, replace=False)).astype(np.int32)
    vals = rng.random(nnz) + 0.1
    vals /= np.linalg.norm(vals)
    vecs.append(SparseVector(400, dims, vals))
for i in range(5):
    vecs.append(vecs[i])  # guaranteed pairs
csr = CSRMatrix.from_vectors(vecs, 400)
TAU = 0.5

cfg = AllPairsConfig(
    vector_dim=400, query_tile=32, row_bucket=32, dim_bucket=64,
    shard_axis="dims", io_trigger_period_ms=5,
)
eng = MeshEngine(cfg, mesh=global_mesh((8,), devices=["cpu"] * 4))
repl = torch.zeros(1, dtype=torch.int64)

if rank == 0:
    from apsim_tpu_torch.serve import (ClientConnection, RpcServer,
                                       SimilarityServer)

    leader = OpLogLeader(eng, port=0, n_followers=1)
    repl[0] = leader.port
    dist.broadcast(repl, src=0)
    leader.wait_followers()
    sim = SimilarityServer(leader, cfg, device="cpu")
    with RpcServer(sim, port=0) as rpc:
        cc = ClientConnection([f"{rpc.host}:{rpc.port}"])
        for s in range(0, len(vecs), 16):  # the corpus over the RPC surface
            cc.insert_new_vector(
                [(str(i), vecs[i]) for i in range(s, min(s + 16, len(vecs)))]
            )
        cc.flush()
        served = cc.all_pairs(TAU)
        got = {tuple(sorted((a, b), key=int)) for a, b, _ in served}
        dense = csr.to_dense()
        s_mat = dense @ dense.T
        oi, oj = np.nonzero(np.triu(s_mat >= TAU, k=1))
        want = {(str(a), str(b)) for a, b in zip(oi.tolist(), oj.tolist())}
        assert len(want) >= 5, len(want)
        assert got == want, (len(got), len(want))
        assert sim.stats()["n_rows"] == len(vecs)
        cc.close()
    leader.close()
    print(f"TORCH_MULTIHOST_SERVE_OK pairs={len(got)}", flush=True)
else:
    dist.broadcast(repl, src=0)
    n_ops, clean = follow(eng, "127.0.0.1", int(repl[0]))
    assert clean, "leader should have shut down explicitly"
    # the replica converged to the same corpus through log replay alone
    # (the server's flusher coalesces RPC batches: at least one insert
    # and the all_pairs)
    assert eng.n_rows == len(vecs), (eng.n_rows, len(vecs))
    assert n_ops >= 2, n_ops
    print(f"TORCH_FOLLOWER_OK ops={n_ops}", flush=True)

dist.destroy_process_group()
