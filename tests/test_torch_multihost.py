"""Multi-process serving on the PyTorch port, on the CPU: the one-process
no-op, two-process ``torch.distributed`` (``gloo``) clusters running both
mesh engines over one global mesh, the cross-process collectives bit for
bit, the replicated op log behind the RPC server, and ``serve
--replicate`` from the command line (the counterparts of
``tests/test_multihost.py``).

The two-process tests spawn fresh interpreters (``torch_multihost_worker.py``
and ``torch_multihost_serve_worker.py`` beside this file), each owning 4 CPU
shards of an 8-shard mesh.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from apsim_tpu_torch.parallel import (global_mesh, init_multihost,
                                      is_coordinator, make_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
SERVE_WORKER = os.path.join(REPO, "tests", "torch_multihost_serve_worker.py")
TIMEOUT = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    return env


def _run_pair(argv_of, world: int = 2) -> list:
    """Start the ``world`` ranks, wait for all; their outputs."""
    procs = [subprocess.Popen(argv_of(rank), env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_single_host_noop(monkeypatch):
    """Without a coordinator address ``init_multihost`` joins nothing;
    this process is the coordinator and ``global_mesh`` is ``make_mesh``
    (on the CPU only when asked)."""
    import torch
    import torch.distributed as dist

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    init_multihost()  # must not raise or try to dial anything
    init_multihost(backend="gloo")
    assert not dist.is_initialized()
    assert is_coordinator()
    mesh = global_mesh(devices=["cpu"] * 4)
    assert mesh == make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.n_procs == 1 and mesh.local_shards == (
        0, 1, 2, 3) and mesh.lead == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            global_mesh()


def test_cross_process_collectives_bit_for_bit():
    """fp32 partials with -0.0, denormals and mixed signs summed across two
    ranks equal the one-process ``psum`` bit for bit (whole, a subset of
    the shards, ending on either rank); the int32 ``psum``, ``pmax``,
    ``all_gather`` and ``share`` equal theirs."""
    port = _free_port()
    outs = _run_pair(lambda r: [sys.executable, WORKER, str(port), str(r),
                                "collectives"])
    assert "TORCH_MULTIHOST_OK mode=collectives" in outs[0], outs[0][-2000:]


@pytest.mark.parametrize("shard_axis", ["dims", "rows"])
def test_two_process_cluster(shard_axis):
    """``tests/multihost_worker.py``'s steps on the same 86 vectors over a
    two-process 8-shard mesh: ``MeshEngine`` build, join, insert (the rows
    layout on its kernel path, its row capacity growing across the
    processes), top-k and frozen match, then for dims
    ``MeshChunkedAllPairs`` with ``chunk_dim=16`` (and its fp32 and int8
    stripe joins), for rows the rectangle join and a ``(2, 4)`` mesh; the
    fp64 oracle's pair set and the one-process mesh's candidate lists,
    outputs and top-k lists bit for bit."""
    port = _free_port()
    outs = _run_pair(lambda r: [sys.executable, WORKER, str(port), str(r),
                                shard_axis])
    assert f"TORCH_MULTIHOST_OK mode={shard_axis} pairs=" in outs[0], (
        outs[0][-2000:])


@pytest.mark.parametrize("shard_axis", ["dims", "rows"])
def test_four_process_cluster(shard_axis):
    """The same steps over four ranks of 2 shards each: fp32 chains that
    cross three ranks, broadcasts that ranks outside a sum still enter,
    and for rows a ``(2, 4)`` mesh whose row blocks span two ranks."""
    port = _free_port()
    outs = _run_pair(lambda r: [sys.executable, WORKER, str(port), str(r),
                                shard_axis, "4"], world=4)
    assert f"TORCH_MULTIHOST_OK mode={shard_axis} pairs=" in outs[0], (
        outs[0][-2000:])


def test_two_process_serve_end_to_end():
    """RPC ingest -> replicated op log -> two-process global mesh -> pair
    set equal to the fp64 oracle; the follower replays to the same
    corpus."""
    port = _free_port()
    outs = _run_pair(lambda r: [sys.executable, SERVE_WORKER, str(port),
                                str(r)])
    assert "TORCH_MULTIHOST_SERVE_OK" in outs[0], outs[0][-3000:]
    assert "TORCH_FOLLOWER_OK" in outs[1], outs[1][-3000:]


def test_cli_multihost_serve_end_to_end(tmp_path):
    """``apsim-torch serve --mesh --replicate`` over a two-process group
    (``torchrun``'s variables, ``gloo`` for ``--device cpu``): rank 0
    serves RPC, rank 1 replays the op log; a client streams inserts and
    reads the exact join back; after SIGINT the follower says "leader
    closed" and exits 0."""
    from apsim_tpu_torch.serve import ClientConnection
    from apsim_tpu_torch.vector.batch import CSRMatrix
    from apsim_tpu_torch.vector.sparse import SparseVector

    coord, repl, rpc_port = _free_port(), _free_port(), _free_port()
    cfgfile = str(tmp_path / "cfg.json")
    with open(cfgfile, "w") as f:
        json.dump({"vector_dim": 300, "query_tile": 32, "row_bucket": 32,
                   "dim_bucket": 64, "io_trigger_period_ms": 5}, f)
    procs = []
    for rank in (0, 1):
        env = _env()
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(coord),
                   WORLD_SIZE="2", RANK=str(rank), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "apsim_tpu_torch.cli", "serve",
             "--config", cfgfile, "--mesh-shape", "4", "--device", "cpu",
             "--replicate", f"127.0.0.1:{repl}",
             "--host", "127.0.0.1", "--port", str(rpc_port)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    try:
        rng = np.random.default_rng(3)
        vecs = []
        for _ in range(24):
            nnz = int(rng.integers(4, 9))
            dims = np.sort(rng.choice(300, nnz, replace=False)).astype(
                np.int32)
            vals = rng.random(nnz) + 0.1
            vals /= np.linalg.norm(vals)
            vecs.append(SparseVector(300, dims, vals))
        vecs.append(vecs[0])  # guaranteed pair
        cc = None
        deadline = time.time() + TIMEOUT
        while time.time() < deadline:
            if any(p.poll() is not None for p in procs):
                break  # a server process died; its output is shown below
            try:
                cc = ClientConnection([f"127.0.0.1:{rpc_port}"], timeout=30)
                break
            except OSError:
                time.sleep(0.5)
        if cc is None:
            for p in procs:
                p.kill()
            outs = [p.communicate()[0] for p in procs]
            raise AssertionError("server never came up\n--- rank 0 ---\n"
                                 + outs[0][-2000:] + "\n--- rank 1 ---\n"
                                 + outs[1][-2000:])
        cc.insert_new_vector([(str(i), v) for i, v in enumerate(vecs)])
        cc.flush()
        served = cc.all_pairs(0.5)
        got = {tuple(sorted((a, b), key=int)) for a, b, _ in served}
        dense = CSRMatrix.from_vectors(vecs, 300).to_dense()
        s = dense @ dense.T
        oi, oj = np.nonzero(np.triu(s >= 0.5, k=1))
        want = {(str(a), str(b)) for a, b in zip(oi.tolist(), oj.tolist())}
        assert got == want and want, (len(got), len(want))
        cc.close()
    finally:
        procs[0].send_signal(signal.SIGINT)
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)
    assert procs[0].returncode == 0, outs[0][-3000:]
    assert procs[1].returncode == 0, outs[1][-3000:]
    assert "leader closed" in outs[1], outs[1][-2000:]
