"""The port's command line (``apsim_tpu_torch.cli``) and load generator on
the CPU: the first four cases of ``tests/test_cli_loadgen.py`` with
``--device cpu``; ``join`` and ``topk`` output against the JAX package's
CLI on the same store; and the refusal to run on the CPU unasked.

Tolerances: ``join`` prints the same pair lines (ids and similarity to six
decimals) as the JAX CLI, ``topk`` the same neighbour lists (four
decimals); ``build`` writes a checkpoint the JAX package restores.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import apsim_tpu
from apsim_tpu.cli import main as jax_cli
from apsim_tpu_torch import AllPairsConfig, Engine
from apsim_tpu_torch.bench.loadgen import LoadGenerator
from apsim_tpu_torch.cli import main as cli_main
from apsim_tpu_torch.etl.store import VectorStore
from apsim_tpu_torch.serve import ClientConnection, RpcServer, SimilarityServer
from apsim_tpu_torch.vector.batch import CSRMatrix

from oracle import random_sparse_corpus

DIM = 200
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_pt(csr):
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr, csr.indices,
                     csr.data)


def cpu_server(cfg):
    return SimilarityServer(Engine(cfg, "cpu"), cfg)


@pytest.fixture
def corpus_dir(tmp_path):
    d = tmp_path / "corpus" / "inbox"
    d.mkdir(parents=True)
    (d / "1.").write_text("alpha beta gamma alpha")
    (d / "2.").write_text("alpha beta gamma alpha")  # duplicate
    (d / "3.").write_text("delta epsilon zeta")
    return str(tmp_path / "corpus")


def test_cli_etl_build_join_topk(tmp_path, corpus_dir, capsys):
    store = str(tmp_path / "store")
    ckpt = str(tmp_path / "ckpt")
    cfgfile = str(tmp_path / "cfg.json")
    with open(cfgfile, "w") as f:
        json.dump({"vectorDim": 4096, "query_tile": 64, "row_bucket": 64,
                   "dim_bucket": 64}, f)
    cpu = ["--device", "cpu"]
    assert cli_main(
        ["etl", corpus_dir, "--store", store, "--table", "T",
         "--vector-dim", "4096", "--text-out", str(tmp_path / "vecs.txt")]
    ) == 0
    assert os.path.exists(str(tmp_path / "vecs.txt"))
    assert cli_main(
        ["build", "--config", cfgfile, "--store", store, "--table", "T",
         "--checkpoint", ckpt] + cpu) == 0
    assert cli_main(
        ["join", "--config", cfgfile, "--checkpoint", ckpt, "--tau", "0.9"]
        + cpu) == 0
    out = capsys.readouterr().out
    assert "inbox/1." in out and "inbox/2." in out
    assert cli_main(
        ["topk", "--config", cfgfile, "--checkpoint", ckpt,
         "--query-store", store, "--query-table", "T", "-k", "2"] + cpu) == 0
    out = capsys.readouterr().out
    assert "inbox/1." in out
    assert cli_main(
        ["join", "--config", cfgfile, "--checkpoint", ckpt, "--tau", "0.9",
         "--chunked"] + cpu) == 0
    out = capsys.readouterr().out
    assert "inbox/1." in out and "inbox/2." in out
    # mesh variants: a dense mesh from the store, the chunked mesh from
    # the checkpoint, a dense mesh from the checkpoint (8 shards of the CPU)
    for extra in (["--store", store, "--table", "T"],
                  ["--checkpoint", ckpt, "--chunked"],
                  ["--checkpoint", ckpt]):
        assert cli_main(
            ["join", "--config", cfgfile, "--tau", "0.9", "--mesh-shape",
             "8"] + extra + cpu) == 0
        out = capsys.readouterr().out
        assert "inbox/1." in out and "inbox/2." in out
    assert cli_main(
        ["build", "--config", cfgfile, "--store", store, "--table", "T",
         "--chunked", "--checkpoint", str(tmp_path / "ckpt2")] + cpu) == 0
    err = capsys.readouterr().err
    assert "n_chunks" in err  # chunked stats prove the flavor was honored
    # the chunked build's checkpoint restores in the JAX package
    j = apsim_tpu.Engine.load(str(tmp_path / "ckpt2"))
    assert j.n_rows == 3


def test_cli_bench_reads_config_block(tmp_path, capsys):
    rng = np.random.default_rng(5)
    csr = to_pt(random_sparse_corpus(rng, 12, DIM))
    cfg = AllPairsConfig(
        vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
        similarity_threshold=0.9, io_trigger_period_ms=5,
    )
    store = str(tmp_path / "store")
    VectorStore(store).write("T", csr, [str(i) for i in range(csr.n_rows)])
    cfgfile = str(tmp_path / "bench.json")
    with open(cfgfile, "w") as f:
        json.dump({"benchmark": {"totalMessageCount": 4, "childrenNum": 2,
                                 "writeBatchingDuration": 1,
                                 "expDuration": 30000}}, f)
    with RpcServer(cpu_server(cfg), port=0) as rpc:
        assert cli_main(
            ["bench", "--config", cfgfile,
             "--remote", f"{rpc.host}:{rpc.port}",
             "--store", store, "--table", "T"]
        ) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["sent"] == 8 and rep["messages"] == 8


def test_cli_bench_ccweb_end_to_end(tmp_path, capsys):
    dim = 64
    rng = np.random.default_rng(7)
    lines = []
    for i in range(10):
        dense = np.zeros(dim)
        nz = rng.choice(dim, size=6, replace=False)
        dense[nz] = rng.uniform(0.2, 1.0, size=6)
        if i % 2 == 1:  # 5 duplicated vectors guarantee pairs at tau 0.9
            dense = np.zeros(dim)
            dense[:4] = [0.5, 0.25, 0.125, 0.0625]
        feats = ",".join(f"{x:.6f}" for x in dense)
        lines.append(f"(vid{i},{dim},[{feats}])")
    path = str(tmp_path / "ccweb.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    cfg = AllPairsConfig(
        vector_dim=dim, query_tile=64, row_bucket=64, dim_bucket=64,
        similarity_threshold=0.9, io_trigger_period_ms=5,
    )
    sim = cpu_server(cfg)
    with RpcServer(sim, port=0) as rpc:
        assert cli_main(
            ["bench", "--ccweb", path,
             "--remote", f"{rpc.host}:{rpc.port}",
             "--total-message-count", "4", "--children-num", "1",
             "--write-batching-ms", "1"]
        ) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["messages"] == 4 and rep["avg_latency_ms"] > 0
    assert sim.engine.n_rows == 10


def test_loadgen_protocol(tmp_path):
    rng = np.random.default_rng(31)
    csr = to_pt(random_sparse_corpus(rng, 40, DIM))
    cfg = AllPairsConfig(
        vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
        similarity_threshold=0.9, io_trigger_period_ms=5,
    )
    sim = cpu_server(cfg)
    with RpcServer(sim, port=0) as rpc:
        cc = ClientConnection([f"{rpc.host}:{rpc.port}"])
        vectors = [(str(i), csr.row(i)) for i in range(csr.n_rows)]
        gen = LoadGenerator(
            cc, vectors, total_message_count=10, children_num=2,
            write_batching_ms=1, timeout_s=30.0,
        )
        rep = gen.run()
        cc.close()
    assert rep["messages"] == 20, rep
    assert rep["avg_latency_ms"] > 0
    assert rep["min_latency_ms"] <= rep["avg_latency_ms"] <= rep[
        "max_latency_ms"]
    assert sim.engine.n_rows == csr.n_rows  # frozen for the test phase


# ------------------------------------------- the port against the JAX CLI
def words_corpus(root, n=120, seed=4):
    """A seeded text corpus: docs of Zipf-ish words, every 10th a copy."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in range(n):
        if i % 10 == 9:
            text = open(os.path.join(root, f"{i - 9}.")).read()
        else:
            k = int(rng.integers(5, 40))
            text = " ".join(f"w{j}" for j in np.minimum(
                rng.zipf(1.4, size=k), 300))
        with open(os.path.join(root, f"{i}."), "w") as f:
            f.write(text)


@pytest.mark.parametrize("flags", [[], ["--chunked"]])
def test_join_and_topk_equal_jax_cli(tmp_path, capsys, flags):
    """``etl`` by either package writes the same table; ``join`` and
    ``topk`` of the port print what the JAX CLI prints on that store,
    from the store and from a checkpoint either package wrote."""
    words_corpus(str(tmp_path / "docs"))
    cfgfile = str(tmp_path / "cfg.json")
    with open(cfgfile, "w") as f:
        json.dump({"vectorDim": 8192, "query_tile": 64, "row_bucket": 64,
                   "dim_bucket": 64}, f)
    stores = {}
    for name, main in (("pt", cli_main), ("jax", jax_cli)):
        stores[name] = str(tmp_path / f"store_{name}")
        assert main(["etl", str(tmp_path / "docs"), "--store",
                     stores[name], "--table", "T", "--vector-dim",
                     "8192"]) == 0
    pt_tab, j_tab = (VectorStore(stores[k]).read("T") for k in ("pt", "jax"))
    assert pt_tab[1] == j_tab[1]
    assert np.array_equal(pt_tab[0].data, j_tab[0].data)
    store = stores["jax"]
    base = ["--config", cfgfile] + flags
    assert jax_cli(["build", "--store", store, "--table", "T",
                    "--checkpoint", str(tmp_path / "jck")] + base) == 0
    assert cli_main(["build", "--store", store, "--table", "T",
                     "--checkpoint", str(tmp_path / "pck"), "--device",
                     "cpu"] + base) == 0
    capsys.readouterr()

    def run(main, args):
        assert main(args) == 0
        return sorted(capsys.readouterr().out.splitlines())

    for src in (["--store", store, "--table", "T"],
                ["--checkpoint", str(tmp_path / "jck")],
                ["--checkpoint", str(tmp_path / "pck")]):
        for cmd in (["join", "--tau", "0.6"],
                    ["topk", "-k", "4", "--query-store", store,
                     "--query-table", "T", "--limit", "30"]):
            want = run(jax_cli, cmd + src + base)
            got = run(cli_main, cmd + src + base + ["--device", "cpu"])
            assert got == want and len(want) >= (12 if cmd[0] == "join"
                                                  else 30)


def test_cli_refuses_the_cpu_without_asking(tmp_path, corpus_dir,
                                            monkeypatch):
    """Without ``--device`` the CLI runs on the card: where CUDA is absent
    ``build``, ``join`` and ``serve`` raise instead of running on the CPU
    (a fresh interpreter, so CUDA is really absent there when it is
    here).  A ``serve`` in a group of several processes refuses to start
    without ``--replicate`` (``tests/test_torch_multihost.py`` runs it
    with the flag)."""
    store = str(tmp_path / "store")
    assert cli_main(["etl", corpus_dir, "--store", store, "--table", "T",
                     "--vector-dim", "4096"]) == 0
    code = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from apsim_tpu_torch.cli import main\n"
        "args = sys.argv[1:]\n"
        "try:\n"
        "    main(args)\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA' in str(e), e\n"
        "    sys.exit(7)\n"
    )
    common = ["--store", store, "--table", "T", "--vector-dim", "4096"]
    for args in (["build"] + common, ["join"] + common,
                 ["serve", "--port", "0"] + common,
                 ["join", "--mesh"] + common):
        proc = subprocess.run([sys.executable, "-c", code] + args, cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 7, (args, proc.stdout, proc.stderr)
    import torch.distributed as dist

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    with pytest.raises(SystemExit, match="--replicate HOST:PORT"):
        cli_main(["serve", "--device", "cpu", "--port", "0"])
