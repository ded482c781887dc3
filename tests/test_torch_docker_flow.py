"""The port's deploy layer on the CPU (``sbin_torch/``, ``docker_torch/``;
the counterpart of ``tests/test_docker_flow.py``).

- The three-container flow in process (etl -> serve -> the interactive
  client's test / start / quit) with the port on ``--device cpu``, on the
  JAX test's 4-document fixture and a seeded 300-document text corpus: the
  pushed pair set and the ``all_pairs`` RPC equal the JAX package's same
  flow on the same corpus, also when the JAX package wrote the store.
- ``sbin_torch/daemon.sh`` in subprocesses: start, status, the load
  generator, a second start on the held port, stop by SIGINT and the
  checkpoint it writes; a server that never comes up or ignores SIGINT; on
  a machine without CUDA, a start on the card fails and leaves no PID file.
- ``docker_torch/bin/*.sh`` through a ``docker`` that records its argv:
  one card a container, torch's rendezvous variables, the volume contract,
  and the container's command parsed by the port's own CLI parser.
- Static checks of every new script and of the Dockerfile, whose compile
  step runs here with a stand-in ``nvcc``.

Tolerances: none; pair sets are compared as sets of ids.
"""

import glob
import io
import json
import os
import re
import shutil
import signal
import stat
import subprocess
import sys
import time

import pytest

import apsim_tpu
import apsim_tpu.serve as jserve
from apsim_tpu.cli import main as jax_cli
from apsim_tpu.etl.store import VectorStore as JaxStore

import apsim_tpu_torch as pt
from apsim_tpu_torch.cli import build_parser, main as cli_main
from apsim_tpu_torch.etl.store import VectorStore
from apsim_tpu_torch.ops.tri_score import LAUNCHES
from apsim_tpu_torch.serve import (ClientConnection, InteractiveClient,
                                   RpcServer, SimilarityServer)
from chip_smoke import text_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SBIN = os.path.join(REPO, "sbin_torch")
DOCKER = os.path.join(REPO, "docker_torch")
NEW_SCRIPTS = sorted(glob.glob(os.path.join(SBIN, "*.sh"))
                     + glob.glob(os.path.join(DOCKER, "bin", "*.sh")))
DIM = 4096
TAU = 0.5
FIXTURE_DOCS = {"1.": "alpha beta gamma alpha",
                "2.": "alpha beta gamma alpha",
                "3.": "delta epsilon zeta",
                "4.": "alpha beta gamma"}


def make_corpus(root, kind: str) -> str:
    if kind == "fixture":
        d = os.path.join(root, "inbox")
        os.makedirs(d)
        for name, text in FIXTURE_DOCS.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
    else:
        text_corpus(root, 300, seed=3)
    return root


def emitted_pairs(outputs) -> set:
    return {tuple(sorted((q, c))) for o in outputs
            for q, sims in o.output.items() for c in sims}


def flow(pkg, store_dir: str):
    """Stages 2 and 3 of the docker flow (start-cluster.sh's serve,
    start-client.sh's terminal) with ``pkg``'s server over ``store_dir``:
    the pushed pair set and the ``all_pairs`` RPC's."""
    if pkg is pt:
        cfg_cls, store_cls, serve_mod = pt.AllPairsConfig, VectorStore, None
    else:
        cfg_cls, store_cls, serve_mod = (apsim_tpu.AllPairsConfig, JaxStore,
                                         jserve)
    cfg = cfg_cls(vector_dim=DIM, query_tile=64, row_bucket=64, dim_bucket=64,
                  similarity_threshold=TAU, io_trigger_period_ms=5)
    store = store_cls(store_dir)
    n_rows = store.read("SMALL_DATA")[0].n_rows
    if serve_mod is None:
        srv = SimilarityServer(pt.Engine(cfg, "cpu"), cfg, store=store,
                               device="cpu")
        rpc_cls, conn_cls, term_cls = (RpcServer, ClientConnection,
                                       InteractiveClient)
    else:
        srv = serve_mod.SimilarityServer(apsim_tpu.Engine(cfg), cfg,
                                         store=store)
        rpc_cls, conn_cls, term_cls = (serve_mod.RpcServer,
                                       serve_mod.ClientConnection,
                                       serve_mod.InteractiveClient)
    outputs = []
    with srv:
        srv.add_output_sink(outputs.append)
        with rpc_cls(srv, host="127.0.0.1", port=0) as rpc:
            cc = conn_cls([f"127.0.0.1:{rpc.port}"])
            out = io.StringIO()
            term_cls(cc, out=out).run(input_lines=[
                "test", "ping",
                "start", "SMALL_DATA", "0", str(n_rows - 1),
                "quit",
            ])
            assert "test reply" in out.getvalue()
            deadline = time.time() + 60
            while srv.stats()["n_rows"] != n_rows:
                assert time.time() < deadline, srv.stats()["n_rows"]
                time.sleep(0.05)
            srv.flush()
            cc2 = conn_cls([f"127.0.0.1:{rpc.port}"])
            joined = {tuple(sorted((a, b))) for a, b, _ in
                      cc2.all_pairs(TAU)}
            if pkg is pt:  # the port's stats carry its launch counts
                assert cc2.stats()["launches"] == LAUNCHES
            cc2.close()
            cc.close()
    return emitted_pairs(outputs), joined


@pytest.fixture(scope="module")
def jax_flows(tmp_path_factory):
    """The JAX package's whole flow (its etl, its server) per corpus."""
    out = {}
    for kind in ("fixture", "text"):
        root = tmp_path_factory.mktemp(f"jax_{kind}")
        corpus = make_corpus(str(root / "corpus"), kind)
        store = str(root / "store")
        assert jax_cli(["etl", corpus, "--store", store, "--table",
                        "SMALL_DATA", "--vector-dim", str(DIM)]) == 0
        out[kind] = (corpus, store, flow(apsim_tpu, store))
    return out


@pytest.mark.parametrize("etl", ["port", "jax"])
@pytest.mark.parametrize("kind", ["fixture", "text"])
def test_three_container_flow(tmp_path, jax_flows, kind, etl):
    """preprocess -> cluster -> client with the port's server on the CPU:
    the same pushed pairs and joined pairs as the JAX package's flow.  With
    ``etl="jax"`` the store the JAX package wrote is served by the port
    (the state carried across between the packages)."""
    corpus, jax_store, (want_pushed, want_joined) = jax_flows[kind]
    if etl == "port":
        store = str(tmp_path / "store")
        assert cli_main(["etl", corpus, "--store", store, "--table",
                         "SMALL_DATA", "--vector-dim", str(DIM)]) == 0
    else:
        store = jax_store
    pushed, joined = flow(pt, store)
    assert pushed == want_pushed and joined == want_joined
    assert joined <= pushed and joined
    if kind == "fixture":
        assert ("inbox/1.", "inbox/2.") in joined
    else:
        assert len(joined) >= 10


# ------------------------------------------------------------ sbin_torch
def daemon_env(tmp_path, **extra) -> dict:
    env = dict(os.environ, APSIM_PYTHON=sys.executable,
               APSIM_PID_DIR=str(tmp_path / "pid"),
               APSIM_LOG_DIR=str(tmp_path / "logs"))
    env.update(extra)
    return env


def run(script: str, args, env: dict, cwd, timeout: float = 120):
    return subprocess.run([os.path.join(SBIN, script)] + list(args),
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def pid_gone(pid: int, timeout: float = 10.0) -> bool:
    """True once ``pid`` has exited (a zombie counts), within ``timeout``."""
    deadline = time.time() + timeout
    while True:
        try:
            with open(f"/proc/{pid}/status") as f:
                if "\tZ" in next(ln for ln in f if ln.startswith("State:")):
                    return True
        except FileNotFoundError:
            return True
        if time.time() >= deadline:
            return False
        time.sleep(0.05)


def test_daemon_lifecycle(tmp_path):
    """start -> status -> load + start-test.sh -> a second start on the
    held port -> stop: SIGINT, the process gone, and its checkpoint loads
    with every row the daemon held."""
    corpus = make_corpus(str(tmp_path / "corpus"), "text")
    store, ck = str(tmp_path / "store"), str(tmp_path / "ckpt")
    assert cli_main(["etl", corpus, "--store", store, "--table", "T",
                     "--vector-dim", str(DIM)]) == 0
    n = VectorStore(store).read("T")[0].n_rows
    env = daemon_env(tmp_path)
    pid_file = tmp_path / "pid" / "apsim-torch-server.pid"
    common = ["--device", "cpu", "--store", store, "--table", "T",
              "--vector-dim", str(DIM), "--checkpoint-dir", ck]
    p = run("daemon.sh", ["start", "--port", "0"] + common, env, tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    addr = re.search(r"serving on (\S+),", p.stdout).group(1)
    pid = int(pid_file.read_text())
    try:
        p = run("daemon.sh", ["status"], env, tmp_path)
        assert p.stdout.strip() == f"running (pid {pid})"
        cc = ClientConnection([addr])
        cc.load_data("T", 0, n - 1)
        deadline = time.time() + 60
        while cc.stats()["n_rows"] != n:
            assert time.time() < deadline
            time.sleep(0.05)
        cc.close()
        p = run("start-test.sh", [addr, "--store", store, "--table", "T",
                                  "--total-message-count", "5",
                                  "--children-num", "2",
                                  "--write-batching-ms", "1"], env, tmp_path)
        assert p.returncode == 0, p.stderr
        lines = p.stdout.strip().splitlines()
        assert len(lines) == 1 and json.loads(lines[0])["messages"] == 10
        # the same start on the held port, under another PID directory:
        # the server dies on bind, and start says so
        env2 = daemon_env(tmp_path, APSIM_PID_DIR=str(tmp_path / "pid2"),
                          APSIM_LOG_DIR=str(tmp_path / "logs2"))
        port = addr.rsplit(":", 1)[1]
        p = run("daemon.sh", ["start", "--port", port] + common, env2,
                tmp_path)
        assert p.returncode == 1 and "Address already in use" in p.stderr
        assert os.listdir(tmp_path / "pid2") == []
        cc = ClientConnection([addr])
        held = cc.stats()["n_rows"]
        cc.close()
        assert held == 2 * n  # the table, then the load test's warm-up
        p = run("daemon.sh", ["stop"], env, tmp_path)
        assert p.returncode == 0 and p.stdout.strip() == "stopped", p.stderr
        assert pid_gone(pid) and not pid_file.exists()
        p = run("daemon.sh", ["status"], env, tmp_path)
        assert p.stdout.strip() == "stopped"
        p = run("daemon.sh", ["stop"], env, tmp_path)
        assert p.returncode == 0 and p.stdout.strip() == "not running"
    finally:
        if not pid_gone(pid, 0):
            os.kill(pid, signal.SIGKILL)
    assert pt.Engine.load(ck, device="cpu").n_rows == held


def test_start_all_and_stop_all_fall_back_to_the_local_daemon(tmp_path):
    """Without a hosts file start-all.sh / stop-all.sh run the local
    daemon.sh, and start-all.sh returns only once the server is up."""
    env = daemon_env(tmp_path)
    missing = str(tmp_path / "servers")
    p = run("start-all.sh", [missing, "--device", "cpu", "--port", "0"],
            env, tmp_path)
    assert p.returncode == 0, p.stderr
    assert "starting locally" in p.stderr and "serving on" in p.stdout
    pid = int((tmp_path / "pid" / "apsim-torch-server.pid").read_text())
    p = run("stop-all.sh", [missing], env, tmp_path)
    assert p.returncode == 0 and p.stdout.strip() == "stopped"
    assert pid_gone(pid)


FAKE_SERVERS = {
    # comes up, then ignores SIGINT
    "deaf": "import signal, time\n"
            "signal.signal(signal.SIGINT, signal.SIG_IGN)\n"
            "print('serving on 127.0.0.1:1', flush=True)\n"
            "time.sleep(600)\n",
    # never comes up
    "mute": "import time\ntime.sleep(600)\n",
}


@pytest.mark.parametrize("fake", sorted(FAKE_SERVERS))
def test_daemon_bounds_its_waits(tmp_path, fake):
    """A server that never says it is up fails start after
    APSIM_START_TIMEOUT (killed, no PID file); one that ignores SIGINT
    fails stop after APSIM_STOP_TIMEOUT (killed)."""
    pkg = tmp_path / "fake" / "apsim_tpu_torch"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "cli.py").write_text(FAKE_SERVERS[fake])
    env = daemon_env(tmp_path, PYTHONPATH=str(tmp_path / "fake"),
                     APSIM_START_TIMEOUT="2", APSIM_STOP_TIMEOUT="1")
    # daemon.sh puts its checkout first on PYTHONPATH: run a copy of the
    # script beside the fake package instead
    (tmp_path / "fake" / "sbin_torch").mkdir()
    script = tmp_path / "fake" / "sbin_torch" / "daemon.sh"
    shutil.copy(os.path.join(SBIN, "daemon.sh"), script)
    pid_file = tmp_path / "pid" / "apsim-torch-server.pid"

    def daemon(*args):
        return subprocess.run([str(script), *args], env=env, cwd=tmp_path,
                              capture_output=True, text=True, timeout=60)

    p = daemon("start")
    if fake == "mute":
        assert p.returncode == 1 and "not up after 2 s" in p.stderr
        assert not pid_file.exists()
        return
    assert p.returncode == 0, p.stderr
    pid = int(pid_file.read_text())
    p = daemon("stop")
    assert p.returncode == 1 and "killed it" in p.stderr
    assert pid_gone(pid) and not pid_file.exists()


def test_daemon_ignores_a_stale_pid_file(tmp_path):
    """A PID file naming a live process that is not this package's server
    (its PID reused): status says stopped, stop signals nothing."""
    env = daemon_env(tmp_path)
    other = subprocess.Popen(["sleep", "60"])
    try:
        (tmp_path / "pid").mkdir()
        (tmp_path / "pid" / "apsim-torch-server.pid").write_text(
            f"{other.pid}\n")
        p = run("daemon.sh", ["status"], env, tmp_path)
        assert p.stdout.strip() == "stopped"
        p = run("daemon.sh", ["stop"], env, tmp_path)
        assert p.returncode == 0 and p.stdout.strip() == "not running"
        assert other.poll() is None
        assert os.listdir(tmp_path / "pid") == []
    finally:
        other.kill()
        other.wait(timeout=10)


def test_daemon_start_on_the_card_fails_without_one(tmp_path):
    """No fallback: where CUDA is absent, ``daemon.sh start`` on the card
    (the serve default) exits non-zero and leaves no PID file."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: a start on the card would succeed")
    env = daemon_env(tmp_path)
    for args in (["--device", "cuda"], []):
        p = run("daemon.sh", ["start", "--port", "0"] + args, env, tmp_path)
        assert p.returncode == 1, p.stdout
        assert "no CUDA" in p.stderr
        assert os.listdir(tmp_path / "pid") == []


# ---------------------------------------------------------- docker_torch
SHIM = """#!/usr/bin/env python3
import json, os, sys
with open(os.environ["DOCKER_ARGV_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if sys.argv[1:3] == ["network", "inspect"]:
    sys.exit(1)  # no such network yet
if sys.argv[1:2] == ["ps"]:
    print("compute-node-1\\ncompute-node-0")
"""
IMAGE = "apsim-torch-under-test"


def docker_calls(tmp_path, script: str, args=(), **env_extra):
    """Run ``docker_torch/bin/<script>`` with a recording ``docker`` first
    on PATH; returns each call's argv."""
    bindir = tmp_path / "shim"
    bindir.mkdir(exist_ok=True)
    shim = bindir / "docker"
    shim.write_text(SHIM)
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "argv.jsonl"
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               DOCKER_ARGV_LOG=str(log), APSIM_IMAGE=IMAGE,
               APSIM_DATA="/corpus", APSIM_STORE=str(tmp_path / "store"),
               **env_extra)
    p = subprocess.run([os.path.join(DOCKER, "bin", script), *args],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    return [json.loads(ln) for ln in log.read_text().splitlines()]


def split_run(argv):
    """``docker run`` argv -> (options before the image, command after)."""
    assert argv[0] == "run" and IMAGE in argv, argv
    k = argv.index(IMAGE)
    return argv[1:k], argv[k + 1:]


def env_of(opts) -> dict:
    return dict(opts[k + 1].split("=", 1) for k, o in enumerate(opts)
                if o == "-e")


def volumes(opts) -> list:
    return [opts[k + 1] for k, o in enumerate(opts) if o == "-v"]


@pytest.mark.parametrize("multihost", [False, True])
def test_start_cluster_gives_each_container_a_card(tmp_path, multihost):
    env = {"APSIM_MULTIHOST": "1"} if multihost else {}
    calls = docker_calls(tmp_path, "start-cluster.sh", ["2"], **env)
    assert calls[:2] == [["network", "inspect", "apsim-net"],
                         ["network", "create", "apsim-net"]]
    runs = calls[2:]
    assert len(runs) == 2
    store = str(tmp_path / "store")
    for i, argv in enumerate(runs):
        assert not any("JAX_" in a for a in argv)
        opts, cmd = split_run(argv)
        assert opts[opts.index("--gpus") + 1] == f"device={i}"
        assert opts[opts.index("--name") + 1] == f"compute-node-{i}"
        assert opts[opts.index("--network") + 1] == "apsim-net"
        assert volumes(opts) == ["/corpus:/root/data:ro",
                                 f"{store}:/root/store"]
        args = build_parser().parse_args(cmd)
        assert (args.cmd, args.store, args.port, args.device) == (
            "serve", "/root/store", 2551, "cuda")
        if multihost:
            assert env_of(opts) == {"MASTER_ADDR": "compute-node-0",
                                    "MASTER_PORT": "9876",
                                    "WORLD_SIZE": "2", "RANK": str(i)}
            assert "--ipc=host" in opts
            assert args.mesh and args.replicate == "compute-node-0:9877"
        else:
            assert env_of(opts) == {}
            assert not args.mesh and args.replicate is None


@pytest.mark.parametrize("script", ["start-preprocess.sh",
                                    "start-client.sh"])
def test_preprocess_and_client_containers(tmp_path, script):
    (argv,) = docker_calls(tmp_path, script)
    assert not any("JAX_" in a for a in argv)
    opts, cmd = split_run(argv)
    store = str(tmp_path / "store")
    args = build_parser().parse_args(cmd)
    if script == "start-preprocess.sh":
        assert volumes(opts) == ["/corpus:/root/data:ro",
                                 f"{store}:/root/store"]
        assert (args.cmd, args.corpus, args.store, args.table) == (
            "etl", "/root/data", "/root/store", "SMALL_DATA")
    else:
        assert volumes(opts) == ["/corpus:/root/data:ro",
                                 f"{store}:/root/store:ro"]
        assert opts[opts.index("--network") + 1] == "apsim-net"
        assert (args.cmd, args.remote) == ("client",
                                           ["compute-node-0:2551"])


def test_stop_cluster_stops_with_the_image_signal(tmp_path):
    """Each compute-node container is stopped (SIGINT, the image's
    STOPSIGNAL: the final checkpoint) before it is removed, node 0 first."""
    calls = docker_calls(tmp_path, "stop-cluster.sh")
    assert calls[0][0] == "ps"
    assert calls[1:] == [["stop", "-t", "60", "compute-node-0"],
                         ["rm", "compute-node-0"],
                         ["stop", "-t", "60", "compute-node-1"],
                         ["rm", "compute-node-1"]]


# -------------------------------------------------------- static checks
def dockerfile_lines() -> list:
    """The Dockerfile's instructions, continuation lines joined."""
    text = open(os.path.join(DOCKER, "Dockerfile")).read()
    text = re.sub(r"\\\n", " ", text)
    return [ln.strip() for ln in text.splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]


@pytest.mark.parametrize("path", [os.path.relpath(p, REPO)
                                  for p in NEW_SCRIPTS])
def test_script_parses_and_names_only_the_port(path):
    full = os.path.join(REPO, path)
    p = subprocess.run(["bash", "-n", full], capture_output=True, text=True,
                       timeout=30)
    assert p.returncode == 0, p.stderr
    assert os.access(full, os.X_OK)
    text = open(full).read()
    assert text.startswith("#!/usr/bin/env bash\n")
    assert "set -euo pipefail" in text
    assert not re.search(r"apsim_tpu\.cli|apsim_tpu/|jax", text, re.I)


def test_dockerfile_names_only_the_port():
    text = open(os.path.join(DOCKER, "Dockerfile")).read()
    assert not re.search(r"apsim_tpu\.cli|apsim_tpu/|jax", text, re.I)
    lines = dockerfile_lines()
    sources = [w for ln in lines if ln.startswith("COPY ")
               for w in ln.split()[1:-1]]
    assert sources == ["apsim_tpu_torch", "conf", "sbin_torch"]
    for src in sources:
        assert os.path.exists(os.path.join(REPO, src)), src
    assert ('ENTRYPOINT ["python3", "-m", "apsim_tpu_torch.cli"]'
            in lines)
    cmd = json.loads(next(ln for ln in lines
                          if ln.startswith("CMD "))[len("CMD "):])
    args = build_parser().parse_args(cmd)
    assert (args.cmd, args.host, args.device) == ("serve", "0.0.0.0", "cuda")
    assert "STOPSIGNAL SIGINT" in lines
    assert len(NEW_SCRIPTS) == 8


FAKE_NVCC = """#!/usr/bin/env bash
echo "$@" >> "$(dirname "$0")/calls"
out="${@: -1}"
: > "$out"
"""


def test_dockerfile_compile_step_prebuilds_what_the_first_launch_loads(
        tmp_path):
    """The image's compile step, run in a copy laid out as the image is
    (its COPY lines under one root) with a stand-in nvcc: it builds the
    kernel and host libraries into the copy's build directory, and a later
    process finds both there without compiling again."""
    root = tmp_path / "opt" / "apsim"
    lines = dockerfile_lines()
    for ln in lines:
        if ln.startswith("COPY "):
            src, dst = ln.split()[1:]
            shutil.copytree(os.path.join(REPO, src), root / dst,
                            ignore=shutil.ignore_patterns("__pycache__"))
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(root), CUDA_HOME=str(cuda))
    step = next(ln for ln in lines if ln.startswith("RUN python3 "))
    p = subprocess.run(["bash", "-c", step[len("RUN "):]], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    kernel_so, native_so = p.stdout.split()
    build = str(root / "build" / "apsim_tpu_torch")
    assert os.path.dirname(kernel_so) == build == os.path.dirname(native_so)
    assert len((cuda / "bin" / "calls").read_text().splitlines()) == 1
    check = ("from apsim_tpu_torch import native\n"
             "from apsim_tpu_torch.ops import _build\n"
             "print(_build.compile_library()[0])\n"
             "print(native.get_lib()._name)\n")
    p = subprocess.run([sys.executable, "-c", check], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == [kernel_so, native_so]
    assert len((cuda / "bin" / "calls").read_text().splitlines()) == 1
