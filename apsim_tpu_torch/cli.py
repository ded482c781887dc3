"""``apsim-torch`` command-line interface (the PyTorch port of
``apsim_tpu/cli.py``; ``python -m apsim_tpu_torch.cli`` runs it too).

Mirrors the reference's entry points with named flags instead of positional
HOCON paths (fixing SURVEY.md fine-print #9):

  apsim etl     — corpus → TF-IDF → vector store   (PreprocessWithTFIDF.main +
                  HBaseUpLoader.main, etl/.../PreprocessWithTFIDF.scala:54-68)
  apsim build   — bulk-build an index from a store table and checkpoint it
  apsim join    — all-pairs join at a threshold (batch mode)
  apsim topk    — k-NN queries against a checkpoint
  apsim serve   — run the TCP similarity service
                  (SimilaritySearchService.main, SimilaritySearchService.scala:14-34)
  apsim client  — interactive terminal (Client.main, Client.scala:101-113)
  apsim bench   — insert→first-result latency harness
                  (LoadGenerator.main, LoadGenerator.scala:177-183)
  apsim bench-suite — every BASELINE.json config with its parity checks
                  (``bench/suite.py``); exits 1 when a check fails

Every subcommand that builds an engine takes ``--device {cuda,cpu}``
(default ``cuda``): without CUDA the default raises, it never falls back to
the CPU.  ``--mesh`` spans every visible card (on the CPU, ``--mesh-shape``
shards of the CPU).  ``serve`` blocks until SIGINT and checkpoints on the
way out.  Run in several processes (``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` set, as ``torchrun`` sets them), ``serve
--replicate HOST:PORT`` serves one index from all of them: rank 0 serves
RPC and ships every engine call through the op log at ``HOST:PORT``, the
others replay it (``serve/replica.py``); ``--mesh`` then lays one mesh over
every process's devices (``parallel/multihost.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys



def _load_cfg(args) -> "AllPairsConfig":
    from .config import AllPairsConfig, load_config

    paths = [p for p in (args.config or [])]
    overrides = {}
    if getattr(args, "tau", None) is not None:
        overrides["similarity_threshold"] = args.tau
    if getattr(args, "vector_dim", None):
        overrides["vector_dim"] = args.vector_dim
    return load_config(*paths, overrides=overrides)


def cmd_etl(args) -> int:
    from .etl.corpus import iter_documents
    from .etl.store import VectorStore, save_text_vectors
    from .etl.tfidf import tfidf_pipeline, top_dim_filter

    ids, docs = [], []
    for relpath, content in iter_documents(args.corpus):
        ids.append(relpath)
        docs.append(content)
    print(f"{len(docs)} documents", file=sys.stderr)
    csr = tfidf_pipeline(
        docs, num_features=args.vector_dim, normalize=not args.no_normalize
    )
    if args.filter_threshold:
        csr = top_dim_filter(csr, args.filter_threshold)
    if args.text_out:
        save_text_vectors(args.text_out, csr)
    if args.store:
        VectorStore(args.store).write(args.table, csr, ids)
        print(f"wrote table {args.table} to {args.store}", file=sys.stderr)
    return 0


def cmd_build(args) -> int:
    from .etl.store import VectorStore

    cfg = _load_cfg(args)
    cfg, use_mesh = _mesh_cfg(args, cfg)
    cls = _engine_cls(args, use_mesh)
    if not args.store:
        raise SystemExit("apsim build: --store is required")
    csr, ids = VectorStore(args.store).read(args.table)
    eng = _new_engine(args, cls, cfg)
    stats = eng.build(csr, ids)
    print(json.dumps(dict(stats)), file=sys.stderr)
    if args.checkpoint:
        eng.save(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    return 0


def _mesh_cfg(args, cfg):
    """Fold --mesh-shape into the config; True iff a mesh engine was asked
    — by flag OR by a ``mesh_shape`` in the config file (previously only
    the flags selected the mesh engine, so a config-file mesh_shape built
    an unsharded index with no warning)."""
    if getattr(args, "mesh_shape", None):
        cfg = cfg.replace(
            mesh_shape=tuple(int(s) for s in args.mesh_shape.split(","))
        )
    return cfg, bool(getattr(args, "mesh", False) or
                     getattr(args, "mesh_shape", None) or cfg.mesh_shape)


def _engine_cls(args, use_mesh: bool):
    """Engine flavor from --chunked/--mesh: dense or out-of-core, single
    device or mesh-sharded.  Every CLI path (store build, checkpoint
    restore) goes through the same selection."""
    if getattr(args, "chunked", False):
        if use_mesh:
            from .parallel import MeshChunkedAllPairs

            return MeshChunkedAllPairs
        from .engine.chunked import ChunkedAllPairs

        return ChunkedAllPairs
    if use_mesh:
        from .parallel import MeshEngine

        return MeshEngine
    from .engine.engine import Engine

    return Engine


def _new_engine(args, cls, cfg):
    """An empty engine of ``cls`` on ``--device``: the mesh flavors span
    every visible card, or ``mesh_shape`` shards of the CPU.  In a group
    of several processes the mesh is the global one: each process puts
    its share of ``mesh_shape`` (one shard by default) on its card, or on
    the CPU."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .parallel import (MeshChunkedAllPairs, MeshEngine, global_mesh,
                           make_mesh)

    dev = torch.device(args.device)
    multi = dist.is_initialized() and dist.get_world_size() > 1
    if multi and dev.type == "cuda":  # this process's card
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if cls in (MeshEngine, MeshChunkedAllPairs):
        shape = cfg.mesh_shape or None
        if multi:
            world = dist.get_world_size()
            per = max(1, int(np.prod(shape or (world,))) // world)
            return cls(cfg, mesh=global_mesh(shape, devices=[dev] * per))
        devices = (None if dev.type == "cuda"
                   else ["cpu"] * int(np.prod(shape or (1,))))
        return cls(cfg, mesh=make_mesh(shape, devices=devices))
    return cls(cfg, dev)


def _engine_from(args):
    from .etl.store import VectorStore

    cfg = _load_cfg(args)
    cfg, use_mesh = _mesh_cfg(args, cfg)
    cls = _engine_cls(args, use_mesh)
    if args.checkpoint and not args.store:
        # checkpoints are engine-flavor-agnostic: restore into whatever
        # flavor the flags ask for
        eng = _new_engine(args, cls, cfg)
        eng.restore(args.checkpoint)
        return eng
    if not args.store:
        raise SystemExit(
            f"apsim {args.cmd}: --store (or --checkpoint to restore) is "
            "required"
        )
    eng = _new_engine(args, cls, cfg)
    csr, ids = VectorStore(args.store).read(args.table)
    eng.build(csr, ids)
    return eng


def cmd_join(args) -> int:
    eng = _engine_from(args)
    res = eng.all_pairs(args.tau)
    out = sys.stdout if not args.out else open(args.out, "w")
    for a, b, s in res.id_pairs():
        print(f"{a}\t{b}\t{s:.6f}", file=out)
    if args.out:
        out.close()
    print(f"{res.n_pairs} pairs", file=sys.stderr)
    return 0


def cmd_topk(args) -> int:
    from .etl.store import VectorStore

    eng = _engine_from(args)
    if not (args.query_store or args.store):
        raise SystemExit(
            "apsim topk: --query-store (or --store) is required for queries"
        )
    qcsr, qids = VectorStore(args.query_store or args.store).read(
        args.query_table or args.table
    )
    queries = [(qids[i], qcsr.row(i)) for i in range(min(qcsr.n_rows, args.limit))]
    res = eng.topk(queries, args.k)
    for qid, neighbors in res.items():
        row = ", ".join(f"{c}:{s:.4f}" for c, s in neighbors)
        print(f"{qid}\t{row}")
    return 0


def cmd_serve(args) -> int:
    from .parallel import init_multihost

    cfg = _load_cfg(args)
    if args.checkpoint_dir:
        cfg = cfg.replace(
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_interval_s=args.checkpoint_interval,
        )
    # multi-process: join the process group first (a no-op unless
    # MASTER_ADDR is set — the seed-node analog); the mesh flavors then
    # span every process's devices
    init_multihost(backend=args.dist_backend
                   or ("gloo" if args.device == "cpu" else None))
    import torch.distributed as dist

    multi = dist.is_initialized() and dist.get_world_size() > 1
    if multi and not args.replicate:
        raise SystemExit(
            "multi-process serving needs --replicate HOST:PORT (the "
            "coordinator's op-log address)"
        )
    try:
        return _serve(args, cfg, multi)
    finally:
        if multi:
            dist.destroy_process_group()


def _serve(args, cfg, multi: bool) -> int:
    """``serve`` after the process group is joined: a follower replays the
    op log; the coordinator (or the only process) serves RPC."""
    import torch.distributed as dist

    from .engine.engine import Engine
    from .etl.store import VectorStore
    from .parallel import is_coordinator
    from .serve import RpcServer, SimilarityServer

    cfg, use_mesh = _mesh_cfg(args, cfg)
    store = (
        VectorStore(args.store, run_mode=cfg.run_mode)
        if args.store else None
    )
    cls = _engine_cls(args, use_mesh)
    leader = None
    if multi:
        host, port = args.replicate.rsplit(":", 1)
        # every process builds its replica (over the global mesh for the
        # mesh flavors); device work runs in lockstep via the op log
        engine = _new_engine(args, cls, cfg)
        if not is_coordinator():
            from .serve.replica import follow

            print("follower: replaying op log", flush=True)
            # the follower's store (same --store path: shared volume /
            # filesystem) lets bulk loads replicate as a table name +
            # content hash instead of the corpus itself
            n, clean = follow(
                engine, host, int(port), cfg.auth_token, store=store,
            )
            if not clean:
                # leader died mid-log: this replica holds its full state —
                # exit nonzero so a supervisor restarts it as the new
                # coordinator (its engine can be re-served as-is)
                print(
                    f"follower: LEADER LOST after {n} ops; replica state "
                    "is complete and promotable", flush=True,
                )
                return 1
            print(f"follower: leader closed after {n} ops", flush=True)
            return 0
        from .serve.replica import OpLogLeader

        n_followers = dist.get_world_size() - 1
        leader = OpLogLeader(
            engine, host=host, port=int(port), n_followers=n_followers,
            auth_token=cfg.auth_token,
        )
        print(
            f"op log on {leader.host}:{leader.port}; waiting for "
            f"{n_followers} follower(s)", flush=True,
        )
        leader.wait_followers()
        engine = leader
    else:
        # plain dense: let the server construct (and checkpoint-load) the
        # engine; other flavors are caller-provided and restored by the
        # server if a checkpoint exists
        engine = None if cls is Engine else _new_engine(args, cls, cfg)
    sim = SimilarityServer(engine, cfg, store=store, device=args.device)
    rpc = RpcServer(sim, host=args.host, port=args.port).start()
    try:
        import signal

        # a shell that starts serve in the background (``sbin_torch/
        # daemon.sh``'s ``nohup ... &``) leaves SIGINT ignored, and Python
        # then installs no handler: install it before saying we are up, so
        # the stop that follows checkpoints instead of being lost
        signal.signal(signal.SIGINT, signal.default_int_handler)
        print(f"serving on {rpc.host}:{rpc.port}", flush=True)
        signal.pause()
    except (KeyboardInterrupt, AttributeError):
        pass
    finally:
        rpc.close()
        if leader is not None:
            leader.close()
    return 0


def cmd_client(args) -> int:
    from .serve import ClientConnection, InteractiveClient

    cc = ClientConnection(
        args.remote, auth_token=args.auth_token or None,
        ca_file=args.ca_file or None,
    )
    InteractiveClient(cc).run()
    cc.close()
    return 0


def cmd_bench(args) -> int:
    from .bench.loadgen import LoadGenerator
    from .config import load_config
    from .etl.ccweb import load_ccweb_file
    from .etl.store import VectorStore
    from .serve import ClientConnection

    # the reference reads the whole benchmark block from config
    # (LoadGenerator.scala:92-98); CLI flags override the config values
    cfg = load_config(*(args.config or []))
    total = (
        cfg.bench_total_message_count
        if args.total_message_count is None else args.total_message_count
    )
    children = (
        cfg.bench_children_num
        if args.children_num is None else args.children_num
    )
    batching = (
        cfg.bench_write_batching_ms
        if args.write_batching_ms is None else args.write_batching_ms
    )
    if args.ccweb:
        vectors = load_ccweb_file(args.ccweb)
    else:
        csr, ids = VectorStore(args.store).read(args.table)
        vectors = [(ids[i], csr.row(i)) for i in range(csr.n_rows)]
    # a server configured with auth_token/TLS needs matching client creds;
    # the config file the bench already loads carries the token
    cc = ClientConnection(
        args.remote,
        auth_token=args.auth_token or cfg.auth_token or None,
        ca_file=args.ca_file or None,
    )
    gen = LoadGenerator(
        cc,
        vectors,
        total_message_count=total,
        children_num=children,
        write_batching_ms=batching,
        # expDuration bounds the experiment phase (LoadGenerator.scala:19,
        # :161-169 — ReceiveTimeout ends the run); here it caps the wait for
        # outstanding first-result latencies
        timeout_s=cfg.bench_exp_duration_ms / 1000.0,
    )
    print(json.dumps(gen.run()))
    cc.close()
    return 0


def cmd_bench_suite(args) -> int:
    from .bench import suite

    argv = ["--device", args.device]
    if args.enron:
        argv += ["--enron", args.enron]
    return suite.main(argv)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="apsim-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", action="append", help="JSON config file (layered)")
        sp.add_argument("--store", required=False, default=None)
        sp.add_argument("--table", default="SMALL_DATA")
        sp.add_argument("--checkpoint", default=None)
        sp.add_argument("--tau", type=float, default=None)
        sp.add_argument("--vector-dim", type=int, default=None, dest="vector_dim")
        sp.add_argument("--chunked", action="store_true",
                        help="out-of-core batch engine (beyond-HBM corpora)")
        sp.add_argument("--mesh", action="store_true",
                        help="shard the index over all visible devices")
        sp.add_argument("--mesh-shape", default=None, dest="mesh_shape",
                        help="e.g. '8' (1-D) or '2,4' (2-D rows x dims; "
                             "chunked mode is 1-D only)")
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the engine runs (default: the card; "
                             "without CUDA this raises)")

    sp = sub.add_parser("etl")
    sp.add_argument("corpus")
    sp.add_argument("--store", default=None)
    sp.add_argument("--table", default="SMALL_DATA")
    sp.add_argument("--vector-dim", type=int, default=1 << 20, dest="vector_dim")
    sp.add_argument("--filter-threshold", type=int, default=0,
                    help="keep top-N dims by max weight (HBaseUpLoader parity)")
    sp.add_argument("--no-normalize", action="store_true")
    sp.add_argument("--text-out", default=None,
                    help="also write reference text format")
    sp.set_defaults(fn=cmd_etl)

    sp = sub.add_parser("build")
    common(sp)
    sp.set_defaults(fn=cmd_build)

    sp = sub.add_parser("join")
    common(sp)
    sp.add_argument("--out", default=None)
    sp.set_defaults(fn=cmd_join)

    sp = sub.add_parser("topk")
    common(sp)
    sp.add_argument("-k", type=int, default=10)
    sp.add_argument("--query-store", default=None)
    sp.add_argument("--query-table", default=None)
    sp.add_argument("--limit", type=int, default=10)
    sp.set_defaults(fn=cmd_topk)

    sp = sub.add_parser("serve")
    common(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=2551)
    sp.add_argument("--checkpoint-dir", default="", dest="checkpoint_dir",
                    help="auto-checkpoint/restore the index here")
    sp.add_argument("--checkpoint-interval", type=float, default=60.0,
                    dest="checkpoint_interval")
    sp.add_argument("--replicate", default=None,
                    help="multi-process: the coordinator's op-log address "
                         "HOST:PORT (rank 0 listens, the others follow)")
    sp.add_argument("--dist-backend", default=None, dest="dist_backend",
                    choices=("nccl", "gloo"),
                    help="torch.distributed backend of a multi-process "
                         "serve (default: nccl on the card, gloo with "
                         "--device cpu; two ranks on one card need gloo)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("client")
    sp.add_argument("--remote", action="append", required=True,
                    help="host:port (repeatable)")
    sp.add_argument("--auth-token", default=None, dest="auth_token")
    sp.add_argument("--ca-file", default=None, dest="ca_file",
                    help="PEM CA to verify the server cert (enables TLS)")
    sp.set_defaults(fn=cmd_client)

    sp = sub.add_parser("bench")
    sp.add_argument("--config", action="append",
                    help="JSON config (layered); bench_* keys set defaults")
    sp.add_argument("--remote", action="append", required=True)
    sp.add_argument("--ccweb", default=None)
    sp.add_argument("--store", default=None)
    sp.add_argument("--table", default="SMALL_DATA")
    sp.add_argument("--total-message-count", type=int, default=None)
    sp.add_argument("--children-num", type=int, default=None)
    sp.add_argument("--write-batching-ms", type=int, default=None)
    sp.add_argument("--auth-token", default=None, dest="auth_token",
                    help="overrides the config file's auth_token")
    sp.add_argument("--ca-file", default=None, dest="ca_file")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser(
        "bench-suite",
        help="run every BASELINE.json benchmark config and emit JSON; "
             "exits 1 when a parity flag is false or a leg failed",
    )
    sp.add_argument("--enron", default=None, metavar="ROOT",
                    help="the Enron maildir root (default: the synthetic "
                         "corpus of Enron's row count)")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the suite runs (default: the card; without "
                         "CUDA this raises)")
    sp.set_defaults(fn=cmd_bench_suite)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
