"""Configuration system.

The reference layers Typesafe HOCON files (CLI akka conf ⊕ app conf ⊕
classpath default — SimilaritySearchService.scala:20-22) with every engine key
under ``cpslab.allpair.*`` (full inventory in SURVEY.md §5).  Here the same
knobs are a flat dataclass loadable from JSON, with the same layering rule:
later sources fall back to earlier ones.

Key mapping (reference key -> field), citations into /root/reference:
  vectorDim             -> vector_dim            (conf/app.conf:6;
                                                  EntryProxyActor.scala:25)
  similarityThreshold   -> similarity_threshold  (conf/app.conf:15)
  indexThreshold        -> index_threshold       (WriteWorkerActor.scala:35;
                                                  absent from
                                                  shipped confs -> default
                                                  0.0 here instead
                                                  of a missing-key crash)
  maxShardNum           -> max_shard_num         (CommonUtils.scala:23)
  maxEntryNum           -> max_entry_num         (CommonUtils.scala:24)
  maxIOEntryActorNum    -> max_io_workers        (EntryProxyActor.scala:19)
  maxIndexEntryActorNum -> max_index_workers     (EntryProxyActor.scala:21)
  ioTriggerPeriod (ms)  -> io_trigger_period_ms  (WriteWorkerActor.scala:54)
  outputIODuration (ms) -> output_io_duration_ms (IndexingWorkerActor.scala:26)
  runMode               -> run_mode              (conf/app.conf:16)
  ioRangeNum            -> io_range_num          (Client.scala:21)
  rawDataTable          -> raw_data_table        (conf/app.conf:14)
  benchmark.*           -> bench_*               (conf/app_client_template.conf:20-27)

Engine additions: dtype / tile sizes / mesh shape / shard axis.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

__all__ = ["AllPairsConfig", "load_config"]

_KEY_ALIASES = {
    # reference HOCON camelCase -> dataclass field
    "vectorDim": "vector_dim",
    "similarityThreshold": "similarity_threshold",
    "indexThreshold": "index_threshold",
    "maxShardNum": "max_shard_num",
    "maxEntryNum": "max_entry_num",
    "maxIOEntryActorNum": "max_io_workers",
    "maxIndexEntryActorNum": "max_index_workers",
    "ioTriggerPeriod": "io_trigger_period_ms",
    "outputIODuration": "output_io_duration_ms",
    "runMode": "run_mode",
    "ioRangeNum": "io_range_num",
    "rawDataTable": "raw_data_table",
    "expDuration": "bench_exp_duration_ms",
    "writeBatchingDuration": "bench_write_batching_ms",
    "totalMessageCount": "bench_total_message_count",
    "childrenNum": "bench_children_num",
}


@dataclasses.dataclass
class AllPairsConfig:
    # --- engine semantics (reference parity) ---
    vector_dim: int = 1 << 20          # conf/app.conf:6
    similarity_threshold: float = 0.7  # conf/app.conf:15
    index_threshold: float = 0.0       # streaming component filter
    # Accepted-but-collapsed reference keys.  The actor topology they
    # configured does not exist on a device mesh; they are kept so reference
    # config files load unchanged, with these fates (docs/CONFIG.md):
    max_shard_num: int = 10            # conf/app.conf:12 — COLLAPSED into
                                       # mesh_shape: the dim-shard count is
                                       # the device-mesh size, not a free knob
    max_entry_num: int = 10            # app_server_template.conf — COLLAPSED:
                                       # entity placement (shardId %
                                       # maxEntryNum) has no analog; the index
                                       # lives on the mesh, not on entities
    max_io_workers: int = 10           # conf/app.conf:11 — READ: second-level
                                       # bulk-load split (the EntryProxy
                                       # re-split, EntryProxyActor.scala:64);
                                       # sets ingest micro-batch granularity
    max_index_workers: int = 10        # conf/app.conf:10 — COLLAPSED: the
                                       # intra-node dim % maxIndexEntryActorNum
                                       # split folds into the same device
                                       # mesh axis (SURVEY.md §2 parallelism
                                       # table, row 2)
    io_trigger_period_ms: int = 10     # conf/app.conf:9 (micro-batch flush)
    max_flush_batch: int = 4096        # deviation from the reference
                                       # (which drains its whole buffer per
                                       # IOTrigger tick): a flush coalesces
                                       # AT MOST this many vectors per
                                       # engine micro-batch.  On an NVIDIA
                                       # H100 80GB HBM3 at 700 W, serving a
                                       # 500k-row chunked index at 9,000
                                       # vec/s offered for 15 s (serve_probe
                                       # 500000 --flush-cap N, two calls,
                                       # PERF.md), a cap of 4,096
                                       # sustained 7,644 / 7,724 vec/s,
                                       # 2,048 8,019 / 7,372 (no difference
                                       # beyond the noise), 0 (drain
                                       # everything, batches to 28,156
                                       # rows) 6,794; at 3,000 vec/s all
                                       # three kept up.  0 = follow the
                                       # reference.
    output_io_duration_ms: int = 0     # 0 => immediate emission
    run_mode: str = "DEBUG"            # conf/app.conf:16
    io_range_num: int = 1              # conf/app.conf:13
    raw_data_table: str = "SMALL_DATA"  # conf/app.conf:14

    # --- benchmark harness (app_client_template.conf:20-27) ---
    bench_exp_duration_ms: int = 30000
    bench_write_batching_ms: int = 50
    bench_total_message_count: int = 50
    bench_children_num: int = 1

    # --- engine knobs (new) ---
    admission: str = "ones"            # max-weight admission pruning:
                                       #   "ones" = reference's 1.0 stub
                                       #   (EntryProxyActor.scala:51-57),
                                       #   "real" = running max weights,
                                       #   "off"
    dtype: str = "float32"             # device score dtype: float32 | bfloat16
    matmul_precision: str = "default"  # products: "default" (bf16
                                       # operands, fp32 sums; exactness is
                                       # kept by the wide rescore margin +
                                       # fp64 rescore) | "highest" (true
                                       # fp32 products, narrow margin; the
                                       # rectangle join at 32,768 rows: 56.5
                                       # ms default, 0.769 s highest on an
                                       # NVIDIA H100 80GB HBM3 at 700 W,
                                       # chip_smoke.py phase 7, PERF.md)
    use_pallas: str = "auto"           # all-pairs hot op: "auto" = the
                                       # hand-written upper-triangle kernels
                                       # (csrc/score_bits.cu) where the
                                       # capacities tile and the bit-packed
                                       # hits fit 2 GB, else the rectangle
                                       # join; "on" | "off"
    extract_cap: int = 1 << 18         # device pair-buffer capacity
                                       # (auto-grows ×4 on overflow)
    extract_group: int = 8             # rows per group in the two-level
                                       # on-device pair compaction
    query_tile: int = 1024             # rows per scoring tile
    row_bucket: int = 512              # row-capacity growth quantum
    dim_bucket: int = 4096             # compact-dim capacity growth quantum
    dormant_dims: bool = True          # at build, keep df==1 dims OFF the
                                       # device (they can't contribute to any
                                       # i!=j pair); archived host-side and
                                       # activated on demand by inserts —
                                       # cuts Enron's matmul K by 0.56x
    rescore_margin: float = 1e-4      # relative device-error bound (fp64
                                       # host rescore is always on: it is what
                                       # makes the emitted pair set exact)
    mesh_shape: tuple = ()             # e.g. (8,) — empty => single device
    shard_axis: str = "dims"           # "dims" (reference parity) | "rows"
    pallas_int8: bool = True           # score the kernel join at int8
                                       # (2x the tensor cores' bf16 rate,
                                       # half the operand bytes) with a
                                       # per-pair quantization bound in the
                                       # epilogue — exact (proven superset +
                                       # fp64 rescore; 8,586 synthetic rows
                                       # at tau=0.8: 3.95-4.30 ms a join vs
                                       # 6.13-6.51 ms at bf16, identical
                                       # pair set, on an NVIDIA H100 80GB
                                       # HBM3 at 700 W, bench_torch.py,
                                       # PERF.md). Auto-gated on
                                       # int32 accumulator safety
                                       # (max_nnz < 66k) and adaptively
                                       # demoted to bf16 if a corpus makes
                                       # the bound admit vastly more
                                       # candidates than the true result.
    match_slab_budget_mb: int = 7168   # streaming fast path (chunked engine):
                                       # keep the densified chunk slabs
                                       # RESIDENT on device and update them
                                       # incrementally on insert, instead of
                                       # re-scattering the whole corpus every
                                       # micro-batch.  Enabled while the
                                       # stacked slabs fit this budget
                                       # (n_chunks·row_cap·chunk_width·2 B at
                                       # bf16); beyond it the paneled route.
                                       # 0 disables the cache.  On an NVIDIA
                                       # H100 80GB HBM3 at 700 W (bench/
                                       # constants_ab, PERF.md) the stack is
                                       # faster at bs 32 (8.2 / 11.0 / 19.9
                                       # ms against 10.9 / 17.8 / 35.6 at
                                       # 100k / 200k / 500k rows), even at
                                       # 256 and slower from 1,024 on
                                       # (1.0-1.35x; 1.2-2.1x at 4,096), at
                                       # every size, while the card holds
                                       # the 500k stack (peak 43.8 GB): so
                                       # the budget is no memory limit but
                                       # the reach of a trade, kept at the
                                       # largest stack measured on the
                                       # route, 7,168 MiB (the 100k stream's
                                       # 114,688-row capacity).
    profile_dir: str = ""              # when set, write a torch.profiler
                                       # trace of every all_pairs/insert
                                       # (a server: of every flush with
                                       # work), every thread, the stages
                                       # as apsim::<stage> ranges (Chrome
                                       # trace JSON: Perfetto); per-stage
                                       # wall timings are always
                                       # collected in stats["timings"]
    tls_cert: str = ""                 # PEM cert path: serve TLS when both
    tls_key: str = ""                  # cert+key are set (non-loopback
                                       # deployments; the reference's Akka
                                       # remote is plaintext TCP)
    auth_token: str = ""               # shared secret: when set, every
                                       # connection must send
                                       # {"op":"auth","token":...} first
    checkpoint_dir: str = ""           # server auto-checkpoint location
    checkpoint_interval_s: float = 0.0  # 0 = off (reference has NO
                                       # checkpointing; its index dies with
                                       # the actor — SURVEY.md §5)

    def replace(self, **kw: Any) -> "AllPairsConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "AllPairsConfig":
        return AllPairsConfig().updated(d)

    def updated(self, d: Mapping[str, Any]) -> "AllPairsConfig":
        fields = {f.name for f in dataclasses.fields(self)}
        kw: dict[str, Any] = {}
        for k, v in _flatten(d).items():
            k = _KEY_ALIASES.get(k, k)
            if k in fields:
                if k == "mesh_shape":
                    v = tuple(v)
                kw[k] = v
        return dataclasses.replace(self, **kw)


def _flatten(d: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Flatten nested dicts; strips the reference's ``cpslab.allpair.`` and
    ``benchmark.`` nesting so HOCON-shaped JSON files load directly.

    Two sections defining the SAME leaf name is ambiguous (dict order would
    silently pick a winner) — rejected with the dotted paths named."""
    paths: dict[str, str] = {}

    def walk(m: Mapping[str, Any], pre: str, out: dict[str, Any]):
        for k, v in m.items():
            if isinstance(v, Mapping):
                walk(v, f"{pre}{k}.", out)
            else:
                if k in out:
                    raise ValueError(
                        f"config key '{k}' defined in both "
                        f"'{paths[k]}' and '{pre}{k}'"
                    )
                out[k] = v
                paths[k] = f"{pre}{k}"

    out: dict[str, Any] = {}
    walk(d, prefix, out)
    return out


def load_config(
    *paths: str, overrides: Mapping[str, Any] | None = None
) -> AllPairsConfig:
    """Layered load: each successive JSON file overrides the previous
    (the reference's ``withFallback`` chain in reverse,
    SimilaritySearchService.scala:20-22); ``overrides`` wins last."""
    cfg = AllPairsConfig()
    for p in paths:
        with open(p, "r", encoding="utf-8") as f:
            cfg = cfg.updated(json.load(f))
    if overrides:
        cfg = cfg.updated(overrides)
    return cfg
