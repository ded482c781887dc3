#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

Run from the repository root, with one NVIDIA H100 visible:

    python3 chip_smoke.py [--profile]

``python3 chip_smoke.py --multihost 4 nccl`` runs phase 12 alone with its
ranks one a card over four cards (and the references it is held against,
rebuilt on the first card); it ends with the same lines.

``python3 chip_smoke.py --mesh-cards N`` runs phase 17 alone on a machine
with at least N >= 2 cards (fewer raise before any work; the mesh is never
shrunk) and ends with the same lines.  The default run (phases 1-16) needs
one card and never runs phase 17.

``--profile`` adds one more join of each dense engine under
``torch.profiler`` after phase 3 (device busy time and idle share; the
profiler's start-up costs about 7 s on an H100 machine).

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   the CUDA kernels of ``apsim_tpu_torch/csrc/`` are built with nvcc, and
   ``ptxas`` must report 0 spill bytes for every kernel.
   Then the int8 kernels at their edges, each bit for bit (kernels 1 and
   3: gb, g64, cnt) or exactly (kernel 4: every int32) against its plain
   version: K = 128 (one ring stage) and K = 4,096 at block tiles
   (1024, 512), (512, 512), (256, 256) and (64, 128) (both thread-block
   tiles, 128 x 256 and 64 x 128), the dense triangle and a cross-panel
   rectangle with offsets and valid = 0 blocks, one with every sub-tile
   dead; ±127 operands at K = 32,768 (the int32 gate's largest dot);
   kernel 4 at both thread-block tiles with fewer tiles than SMs.
   Then the bf16 kernel at the same edges against its plain version: K = 64
   elements (one ring stage) and K = 2,048 (32 stages) at the same four
   block tiles, on 1,900 random unit rows and 148 padding rows, with a
   threshold inside the bulk of the scores, and a block list with fewer
   tiles than SMs: every cell whose bit differs has a plain fp32 score
   within 1e-5 of the threshold.  A dense stress (2,048 rows of 32,768
   positive elements each, threshold at the scores' median): the tensor
   cores' fp32 sums of 32,768 positive products drift further from the plain
   version's than any sparse row's can, so there the cells that differ are
   held within (K + 2) * 2^-24, the engine's own bound on fp32 accumulation
   over K nonzeros (``Engine._margin_rel``; its bf16 margin, 2e-2, is ten
   times wider), and the worst distance found is printed.
2. Each kernel against its plain PyTorch version on the index of an engine
   built from ``synthetic_corpus(4096)`` with padding rows, at tiles
   (1024, 512) and (256, 256), tau_eff of tau = 0.8.  int8: gb, g64 and cnt
   bit-identical.  bf16: every differing hit cell has a plain fp32 score
   within 1e-5 of tau_eff.  Both: g64 and cnt agree with the kernel's own gb.
3. The main path, ``Engine.build`` + ``Engine.all_pairs(0.8)`` three times,
   on ``synthetic_corpus(32768, seed=0)`` with the default config (int8
   kernel), then on 8,586 rows with ``pallas_int8=False`` (bf16 kernel).
   The launch counters are zeroed just before and read just after; each
   kernel must have launched.  The third join of each is timed.
4. Each kernel against its plain version again, at the main path's own
   operands and tiles (timed, CUDA events, median of 5), and exact pair-set
   parity of both joins with an fp64 dense oracle that shares no code with
   the engine.
5. The out-of-core path.  The cross-panel kernel against its plain version
   on two panels of a padded 3,000-row chunked index (panel offsets, a
   diagonal and an off-diagonal pair, blocks blanked by valid = 0, tiles
   (1024, 512) and (64, 128)), bit-identical.  Then, with the counters
   zeroed just before, ``ChunkedAllPairs.build`` + ``all_pairs(0.8)``
   three times on ``synthetic_corpus(100000, seed=0)`` (the resident
   sweep; the third timed with its stage split); the kernel against its
   plain version on one diagonal and one off-diagonal panel pair of that
   join (timed); one join with the rolling sweep; exact pair-set parity of
   both joins with the fp64 oracle.  5c: ``ChunkedAllPairs`` with
   ``chunk_dim`` 1,536 on 24,000 rows, whose ``d_cap`` is no multiple of
   2,048, so the join takes (64, 128) block tiles and kernel 3's 64 x 128
   thread-block instantiation: launches once per panel pair per join
   (counters zeroed just before), the kernel bit for bit against its plain
   version at the join's operands, the pair set against the fp64 oracle,
   the third join timed.
6. The mesh paths, their shards on the one card.  Kernel 4 (the per-shard
   int8 matmul) against its plain version, exact int32 equality, at two
   small shapes and at the mesh join's own per-shard operands (a diagonal
   and an off-diagonal panel pair at 1 shard and at 8), timed beside
   ``torch._int_mm`` on the same operands (a yardstick only: the port never
   calls it).  ``MeshChunkedAllPairs`` on phase 5's corpus: with
   ``make_mesh(1)``, counters zeroed, build + ``all_pairs(0.8)`` three times
   (the third timed with its stage split), kernel 4 launched once per panel
   pair per join; then once over ``make_mesh(8, devices=[cuda:0] * 8)``,
   8 launches per panel pair.  Kernel 5 (``pair_bits_int8``, the pair's
   summed-partial epilogue) launches once per panel pair at either shard
   count (one row slice on the one card); at 1 and 8 shards it is held
   bit for bit (gb, g64, counts) against its plain version at the join's
   own partials of a diagonal and an off-diagonal pair, timed beside it,
   with its bound (its bytes over the memory rate).
   ``MeshEngine(shard_axis="rows")`` over 4 shards of the card on phase
   3's corpus, three joins, kernel 3 launched 4
   times per join; then kernel 3 against its plain version, bit-identical,
   at the first and the last shard's own launch of that join (the gathered
   int8 index, the shard's striped schedule and valid flags).  Every mesh
   join's pair set equals the fp64 oracle and its candidate set that of the
   single-device join on the same corpus.

7. The full-rectangle join and everything that reaches it, each join
   gated on exact parity with the fp64 oracle of its corpus.
   ``Engine(use_pallas="off")`` on phase 3's 32,768 rows (bf16 operands,
   fp32 scores) and ``Engine(matmul_precision="highest")`` (a true fp32
   product) on the 8,586 rows and once at 32,768: build, three joins, the
   third timed with its stage split; the candidate set must contain the
   oracle's pairs; ``torch.backends.cuda.matmul.allow_tf32`` is printed
   before and after and must be unchanged, also when it was on.
   ``ChunkedAllPairs(pallas_int8=False)`` on phase 5's 100,000 rows: the
   bf16 stripes, three joins, pair set equal to phase 5's panel join
   (``stripe_parity``); stripe width, stripes, densify passes, stage split,
   peak memory; kernel 6 (``pair_bits_f32``, the stripes' threshold +
   bit-pack) launched once per stripe between zeroed counters, and held
   bit for bit against its plain version at the middle stripe's live rows
   (1 partial), timed against its bytes bound.  The ``highest`` stripes
   (``pallas_int8=False, matmul_precision="highest"``: true fp32 products)
   on phase 3's 32,768 rows: one join, kernel 6 once per stripe.  Then one
   join with ``_int8_stripes = True``: kernel 4 launched once per (stripe,
   chunk) and kernel 5 once per stripe, one (stripe, chunk) product
   compared bit for bit with its plain version and timed beside
   ``torch._int_mm``, kernel 5 held and timed at the middle stripe.  The
   meshes on the one card: ``MeshEngine(shard_axis="dims")`` over 4
   shards and a ``(2, 2)`` mesh on the 32,768 rows, phase 6's rows mesh
   joined once more after ``_int8_off = True``, and
   ``MeshChunkedAllPairs`` on the 100,000 rows (one join each): the bf16
   stripes over 8 shards (kernel 6 once per stripe on the 8 partials, no
   sum formed; held and timed at the middle stripe) and the int8 stripes
   over 4 (kernel 5 once per stripe).

8. The dense engine's streaming path on phase 3's corpus.  ``Engine``
   builds on rows 0-24,575; every other row is streamed through
   ``insert(tau=0.8)`` (16 batches of 1, 16 of 32, then 256-row batches to
   the last row), which grows the row capacity to 49,152.  Gates: the
   build join's pairs and every insert's output, as unordered pairs, equal
   the fp64 oracle's; ``all_pairs(0.8)`` of the streamed index launches
   kernel 1 (counters zeroed just before) and equals the oracle; the bf16
   copy the inserts kept equals ``x.to(bfloat16)`` bit for bit;
   ``topk(k=10)`` for 1,024 queries (512 corpus rows under new ids, 512 of
   another seed) matches a dense fp64 top-k on the card rank for rank
   within 1e-12 (ids equal where the 10th and 11th scores differ by more),
   with ``allow_tf32`` on beforehand and unchanged after; ``freeze`` then
   256 inserts (128 corpus copies, 128 of a third seed) equal the fp64
   oracle at tau = 0.8 and index nothing.  Then, on rows of their own
   seed, host-clock timings (warm, median of 9): insert + ``result()`` at
   bs = 1, 32 and 256 with the stage split at 256, eight bs = 256 batches
   pipelined one deep with ``defer=True``, ``topk`` and frozen matching.

9. The chunked engine's streaming path on phase 5's corpus: 9a builds on
   90,000 rows and streams the rest on the resident route (the streamed
   union, the join of the streamed index with kernel 3, top-k and frozen
   matching against fp64 oracles), 9b beyond the slab budget (the router,
   column growth, both routes forced), then each route's timings.

10. Checkpoints, the server and the command line, on the card.  10a:
    phase 8's streamed dense index (checkpointed right after its join) is
    restored with ``Engine.load``; its join launches kernel 1 (counters
    zeroed just before), equals the fp64 oracle, and kernel 1 equals its
    plain version bit for bit at the restored operands; phase 9a's
    streamed chunked index is restored with its ``build`` made to raise
    (the fast path must place the saved buffers), and its join launches
    kernel 3 and equals the oracle.  Save, restore and build seconds and
    the npz sizes are printed.  10b: phase 3's rows go into a
    ``VectorStore`` table; ``SimilarityServer`` + ``RpcServer`` on
    127.0.0.1 bulk-load the first 24,576 rows through a load RPC, four
    ``ClientConnection``s stream the other 8,192 concurrently (batches of
    1, 32, 256) while a subscriber collects the pushed outputs; the pushed
    pairs and the ``all_pairs`` RPC (kernel 1 launched) equal the oracle,
    the ``topk`` RPC for 256 queries equals ``engine.topk`` id for id, and
    the checkpoint ``close()`` writes restores into a second server with
    the same join.  10c: ``python -m apsim_tpu_torch.cli`` in subprocesses:
    ``etl`` of a seeded 3,000-document text corpus, ``build`` and
    ``join`` on the card (the join's output equals an in-process join of
    the same store), ``serve`` driven by ``bench`` (the load generator;
    its insert -> first-result latencies printed), stopped with SIGINT;
    the checkpoint it writes on the way out loads.

11. The meshes' streaming path, their shards on the one card.  11a:
    ``MeshEngine`` over ``make_mesh(4, devices=[card] * 4)`` with
    ``shard_axis="rows"``, then ``"dims"``, then a ``(2, 2)`` mesh, each
    built on phase 8's first 24,576 rows with the rest streamed on phase
    8's schedule (row_cap 24,576 -> 49,152): the build join and every
    insert's output equal the fp64 oracle; the join of the streamed index
    equals it (the rows layout launches kernel 3 four times, counters
    zeroed just before, and kernel 3 equals its plain version bit for bit
    at shards 0 and 3 of that join, shard 0 timed); every block equals
    phase 8's streamed ``x`` on its live rows and is zero past them;
    phase 8's top-k and frozen queries pass ``check_topk`` /
    ``check_frozen``.  11c, on the rows layout: ``SimilarityServer`` +
    ``RpcServer`` over the streamed mesh, two clients stream 2,048 fresh
    rows, the pushed pairs equal the fp64 oracle.  Then each layout's
    insert (bs = 1, 32, 256, stage split at 256), top-k and frozen-match
    timings.  11b: ``MeshChunkedAllPairs`` over 8 shards of the card on
    phase 5's corpus: build 90,000 rows, stream the rest with phase 9a's
    batch sizes (every match on the rebuild route); the union, the join
    of the streamed index (kernel 4 eight times per panel pair; kernel 4
    exactly its plain version at pair (0, last) of shard 0, timed beside
    ``torch._int_mm``), top-k and frozen matching against fp64; batches of
    rows inside the fullest chunk until every shard's per-chunk capacity
    doubles (asserted; each batch against the fp64 oracle, and the join
    after it); then the timings with the stage split (slabs, product,
    reduce, compact).

12. One index from two processes on the one card: the script starts two
    ranks of itself (``--phase12-rank``) in a ``gloo`` group (NCCL refuses
    two ranks on one card; the backend is printed), with phases 3, 5, 6
    and 11a's corpora, oracles and results passed through files.  12a:
    ``MeshEngine`` over ``global_mesh((4,))``, 2 shards a rank, rows then
    dims layout, phase 11a's build and stream: every insert output, the
    join's candidate lists (rows: kernel 3 launched once per own shard,
    counters zeroed just before, and bit for bit against its plain
    version at one own shard), 1,024 top-k lists and the frozen match
    equal phase 11a's one-process mesh bit for bit, and the pair sets the
    fp64 oracle.  12b: ``MeshChunkedAllPairs`` over ``global_mesh((8,))``,
    4 shards a rank, on phase 5's corpus: the join (kernel 4 four times a
    panel pair on each rank, exact against its plain version at an own
    shard) equals phase 5's pair set and phase 6's candidate set; 512
    fresh rows streamed on the rebuild route equal the fp64 oracle.  Each
    rank prints its build, join and insert times (bs = 1 and 256, with
    the stage split and the cross-process stage), top-k time and the
    bytes that crossed processes.  12c: ``python -m apsim_tpu_torch.cli
    serve --replicate`` in two processes (rows layout, ``--mesh-shape
    4``); a client streams 2,048 rows, the ``all_pairs`` RPC equals the
    fp64 oracle, each rank launched kernel 3, and after SIGINT the
    follower prints "leader closed" and exits 0.
13. The benchmark suite and the stage probes (``apsim_tpu_torch/bench/``)
    through their entry points, each between zeroed launch counters:
    ``suite.run_suite`` on ``synthetic_corpus(8586, seed=0)`` at taus 0.5
    and 0.8 (``stream_batch=256``, 1,024 top-k queries, the mesh over
    every visible card): every threshold's ``parity_full``, the stream
    equal to the batch join, top-k self-match 1.0, the mesh equal to the
    single device, no leg holding ``"error"``, kernels 1 and 3 launched;
    ``scale.run_scale`` at 8,586 rows (the suite's pair count at 0.8);
    ``join_probe.probe_size`` at 8,586 and 32,768 rows (kernel 1, 17
    launches a size; the 8,586-row kernel-only launch bit for bit against
    its plain version); ``insert_probe`` at 20,000 rows with ``--stages``;
    ``panel_probe`` at 100,000 rows with ``--joins-only`` (kernel 3 once a
    panel pair a join, phase 5's pair count); ``serve_probe`` at 100,000
    rows, 1,000 vectors/s for 10 s (every offered vector indexed).  Each
    record is printed on a line of its own, and each kernel's record gets
    the phase's launches (``bench_launches``).
14. ``bench_torch.py``'s runners (``bench_torch.run_cell``) for
    ``dense_int8_join_8586`` with 3 timed joins (no time window) and
    ``dense_insert_bs32`` (build 24,576 rows, 256 batches of 32), each
    between zeroed launch counters: every gate of the cell holds (the
    join's pairs against the fp64 oracle, every batch's against its own),
    kernel 1 launched by the join and no kernel by the inserts, and each
    record carries its metrics.  Each kernel's record gets the launches
    (``bench_torch_launches``).
15. The deploy scripts (``sbin_torch/``) as an operator runs them, from a
    directory outside the checkout: ``python -m apsim_tpu_torch.cli etl``
    of a seeded 8,586-document text corpus (what the preprocess container
    runs); ``start-all.sh`` without a hosts file starts the local daemon
    on the card and returns once it serves; a ``ClientConnection``
    bulk-loads the table; the ``all_pairs`` RPC's pair set equals the
    fp64 oracle (``bench/ooc.batch_oracle`` over the table, its columns
    renumbered) and launched kernel 1 in the daemon (the daemon's launch
    counts, read over the ``stats`` RPC just before and just after; its
    ``kernel`` section), whose process holds the card's device files
    open; ``start-test.sh`` runs the load generator (400 messages);
    ``daemon.sh start`` on the held port exits non-zero and leaves no PID
    file; ``stop-all.sh`` stops the daemon with SIGINT, ``status`` says
    stopped, and the checkpoint written on the way out loads with every
    row the daemon held (the table and the load test's warm-up copy).
    Each kernel's record gets the daemon's launches (``deploy_launches``).
16. The schedule and slab studies (``apsim_tpu_torch/bench/``), between
    zeroed launch counters: ``tri_probe`` at 8,192 x 16,384 on one device
    and over a dims mesh of 4 shards of the card (parity leg: the
    triangle's pairs equal the rectangle's folded); ``mesh_tri_probe`` at
    8,192 rows over 4 shards (the rectangle's candidates folded equal the
    triangle's; the flops per device its dispatch counter saw equal the
    closed form of each schedule); ``ell_probe``'s two formulations on
    phase 5's first 98,304 rows, K 192, bs 256, each count inside the
    bracket of the fp64 contraction of the same operands (cells within
    ``(K + 2) * 2^-23`` of the sum of their terms' magnitudes from tau
    may fall either side; the phase prints how many).  None of the four
    kernels launches (each kernel's record gets ``study_launches``).

17. (``--mesh-cards N`` only.)  The one-process meshes with one shard a
    card, each leg run first with every shard on card 0 (the same mesh,
    the same run) and held to it bit for bit (``equal_bits``: pair sets
    with their similarities, every insert's output, the candidate lists,
    the top-k lists, the frozen matches, the blocks) and to the fp64
    oracle.  Kernels 1 and 2 first, against their plain versions on every
    card (phase 2's index, built on that card).  17a: ``MeshEngine`` over
    ``make_mesh(shape, devices=[cuda:0 .. cuda:N-1])`` in phase 11a's three
    layouts through ``mesh_dense_stream`` (build, join, the stream with its
    row growth, the streamed join: the rows layout launches kernel 3 once
    on each card, ``LAUNCHES_BY_CARD``, and it equals its plain version at
    each card's own operands; top-k, frozen matching, the in-process
    server on the rows layout, the timings; every shard's blocks on its
    own card), then the warm join's wall time (median of 5, stage split),
    new dims (column growth, dormant activation) against the fp64 oracle
    and the join of the grown index.  17b: ``MeshChunkedAllPairs`` over N
    cards on phase 5's corpus through ``mesh_chunked_stream`` (kernels 4
    and 5 once a card a panel pair, kernel 4 exactly its plain version on
    each card, kernel 5 bit for bit its plain version on each card's row
    slice of the partials); then its stripe joins (17b stripes: the bf16
    stripes and the int8 stripes, one join each, on card 0 and over the
    cards): kernel 6 (or kernel 5) once a card a stripe, the candidate
    lists and the join bit for bit the same mesh's on card 0 and the pair
    set the fp64 oracle's, the kernel bit for bit its plain version on
    each card's row slice of the middle stripe.  17c: ``MeshChunkedAllPairs`` joins
    ``synthetic_corpus(500000)`` (made in a process of its own meanwhile)
    twice with every shard on card 0 and twice over the cards, the two bit
    for bit equal and their pair set that of one-card ``ChunkedAllPairs``;
    wall times, stage split, each card's peak memory.  17d: ``python -m
    apsim_tpu_torch.cli serve --mesh --mesh-shape N`` (rows layout): a load
    RPC of phase 3's rows, the ``all_pairs`` RPC against the fp64 oracle,
    two clients streaming fresh rows against it, SIGINT (kernel 3 once a
    card in the server); the checkpoint restores onto the cards and onto a
    one-card ``Engine`` with equal joins (kernel 1 bit for bit at the
    restored operands).  ``nvidia-smi topo -m`` and
    ``can_device_access_peer`` of every pair are printed first, a summary
    of every leg's timings and peak memory last.

Every kernel's record holds its bound: the larger of its operations over
the card's peak rate for their type and its bytes (inputs read once,
outputs written once) over the memory rate, at this run's shapes.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import bench_torch
from apsim_tpu_torch import (AllPairsConfig, ChunkedAllPairs, CSRMatrix,
                             Engine, MeshChunkedAllPairs, MeshEngine,
                             SparseVector, make_mesh)
from apsim_tpu_torch.bench import (ell_probe, insert_probe, join_probe,
                                   mesh_tri_probe, panel_probe, scale,
                                   serve_probe, suite, tri_probe)
from apsim_tpu_torch.bench.mfu import H100_SXM
from apsim_tpu_torch.bench.ooc import (batch_oracle, csr_rows, dense_rows,
                                       join_ops, profile_join)
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import _build, panel as panel_ops, tri_score as ts
from apsim_tpu_torch.ops import chunked as chunked_ops
from apsim_tpu_torch.ops import mesh_pallas, panel_mesh
from apsim_tpu_torch.ops import score as score_ops
from apsim_tpu_torch.parallel.collectives import all_gather, gather_rows
from apsim_tpu_torch.vector.batch import round_up

TAU = 0.8
BF16_BAND = 1e-5  # |plain fp32 score - tau_eff| allowed where bf16 bits differ
SOURCE = "apsim_tpu_torch/csrc/score_bits.cu"
REPLACES = {
    "score_bits_int8": "apsim_tpu/ops/pallas_score.py:453",  # _kernel_int8
    "score_bits_bf16": "apsim_tpu/ops/pallas_score.py:117",  # _kernel
    "panel_score_bits_int8": "apsim_tpu/ops/panel.py:151",  # _kernel_int8_cross
    "int8_matmul": "apsim_tpu/ops/panel_mesh.py:42",  # _mm_kernel
    # not Pallas kernels: the psum + bound + bit-pack XLA fuses in
    # mesh_panel_pair's shard_map body, and the psum + threshold + bit-pack
    # XLA builds behind the bf16 / fp32 stripes (join_epilogue_bits)
    "pair_bits_int8": "apsim_tpu/ops/panel_mesh.py:183",
    "pair_bits_f32": "apsim_tpu/ops/chunked.py:288",
    # the XLA ops of _compact_bits (three nonzero levels), not Pallas
    "compact_bits": "apsim_tpu/ops/pallas_score.py:320",
}
# the kernels that write bit-packed hits: kernel 7 compacts each of their
# launches once, on the same card
BITS_KERNELS = ("score_bits_int8", "score_bits_bf16", "panel_score_bits_int8",
                "pair_bits_int8", "pair_bits_f32")
OOC_ROWS = 100_000
# H100 SXM peaks (NVIDIA data sheet, dense; ``bench/mfu.py``): int8 ops/s,
# bf16 flop/s, fp32 flop/s outside the tensor cores, HBM bytes/s
PEAK_INT8, PEAK_BF16, PEAK_FP32, HBM_BYTES_PER_S = (
    H100_SXM[k] for k in ("int8", "bf16", "fp32", "hbm"))


_LOG = threading.Lock()  # the relays of phase 12 log from threads


def log(*a) -> None:
    with _LOG:
        print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def median_ms(fn, reps: int = 5, dev=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events on the
    current stream of ``dev``, the card ``fn`` runs on; default the
    current card)."""
    times = []
    with (torch.cuda.device(dev) if dev is not None
          else contextlib.nullcontext()):
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(ops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of the operations
    over ``peak`` and the bytes over the memory rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def upper_cells(bi, bj, tm: int, tn: int, off=(0, 0)) -> int:
    """Cells of the blocks (bi, bj) whose global row lies below their
    global column: the cells a scorer must compute."""
    r = (off[0] + bi.cpu().numpy().astype(np.int64)[:, None] * tm
         + np.arange(tm))
    c0 = off[1] + bj.cpu().numpy().astype(np.int64)[:, None] * tn
    return int(np.clip(c0 + tn - (r + 1), 0, tn).sum())


def score_bound(operands, aux_bytes: int, bi, bj, tm: int, tn: int,
                off, peak: float) -> dict:
    """Bound of one score-kernel launch: 2 ops per cell per K element on
    the strict-upper cells; the operand and aux bytes, the block list, and
    the gb / g64 / cnt outputs."""
    k = operands[0].shape[1]
    n = bi.numel()
    nbytes = (sum(o.numel() * o.element_size() for o in operands)
              + aux_bytes + 8 * n + n * (tm // 8 * tn + tm // 64 * tn + 12))
    return bound(2 * upper_cells(bi, bj, tm, tn, off) * k, nbytes, peak)


def blocks(row_cap: int, tm: int, tn: int, dev):
    bi, bj = ts.upper_blocks_rect(row_cap, tm, tn)
    return torch.from_numpy(bi).to(dev), torch.from_numpy(bj).to(dev)


def check_packing(out, step: int = 8) -> None:
    """The kernel's g64 and cnt must be what its own gb implies."""
    gb, g64, cnt = out
    for s in range(0, gb.shape[0], step):
        e = min(s + step, gb.shape[0])
        _, r64, rcnt = ts.bitpack_mask(ts.unpack_bits(gb[s:e]))
        if not (torch.equal(r64, g64[s:e]) and torch.equal(rcnt, cnt[s:e])):
            raise AssertionError(f"g64/cnt disagree with gb in blocks {s}:{e}")


def compare(kind: str, ops, bi, bj, tau_eff, tm: int, tn: int,
            timed: bool, band: float = BF16_BAND) -> dict:
    """Kernel vs plain version on the same operands; returns the record.
    ``band``: how far from tau_eff the plain fp32 score of a cell may lie
    when the bf16 kernel's bit differs."""
    if kind == "int8":
        kern = lambda: ts.score_bits_int8(*ops, bi, bj, tau_eff, tm, tn)
        plain = lambda: ts.score_bits_int8_plain(*ops, bi, bj, tau_eff, tm, tn)
    else:
        kern = lambda: ts.score_bits_bf16(ops, bi, bj, tau_eff, tm, tn)
        plain = lambda: ts.score_bits_bf16_plain(ops, bi, bj, tau_eff, tm, tn)
    k = kern()
    torch.cuda.synchronize()
    p = plain()
    check_packing(k)
    rec = {"tiles": [tm, tn], "blocks": int(bi.numel()),
           "pairs_kernel": int(k[2][:, 0].sum()),
           "pairs_plain": int(p[2][:, 0].sum())}
    if kind == "int8":
        err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, p))
        if err:
            n = int((ts.unpack_bits(k[0]) != ts.unpack_bits(p[0])).sum())
            raise AssertionError(
                f"int8 kernel differs from plain at tiles {(tm, tn)}: "
                f"{n} hit cells, max byte error {err}"
            )
        rec.update(max_abs_err=0.0, cells_differing=0)
    else:
        worst, n_diff = 0.0, 0
        for s, e, v in ts.bf16_scores(ops, bi, bj, tm, tn):
            d = ts.unpack_bits(k[0][s:e]) != ts.unpack_bits(p[0][s:e])
            if bool(d.any()):
                n_diff += int(d.sum())
                worst = max(worst, float((v[d] - float(tau_eff)).abs().max()))
        if worst > band:
            raise AssertionError(
                f"bf16 kernel differs from plain at tiles {(tm, tn)} on "
                f"{n_diff} cells; worst |score - tau_eff| = {worst} > {band}"
            )
        rec.update(max_abs_err=worst, cells_differing=n_diff)
    del k, p
    if timed:
        rec["ms"] = median_ms(kern)
        rec["plain_ms"] = median_ms(plain)
    return rec


def oracle_pairs(csr: CSRMatrix, tau: float, dev) -> set:
    """Exact fp64 pair set: dense product of the raw CSR (np.unique column
    remap) on the card, 4,096 rows at a time, strict upper triangle."""
    active, cols = np.unique(csr.indices, return_inverse=True)
    rows = np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr))
    d = torch.zeros((csr.n_rows, active.size), dtype=torch.float64, device=dev)
    d[torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)] = (
        torch.from_numpy(csr.data).to(dev)
    )
    out = set()
    for r0 in range(0, csr.n_rows, 4096):
        r1 = min(r0 + 4096, csr.n_rows)
        ii, jj = torch.nonzero(d[r0:r1] @ d[r0:].T >= tau, as_tuple=True)
        ii, jj = ii + r0, jj + r0
        keep = ii < jj
        out.update(zip(ii[keep].tolist(), jj[keep].tolist()))
    return out


def pair_set(pairs) -> set:
    """(row, col) arrays as a set of int pairs."""
    return set(zip(pairs[0].tolist(), pairs[1].tolist()))


def check_parity(res, want: set, label: str) -> int:
    got = set(zip(res.i.tolist(), res.j.tolist()))
    if got != want:
        raise AssertionError(
            f"{label}: pair set differs from the fp64 oracle: "
            f"{len(got - want)} extra, {len(want - got)} missing "
            f"(e.g. extra {sorted(got - want)[:5]}, "
            f"missing {sorted(want - got)[:5]})"
        )
    log(f"{label}: parity OK, {len(got)} pairs equal the fp64 oracle")
    return len(got)


def timed_join(eng: Engine, label: str) -> dict:
    """all_pairs(TAU) three times; the third is timed with its stage split."""
    eng.all_pairs(TAU)
    eng.all_pairs(TAU)
    before = dict(eng.timer.totals)
    cand0 = eng.stats["candidate_pairs"]
    t0 = time.perf_counter()
    res = eng.all_pairs(TAU)
    secs = time.perf_counter() - t0
    stages = {k: v - before.get(k, 0.0) for k, v in eng.timer.totals.items()}
    n = eng.n_rows
    rec = {
        "rows": n, "row_cap": eng.row_cap, "dim_cap": eng.dim_cap,
        "seconds": secs, "decided_pairs_per_s": n * (n - 1) / 2 / secs,
        "candidates": eng.stats["candidate_pairs"] - cand0,
        "pairs": res.n_pairs, "stages_s": stages,
    }
    log(f"{label}: {json.dumps(rec)}")
    return {"rec": rec, "res": res}


def compare_cross(args, valid, label: str, timed: bool) -> dict:
    """Cross-panel kernel vs its plain version on the wrapper's positional
    ``args`` and ``valid``, bit-identical; a block with valid = 0 must
    write nothing."""
    kern = lambda: panel_ops.panel_score_bits_int8(*args, valid=valid)
    plain = lambda: panel_ops.panel_score_bits_int8_plain(*args, valid=valid)
    bi, bj, off, tm, tn = args[4], args[5], args[6], args[8], args[9]
    dev = args[0].device
    k = kern()
    torch.cuda.synchronize(dev)
    p = plain()
    check_packing(k)
    err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, p))
    if err:
        n = int((ts.unpack_bits(k[0]) != ts.unpack_bits(p[0])).sum())
        raise AssertionError(
            f"panel kernel differs from plain ({label}) at tiles "
            f"{(tm, tn)}: {n} hit cells, max byte error {err}"
        )
    if valid is not None:
        off_blocks = valid == 0
        if k[0][off_blocks].any() or k[2][off_blocks].any():
            raise AssertionError("a block with valid = 0 wrote hits or counts")
    rec = {"offsets": list(off), "tiles": [tm, tn], "blocks": int(bi.numel()),
           "pairs_kernel": int(k[2][:, 0].sum()), "max_abs_err": 0.0}
    del k, p
    if timed:
        rec["ms"] = median_ms(kern, dev=dev)
        rec["plain_ms"] = median_ms(plain, dev=dev)
        rec["tops"] = (rec["blocks"] * tm * tn * args[0].shape[1] * 2
                       / rec["ms"] / 1e9)
        rec.update(score_bound(args[:2], 4 * (args[2].numel()
                                              + args[3].numel()),
                               bi, bj, tm, tn, off, PEAK_INT8))
    return rec


def compare_panel(eng: ChunkedAllPairs, pi: int, pj: int, tm: int, tn: int,
                  timed: bool, blank: bool = False) -> dict:
    """Cross-panel kernel vs its plain version on panels (pi, pj) of a
    chunked engine's join state; with ``blank`` every third block is
    blanked by valid = 0."""
    st = eng._panel_state()
    rb = st["geom"][0]
    grid = (panel_ops.diag_grid(rb, tm, tn) if pi == pj
            else panel_ops.full_grid(rb, rb, tm, tn))
    bi, bj = (torch.from_numpy(a).to(eng.device) for a in grid)
    valid = None
    if blank:
        valid = torch.ones_like(bi)
        valid[1::3] = 0
    args = (eng._build_slab(st, pi), eng._build_slab(st, pj),
            st["aux_of"][pi], st["aux_of"][pj], bi, bj, (pi * rb, pj * rb),
            eng._tau_eff(TAU), tm, tn)
    rec = compare_cross(args, valid, f"pair {(pi, pj)}", timed)
    return {"pair": [pi, pj], "blanked": blank, **rec}


def int8_rows(dev, rows: int, k: int, seed: int):
    """int8 operands and aux of ``rows`` random unit rows of width ``k``,
    every fourth row a copy of the one before (hits at TAU)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, k), device=dev, generator=gen)
    x[1::4] = x[0::4]
    x /= x.norm(dim=1, keepdim=True)
    return ts.quantize_rows(x)


def bf16_rows(dev, rows: int, pad: int, k: int, seed: int,
              positive: bool = False):
    """bf16 operand of ``rows`` random unit rows of width ``k`` (every
    fourth a copy of the one before; all elements positive on request) and
    ``pad`` zero rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, k), device=dev, generator=gen)
    if positive:
        x.abs_()
    x[1::4] = x[0:-1:4]
    x /= x.norm(dim=1, keepdim=True)
    return torch.cat([x, torch.zeros((pad, k), device=dev)]).to(torch.bfloat16)


def bf16_edge_phase(dev) -> None:
    """The bf16 kernel at the edges of its tiling and ring (phase 1)."""
    for k in (64, 2048):
        tau = 2.4 / k ** 0.5  # 2.4 sigma of a random pair's score
        for tm, tn in ((1024, 512), (512, 512), (256, 256), (64, 128)):
            x = bf16_rows(dev, 1900, 148, k, tm + k)
            bi, bj = blocks(2048, tm, tn, dev)
            rec = compare("bf16", x, bi, bj, tau, tm, tn, timed=False)
            few = compare("bf16", x, bi[:1], bj[:1], tau, tm, tn,
                          timed=False)
            if rec["pairs_kernel"] < 1000 or few["pairs_kernel"] < 1:
                raise AssertionError(
                    f"bf16 edge K={k} tiles {(tm, tn)}: too few hits to "
                    f"tell: {rec['pairs_kernel']}, {few['pairs_kernel']}")
            log(f"phase 1 bf16 edges K={k} tiles {(tm, tn)} thread-block "
                f"tile {ts.thread_block_tile(tm, tn)}: {rec['pairs_kernel']} "
                f"pairs ({rec['cells_differing']} cells differ from plain, "
                f"worst |score - tau| {rec['max_abs_err']:.3g} <= "
                f"{BF16_BAND}); one block: {few['pairs_kernel']} pairs "
                f"({few['cells_differing']} differ)")
    k = 32768
    band = (k + 2) * 2.0 ** -24
    x = bf16_rows(dev, 2048, 0, k, 11, positive=True)
    bi, bj = blocks(2048, 1024, 512, dev)
    tau = float(next(ts.bf16_scores(x, bi[:1], bj[1:2], 1024, 512))[2]
                .median())
    rec = compare("bf16", x, bi, bj, tau, 1024, 512, timed=False, band=band)
    if not 0.2 < rec["pairs_kernel"] / upper_cells(bi, bj, 1024, 512) < 0.8:
        raise AssertionError(f"dense stress: threshold off the bulk: {rec}")
    log(f"phase 1 bf16 dense stress, 2048 rows of {k} positive elements, "
        f"tau {tau:.6f}: {rec['pairs_kernel']} pairs, "
        f"{rec['cells_differing']} cells differ from plain, worst "
        f"|score - tau| {rec['max_abs_err']:.3g} <= {band:.3g} "
        f"((K + 2) * 2^-24)")


def edge_phase(dev) -> None:
    """The int8 kernels at the edges of their tiling and ring (phase 1)."""
    for k in (128, 4096):
        for tm, tn in ((1024, 512), (512, 512), (256, 256), (64, 128)):
            q, aux = int8_rows(dev, 2048, k, tm + k)
            bi, bj = blocks(2048, tm, tn, dev)
            rec = compare("int8", (q, aux), bi, bj, TAU, tm, tn, timed=False)
            recs = [rec["pairs_kernel"]]
            gi, gj = (torch.from_numpy(a).to(dev)
                      for a in panel_ops.full_grid(1024, 1024, tm, tn))
            valid = torch.ones_like(gi)
            valid[::3] = 0
            ai, aj = aux[:, :1024].contiguous(), aux[:, 1024:].contiguous()
            for off in ((0, 1024), (512, 768), (1024, 0)):
                args = (q[:1024], q[1024:], ai, aj, gi, gj, off, TAU, tm, tn)
                recs.append(compare_cross(args, valid, f"edge {off}",
                                          timed=False)["pairs_kernel"])
            if recs[0] == 0 or recs[-1] != 0:
                raise AssertionError(
                    f"edge K={k} tiles {(tm, tn)}: expected hits in the "
                    f"triangle and none in the dead rectangle, got {recs}")
            log(f"phase 1 edges K={k} tiles {(tm, tn)} thread-block tile "
                f"{ts.thread_block_tile(tm, tn)}: bit-identical; pairs (triangle, "
                f"(0, 1024), (512, 768), dead (1024, 0)) = {recs}")
    k = 32768
    gen = torch.Generator(device=dev).manual_seed(7)
    sign = torch.randint(0, 2, (256, 1), device=dev, generator=gen)
    q = (127 * (2 * sign - 1)).to(torch.int8).expand(256, k).contiguous()
    d = panel_mesh.int8_matmul(q[:128], q)
    if (not torch.equal(d, panel_mesh.int8_matmul_plain(q[:128], q))
            or int(d.abs().max()) != 127 * 127 * k):
        raise AssertionError("kernel 4 is not exact on ±127 rows, K = 32768")
    aux = torch.stack([torch.full((256,), 1 / 127 / 181.02, device=dev),
                       torch.ones(256, device=dev),
                       torch.full((256,), float(k), device=dev)])
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    rec = compare_cross((q, q, aux, aux, zero, zero, (0, 256), 0.5, 256, 256),
                        None, "±127 rows", timed=False)
    log(f"phase 1 edges ±127 rows, K = {k}: kernel 4 exact (|D| = "
        f"{int(d.abs().max())}), kernel 3 bit-identical "
        f"({rec['pairs_kernel']} pairs)")
    del q, d
    for m, n, dd in ((64, 128, 128), (128, 256, 128), (128, 256, 4096),
                     (192, 384, 256), (8192, 256, 128)):
        gen = torch.Generator(device=dev).manual_seed(m * n + dd)
        xi, xj = (torch.randint(-127, 128, (r, dd), dtype=torch.int8,
                                device=dev, generator=gen) for r in (m, n))
        if not torch.equal(panel_mesh.int8_matmul(xi, xj),
                           panel_mesh.int8_matmul_plain(xi, xj)):
            raise AssertionError(f"kernel 4 differs at {(m, n, dd)}")
        log(f"phase 1 edges kernel 4 [{m}, {dd}] x [{n}, {dd}]^T, thread-"
            f"block tile {ts.thread_block_tile(m, n)}: exact")


def compare_rows_shard(eng: MeshEngine, s: int, timed: bool = False) -> dict:
    """The cross-panel kernel vs its plain version on shard ``s``'s launch
    of the rows mesh join: the all-gathered int8 index and aux, the shard's
    striped schedule and its valid flags, zero offsets, the path's tiles
    (``timed``: with its time, its plain version's and its bound)."""
    dev = eng.mesh.devices[s]
    tm, tn = eng._mesh_rows_geom()
    bi, bj, va = (torch.from_numpy(a[s]).to(dev) for a in
                  mesh_pallas.rows_schedule(eng.row_cap, eng.n_shards, tm, tn))
    mesh = eng.mesh  # on a mesh over processes: this process's blocks
    qa = {t: ts.quantize_rows(eng.x_blocks[t]) for t in mesh.local_shards}
    qg = all_gather([qa[t][0] if t in qa else None
                     for t in range(mesh.size)], 0, dev, mesh)
    ag = all_gather([qa[t][1] if t in qa else None
                     for t in range(mesh.size)], 1, dev, mesh).contiguous()
    del qa
    args = (qg, qg, ag, ag, bi, bj, (0, 0), eng._tau_eff(TAU), tm, tn)
    rec = compare_cross(args, va, f"rows mesh shard {s}", timed=timed)
    if timed:  # the live blocks only; the gathered copy read once
        live = va > 0
        rec.update(score_bound((qg,), 4 * ag.numel(), bi[live], bj[live],
                               tm, tn, (0, 0), PEAK_INT8))
    return {"shard": s, "live_blocks": int(va.sum()), **rec}


def ooc_join(eng: ChunkedAllPairs, label: str, reps: int,
             ops_of=join_ops) -> dict:
    """``reps`` joins at TAU; the last is timed with its stage split.
    ``ops_of(geom)`` gives the join's int8 operations."""
    for _ in range(reps - 1):
        eng.all_pairs(TAU)
    before = dict(eng.timer.totals)
    counts0 = dict(eng.timer.counts)
    cand0 = eng.stats["candidates_scored"]
    t0 = time.perf_counter()
    res = eng.all_pairs(TAU)
    secs = time.perf_counter() - t0
    stages = {k: v - before.get(k, 0.0) for k, v in eng.timer.totals.items()
              if k != "all_pairs"}
    n = eng.n_rows
    geom = eng._panel_geom()
    ops = ops_of(geom)
    rec = {
        "rows": n, "geom": dict(zip(("rb", "tm", "tn", "n_panels", "d_cap"),
                                    geom)),
        "seconds": secs, "decided_pairs_per_s": n * (n - 1) / 2 / secs,
        "candidates": eng.stats["candidates_scored"] - cand0,
        "pairs": res.n_pairs, "stages_s": stages,
        "slab_builds": eng.timer.counts["slabs"] - counts0.get("slabs", 0),
        "int8_ops": ops, "kernel_stage_tops": ops / stages["kernel"] / 1e12,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    log(f"{label}: {json.dumps(rec)}")
    return {"rec": rec, "res": res}


OFF2048_ROWS = 24_000  # phase 5c's corpus
OFF2048_CHUNK = 1536  # a chunk width whose d_cap is no multiple of 2,048


def off2048_leg(dev, kernels: list) -> None:
    """Phase 5c: ``ChunkedAllPairs`` with ``chunk_dim`` 1,536 on
    ``synthetic_corpus(24000, seed=5)``, so ``d_cap`` is no multiple of
    2,048 and the geometry takes (64, 128) block tiles, which kernel 3
    runs through its 64 x 128 thread-block instantiation.  Counters zeroed
    just before build + three joins: kernel 3 launched once per panel pair
    per join; the kernel bit for bit against its plain version at the
    join's last off-diagonal pair (timed); the pair set equal to the fp64
    oracle; the third join timed with its stage split."""
    csr = synthetic_corpus(OFF2048_ROWS, seed=5)
    eng = ChunkedAllPairs(AllPairsConfig(), dev, chunk_dim=OFF2048_CHUNK)
    zero_launches()
    eng.build(csr)
    label = f"phase 5c, chunk_dim {OFF2048_CHUNK}, {OFF2048_ROWS} rows"
    j = ooc_join(eng, label, reps=3)
    got = dict(ts.LAUNCHES)
    rb, tm, tn, n_panels, d_cap = eng._panel_geom()
    if (tm, tn) != (64, 128) or d_cap % 2048 == 0:
        raise AssertionError(f"{label}: geometry {eng._panel_geom()} does "
                             f"not take the (64, 128) tiles")
    if ts.thread_block_tile(tm, tn) != (64, 128):
        raise AssertionError(f"{label}: thread-block tile "
                             f"{ts.thread_block_tile(tm, tn)}")
    expect = {k: 0 for k in got}
    expect["panel_score_bits_int8"] = 3 * n_panels * (n_panels + 1) // 2
    expect = with_compactions(expect)
    if got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    rec = compare_panel(eng, 0, n_panels - 1, tm, tn, timed=True)
    log(f"{label}: panel kernel at the join's operands: {json.dumps(rec)}")
    check_parity(j["res"], oracle_pairs(csr, TAU, dev), label)
    if not np.all(np.isfinite(j["res"].sims)):
        raise AssertionError(f"{label}: non-finite sims")
    k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
    k3.update(off2048_launches=got["panel_score_bits_int8"],
              off2048_ms=rec["ms"], off2048_plain_ms=rec["plain_ms"],
              off2048_bound_ms=rec["bound_ms"],
              off2048_join_seconds=j["rec"]["seconds"])


def zero_launches() -> None:
    ts.zero_launches()


def kernel_device_ms(fn, part: str, reps: int = 20) -> float:
    """Device time a call of ``fn`` spends in the kernels whose names hold
    ``part``, from ``torch.profiler`` over ``reps`` calls (a launch that
    takes microseconds on the card takes longer to launch from the host, so
    events around one call time the host)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and part in e.name)
    if us <= 0:
        raise AssertionError(f"no kernel named *{part}* in the trace")
    return us / reps / 1e3


def compare_compact(bits, bi, bj, tm: int, tn: int, label: str) -> dict:
    """Kernel 7 against the plain chain (``compact_bits_plain`` on the
    card) on one hit structure: the same lists, value and order, and the
    decoded counts equal to the kernel's; then each timed beside its bytes
    bound (every g64 byte, 8 gb bytes a hit super, 16 bytes written a
    hit): kernel 7's three passes by their device time
    (``kernel_device_ms``), one call end to end on the stream (CUDA
    events, its host launch included: ``launch_ms``), the chain end to
    end, its waits included (median of 5)."""
    gb, g64, cnt = bits
    pre = tm % ts.SUPER2 == 0
    total, groups, supers = cnt.sum(dim=0, dtype=torch.int64).tolist()
    got = torch.zeros(3, dtype=torch.int64, device=gb.device)
    r, c = ts.compact_bits_cuda(gb, g64, bi, bj, tm, tn, pre, total, got)
    pr, pc, found = ts.compact_bits_plain(gb, g64, bi, bj, tm, tn, pre)
    if not (torch.equal(r, pr) and torch.equal(c, pc)):
        raise AssertionError(f"{label}: kernel 7's lists differ from the "
                             f"plain chain's")
    if got.tolist() != [total, groups, supers] or found[::-1] != (
            total, groups, supers):
        raise AssertionError(f"{label}: decoded {got.tolist()}, plain "
                             f"{found[::-1]}, counted "
                             f"{[total, groups, supers]}")
    def kernel():
        return ts.compact_bits_cuda(gb, g64, bi, bj, tm, tn, pre, total, got)

    ms = kernel_device_ms(kernel, "compact_")
    launch_ms = median_ms(kernel, reps=20)
    plain_ms = median_ms(lambda: ts.compact_bits_plain(
        gb, g64, bi, bj, tm, tn, pre))
    rec = {"label": label, "blocks": bi.numel(), "tm": tm, "tn": tn,
           "pre_level": pre, "hits": total, "hit_supers": supers,
           "g64_bytes": g64.numel(), "ms": ms, "launch_ms": launch_ms,
           "plain_ms": plain_ms,
           **bound(0, g64.numel() + 8 * supers + 16 * total, PEAK_INT8)}
    log(f"kernel 7, {label}: {json.dumps(rec)}")
    return rec


def sweep_pair_bits(eng: ChunkedAllPairs, rb: int = 8192):
    """Kernel 3's hit structure of the off-diagonal pair of rows ``[0,
    rb)`` and ``[rb, 2 rb)`` of ``eng``'s index at ``rb``-row panels (the
    8,192 rows of the benchmark's join), with the pair's global block ids:
    ``(bits, bi, bj, tm, tn)``."""
    st = eng._panel_state()
    rb0, tm, tn, n_panels, d_cap = st["geom"]
    end = int(st["starts"][min(-(-2 * rb // rb0), n_panels)])
    xi, xj = (panel_ops.build_panel_slab(st["r_s"], st["gc_s"], st["q_s"],
                                         0, end, r0, rb, d_cap)
              for r0 in (0, rb))
    ai, aj = (st["aux_p"][:, r0:r0 + rb].contiguous() for r0 in (0, rb))
    bi, bj = (torch.from_numpy(a).to(xi.device)
              for a in panel_ops.full_grid(rb, rb, tm, tn))
    bits = panel_ops.panel_score_bits_int8(xi, xj, ai, aj, bi, bj, (0, rb),
                                           eng._tau_eff(TAU), tm, tn)
    return bits, bi, bj + rb // tn, tm, tn


def launches_by_card() -> dict:
    """``ts.LAUNCHES_BY_CARD`` as a plain copy."""
    return {k: dict(v) for k, v in ts.LAUNCHES_BY_CARD.items()}


def mesh_join_ops(geom) -> int:
    """int8 operations of one mesh panel join: every panel pair is a full
    ``rb x rb`` rectangle over the global width."""
    rb, _, _, n_panels, d_cap = geom
    return n_panels * (n_panels + 1) // 2 * 2 * rb * rb * d_cap


def compare_mm(xi, xj, label: str) -> dict:
    """Kernel 4 against its plain version on (xi, xj), exact int32
    equality; timed (CUDA events, median of 5) beside ``torch._int_mm`` on
    the same operands, the library yardstick."""
    dev = xi.device
    k = panel_mesh.int8_matmul(xi, xj)
    torch.cuda.synchronize(dev)
    p = panel_mesh.int8_matmul_plain(xi, xj)
    if not torch.equal(k, p):
        raise AssertionError(
            f"int8_matmul differs from plain ({label}): "
            f"{int((k != p).sum())} cells")
    lib_equal = bool(torch.equal(torch._int_mm(xi, xj.t()), k))
    del k, p
    (m, d), n = xi.shape, xj.shape[0]
    ops = 2 * m * n * d
    rec = {"label": label, "m": m, "n": n, "d": d, "max_abs_err": 0.0,
           "library_equal": lib_equal,
           "ms": median_ms(lambda: panel_mesh.int8_matmul(xi, xj), dev=dev),
           "plain_ms": median_ms(lambda: panel_mesh.int8_matmul_plain(xi, xj),
                                 dev=dev),
           "library_ms": median_ms(lambda: torch._int_mm(xi, xj.t()),
                                   dev=dev)}
    rec["tops"] = ops / rec["ms"] / 1e9
    rec.update(bound(ops, (m + n) * d + 4 * m * n, PEAK_INT8))
    log(f"kernel 4: {json.dumps(rec)}")
    return rec


# operations of kernel 5 per strict-upper cell beyond the S - 1 int32
# adds: the bound's 12 float operations and the compare
PAIR_BITS_OPS = 13


def compare_bits(placed, bounds, devs, row0: int, col0: int, cols: int,
                 tau_eff, label: str, aux_i=None, aux_j=None) -> list:
    """Kernel 5 (int32 partial dots; ``aux_i`` / ``aux_j`` the rectangle's
    row and column tables) or kernel 6 (fp32 partial scores, no tables)
    against its plain version on each card's row slice of a rectangle
    whose cell (0, 0) is global ``(row0, col0)``, as the join cuts and
    places it (``placed[k]`` the partials of rows ``bounds[k]`` on
    ``devs[k]``): gb, g64 and the counts bit for bit, timed (CUDA events,
    median of 5) beside the plain version; its bound: the partials of the
    strict-upper cells read once (the kernel loads no other), the aux
    tables, the bits and counts written, over the memory rate, against the
    S - 1 adds and the test of each such cell (``PAIR_BITS_OPS`` for
    kernel 5's bound, one compare for kernel 6's) over the fp32 rate.  One
    record a card."""
    int8 = aux_i is not None
    kernel, plain = ((panel_mesh.pair_bits_int8,
                      panel_mesh.pair_bits_int8_plain) if int8 else
                     (panel_mesh.pair_bits_f32, panel_mesh.pair_bits_f32_plain))
    zero = torch.zeros(1, dtype=torch.int64)
    recs = []
    for ps, (a, b), dev in zip(placed, bounds, devs):
        args = ((ps, aux_i[:, a:b].to(dev), aux_j.to(dev)) if int8
                else (ps,)) + (row0 + a, col0, tau_eff)
        with torch.cuda.device(dev):
            k = kernel(*args)
            torch.cuda.synchronize(dev)
            p = plain(*args)
        for what, x, y in zip(("gb", "g64", "cnt"), k, p):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"{kernel.__name__} differs from plain ({label}, card "
                    f"{dev.index}, rows {a}-{b}): {what}, "
                    f"{int((x != y).sum())} elements")
        cells = upper_cells(zero, zero, b - a, cols, (row0 + a, col0))
        n = len(ps)
        nbytes = (4 * n * cells + (12 * (b - a + cols) if int8 else 0)
                  + (b - a) // 8 * cols + (b - a) // 64 * cols + 24)
        rec = {"label": label, "card": dev.index, "origin": [row0, col0],
               "rows": [a, b], "cols": cols, "parts": n,
               "upper_cells": cells, "bytes": nbytes,
               "pairs_kernel": int(k[2][0, 0]),
               "pairs_plain": int(p[2][0, 0]), "max_abs_err": 0.0}
        del k, p
        rec.update(
            ms=median_ms(lambda: kernel(*args), dev=dev),
            plain_ms=median_ms(lambda: plain(*args), dev=dev),
            library_ms=None)  # no one PyTorch call sums, tests and packs
        rec["gb_per_s"] = nbytes / rec["ms"] / 1e6
        ops = PAIR_BITS_OPS if int8 else 1
        rec.update(bound(cells * (n - 1 + ops), nbytes, PEAK_FP32))
        log(f"{'kernel 5' if int8 else 'kernel 6'}: {json.dumps(rec)}")
        recs.append(rec)
    return recs


def compare_pair_bits(eng: MeshChunkedAllPairs, pi: int, pj: int,
                      label: str) -> list:
    """Kernel 5 against its plain version at panel pair ``(pi, pj)`` of a
    mesh join's own operands (``compare_bits``): every shard's kernel 4
    partial, cut into row slices on the mesh's cards as the join cuts them
    (``panel_mesh.card_slices``, ``gather_rows``)."""
    st = eng._panel_state()
    rb = st["geom"][0]
    xi, xj = eng._build_slab(st, pi), eng._build_slab(st, pj)
    parts = [panel_mesh.int8_matmul(a, b) for a, b in zip(xi, xj)]
    del xi, xj
    bounds, devs = panel_mesh.card_slices(eng.mesh.devices, rb)
    placed = gather_rows(parts, bounds, devs)
    del parts
    aux = st["aux_on"][eng.mesh.lead]
    return compare_bits(placed, bounds, devs, pi * rb, pj * rb, rb,
                        eng._tau_eff(TAU), label,
                        aux[:, pi * rb:(pi + 1) * rb],
                        aux[:, pj * rb:(pj + 1) * rb])


def stripe_partials(eng, q0: int, int8: bool) -> list:
    """Every shard's partial of the stripe at ``q0`` as the engine's stripe
    join forms it (one for ``ChunkedAllPairs``): fp32 scores, or int32
    dots (kernel 4) on the int8 stripes."""
    st = eng._q_super()
    if isinstance(eng, MeshChunkedAllPairs):
        ents, counts = list(zip(*eng._ent)), eng._local_counts()
    else:
        ents, counts = [eng._ent], [eng._counts]
    if int8:
        q8 = eng._int8_slabs()[0]
        q8 = q8 if isinstance(eng, MeshChunkedAllPairs) else [q8]
        return [chunked_ops.stripe_dots_int8(
            e[0], e[1], q, n, q0, eng.row_cap, eng._chunk_width, st)
            for e, q, n in zip(ents, q8, counts)]
    return [chunked_ops.stripe_scores(
        *e, n, q0, eng.row_cap, eng._chunk_width, st,
        eng.cfg.matmul_precision) for e, n in zip(ents, counts)]


def compare_stripe(eng, q0: int, label: str, int8: bool = False) -> list:
    """``compare_bits`` at the stripe at ``q0`` of ``eng``'s own
    stripe join: its shards' partials, their live rows cut into one slice
    a card and placed there (``panel_mesh.card_slices``,
    ``gather_rows``)."""
    parts = stripe_partials(eng, q0, int8)
    st = eng._q_super()
    live = chunked_ops.stripe_live_rows(eng.row_cap, q0, st)
    devices = (eng.mesh.devices if isinstance(eng, MeshChunkedAllPairs)
               else [parts[0].device])
    bounds, devs = panel_mesh.card_slices(devices, live)
    placed = gather_rows(parts, bounds, devs)
    del parts
    aux = eng._int8_slabs()[1] if int8 else None
    return compare_bits(placed, bounds, devs, 0, q0, st, eng._tau_eff(TAU),
                        label, aux, None if aux is None else aux[:, q0:q0 + st])


def with_compactions(expect: dict) -> dict:
    """``expect``, launches by kernel (or by kernel, then card: a dict per
    kernel), with kernel 7's: one for each launch of ``BITS_KERNELS``, on
    its card."""
    if not isinstance(expect.get("compact_bits", 0), dict):
        return dict(expect, compact_bits=sum(
            expect.get(k, 0) for k in BITS_KERNELS))
    cards: dict = {}
    for k in BITS_KERNELS:
        for card, n in expect.get(k, {}).items():
            cards[card] = cards.get(card, 0) + n
    return dict(expect, compact_bits=cards)


def expect_launches(label: str, want: dict) -> dict:
    """The launches since the counters were zeroed must be ``want`` (every
    other kernel none, kernel 7 once for each launch of ``BITS_KERNELS``)."""
    got = dict(ts.LAUNCHES)
    expect = with_compactions({k: want.get(k, 0) for k in got})
    log(f"kernel launches on the {label}: {got}")
    if got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    return got


def pair_bits_record(recs: list, launches: int,
                     name: str = "pair_bits_int8") -> dict:
    """The kernels line's record of kernel 5 (or 6) from
    ``compare_bits``' records: the times of the slowest card's slice, the
    worst error."""
    worst = max(recs, key=lambda r: r["ms"])
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            **{k: worst[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}


def rect_flops(row_cap: int, tile: int, dim_cap: int) -> int:
    """Multiply-adds x 2 of one upper rectangle join: every tile against
    its bucket's row prefix."""
    return sum(2 * (b1 * tile) * tile * dim_cap * (b1 - b0)
               for b0, b1 in score_ops.upper_buckets(row_cap // tile))


def rect_phase(cfg: AllPairsConfig, csr, want: set, label: str, dev,
               make=None) -> dict:
    """Build an engine whose join is the full rectangle, join three times
    (the third timed), hold the pair set against the oracle ``want`` and
    the candidate set against it as a superset; TF32 must be as found."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    eng = make(cfg) if make else Engine(cfg, dev)
    log(f"build {label}: {json.dumps(eng.build(csr))}")
    if eng._kernel_ok():
        raise AssertionError(f"{label}: the kernel path was not refused")
    before = dict(ts.LAUNCHES)
    j = timed_join(eng, label)
    flops = rect_flops(eng.row_cap, eng.cfg.query_tile, eng.dim_cap)
    log(f"{label}: {flops:.3e} FLOP a join, "
        f"{flops / j['rec']['stages_s']['kernel'] / 1e12:.1f} TFLOP/s in "
        f"the kernel stage; allow_tf32 {tf32} before, "
        f"{torch.backends.cuda.matmul.allow_tf32} after")
    if torch.backends.cuda.matmul.allow_tf32 != tf32:
        raise AssertionError(f"{label}: the join changed allow_tf32")
    if dict(ts.LAUNCHES) != before or eng._used_int8:
        raise AssertionError(f"{label}: the rectangle launched a kernel")
    check_parity(j["res"], want, label)
    cand = pair_set(eng._all_pairs_rect(eng._tau_eff(TAU)))
    if not cand >= want:
        raise AssertionError(f"{label}: {len(want - cand)} oracle pairs are "
                             f"missing from the candidate set")
    log(f"{label}: {len(cand)} candidates contain the oracle's {len(want)}")
    if not np.all(np.isfinite(j["res"].sims)):
        raise AssertionError(f"{label}: non-finite sims")
    return j


def stripe_join(eng: ChunkedAllPairs, label: str, reps: int) -> dict:
    """``reps`` stripe joins at TAU; the last is timed with its stage
    split, stripe geometry and peak memory."""
    if eng._panel_ok() and eng._panel_state() is not None:
        raise AssertionError(f"{label}: the panel path was not refused")
    for _ in range(reps - 1):
        eng.all_pairs(TAU)
    torch.cuda.reset_peak_memory_stats()
    before = dict(eng.timer.totals)
    counts0 = dict(eng.timer.counts)
    cand0 = eng.stats["candidates_scored"]
    t0 = time.perf_counter()
    res = eng.all_pairs(TAU)
    secs = time.perf_counter() - t0
    st = eng._q_super()
    n = eng.n_rows
    n_stripes = -(-n // st)
    width = eng._chunk_width
    rec = {
        "rows": n, "row_cap": eng.row_cap, "super_tile": st,
        "stripes": n_stripes, "n_chunks": eng._n_chunks, "chunk_width": width,
        "densify_passes": eng.timer.counts["slabs"] - counts0.get("slabs", 0),
        "seconds": secs, "decided_pairs_per_s": n * (n - 1) / 2 / secs,
        "candidates": eng.stats["candidates_scored"] - cand0,
        "pairs": res.n_pairs,
        "stages_s": {k: v - before.get(k, 0.0)
                     for k, v in eng.timer.totals.items() if k != "all_pairs"},
        "ops": n_stripes * eng._n_chunks * 2 * eng.row_cap * st * width,
        "int8": eng._int8_slabs() is not None,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    log(f"{label}: {json.dumps(rec)}")
    return {"rec": rec, "res": res}


def compare_stripe_mm(eng: ChunkedAllPairs, q0: int, c: int) -> dict:
    """Kernel 4 at one (stripe, chunk) product of the int8 stripes, bit for
    bit against its plain version, timed beside ``torch._int_mm``."""
    q2d, _ = eng._int8_slabs()
    slab = chunked_ops.densify_chunk(
        eng._ent[0], eng._ent[1], q2d, eng._counts, c, eng.row_cap,
        eng._chunk_width, torch.int8)
    xj = chunked_ops.stripe_query_rows(slab, q0, eng._q_super(),
                                       panel_mesh.MM_TN)
    if int((slab != 0).sum()) != int(eng._counts[c]):
        raise AssertionError("the slab does not hold the chunk's entries")
    return compare_mm(slab, xj, f"int8 stripe q0={q0}, chunk {c}")


def stripe_phase(dev, ooc_csr: CSRMatrix, want: set, panel_pairs: set,
                 big_csr: CSRMatrix, want32: set, kernels: list) -> None:
    """Phase 7's stripe joins (module docstring): the bf16 stripes at
    100,000 rows, the ``highest`` stripes at 32,768, the int8 stripes,
    the chunked mesh's bf16 stripes over 8 shards of the card and its int8
    stripes over 4, each against the fp64 oracle with its launches
    between zeroed counters; kernel 6 held and timed at the middle stripe
    (1 partial and 8), kernels 4 and 5 on the int8 stripes.  Appends
    kernel 6's record to ``kernels``, adds ``stripe_*`` keys to kernel 4's
    and 5's."""
    pb_main = next(k for k in kernels if k["name"] == "pair_bits_int8")
    seng = ChunkedAllPairs(AllPairsConfig(pallas_int8=False), dev)
    log(f"build stripe engine: {json.dumps(seng.build(ooc_csr))}")
    zero_launches()
    js = stripe_join(seng, f"bf16 stripes, {OOC_ROWS} rows", reps=3)
    n_st = js["rec"]["stripes"]
    k6_launches = expect_launches(f"bf16 stripes, {OOC_ROWS} rows",
                                  {"pair_bits_f32": 3 * n_st})["pair_bits_f32"]
    check_parity(js["res"], want, f"bf16 stripes, {OOC_ROWS} rows")
    stripe_parity = js["res"].pair_set() == panel_pairs
    log(f"stripe_parity: {stripe_parity} ({len(panel_pairs)} pairs of the "
        f"panel join)")
    if not stripe_parity:
        raise AssertionError("the stripe join's pair set differs from the "
                             "panel join's")
    # kernel 6 at one stripe of that join (the middle one), 1 partial
    q0_mid = n_st // 2 * seng._q_super()
    k6_recs = compare_stripe(seng, q0_mid, f"bf16 stripes, {OOC_ROWS} rows")
    del seng, js
    torch.cuda.empty_cache()

    heng = ChunkedAllPairs(AllPairsConfig(
        pallas_int8=False, matmul_precision="highest"), dev)
    heng.build(big_csr)
    zero_launches()
    jh = stripe_join(heng, "highest stripes, 32768 rows", reps=1)
    k6_launches += expect_launches("highest stripes, 32768 rows", {
        "pair_bits_f32": jh["rec"]["stripes"]})["pair_bits_f32"]
    check_parity(jh["res"], want32, "highest stripes, 32768 rows")
    del heng, jh
    torch.cuda.empty_cache()

    ieng = ChunkedAllPairs(AllPairsConfig(use_pallas="off"), dev)
    ieng._int8_stripes = True
    ieng.build(ooc_csr)
    zero_launches()
    ji = stripe_join(ieng, f"int8 stripes, {OOC_ROWS} rows", reps=1)
    if not ji["rec"]["int8"]:
        raise AssertionError("the int8 stripes were not taken")
    stripe_launches = expect_launches(f"int8 stripes, {OOC_ROWS} rows", {
        "int8_matmul": ji["rec"]["stripes"] * ji["rec"]["n_chunks"],
        "pair_bits_int8": ji["rec"]["stripes"]})
    check_parity(ji["res"], want, f"int8 stripes, {OOC_ROWS} rows")
    mm_stripe = compare_stripe_mm(ieng, ieng._q_super(), 3)
    next(k for k in kernels if k["name"] == "int8_matmul").update({
        "stripe_launches": stripe_launches["int8_matmul"],
        **{f"stripe_{k}": mm_stripe[k] for k in (
            "m", "n", "d", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")},
    })
    (k5_stripe,) = compare_stripe(ieng, q0_mid, f"int8 stripes, {OOC_ROWS} "
                                  f"rows", int8=True)
    pb_main.update({
        "stripe_launches": stripe_launches["pair_bits_int8"],
        **{f"stripe_{k}": k5_stripe[k] for k in (
            "rows", "cols", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")},
    })
    del ieng, ji
    torch.cuda.empty_cache()

    for n_shards, int8 in ((8, False), (4, True)):
        kind = "int8" if int8 else "bf16"
        name = "pair_bits_int8" if int8 else "pair_bits_f32"
        meng = MeshChunkedAllPairs(
            AllPairsConfig(use_pallas="off") if int8 else AllPairsConfig(
                pallas_int8=False),
            mesh=make_mesh(n_shards, devices=[dev] * n_shards))
        meng._int8_stripes = int8
        meng.build(ooc_csr)
        label = (f"mesh {kind} stripes, {n_shards} shards on one card, "
                 f"{OOC_ROWS} rows")
        zero_launches()
        jm = stripe_join(meng, label, reps=1)
        n_st = jm["rec"]["stripes"]
        got = expect_launches(label, {
            "int8_matmul": n_st * jm["rec"]["n_chunks"] if int8 else 0,
            name: n_st})
        check_parity(jm["res"], want, label)
        if jm["res"].pair_set() != panel_pairs:
            raise AssertionError(f"{label}: pair set differs from the "
                                 f"single-device panel join's")
        if int8:
            pb_main["stripe_launches"] += got[name]
        else:  # kernel 6 at 8 partials, the middle stripe
            k6_launches += got[name]
            k6_8 = compare_stripe(meng, q0_mid, label)
        del meng, jm
        torch.cuda.empty_cache()
    k6 = pair_bits_record(k6_recs, k6_launches, "pair_bits_f32")
    k6.update({f"shards8_{k}": v for k, v in pair_bits_record(
        k6_8, k6_launches, "pair_bits_f32").items()
        if k not in ("name", "route", "source", "replaces", "launches")})
    k6["stripe"] = {k: k6_recs[0][k] for k in ("origin", "rows", "cols",
                                                "upper_cells", "bytes")}
    kernels.append(k6)


# ------------------------------------------------ phase 8: the streaming path
STREAM_BUILD = 24_576


def dense64(csr: CSRMatrix, dev) -> torch.Tensor:
    """fp64 ``[rows, 32768]`` of a synthetic corpus (its dims lie below
    32,768) on the card: the streaming oracle's operand."""
    rows = np.repeat(np.arange(csr.n_rows), np.diff(csr.indptr))
    d = torch.zeros((csr.n_rows, 32768), dtype=torch.float64, device=dev)
    d[torch.from_numpy(rows).to(dev),
      torch.from_numpy(csr.indices.astype(np.int64)).to(dev)] = (
        torch.from_numpy(csr.data).to(dev))
    return d


def median_host_ms(fn, reps: int = 9) -> float:
    """Median host-clock time of ``fn`` over ``reps`` warm runs."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def shifted_rows(csr: CSRMatrix) -> list:
    """64 corpus rows with their dims moved past the corpus's (every
    synthetic dim lies below 32,768)."""
    picks = np.arange(7, csr.n_rows, csr.n_rows // 64)[:64]
    vecs = []
    for p in picks:
        v = csr.row(int(p))
        vecs.append(SparseVector(v.size, v.indices + 32768, v.values))
    return vecs


def dims_step(eng: Engine, csr: CSRMatrix, d: torch.Tensor,
              want: set) -> None:
    """Column growth and dormant activation on the streamed index: 64
    corpus rows with their dims moved past the corpus's mint columns (dims
    seen twice in the batch) and archive the rest as singletons; copies of
    eight of them then activate those singletons, whose entries go into
    the older rows of ``x`` and of its kept bf16 copy, without growth. The
    outputs equal an fp64 oracle, and the join of the grown index (kernel
    1) equals the old pair set with the new pairs."""
    vecs = shifted_rows(csr)
    n0 = eng.n_rows
    ids = [str(n0 + k) for k in range(72)]
    cap0, dorm0 = eng.dim_cap, eng.stats["dormant_dims"]
    union = set()

    def add(out) -> None:
        for q, cands in out.output.items():
            for c in cands:
                a, b = int(q), int(c)
                union.add((min(a, b), max(a, b)))

    add(eng.insert(list(zip(ids[:64], vecs)), tau=TAU))
    cap1, dorm1 = eng.dim_cap, eng.stats["dormant_dims"]
    kept1 = eng._bf16_cache[1]
    if cap1 <= cap0 or dorm1 <= dorm0:
        raise AssertionError(f"new dims: dim_cap {cap0} -> {cap1}, dormant "
                             f"dims {dorm0} -> {dorm1}")
    add(eng.insert(list(zip(ids[64:], vecs[:8])), tau=TAU))
    dorm2 = eng.stats["dormant_dims"]
    key, kept = eng._bf16_cache
    if eng.dim_cap != cap1 or dorm2 >= dorm1:
        raise AssertionError(f"activation: dim_cap {cap1} -> {eng.dim_cap}, "
                             f"dormant dims {dorm1} -> {dorm2}")
    if kept is not kept1 or key != (id(eng.x), eng.x._version) or not (
            torch.equal(kept, eng.x.to(torch.bfloat16))):
        raise AssertionError("the activation's entries are not in the kept "
                             "bf16 copy, or the copy was recast")
    # fp64 oracle of the 72 new rows against the corpus and each other
    rows = np.repeat(np.arange(72), [v.indices.size for v in vecs + vecs[:8]])
    q = torch.zeros((72, 65536), dtype=torch.float64, device=d.device)
    q[torch.from_numpy(rows).to(d.device),
      torch.from_numpy(np.concatenate(
          [v.indices for v in vecs + vecs[:8]]).astype(np.int64)).to(
              d.device)] = torch.from_numpy(np.concatenate(
                  [v.values for v in vecs + vecs[:8]])).to(d.device)
    want_new = set()
    ii, rr = torch.nonzero(q[:, :32768] @ d.T >= TAU, as_tuple=True)
    want_new.update((r, n0 + i) for i, r in zip(ii.tolist(), rr.tolist()))
    ii, jj = torch.nonzero(q @ q.T >= TAU, as_tuple=True)
    want_new.update((n0 + i, n0 + j) for i, j in zip(ii.tolist(), jj.tolist())
                    if i < j)
    if union != want_new:
        raise AssertionError(f"new-dims inserts differ from the fp64 oracle: "
                             f"{len(union - want_new)} extra, "
                             f"{len(want_new - union)} missing")
    zero_launches()
    res = eng.all_pairs(TAU)
    if ts.LAUNCHES["score_bits_int8"] < 1 or not eng._used_int8:
        raise AssertionError("the grown index's join did not launch "
                             "score_bits_int8")
    check_parity(res, want | want_new, "phase 8 join of the grown index")
    log(f"phase 8 new dims: dim_cap {cap0} -> {cap1}, dormant dims {dorm0} "
        f"-> {dorm1} -> {dorm2} (8 copies activated {dorm1 - dorm2}); kept "
        f"bf16 copy in step; {len(union)} new pairs equal the fp64 oracle; "
        f"join of the grown index (kernel 1, "
        f"{ts.LAUNCHES['score_bits_int8']} launches) equals the oracle")


def check_topk(eng, queries, sq: torch.Tensor, label: str) -> None:
    """``eng.topk(queries, 10)`` with ``allow_tf32`` on beforehand: it must
    come back on, and every query's fp64 scores must equal the dense fp64
    top-k of the scores ``sq [nq, n_rows]`` rank for rank within 1e-12 (the
    ids too where the 10th and 11th scores differ), each reported score
    its row's own."""
    dev = sq.device
    ora_s, ora_r = torch.topk(sq, 11, dim=1)
    ora_s, ora_r = ora_s.cpu().numpy(), ora_r.cpu().numpy()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    top = eng.topk(queries, 10)
    tf32_after = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"{label} topk: allow_tf32 True before, {tf32_after} after")
    if tf32_after is not True:
        raise AssertionError("topk changed allow_tf32")
    n_tied = 0
    for qi, (qid, _) in enumerate(queries):
        got = top[qid]
        scores = np.array([v for _, v in got])
        if len(got) != 10 or np.abs(scores - ora_s[qi, :10]).max() > 1e-12:
            raise AssertionError(f"topk {qid}: scores {scores} vs fp64 "
                                 f"{ora_s[qi, :10]}")
        if ora_s[qi, 9] - ora_s[qi, 10] > 1e-12:
            if {int(c) for c, _ in got} != set(ora_r[qi, :10].tolist()):
                raise AssertionError(f"topk {qid}: ids differ from fp64")
        else:
            n_tied += 1
    ids = torch.tensor([[int(c) for c, _ in top[q]] for q, _ in queries],
                       device=dev)
    mine = torch.tensor([[v for _, v in top[q]] for q, _ in queries],
                        dtype=torch.float64, device=dev)
    if float((torch.gather(sq, 1, ids) - mine).abs().max()) > 1e-12:
        raise AssertionError("topk: a reported score is not its row's")
    log(f"{label} topk(k=10), {len(queries)} queries: fp64 scores rank for "
        f"rank within 1e-12 of the dense fp64 top-k, ids equal where the "
        f"10th and 11th differ ({n_tied} queries tied there)")


def check_frozen(eng, fq, fs: torch.Tensor, fpicks, label: str) -> None:
    """``freeze``, then ``insert(fq)``: the output must equal the fp64
    oracle of the scores ``fs [nq, n_rows]`` at TAU (similarities within
    1e-12), each copied corpus row ``z<r>`` must find row r, and nothing
    may be indexed; ``unfreeze`` after."""
    eng.freeze()
    n0 = eng.n_rows
    out = eng.insert(fq, tau=TAU).output
    if eng.n_rows != n0:
        raise AssertionError("a frozen insert indexed rows")
    qi, ri = torch.nonzero(fs >= TAU, as_tuple=True)
    fs_h = fs.cpu().numpy()
    row_of = {q: k for k, (q, _) in enumerate(fq)}
    want_f: dict = {}
    for a, b in zip(qi.tolist(), ri.tolist()):
        want_f.setdefault(fq[a][0], set()).add(str(b))
    if {q: set(c) for q, c in out.items()} != want_f or any(
            abs(v - fs_h[row_of[q], int(c)]) > 1e-12
            for q, cs in out.items() for c, v in cs.items()):
        raise AssertionError("frozen match differs from the fp64 oracle")
    if any(not out.get(f"z{r}", {}).get(str(r)) for r in fpicks):
        raise AssertionError("a copied row did not find itself")
    log(f"{label} frozen match, {len(fq)} queries: "
        f"{sum(map(len, out.values()))} pairs equal the fp64 oracle at "
        f"tau = {TAU}; n_rows unchanged")
    eng.unfreeze()


def stream_phase(dev, csr: CSRMatrix, want: set, kernels: list,
                 smi: str, ckpt: str) -> dict:
    """Phase 8: build on the first 24,576 rows of phase 3's corpus, stream
    every other row through ``insert``, then hold the union of the outputs,
    the join of the streamed index (and kernel 1 at its operands), the kept
    bf16 copy, ``topk``, frozen matching and ``dims_step`` against fp64
    oracles; then time the streaming entry points.  The streamed index is
    checkpointed to ``ckpt`` right after its join (phase 10 restores it).
    Returns the save's record, and for phase 11 a host copy of the live
    rows of the streamed ``x`` and the top-k and frozen-match query sets
    with their fp64 scores (on the host)."""
    t_phase = time.perf_counter()
    eng = Engine(AllPairsConfig(), dev)
    log(f"phase 8 build, {STREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, STREAM_BUILD)))}")
    caps0 = (eng.row_cap, eng.dim_cap)
    res = eng.all_pairs(TAU)
    union = set(zip(res.i.tolist(), res.j.tolist()))
    sizes = [1] * 16 + [32] * 16
    s = STREAM_BUILD
    t0 = time.perf_counter()
    n_batches = 0
    while s < csr.n_rows:
        bs = sizes[n_batches] if n_batches < len(sizes) else 256
        e = min(s + bs, csr.n_rows)
        out = eng.insert([(str(i), csr.row(i)) for i in range(s, e)], tau=TAU)
        for q, cands in out.output.items():
            for c in cands:
                a, b = int(q), int(c)
                union.add((min(a, b), max(a, b)))
        s, n_batches = e, n_batches + 1
    stream_s = time.perf_counter() - t0
    if eng.n_rows != csr.n_rows or eng.row_cap != 2 * STREAM_BUILD:
        raise AssertionError(f"stream: n_rows {eng.n_rows}, row_cap "
                             f"{eng.row_cap}")
    if union != want:
        raise AssertionError(
            f"streamed union differs from the fp64 oracle: "
            f"{len(union - want)} extra, {len(want - union)} missing")
    x8 = eng.x[:eng.n_rows].cpu()  # phase 11's meshes must equal it
    log(f"phase 8 stream: {n_batches} inserts of rows {STREAM_BUILD}-"
        f"{csr.n_rows - 1} in {stream_s:.3f} s; (row_cap, dim_cap) {caps0} -> "
        f"{(eng.row_cap, eng.dim_cap)}; build join + every insert's output: "
        f"{len(union)} pairs equal the fp64 oracle")

    zero_launches()
    res = eng.all_pairs(TAU)
    launches = dict(ts.LAUNCHES)
    log(f"phase 8 join of the streamed index, kernel launches: {launches}")
    if launches["score_bits_int8"] < 1 or not eng._used_int8:
        raise AssertionError("the streamed index's join did not launch "
                             "score_bits_int8")
    check_parity(res, want, "phase 8 join of the streamed index")
    tm, tn = eng._tiles()
    bi, bj = blocks(eng.row_cap, tm, tn, dev)
    rec = compare("int8", eng._operands(True), bi, bj, eng._tau_eff(TAU),
                  tm, tn, timed=False)
    log(f"phase 8 int8 kernel vs plain at the streamed index's operands, "
        f"row_cap={eng.row_cap} dim_cap={eng.dim_cap} "
        f"({eng.row_cap - eng.n_rows} padding rows): {json.dumps(rec)}")
    kernels[0].update(stream_join_launches=launches["score_bits_int8"],
                      stream_max_abs_err=rec["max_abs_err"])
    del bi, bj
    saved = save_checkpoint(eng, ckpt, "phase 8 streamed dense index")

    key, kept = eng._bf16_cache
    if key != (id(eng.x), eng.x._version) or not torch.equal(
            kept, eng.x.to(torch.bfloat16)):
        raise AssertionError("the kept bf16 copy is not a fresh cast of x")
    log("phase 8 kept bf16 copy: in step with x, equal to x.to(bfloat16) "
        "bit for bit")

    # top-k: 512 corpus rows under new ids (ties at 1.0 with duplicates)
    # and 512 rows of another seed, against an fp64 dense top-k
    d = dense64(csr, dev)
    qsrc = synthetic_corpus(512, seed=7)
    picks = np.arange(0, csr.n_rows, csr.n_rows // 512)[:512]
    queries = ([(f"t{r}", csr.row(int(r))) for r in picks]
               + [(f"s{i}", qsrc.row(i)) for i in range(512)])
    qd = torch.cat([d[torch.from_numpy(picks).to(dev)], dense64(qsrc, dev)])
    sq = qd @ d.T
    check_topk(eng, queries, sq, "phase 8")
    sq_host = sq.cpu()
    del sq, qd

    # frozen matching: queries are scored, not indexed
    fsrc = synthetic_corpus(128, seed=11)
    fpicks = np.arange(5, csr.n_rows, csr.n_rows // 128)[:128]
    fq = ([(f"z{r}", csr.row(int(r))) for r in fpicks]
          + [(f"y{i}", fsrc.row(i)) for i in range(128)])
    fd = torch.cat([d[torch.from_numpy(fpicks).to(dev)], dense64(fsrc, dev)])
    fs = fd @ d.T
    check_frozen(eng, fq, fs, fpicks, "phase 8")
    qsets = (queries, sq_host, fq, fs.cpu(), fpicks)
    dims_step(eng, csr, d, want)
    del d, fd, fs
    torch.cuda.empty_cache()

    # timings (host clock, warm, median of 9), after the gates
    def split(before: dict, names, reps: int = 9) -> dict:
        """Mean ms per call of each Timer section since ``before``."""
        return {k: (eng.timer.totals.get(k, 0.0) - before.get(k, 0.0))
                / reps * 1e3 for k in names}

    rec = {"card": smi, "rows": eng.n_rows, "row_cap": eng.row_cap,
           "dim_cap": eng.dim_cap}
    before = dict(eng.timer.totals)
    rec["topk_ms"] = median_host_ms(lambda: eng.topk(queries, 10))
    rec["topk_queries_per_s"] = len(queries) / rec["topk_ms"] * 1e3
    rec["topk_stages_ms"] = split(before, ("topk_fetch", "topk_rescore",
                                           "topk_assemble"))
    eng.freeze()
    eng.insert(fq, tau=TAU)
    before = dict(eng.timer.totals)
    rec["frozen_ms"] = median_host_ms(lambda: eng.insert(fq, tau=TAU))
    rec["frozen_queries_per_s"] = len(fq) / rec["frozen_ms"] * 1e3
    rec["frozen_stages_ms"] = split(before, ("admit", "frozen_product",
                                             "frozen_rescore"))
    eng.unfreeze()
    extra = synthetic_corpus(8192, seed=13)
    cursor = [0]

    def take(n):
        a = cursor[0]
        cursor[0] += n
        return [(f"x{i}", extra.row(i)) for i in range(a, a + n)]

    for bs in (1, 32, 256):
        batches = [take(bs) for _ in range(11)]
        for b in batches[:2]:
            eng.insert(b, tau=TAU, defer=True).result()
        it = iter(batches[2:])
        before = dict(eng.timer.totals)
        ms = median_host_ms(
            lambda: eng.insert(next(it), tau=TAU, defer=True).result())
        rec[f"insert_bs{bs}_ms"] = ms
        rec[f"insert_bs{bs}_vectors_per_s"] = bs / ms * 1e3
        if bs == 256:
            rec["stages_ms_per_batch_bs256"] = split(
                before, ("insert", "admit", "prepare", "append", "product",
                         "compact", "d2h", "rescore"))
    batches = [take(256) for _ in range(8)]
    t0 = time.perf_counter()
    prev = None
    for b in batches:
        cur = eng.insert(b, tau=TAU, defer=True)
        if prev is not None:
            prev.result()
        prev = cur
    prev.result()
    dt = time.perf_counter() - t0
    rec["pipelined_bs256_ms_per_batch"] = dt / len(batches) * 1e3
    rec["pipelined_bs256_vectors_per_s"] = 256 * len(batches) / dt
    if eng.row_cap != 2 * STREAM_BUILD:
        raise AssertionError("the timing inserts grew the index")
    # the path's two products alone (CUDA events, median of 5): a bs = 256
    # match against the kept bf16 copy, and top-k's true fp32 product for
    # 1,024 queries
    n, k = eng.n_rows, eng.dim_cap
    xo, xs = eng._rect_operand()[:n], eng.x[:n]
    qb, qf = xo[n - 256:], eng.x[:1024]
    rec["match_product"] = {
        "shape": [n, 256, k],
        "ms": median_ms(lambda: score_ops.score_tile(xo, qb, "default")),
        **bound(2 * n * 256 * k, 2 * (n + 256) * k + 4 * n * 256, PEAK_BF16)}
    rec["topk_product"] = {
        "shape": [1024, n, k],
        "ms": median_ms(lambda: score_ops.score_tile(qf, xs, "highest")),
        **bound(2 * 1024 * n * k, 4 * (n + 1024) * k + 4 * 1024 * n,
                PEAK_FP32)}
    rec["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 8 timings: {json.dumps(rec)}")
    return saved, x8, qsets


# ---------------------------------------- phase 9: the chunked streaming path
CSTREAM_BUILD = 90_000
CSTREAM_CAPS = [90112, 98304, 106496]  # the row capacities the stream sees
DIMS_CAPACITY = 36864  # compact capacity after the shifted rows' new dims


def pairs_of(out) -> set:
    """An insert's output as unordered int pairs."""
    return {(min(int(q), int(c)), max(int(q), int(c)))
            for q, cands in out.output.items() for c in cands}


def block_scores(csr: CSRMatrix, qd: torch.Tensor) -> torch.Tensor:
    """fp64 scores ``[nq, csr.n_rows]`` of dense queries ``qd`` against the
    rows of ``csr``, densified on the card 16,384 rows at a time."""
    out = torch.empty((qd.shape[0], csr.n_rows), dtype=torch.float64,
                      device=qd.device)
    for r0 in range(0, csr.n_rows, 16384):
        r1 = min(r0 + 16384, csr.n_rows)
        out[:, r0:r1] = qd @ dense_rows(csr, r0, r1, qd.shape[1],
                                        qd.device).T
    return out


def query_sets(csr: CSRMatrix, dev):
    """Phase 8's query sets on the 100,000-row corpus: 1,024 top-k queries
    (512 corpus rows under new ids, 512 of seed 7) and 256 frozen-match
    queries (128 copies, 128 of seed 11), each with its fp64 scores
    against the corpus."""
    qsrc, fsrc = synthetic_corpus(512, seed=7), synthetic_corpus(128, seed=11)
    picks = np.arange(0, csr.n_rows, csr.n_rows // 512)[:512]
    fpicks = np.arange(5, csr.n_rows, csr.n_rows // 128)[:128]
    queries = ([(f"t{r}", csr.row(int(r))) for r in picks]
               + [(f"s{i}", qsrc.row(i)) for i in range(512)])
    fq = ([(f"z{r}", csr.row(int(r))) for r in fpicks]
          + [(f"y{i}", fsrc.row(i)) for i in range(128)])
    scores = []
    for qs in (queries, fq):
        qcsr = CSRMatrix.from_vectors([v for _, v in qs], csr.n_cols)
        scores.append(block_scores(
            csr, dense_rows(qcsr, 0, qcsr.n_rows, 32768, dev)))
    return queries, scores[0], fq, scores[1], fpicks


def stream_rows(eng, csr: CSRMatrix, lo: int, sizes, route=None,
                beyond_budget: bool = False, outputs=None):
    """Insert rows ``[lo, n_rows)`` of ``csr`` (ids: row numbers) in batches
    of ``sizes``, then of 256; ``route`` (if given) must be each batch's;
    with ``beyond_budget`` each batch must find the chunked engine beyond
    its slab budget; ``outputs`` (a list, if given) takes each batch's
    output dict.  Returns the union of the outputs, the routes taken
    (chunked engines), the row capacities seen, the batch count and the
    seconds."""
    union, routes, caps = set(), [], [eng.row_cap]
    s, nb = lo, 0
    t0 = time.perf_counter()
    while s < csr.n_rows:
        bs = sizes[nb] if nb < len(sizes) else 256
        e = min(s + bs, csr.n_rows)
        if beyond_budget and not eng._paneled_ok():
            raise AssertionError(f"batch at row {s}: not beyond the budget")
        out = eng.insert([(str(i), csr.row(i)) for i in range(s, e)], tau=TAU)
        routes.append(getattr(eng, "last_route", None))
        if route is not None and eng.last_route != route:
            raise AssertionError(f"batch at row {s} took {eng.last_route}, "
                                 f"not {route}")
        if eng.row_cap != caps[-1]:
            caps.append(eng.row_cap)
        if outputs is not None:
            outputs.append(out.output)
        union |= pairs_of(out)
        s, nb = e, nb + 1
    return union, routes, caps, nb, time.perf_counter() - t0


def chunked_stream_resident(dev, csr: CSRMatrix, want: set, kernels: list,
                            qsets, smi: str, ckpt: str) -> dict:
    """Phase 9a: the resident route at 100,000 rows: build on 90,000, stream
    the rest, gate, join (kernel 3), top-k and frozen matching against fp64
    oracles; then the route's timings.  The streamed index is checkpointed
    to ``ckpt`` right after its join.  Returns the save's record."""
    eng = ChunkedAllPairs(AllPairsConfig(), dev)
    log(f"phase 9a build, {CSTREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, CSTREAM_BUILD)))}")
    res = eng.all_pairs(TAU)
    builds0 = eng.timer.counts.get("match_slabs", 0)
    union, _, caps, nb, secs = stream_rows(
        eng, csr, CSTREAM_BUILD, [1] * 8 + [32] * 8, "resident_slabs")
    union |= set(zip(res.i.tolist(), res.j.tolist()))
    builds = eng.timer.counts["match_slabs"] - builds0
    if caps != CSTREAM_CAPS or builds != len(caps):
        raise AssertionError(f"resident stream: row caps {caps}, stack "
                             f"built {builds} times")
    if union != want:
        raise AssertionError(
            f"phase 9a streamed union differs from the fp64 oracle: "
            f"{len(union - want)} extra, {len(want - union)} missing")
    stack = eng._mslab
    log(f"phase 9a stream: {nb} inserts of rows {CSTREAM_BUILD}-"
        f"{csr.n_rows - 1} in {secs:.3f} s, every one on the resident "
        f"route; row_cap {caps}; stack {list(stack.shape)} {stack.dtype} "
        f"({stack.numel() * stack.element_size() / 1e9:.2f} GB) built "
        f"{builds} times; build join + every insert's output: "
        f"{len(union)} pairs equal the fp64 oracle")

    zero_launches()
    res = eng.all_pairs(TAU)
    launches = dict(ts.LAUNCHES)
    geom = eng._panel_geom()
    n_pairs = geom[3] * (geom[3] + 1) // 2
    expect = {k: 0 for k in launches}
    expect["panel_score_bits_int8"] = n_pairs
    expect = with_compactions(expect)
    if launches != expect or eng._mslab is not None:
        raise AssertionError(f"join of the streamed chunked index: launches "
                             f"{launches}, expected {expect}")
    check_parity(res, want, "phase 9a join of the streamed chunked index")
    last = geom[3] - 1
    recs = [compare_panel(eng, pi, pj, *geom[1:3], timed=False)
            for pi, pj in ((0, last), (last, last))]
    log(f"phase 9a panel kernel vs plain at the streamed index ({eng.n_rows} "
        f"rows, the last panel {geom[0] * geom[3] - eng.n_rows} rows of "
        f"padding): {json.dumps(recs)}")
    k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
    k3.update(stream_join_launches=launches["panel_score_bits_int8"],
              stream_max_abs_err=max(r["max_abs_err"] for r in recs))
    saved = save_checkpoint(eng, ckpt, "phase 9a streamed chunked index")

    queries, sq, fq, fs, fpicks = qsets
    check_topk(eng, queries, sq, "phase 9a")
    if eng._mslab is None:
        raise AssertionError("topk did not score against the resident stack")
    check_frozen(eng, fq, fs, fpicks, "phase 9a")
    if eng.last_route != "resident_slabs":
        raise AssertionError(f"frozen match took {eng.last_route}")

    # timings (host clock, warm, median of 9), after the gates
    rec = {"card": smi, "rows": eng.n_rows, "row_cap": eng.row_cap}
    rec.update(stream_timings(eng, synthetic_corpus(4096, seed=13),
                              (1, 32, 256), "resident_slabs"))
    if eng.row_cap != CSTREAM_CAPS[-1]:
        raise AssertionError("the timing inserts crossed a row capacity")
    # top-k against the bf16 stack fetches deep (the bf16 margin): seconds
    # a call, so the median of 3
    before = dict(eng.timer.totals)
    rec["topk_ms"] = median_host_ms(lambda: eng.topk(queries, 10), 3)
    rec["topk_queries_per_s"] = len(queries) / rec["topk_ms"] * 1e3
    rec["topk_stages_ms"] = {
        k: (eng.timer.totals[k] - before[k]) / 3 * 1e3
        for k in ("topk_fetch", "topk_rescore", "topk_assemble")}
    eng.freeze()
    eng.insert(fq, tau=TAU)
    rec["frozen_ms"] = median_host_ms(lambda: eng.insert(fq, tau=TAU))
    rec["frozen_queries_per_s"] = len(fq) / rec["frozen_ms"] * 1e3
    eng.unfreeze()
    # the match's product alone (CUDA events, median of 5): a bs = 256
    # batch against the whole stack
    stack = eng._match_slabs()
    extra = synthetic_corpus(256, seed=21)
    ccsr = eng.compact.map_csr(eng._drop_unmapped(extra), extend=False)
    q = eng._bucket_queries(ccsr, 256)
    n_c, rc, w = stack.shape
    rec["match_product"] = {
        "shape": [n_c, rc, w, 256],
        "ms": median_ms(lambda: chunked_ops.chunk_scores(
            lambda c: stack[c], q, n_c, w, 256, stack.dtype, "default")),
        **bound(2 * n_c * rc * w * 256,
                stack.numel() * 2 + 12 * int(ccsr.indptr[-1]) + 4 * rc * 256,
                PEAK_BF16)}
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"phase 9a timings: {json.dumps(rec)}")
    return saved


STREAM_SPLIT = ("insert", "admit", "prepare", "append", "match_slabs",
                "sort_entries", "product", "compact", "host_match", "d2h",
                "rescore")


def stream_timings(eng, extra: CSRMatrix, sizes, route, reps: int = 9,
                   cursor=None, split=STREAM_SPLIT, traffic=None) -> dict:
    """Insert latency (host clock, warm: two batches first, then the
    median of ``reps``) and vectors/s at each batch size of ``sizes`` on
    rows of ``extra``, every batch on ``route`` (a chunked engine's; None:
    no route), with the stage split (``split``'s sections) per batch at
    the largest size, or at every size given ``traffic`` (the
    collectives' ``TRAFFIC``), which adds the cross-process seconds and
    bytes per batch."""
    cursor = cursor if cursor is not None else [0]
    rec = {}
    for bs in sizes:
        batches = []
        for _ in range(reps + 2):
            a = cursor[0]
            cursor[0] += bs
            batches.append([(f"x{a + i}", extra.row(a + i))
                            for i in range(bs)])
        for b in batches[:2]:
            eng.insert(b, tau=TAU)
        it = iter(batches[2:])
        before = dict(eng.timer.totals)
        crossed = dict(traffic or {})

        def one():
            eng.insert(next(it), tau=TAU)
            if route is not None and eng.last_route != route:
                raise AssertionError(f"timed batch took {eng.last_route}")

        ms = median_host_ms(one, reps)
        rec[f"insert_bs{bs}_ms"] = ms
        rec[f"insert_bs{bs}_vectors_per_s"] = bs / ms * 1e3
        if bs == sizes[-1] or traffic is not None:
            stages = {k: (eng.timer.totals.get(k, 0.0) - before.get(k, 0.0))
                      / reps * 1e3 for k in split}
            if traffic is not None:
                stages["cross-process"] = (
                    traffic["seconds"] - crossed["seconds"]) / reps * 1e3
                rec[f"bytes_crossed_per_batch_bs{bs}"] = (
                    traffic["bytes"] - crossed["bytes"]) / reps
            rec[f"stages_ms_per_batch_bs{bs}"] = stages
    return rec


def chunked_stream_beyond(dev, csr: CSRMatrix, want: set, qsets,
                          smi: str) -> dict:
    """Phase 9b: beyond the slab budget at the same 100,000 rows: the
    router's routes, top-k at "highest", column growth and dormant
    activation into the sorted state's overflow, both routes forced, the
    join of the grown index; then each route's timings (forced; the host
    route's median of 3, its batches take seconds) and the router's own
    choice for such a batch."""
    eng = ChunkedAllPairs(AllPairsConfig(match_slab_budget_mb=0), dev)
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 9b build, {CSTREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, CSTREAM_BUILD)))}")
    res = eng.all_pairs(TAU)
    union, routes, caps, nb, secs = stream_rows(eng, csr, CSTREAM_BUILD, [],
                                                beyond_budget=True)
    union |= set(zip(res.i.tolist(), res.j.tolist()))
    if union != want:
        raise AssertionError(
            f"phase 9b streamed union differs from the fp64 oracle: "
            f"{len(union - want)} extra, {len(want - union)} missing")
    log(f"phase 9b stream: {nb} inserts of 256 rows in {secs:.3f} s, routes "
        f"{ {r: routes.count(r) for r in set(routes)} }; row_cap {caps}; "
        f"{len(union)} pairs equal the fp64 oracle")
    queries, sq, _, _, _ = qsets
    check_topk(eng, queries[:256], sq[:256], "phase 9b (fp32 slabs)")

    # column growth and dormant activation (phase 8's dims step)
    index = [csr]
    picks = np.arange(7, csr.n_rows, csr.n_rows // 64)[:64]
    vecs = []
    for p in picks:
        v = csr.row(int(p))
        vecs.append(SparseVector(v.size, v.indices + 32768, v.values))
    cap0, w0 = eng.compact.capacity, eng._chunk_width
    dorm0 = eng.stats["dormant_dims"]
    grown = set()
    step = {}
    for k, vs in ((0, vecs), (64, vecs[:8])):
        n0 = eng.n_rows
        part = CSRMatrix.from_vectors(vs, csr.n_cols)
        out = eng.insert([(str(n0 + i), v) for i, v in enumerate(vs)],
                         tau=TAU)
        step[k] = (eng.last_route, eng.stats["dormant_dims"])
        want_b = batch_oracle(index, part, n0, TAU, dev)
        if pairs_of(out) != want_b:
            raise AssertionError(f"new-dims insert ({len(vs)} rows) differs "
                                 f"from the fp64 oracle")
        grown |= want_b
        index.append(part)
    st = eng._sort_state
    dorm1, dorm2 = step[0][1], step[64][1]
    if (eng.compact.capacity, eng._chunk_width) != (DIMS_CAPACITY, 2 * w0) or (
            dorm1 <= dorm0 or dorm2 >= dorm1 or st is None
            or st["n_o"] == 0):
        raise AssertionError(
            f"dims step: capacity {cap0} -> {eng.compact.capacity}, width "
            f"{w0} -> {eng._chunk_width}, dormant {dorm0} -> {dorm1} -> "
            f"{dorm2}, overflow {None if st is None else st['n_o']}")
    log(f"phase 9b new dims: compact capacity {cap0} -> "
        f"{eng.compact.capacity}, chunk width {w0} -> {eng._chunk_width}, "
        f"dormant dims {dorm0} -> {dorm1} -> {dorm2}, {st['n_o']} entries "
        f"activated into the overflow region; routes {step[0][0]}, "
        f"{step[64][0]}; {len(grown)} pairs equal the fp64 oracle")

    probes = synthetic_corpus(512, seed=101)
    dev_route = "device_paneled"
    for k, (force, name) in enumerate(((True, "host_spgemm"),
                                       (False, dev_route))):
        part = csr_rows(probes, 256 * k, 256 * (k + 1))
        n0 = eng.n_rows
        eng._use_host_match = lambda q, _f=force: _f  # shadow the router
        try:
            out = eng.insert([(str(n0 + i), part.row(i)) for i in range(256)],
                             tau=TAU)
        finally:
            del eng._use_host_match
        want_b = batch_oracle(index, part, n0, TAU, dev)
        if eng.last_route != name or pairs_of(out) != want_b:
            raise AssertionError(f"forced {name}: took {eng.last_route}, "
                                 f"{len(pairs_of(out) ^ want_b)} pairs off")
        grown |= want_b
        index.append(part)
    log("phase 9b forced routes: a bs = 256 batch on host_spgemm and one on "
        "device_paneled, each equal to the fp64 oracle")
    zero_launches()
    res = eng.all_pairs(TAU)
    if ts.LAUNCHES["panel_score_bits_int8"] < 1:
        raise AssertionError("the grown index's join did not launch kernel 3")
    check_parity(res, want | grown, "phase 9b join of the grown index")

    rec = {"card": smi, "rows": eng.n_rows, "row_cap": eng.row_cap,
           "chunk_width": eng._chunk_width, "ph": eng._paneled_ph()}
    extra = synthetic_corpus(4096, seed=17)
    cursor = [0]
    sample = csr_rows(extra, 0, 256)
    rec["router_choice_bs256"] = ("host_spgemm"
                                  if eng._use_host_match(sample.indices)
                                  else dev_route)
    for name, force, reps in (("paneled", False, 9), ("host", True, 3)):
        eng._use_host_match = lambda q, _f=force: _f  # one route each
        try:
            rec[name] = stream_timings(
                eng, extra, (256,), "host_spgemm" if force else dev_route,
                reps=reps, cursor=cursor)
        finally:
            del eng._use_host_match
    rec["router_correct"] = rec["router_choice_bs256"] == min(
        ("host_spgemm", rec["host"]["insert_bs256_ms"]),
        (dev_route, rec["paneled"]["insert_bs256_ms"]),
        key=lambda kv: kv[1])[0]
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"phase 9b timings: {json.dumps(rec)}")
    return rec


def chunked_stream_phase(dev, csr: CSRMatrix, want: set, kernels: list,
                         smi: str, ckpt: str) -> dict:
    """Phase 9: the chunked engine's streaming path on phase 5's corpus;
    returns the record of 9a's checkpoint save and, for phase 11, the
    query sets with their fp64 scores on the host."""
    t_phase = time.perf_counter()
    qsets = query_sets(csr, dev)
    torch.cuda.empty_cache()
    saved = chunked_stream_resident(dev, csr, want, kernels, qsets, smi, ckpt)
    torch.cuda.empty_cache()
    chunked_stream_beyond(dev, csr, want, qsets, smi)
    torch.cuda.empty_cache()
    log(f"phase 9 seconds: {time.perf_counter() - t_phase:.1f}")
    queries, sq, fq, fs, fpicks = qsets
    return saved, (queries, sq.cpu(), fq, fs.cpu(), fpicks)


# ------------------------- phase 10: checkpoints, the server, the command line
CLI_DOCS = 3_000


def save_checkpoint(eng, path: str, label: str) -> dict:
    """``eng.save(path)`` timed (host clock), with the npz's size."""
    t0 = time.perf_counter()
    eng.save(path)
    rec = {"rows": eng.n_rows, "row_cap": eng.row_cap,
           "save_seconds": time.perf_counter() - t0,
           "npz_bytes": os.path.getsize(os.path.join(path, "index.npz")),
           "path": path}
    log(f"{label}: checkpoint saved: {json.dumps(rec)}")
    return rec


def restore_phase(dev, saved8, saved9, want32: set, want: set,
                  kernels: list, smi: str) -> dict:
    """Phase 10a: restore phase 8's dense and phase 9a's chunked checkpoint
    on the card; each join equals the fp64 oracle and launches its kernel
    (kernel 1 also bit for bit against its plain version at the restored
    operands); the chunked restore takes the fast path (no build pass)."""
    (ck8, build32), (ck9, build100k) = saved8, saved9
    rec = {"card": smi}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine.load(ck8["path"], device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if eng.n_rows != ck8["rows"] or eng.ids != [str(i)
                                                for i in range(eng.n_rows)]:
        raise AssertionError(f"dense restore: {eng.n_rows} rows")
    zero_launches()
    res = eng.all_pairs(TAU)
    launches = dict(ts.LAUNCHES)
    if launches["score_bits_int8"] < 1 or not eng._used_int8:
        raise AssertionError(f"restored dense join: launches {launches}")
    check_parity(res, want32, "phase 10a join of the restored dense index")
    tm, tn = eng._tiles()
    bi, bj = blocks(eng.row_cap, tm, tn, dev)
    cmp = compare("int8", eng._operands(True), bi, bj, eng._tau_eff(TAU),
                  tm, tn, timed=False)
    kernels[0].update(restore_join_launches=launches["score_bits_int8"],
                      restore_max_abs_err=cmp["max_abs_err"])
    rec["dense"] = {
        "rows": eng.n_rows, "saved_row_cap": ck8["row_cap"],
        "restored_row_cap": eng.row_cap, "save_seconds": ck8["save_seconds"],
        "restore_seconds": restore_s,
        "build_seconds": build32["build_seconds"],
        "npz_bytes": ck8["npz_bytes"], "kernel_vs_plain": cmp}
    del eng, res, bi, bj
    torch.cuda.empty_cache()

    cfg = Engine.checkpoint_engine_config(ck9["path"])
    ceng = ChunkedAllPairs(cfg, dev)

    def no_build(*a, **k):
        raise AssertionError("the chunked restore fell back to a build pass")

    ceng.build = no_build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ceng.restore(ck9["path"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if ceng.n_rows != ck9["rows"] or ceng._ent_host is None:
        raise AssertionError(f"chunked restore: {ceng.n_rows} rows")
    zero_launches()
    res = ceng.all_pairs(TAU)
    launches = dict(ts.LAUNCHES)
    if launches["panel_score_bits_int8"] < 1:
        raise AssertionError(f"restored chunked join: launches {launches}")
    check_parity(res, want, "phase 10a join of the restored chunked index")
    k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
    k3["restore_join_launches"] = launches["panel_score_bits_int8"]
    rec["chunked"] = {
        "rows": ceng.n_rows, "save_seconds": ck9["save_seconds"],
        "restore_seconds": restore_s, "fast_path": True,
        "build_seconds": build100k["build_seconds"],
        "npz_bytes": ck9["npz_bytes"]}
    log(f"phase 10a checkpoints: {json.dumps(rec)}")
    return rec


def wait_for(pred, timeout: float, what: str) -> None:
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def server_phase(dev, work: str, csr: CSRMatrix, want32: set,
                 kernels: list) -> dict:
    """Phase 10b: the server in-process on the card.  Phase 3's rows go
    into a store table; a load RPC bulk-loads the first three quarters
    (rows 0-24,575 of 32,768), four clients
    stream the rest concurrently (batches of 1, 32 and 256), a subscriber
    collects the pushed outputs; then the pushed pairs, the all_pairs RPC
    (kernel 1) and the topk RPC (against ``engine.topk``) are checked, and
    the checkpoint written on close restores into a second server."""
    from apsim_tpu_torch.etl.store import VectorStore
    from apsim_tpu_torch.serve import (ClientConnection, RpcServer,
                                       SimilarityServer)

    ids = [str(i) for i in range(csr.n_rows)]
    n_load = csr.n_rows * 3 // 4
    t0 = time.perf_counter()
    store = VectorStore(os.path.join(work, "store"), run_mode="PRODUCT")
    store.write("P3", csr, ids)
    rec = {"store_write_seconds": time.perf_counter() - t0}
    cfg = AllPairsConfig(checkpoint_dir=os.path.join(work, "serve_ckpt"))
    sim = SimilarityServer(None, cfg, store=store, device=dev)
    if sim.engine.device != dev:
        raise AssertionError(f"server engine on {sim.engine.device}")
    rpc = RpcServer(sim, "127.0.0.1", 0).start()
    addr = [f"{rpc.host}:{rpc.port}"]
    pushed: set = set()
    lock = threading.Lock()

    def on_output(out, moment) -> None:
        got = {(min(int(q), int(c)), max(int(q), int(c)))
               for q, cands in out.items() for c in cands}
        with lock:
            pushed.update(got)

    clients = []
    try:
        sub = ClientConnection(addr)
        clients.append(sub)
        sub.subscribe_outputs(on_output)
        cc = ClientConnection(addr)
        clients.append(cc)
        t0 = time.perf_counter()
        cc.load_data("P3", 0, n_load - 1)
        cc.flush()
        rec["load_rpc_seconds"] = time.perf_counter() - t0
        if cc.stats()["n_rows"] != n_load:
            raise AssertionError(f"load RPC: {cc.stats()['n_rows']} rows")
        rows = np.arange(n_load, csr.n_rows)
        errors = []

        def stream(part) -> None:
            try:
                c = ClientConnection(addr)
                sizes = [1] * 16 + [32] * 16
                s, k = 0, 0
                while s < part.size:
                    bs = sizes[k] if k < len(sizes) else 256
                    c.insert_new_vector([(ids[r], csr.row(int(r)))
                                         for r in part[s:s + bs]])
                    s, k = s + bs, k + 1
                c.flush()
                c.close()
            except Exception as e:  # surfaced after the join below
                errors.append(e)

        threads = [threading.Thread(target=stream, args=(rows[k::4],))
                   for k in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        cc.flush()
        rec["stream_seconds"] = time.perf_counter() - t0
        if errors:
            raise errors[0]
        st = cc.stats()
        json.dumps(st)
        if (st["n_rows"], st["errors"], st["vectors_dropped_admission"]) != (
                csr.n_rows, 0, 0):
            raise AssertionError(f"served stream: stats {st}")
        wait_for(lambda: len(pushed) >= len(want32), 60,
                 "the pushed outputs")
        time.sleep(0.2)
        with lock:
            if pushed != want32:
                raise AssertionError(
                    f"pushed pairs differ from the fp64 oracle: "
                    f"{len(pushed - want32)} extra, "
                    f"{len(want32 - pushed)} missing")
        log(f"phase 10b served stream: load RPC of {n_load} rows, "
            f"{rows.size} rows from 4 clients; {len(pushed)} pushed pairs "
            f"equal the fp64 oracle")
        zero_launches()
        t0 = time.perf_counter()
        pairs = cc.all_pairs(TAU)
        rec["all_pairs_rpc_seconds"] = time.perf_counter() - t0
        launches = dict(ts.LAUNCHES)
        got = {(min(int(a), int(b)), max(int(a), int(b))) for a, b, _ in pairs}
        if launches["score_bits_int8"] < 1 or got != want32:
            raise AssertionError(
                f"all_pairs RPC: launches {launches}, {len(got ^ want32)} "
                f"pairs off the fp64 oracle")
        kernels[0]["serve_join_launches"] = launches["score_bits_int8"]
        log(f"phase 10b all_pairs RPC: {len(got)} pairs equal the fp64 "
            f"oracle; launches {launches}")
        qsrc = synthetic_corpus(128, seed=23)
        queries = ([(f"t{r}", csr.row(int(r)))
                    for r in range(3, csr.n_rows, csr.n_rows // 128)][:128]
                   + [(f"s{i}", qsrc.row(i)) for i in range(128)])
        t0 = time.perf_counter()
        tk = cc.topk(queries, 10)
        rec["topk_rpc_seconds"] = time.perf_counter() - t0
        with sim._engine_scope():
            direct = sim.engine.topk(queries, 10)
        for qid, _ in queries:
            a, b = tk[qid], direct[qid]
            if [c for c, _ in a] != [c for c, _ in b] or any(
                    abs(x - y) > 1e-12 for (_, x), (_, y) in zip(a, b)):
                raise AssertionError(f"topk RPC differs for {qid}")
        log(f"phase 10b topk RPC: {len(queries)} queries equal engine.topk "
            f"id for id")
    finally:
        for c in clients:
            c.close()
        t0 = time.perf_counter()
        rpc.close()
        rec["close_seconds"] = time.perf_counter() - t0
    if not os.path.exists(os.path.join(cfg.checkpoint_dir, "index.npz")):
        raise AssertionError("close() wrote no checkpoint")
    t0 = time.perf_counter()
    sim2 = SimilarityServer(None, cfg, device=dev)
    rec["restore_seconds"] = time.perf_counter() - t0
    try:
        if sim2.stats()["n_rows"] != csr.n_rows:
            raise AssertionError(f"restored server: {sim2.stats()['n_rows']}")
        res = sim2.all_pairs(TAU)
        got = {(min(int(a), int(b)), max(int(a), int(b)))
               for a, b, _ in res.id_pairs()}
        if got != want32:
            raise AssertionError("the restored server's join differs")
    finally:
        sim2.close()
    log(f"phase 10b restored server: {csr.n_rows} rows, join equal to the "
        f"fp64 oracle; timings {json.dumps(rec)}")
    return rec


def text_corpus(root: str, n: int, seed: int = 10) -> None:
    """``n`` seeded documents of Zipf-distributed words, one file each;
    every 25th document repeats an earlier one, every 25th (offset 12)
    repeats one with a word appended (pairs above and below 0.8)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        if i % 25 == 24:
            text = docs[int(rng.integers(0, i))]
        elif i % 25 == 12:
            text = docs[int(rng.integers(0, i))] + " extra"
        else:
            k = int(rng.integers(20, 200))
            text = " ".join(f"w{j}" for j in rng.zipf(1.3, size=k))
        docs.append(text)
        sub = os.path.join(root, f"box{i % 10}")
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, f"{i}."), "w") as f:
            f.write(text)


def cli(args, **kw):
    """``python -m apsim_tpu_torch.cli args`` from the repository root."""
    cmd = [sys.executable, "-m", "apsim_tpu_torch.cli"] + args
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300, **kw)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args[:1])} failed: {proc.stderr}")
    return proc, time.perf_counter() - t0


def cli_phase(dev, work: str) -> dict:
    """Phase 10c: the command line in subprocesses: ``etl`` of a seeded
    text corpus; then, side by side, ``build`` and ``join`` on the card
    (join output equal to an in-process join of the same store) and
    ``serve`` on the card driven by ``bench`` (the load generator),
    stopped with SIGINT; the checkpoint it writes on the way out loads."""
    from apsim_tpu_torch.etl.store import VectorStore

    docs, store = os.path.join(work, "docs"), os.path.join(work, "cli_store")
    text_corpus(docs, CLI_DOCS)
    rec = {}
    _, rec["etl_seconds"] = cli(["etl", docs, "--store", store, "--table",
                                 "T"])
    ck = os.path.join(work, "cli_ckpt")
    out = os.path.join(work, "pairs.tsv")
    errors = []

    def build_join() -> None:
        try:
            _, rec["build_seconds"] = cli(
                ["build", "--store", store, "--table", "T", "--checkpoint",
                 ck, "--device", dev.type])
            _, rec["join_seconds"] = cli(
                ["join", "--checkpoint", ck, "--tau", str(TAU), "--device",
                 dev.type, "--out", out])
        except Exception as e:  # surfaced after the serve leg
            errors.append(e)

    side = threading.Thread(target=build_join)
    side.start()
    sck = os.path.join(work, "cli_serve_ckpt")
    cmd = [sys.executable, "-m", "apsim_tpu_torch.cli", "serve", "--port",
           "0", "--store", store, "--table", "T", "--checkpoint-dir", sck,
           "--device", dev.type]
    err_path = os.path.join(work, "serve.err")
    err = open(err_path, "w")
    srv = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                           stdout=subprocess.PIPE, stderr=err, text=True)

    def serve_err() -> str:
        err.flush()
        with open(err_path) as f:
            return f.read()[-4000:]

    try:
        line = srv.stdout.readline()
        if not line.startswith("serving on "):
            raise AssertionError(f"serve: {line!r} {serve_err()}")
        addr = line.split()[-1]
        proc, rec["bench_seconds"] = cli(
            ["bench", "--remote", addr, "--store", store, "--table", "T",
             "--total-message-count", "100", "--children-num", "4",
             "--write-batching-ms", "5"])
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        if rep.get("messages") != 400:
            raise AssertionError(f"bench: {rep}")
        rec["loadgen"] = rep
        log(f"phase 10c load generator, insert -> first result: "
            f"{json.dumps(rep)}")
        t0 = time.perf_counter()
        srv.send_signal(signal.SIGINT)
        rc = srv.wait(timeout=120)
        rec["sigint_to_exit_seconds"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"serve exited {rc}: {serve_err()}")
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
        err.close()
        side.join()
    if errors:
        raise errors[0]
    back = Engine.load(sck, device=dev)
    if back.n_rows != CLI_DOCS:
        raise AssertionError(f"serve's checkpoint: {back.n_rows} rows")
    log(f"phase 10c serve stopped by SIGINT; its checkpoint loads with "
        f"{back.n_rows} rows")
    del back
    with open(out) as f:
        lines = sorted(f.read().splitlines())
    csr, ids = VectorStore(store).read("T")
    eng = Engine(AllPairsConfig(), dev)
    eng.build(csr, ids)
    want = sorted(f"{a}\t{b}\t{s:.6f}" for a, b, s in
                  eng.all_pairs(TAU).id_pairs())
    if lines != want or not want:
        raise AssertionError(f"cli join: {len(lines)} lines, in-process "
                             f"{len(want)}")
    log(f"phase 10c etl of {CLI_DOCS} documents, build and join on the "
        f"card: {len(lines)} pairs equal an in-process join of the store; "
        f"timings {json.dumps(rec)}")
    return rec


def serving_phase(dev, work: str, csr: CSRMatrix, want32: set, want: set,
                  kernels: list, smi: str, saved8, saved9) -> None:
    """Phase 10: checkpoints (10a), the server in-process (10b) and the
    command line in subprocesses (10c), all on the card."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    restore_phase(dev, saved8, saved9, want32, want, kernels, smi)
    torch.cuda.empty_cache()
    server_phase(dev, work, csr, want32, kernels)
    torch.cuda.empty_cache()
    cli_phase(dev, work)
    log(f"phase 10 seconds: {time.perf_counter() - t_phase:.1f}")


# ------------------------ phase 11: the meshes' streaming path, one card
MESH_LAYOUTS = (("rows", 4, "rows"), ("dims", 4, "dims"),
                ("2-D", (2, 2), "dims"))
MESH_SPLIT = ("insert", "admit", "prepare", "append", "gather", "product",
              "reduce", "compact", "d2h", "rescore")
CMESH_SPLIT = ("insert", "admit", "prepare", "append", "slabs", "product",
               "reduce", "compact", "d2h", "rescore")
SERVE_ROWS = 2_048
TIMED_BATCHES = (1, 32, 256)


def shard_devices(devices, n: int) -> list:
    """The devices of an ``n``-shard mesh: ``n`` times one device (phase
    11's shards on one card), or a list of exactly ``n`` (phase 17's, one
    card a shard).  A list of another length raises: no shard is moved
    to a card it was not given."""
    if isinstance(devices, (torch.device, str)):
        return [torch.device(devices)] * n
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a {n}-shard mesh given {len(devices)} devices")
    return devices


def where(devices) -> str:
    """``"4 shards on one card"`` or ``"4 shards over 4 cards"``."""
    cards = len(set(devices))
    return (f"{len(devices)} shards on one card" if cards == 1
            else f"{len(devices)} shards over {cards} cards")


def card_counts(devices, per: int = 1) -> dict:
    """Launches a kernel must have made on each card when every shard of
    ``devices`` launched it ``per`` times: ``{card index: count}``."""
    out: dict = {}
    for d in devices:
        out[d.index] = out.get(d.index, 0) + per
    return out


def check_placement(blocks, devices, label: str) -> None:
    """Each shard's tensor lies on its own device."""
    got = [b.device for b in blocks]
    if got != list(devices):
        raise AssertionError(f"{label}: shards on {got}, not {devices}")


def reset_peaks(devices) -> None:
    for d in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(d)


def peaks(devices) -> list:
    """``torch.cuda.max_memory_allocated`` of each distinct card."""
    return [torch.cuda.max_memory_allocated(d)
            for d in dict.fromkeys(devices)]


def mesh_query_timings(eng, queries, fq, reps: int = 9) -> dict:
    """``topk(k=10)`` and frozen-match latency and queries/s (host clock,
    warm, median of ``reps``)."""
    eng.topk(queries, 10)
    rec = {"topk_ms": median_host_ms(lambda: eng.topk(queries, 10), reps)}
    rec["topk_queries_per_s"] = len(queries) / rec["topk_ms"] * 1e3
    eng.freeze()
    eng.insert(fq, tau=TAU)
    rec["frozen_ms"] = median_host_ms(lambda: eng.insert(fq, tau=TAU), reps)
    rec["frozen_queries_per_s"] = len(fq) / rec["frozen_ms"] * 1e3
    eng.unfreeze()
    return rec


def check_blocks(eng: MeshEngine, x8: torch.Tensor, label: str) -> None:
    """Every block of the streamed mesh equals phase 8's streamed ``x`` on
    its live rows and columns, bit for bit, and is zero past them (each
    block on its own card, beside a copy of its part of ``x``)."""
    nr, nd = eng.grid
    hb, wb = eng.row_cap // nr, eng.dim_cap // nd
    if eng.dim_cap != x8.shape[1]:
        raise AssertionError(f"{label}: dim_cap {eng.dim_cap}, phase 8's "
                             f"{x8.shape[1]}")
    for s, blk in enumerate(eng.x_blocks):
        r, d = divmod(s, nd)
        live = min(max(eng.n_rows - r * hb, 0), hb)
        if not torch.equal(blk[:live], x8[r * hb:r * hb + live,
                                          d * wb:(d + 1) * wb].to(
                                              blk.device)) or bool(
                blk[live:].any()):
            raise AssertionError(f"{label}: block {s} differs from phase "
                                 f"8's streamed x")
    log(f"{label}: {len(eng.x_blocks)} blocks of [{hb}, {wb}] equal phase "
        f"8's streamed x on its {eng.n_rows} live rows, bit for bit")


def stream_two_clients(addr, fresh: CSRMatrix, want: set, served_rows,
                       n_target: int, label: str) -> dict:
    """Two clients stream every row of ``fresh`` (ids ``f<i>``, 64 a
    call) to the server at ``addr`` while a subscriber collects the pushed
    outputs; once ``served_rows()`` reaches ``n_target`` the pushed pairs
    must equal ``want`` (id pairs, the fp64 oracle).  Returns the stream's
    seconds."""
    from apsim_tpu_torch.serve import ClientConnection

    pushed: set = set()
    lock = threading.Lock()
    errors = []

    def on_output(out, moment) -> None:
        with lock:
            pushed.update((min(q, c), max(q, c))
                          for q, cands in out.items() for c in cands)

    def stream(part) -> None:
        try:
            c = ClientConnection(addr)
            for s in range(0, part.size, 64):
                c.insert_new_vector([(f"f{i}", fresh.row(int(i)))
                                     for i in part[s:s + 64]])
            c.flush()
            c.close()
        except Exception as e:  # surfaced after the join below
            errors.append(e)

    rec = {}
    sub = ClientConnection(addr)
    try:
        sub.subscribe_outputs(on_output)
        rows = np.arange(fresh.n_rows)
        threads = [threading.Thread(target=stream, args=(rows[k::2],))
                   for k in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        wait_for(lambda: served_rows() == n_target, 60, "the served rows")
        rec["stream_seconds"] = time.perf_counter() - t0
        wait_for(lambda: len(pushed) >= len(want), 60, "the pushed outputs")
        time.sleep(0.2)
        with lock:
            if pushed != want or not want:
                raise AssertionError(
                    f"{label} pushed pairs differ from the fp64 oracle: "
                    f"{len(pushed - want)} extra, {len(want - pushed)} "
                    f"missing")
    finally:
        sub.close()
    return rec


def serve_mesh(devices, eng: MeshEngine, csr: CSRMatrix,
               phase: str = "11c") -> dict:
    """Phase 11c: ``SimilarityServer`` + ``RpcServer`` in-process over the
    streamed rows mesh (its shards on ``devices``; the server on the
    mesh's lead card, the oracle on the first device); two clients stream
    ``SERVE_ROWS`` fresh rows (ids ``f<i>``) while a subscriber collects
    the pushed outputs, which must equal the fp64 oracle of the fresh rows
    against the index and each other."""
    from apsim_tpu_torch.serve import RpcServer, SimilarityServer

    dev = shard_devices(devices, eng.n_shards)[0]
    if eng.mesh.lead != dev:
        raise AssertionError(f"phase {phase}: the mesh leads on "
                             f"{eng.mesh.lead}, not {dev}")
    fresh = synthetic_corpus(SERVE_ROWS, seed=31)
    n0 = eng.n_rows
    ids = [str(i) for i in range(n0)] + [f"f{i}" for i in range(SERVE_ROWS)]
    want = {(min(ids[a], ids[b]), max(ids[a], ids[b]))
            for a, b in batch_oracle([csr], fresh, n0, TAU, dev)}
    sim = SimilarityServer(eng, eng.cfg, device=dev)
    rpc = RpcServer(sim, "127.0.0.1", 0).start()
    try:
        rec = stream_two_clients([f"{rpc.host}:{rpc.port}"], fresh, want,
                                 lambda: sim.stats()["n_rows"],
                                 n0 + SERVE_ROWS, f"phase {phase}")
    finally:
        rpc.close()
    rec.update(rows=SERVE_ROWS, pairs=len(want))
    log(f"phase {phase} server over the rows mesh ({where(devices)}): 2 "
        f"clients streamed {SERVE_ROWS} fresh rows; {len(want)} pushed pairs "
        f"equal the fp64 oracle; {json.dumps(rec)}")
    return rec


def mesh_dense_stream(devices, csr: CSRMatrix, want32: set, x8, qsets8,
                      kernels: list, smi: str, layout: str, shape,
                      axis: str, phase: str = "11a", shards=(0, 3),
                      tag: str = "mesh_stream", keep: bool = False) -> dict:
    """Phase 11a, one layout: ``MeshEngine`` over 4 shards on ``devices``
    (one device: the 4 shards on it; a list: one shard on each), built on
    phase 8's first 24,576 rows, the rest streamed with phase 8's
    schedule; the union, the join of the streamed index (rows: kernel 3
    once per shard, and bit for bit against its plain version at the
    streamed operands of each shard of ``shards``, the first timed), the
    blocks against phase 8's ``x`` (``x8``; None skips it), top-k and
    frozen matching; the rows layout then serves (11c); then the timings.
    Each kernel record gets ``tag``-prefixed keys.  Returns phase 12a's
    reference: the build join's pairs, every insert's output, the
    candidate lists of the streamed index's join, the top-k lists, the
    frozen match's output and the timings (``keep``: the engine too)."""
    devices = shard_devices(devices, 4)
    dev = devices[0]
    label = f"phase {phase} {layout} mesh, {where(devices)}"
    eng = MeshEngine(AllPairsConfig(shard_axis=axis,
                                    similarity_threshold=TAU),
                     mesh=make_mesh(shape, devices=devices))
    log(f"{label} build, {STREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, STREAM_BUILD)))}")
    check_placement(eng.x_blocks, devices, label)
    caps0 = (eng.row_cap, eng.dim_cap)
    res = eng.all_pairs(TAU)
    ref = {"join": (res.i.copy(), res.j.copy(), res.sims.copy()),
           "outputs": []}
    union, _, _, nb, secs = stream_rows(eng, csr, STREAM_BUILD,
                                        [1] * 16 + [32] * 16,
                                        outputs=ref["outputs"])
    union |= set(zip(res.i.tolist(), res.j.tolist()))
    if eng.n_rows != csr.n_rows or eng.row_cap != 2 * STREAM_BUILD:
        raise AssertionError(f"{label}: n_rows {eng.n_rows}, row_cap "
                             f"{eng.row_cap}")
    if union != want32:
        raise AssertionError(f"{label}: streamed union differs from the "
                             f"fp64 oracle: {len(union - want32)} extra, "
                             f"{len(want32 - union)} missing")
    check_placement(eng.x_blocks, devices, label)
    log(f"{label} stream: {nb} inserts in {secs:.3f} s; (row_cap, dim_cap) "
        f"{caps0} -> {(eng.row_cap, eng.dim_cap)}; build join + every "
        f"insert's output: {len(union)} pairs equal the fp64 oracle")
    zero_launches()
    res, ref["cand"] = join_with_candidates(eng, "_finalize_pairs")
    launches, by_card = dict(ts.LAUNCHES), launches_by_card()
    expect = {k: 0 for k in launches}
    expect_cards = {k: {} for k in launches}
    if axis == "rows":
        expect["panel_score_bits_int8"] = 4
        expect_cards["panel_score_bits_int8"] = card_counts(devices)
    expect = with_compactions(expect)
    expect_cards = with_compactions(expect_cards)
    if launches != expect or by_card != expect_cards:
        raise AssertionError(f"{label}: launches {launches}, by card "
                             f"{by_card}, expected {expect}, {expect_cards}")
    check_parity(res, want32, f"{label} join of the streamed index")
    if axis == "rows":
        recs = [compare_rows_shard(eng, s, timed=s == shards[0]
                                   or tag != "mesh_stream")
                for s in shards]
        log(f"{label} kernel 3 vs plain at the streamed operands: "
            f"{json.dumps(recs)}")
        k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
        k3.update({f"{tag}_join_launches": launches[
            "panel_score_bits_int8"],
            **{f"{tag}_{k}": recs[0][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")},
            f"{tag}_max_abs_err": max(r["max_abs_err"] for r in recs)})
        if tag != "mesh_stream":
            k3.update({f"{tag}_join_launches_by_card": by_card[
                "panel_score_bits_int8"],
                f"{tag}_per_card": [
                    {"card": devices[r["shard"]].index,
                     **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms")}} for r in recs]})
    if x8 is not None:
        check_blocks(eng, x8, label)
    queries, sq, fq, fs, fpicks = qsets8
    check_topk(eng, queries, sq, label)
    check_frozen(eng, fq, fs, fpicks, label)
    ref["topk"] = eng.topk(queries, 10)
    ref["frozen"] = frozen_output(eng, fq)
    if axis == "rows":
        ref["served"] = serve_mesh(
            devices, eng, csr,
            phase="11c" if phase == "11a" else f"{phase} in-process server")
    rec = {"card": smi, "layout": layout, "devices": [str(d) for d in
                                                      devices],
           "rows": eng.n_rows, "row_cap": eng.row_cap,
           "dim_cap": eng.dim_cap, "stream_seconds": secs,
           "stream_batches": nb}
    rec.update(stream_timings(eng, synthetic_corpus(4096, seed=13),
                              TIMED_BATCHES, None, split=MESH_SPLIT))
    rec.update(mesh_query_timings(eng, queries, fq))
    if eng.row_cap != 2 * STREAM_BUILD:
        raise AssertionError(f"{label}: the timing inserts grew the index")
    log(f"{label} timings: {json.dumps(rec)}")
    ref["timings"] = rec
    if keep:
        ref["eng"] = eng
    return ref


def capacity_rows(eng: MeshChunkedAllPairs, seed: int = 41):
    """Batches of 256 rows whose entries all lie in the fullest chunk (192
    of its dims each, every 16th row a copy of the one before), enough to
    pass its capacity: the streamed corpus alone fills no chunk past its
    power-of-two capacity, so this batch series makes the growth
    happen."""
    c = int(np.argmax(eng._counts))
    dims = eng.compact.ext_of_col[c::eng._n_chunks]
    need = eng._chunk_cap - int(eng._counts[c]) + 1
    n = round_up(-(-need // 192), 256)
    rng = np.random.default_rng(seed)
    vecs = []
    for i in range(n):
        if i % 16 == 15:
            vecs.append(vecs[-1])
            continue
        d = np.sort(rng.choice(dims, 192, replace=False)).astype(np.int32)
        v = rng.random(192) + 0.05
        vecs.append(SparseVector(1 << 20, d, v / np.linalg.norm(v)))
    return c, [vecs[s:s + 256] for s in range(0, n, 256)]


def mesh_chunked_stream(devices, csr: CSRMatrix, want: set, qsets9,
                        kernels: list, smi: str, n: int = 8,
                        phase: str = "11b", shards=(0,),
                        tag: str = "mesh_stream", keep: bool = False) -> dict:
    """Phase 11b: ``MeshChunkedAllPairs`` over ``n`` shards on ``devices``
    (one device: every shard on it; a list: one shard on each) on phase
    5's corpus: build 90,000 rows, stream the rest with phase 9a's batch
    sizes (every match on the rebuild route); the union, the join of the
    streamed index (kernel 4 ``n`` times per panel pair, and exactly its
    plain version at one panel pair of each shard of ``shards``' own
    operands), top-k and frozen matching against fp64; a per-chunk
    capacity growth on every shard (asserted) with each batch against
    fp64 and the join after it; then the timings with the stage split.
    Each kernel record gets ``tag``-prefixed keys.  Returns the build
    join's pairs, every insert's output, the streamed join's candidate
    lists, the top-k lists, the frozen match's output, the capacity
    batches' outputs, the last join's pairs and the timings (``keep``:
    the engine too)."""
    devices = shard_devices(devices, n)
    dev = devices[0]
    label = f"phase {phase} chunked mesh, {where(devices)}"
    eng = MeshChunkedAllPairs(AllPairsConfig(),
                              mesh=make_mesh(n, devices=devices))
    reset_peaks(devices)
    log(f"{label} build, {CSTREAM_BUILD} rows: "
        f"{json.dumps(eng.build(csr_rows(csr, 0, CSTREAM_BUILD)))}")
    for k in range(3):
        check_placement(eng._ent[k], devices, label)
    res = eng.all_pairs(TAU)
    ref = {"join": (res.i.copy(), res.j.copy(), res.sims.copy()),
           "outputs": []}
    union, _, caps, nb, secs = stream_rows(
        eng, csr, CSTREAM_BUILD, [1] * 8 + [32] * 8, "device_rebuild",
        outputs=ref["outputs"])
    union |= set(zip(res.i.tolist(), res.j.tolist()))
    if union != want:
        raise AssertionError(f"{label}: streamed union differs from the "
                             f"fp64 oracle: {len(union - want)} extra, "
                             f"{len(want - union)} missing")
    log(f"{label} stream: {nb} inserts of rows {CSTREAM_BUILD}-"
        f"{csr.n_rows - 1} in {secs:.3f} s, every one on the rebuild route; "
        f"row_cap {caps}; {len(union)} pairs equal the fp64 oracle")

    def join(want_pairs: set, what: str):
        zero_launches()
        res, cand = join_with_candidates(eng, "_rescore_pairs")
        launches, by_card = dict(ts.LAUNCHES), launches_by_card()
        geom = eng._panel_geom()
        pairs = geom[3] * (geom[3] + 1) // 2
        cards = list(dict.fromkeys(devices))  # one row slice a card
        expect = {k: 0 for k in launches}
        expect["int8_matmul"] = n * pairs
        expect["pair_bits_int8"] = len(cards) * pairs
        expect_cards = {k: {} for k in launches}
        expect_cards["int8_matmul"] = card_counts(devices, pairs)
        expect_cards["pair_bits_int8"] = card_counts(cards, pairs)
        expect = with_compactions(expect)
        expect_cards = with_compactions(expect_cards)
        if launches != expect or by_card != expect_cards:
            raise AssertionError(f"{label} {what}: launches {launches}, by "
                                 f"card {by_card}, expected {expect}, "
                                 f"{expect_cards}")
        check_parity(res, want_pairs, f"{label} {what}")
        return res, cand, launches, by_card

    _, ref["cand"], n_launch, by_card = join(want,
                                             "join of the streamed index")
    st = eng._panel_state()
    last = eng._panel_geom()[3] - 1
    x0, xl = eng._build_slab(st, 0), eng._build_slab(st, last)
    mms = [dict(compare_mm(x0[s], xl[s], f"{label}, pair (0, {last}), "
                           f"shard {s}"), shard=s, card=devices[s].index)
           for s in shards]
    del st, x0, xl
    pbs = compare_pair_bits(eng, 0, last, f"{label}, pair (0, {last})")
    mm = mms[0]
    k4 = next(k for k in kernels if k["name"] == "int8_matmul")
    k5 = next(k for k in kernels if k["name"] == "pair_bits_int8")
    for kr, name, recs in ((k4, "int8_matmul", mms),
                           (k5, "pair_bits_int8", pbs)):
        kr.update({f"{tag}_join_launches": n_launch[name],
                   **{f"{tag}_{k}": recs[0][k] for k in (
                       "ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")},
                   f"{tag}_max_abs_err": max(r["max_abs_err"]
                                             for r in recs)})
        if tag != "mesh_stream":
            kr.update({f"{tag}_join_launches_by_card": by_card[name],
                       f"{tag}_per_card": [
                           {k: r[k] for k in ("card", "max_abs_err", "ms",
                                              "plain_ms", "library_ms",
                                              "bound_ms")} for r in recs]})
    k4.update({f"{tag}_{k}": mm[k] for k in ("m", "n", "d")})
    queries, sq, fq, fs, fpicks = qsets9
    check_topk(eng, queries, sq, label)
    check_frozen(eng, fq, fs, fpicks, label)
    if eng.last_route != "device_rebuild":
        raise AssertionError(f"{label}: frozen match took {eng.last_route}")
    ref["topk"] = eng.topk(queries, 10)
    ref["frozen"] = frozen_output(eng, fq)

    cap0 = eng._chunk_cap
    c, batches = capacity_rows(eng)
    index, grown = [csr], set()
    ref["grown"] = []
    for vs in batches:
        n0 = eng.n_rows
        out = eng.insert([(str(n0 + i), v) for i, v in enumerate(vs)],
                         tau=TAU)
        ref["grown"].append(out.output)
        part = CSRMatrix.from_vectors(vs, csr.n_cols)
        want_b = batch_oracle(index, part, n0, TAU, dev)
        if pairs_of(out) != want_b or eng.last_route != "device_rebuild":
            raise AssertionError(f"{label} capacity batch at row {n0}: "
                                 f"{len(pairs_of(out) ^ want_b)} pairs off "
                                 f"the fp64 oracle, route {eng.last_route}")
        grown |= want_b
        index.append(part)
    shapes = {tuple(t.shape) for t in eng._ent[0]}
    if eng._chunk_cap != 2 * cap0 or shapes != {(eng._n_chunks // n,
                                                 eng._chunk_cap)}:
        raise AssertionError(f"{label}: chunk capacity {cap0} -> "
                             f"{eng._chunk_cap}, shard buffers {shapes}")
    for k in range(3):
        check_placement(eng._ent[k], devices, label)
    log(f"{label} capacity growth: {len(batches)} batches of 256 rows into "
        f"chunk {c} grew every shard's per-chunk capacity {cap0} -> "
        f"{eng._chunk_cap}; {len(grown)} new pairs equal the fp64 oracle")
    res, _, _, _ = join(want | grown, "join after the capacity growth")
    ref["join_grown"] = (res.i.copy(), res.j.copy(), res.sims.copy())

    rec = {"card": smi, "devices": [str(d) for d in devices],
           "rows": eng.n_rows, "row_cap": eng.row_cap,
           "n_chunks": eng._n_chunks, "chunk_cap": eng._chunk_cap,
           "stream_seconds": secs, "stream_batches": nb}
    rec.update(stream_timings(eng, synthetic_corpus(4096, seed=13),
                              TIMED_BATCHES, "device_rebuild",
                              split=CMESH_SPLIT))
    rec.update(mesh_query_timings(eng, queries, fq))
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if len(set(devices)) > 1:
        rec["max_memory_allocated_per_card"] = peaks(devices)
    log(f"{label} timings: {json.dumps(rec)}")
    ref["timings"] = rec
    if keep:
        ref["eng"] = eng
    return ref


def mesh_stream_phase(dev, big_csr: CSRMatrix, want32: set, x8, qsets8,
                      ooc_csr: CSRMatrix, want: set, qsets9, kernels: list,
                      smi: str) -> dict:
    """Phase 11: the meshes' streaming path, their shards on the one card
    (11a the dense mesh in three layouts, 11c the server over its rows
    layout, 11b the chunked mesh).  Returns 11a's references for phase
    12a, by layout."""
    t_phase = time.perf_counter()
    refs = {}
    x8 = x8.to(dev)
    q8 = (qsets8[0], qsets8[1].to(dev), qsets8[2], qsets8[3].to(dev),
          qsets8[4])
    for layout, shape, axis in MESH_LAYOUTS:
        refs[layout] = mesh_dense_stream([dev] * 4, big_csr, want32, x8,
                                         q8, kernels, smi, layout, shape,
                                         axis)
        torch.cuda.empty_cache()
    del x8, q8
    torch.cuda.empty_cache()
    q9 = (qsets9[0], qsets9[1].to(dev), qsets9[2], qsets9[3].to(dev),
          qsets9[4])
    mesh_chunked_stream([dev] * 8, ooc_csr, want, q9, kernels, smi)
    torch.cuda.empty_cache()
    log(f"phase 11 seconds: {time.perf_counter() - t_phase:.1f}")
    return refs


# --------------------- phase 12: one index served from several processes
# by default two ranks on the one card; NCCL refuses two ranks on one card
P12_TOPOLOGY = {"world": 2, "cards": 1, "backend": "gloo"}
P12_TIMEOUT = 900  # seconds for every rank of 12a and 12b together
P12_STREAM = 512  # fresh rows streamed into 12b's chunked mesh
P12_BATCHES = (1, 256)
CLI_WRAP = (  # the CLI as a user runs it, with the launch counts at exit
    "import atexit, json, runpy, sys\n"
    "from apsim_tpu_torch.ops import tri_score as ts\n"
    "atexit.register(lambda: print('LAUNCHES ' + json.dumps(ts.LAUNCHES)"
    " + '\\nLAUNCHES_BY_CARD ' + json.dumps(ts.LAUNCHES_BY_CARD),"
    " flush=True))\n"
    "sys.argv = ['apsim-torch'] + sys.argv[1:]\n"
    "runpy.run_module('apsim_tpu_torch.cli', run_name='__main__')\n"
)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_with_candidates(eng, rescore: str):
    """``eng.all_pairs(TAU)`` and the host candidate lists its rescore
    (the engine's method ``rescore``) was handed: one join for both."""
    seen = []
    inner = getattr(eng, rescore)

    def spy(i, j, tau):
        seen.append((np.array(i), np.array(j)))
        return inner(i, j, tau)

    setattr(eng, rescore, spy)
    try:
        res = eng.all_pairs(TAU)
    finally:
        delattr(eng, rescore)
    return res, seen[0]


def frozen_output(eng, fq) -> dict:
    eng.freeze()
    out = eng.insert(fq, tau=TAU).output
    eng.unfreeze()
    return out


def query_lists(csr: CSRMatrix):
    """Phase 8's top-k and frozen-match query lists (its seeds and
    picks)."""
    qsrc, fsrc = synthetic_corpus(512, seed=7), synthetic_corpus(128, seed=11)
    picks = np.arange(0, csr.n_rows, csr.n_rows // 512)[:512]
    fpicks = np.arange(5, csr.n_rows, csr.n_rows // 128)[:128]
    return ([(f"t{r}", csr.row(int(r))) for r in picks]
            + [(f"s{i}", qsrc.row(i)) for i in range(512)],
            [(f"z{r}", csr.row(int(r))) for r in fpicks]
            + [(f"y{i}", fsrc.row(i)) for i in range(128)])


def save_csr(path: str, csr: CSRMatrix, **extra) -> None:
    np.savez(path, indptr=csr.indptr, indices=csr.indices, data=csr.data,
             n_cols=csr.n_cols, **extra)


def load_csr(path: str):
    z = np.load(path)
    csr = CSRMatrix(z["indptr"].size - 1, int(z["n_cols"]), z["indptr"],
                    z["indices"], z["data"])
    return csr, z


def as_pairs(a: np.ndarray) -> set:
    return set(zip(a[:, 0].tolist(), a[:, 1].tolist()))


def pairs_array(pairs) -> np.ndarray:
    return np.array(sorted(pairs), np.int64).reshape(-1, 2)


def first_difference(got: list, want: list) -> str:
    for k, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return f"batch {k}"
    return f"{len(got)} outputs against {len(want)}"


def p12_timings(eng, route, split, queries=None) -> dict:
    """Insert latency at bs = 1 and 256 (``stream_timings``, with the
    cross-process stage) and, given queries, top-k latency."""
    from apsim_tpu_torch.parallel.collectives import TRAFFIC

    rec = stream_timings(eng, synthetic_corpus(4096, seed=13), P12_BATCHES,
                         route, split=split, traffic=TRAFFIC)
    if queries is not None:
        eng.topk(queries, 10)
        rec["topk_ms"] = median_host_ms(lambda: eng.topk(queries, 10), 3)
    return rec


def p12_dense(dev, rank: int, csr: CSRMatrix, want32: set, ref: dict,
              layout: str, queries, fq, smi: str, n_build: int,
              per: int) -> dict:
    """Phase 12a on one rank: ``MeshEngine`` over ``global_mesh((4,))``,
    ``per`` shards a rank, phase 11a's steps (build ``n_build`` rows,
    stream the rest); every result equal to phase 11a's one-process mesh
    of the same layout."""
    from apsim_tpu_torch.parallel import global_mesh
    from apsim_tpu_torch.parallel.collectives import TRAFFIC, reset_traffic

    label = f"phase 12a rank {rank}, {layout} mesh, {per} of 4 shards"
    mesh = global_mesh((4,), devices=[dev] * per)
    eng = MeshEngine(AllPairsConfig(shard_axis=layout,
                                    similarity_threshold=TAU), mesh=mesh)
    reset_traffic()
    rec = {"card": smi, "layout": layout, "rank": rank,
           "shards": list(mesh.local_shards)}
    t0 = time.perf_counter()
    eng.build(csr_rows(csr, 0, n_build))
    rec["build_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = eng.all_pairs(TAU)
    rec["build_join_seconds"] = time.perf_counter() - t0
    outputs = []
    union, _, _, nb, secs = stream_rows(eng, csr, n_build,
                                        [1] * 16 + [32] * 16,
                                        outputs=outputs)
    union |= set(zip(res.i.tolist(), res.j.tolist()))
    if union != want32:
        raise AssertionError(f"{label}: streamed union differs from the "
                             f"fp64 oracle")
    if outputs != ref["outputs"]:
        raise AssertionError(
            f"{label}: insert outputs differ from phase 11a's at "
            f"{first_difference(outputs, ref['outputs'])}")
    rec.update(stream_seconds=secs, stream_batches=nb)
    zero_launches()
    t0 = time.perf_counter()
    res, cand = join_with_candidates(eng, "_finalize_pairs")
    rec["join_seconds"] = time.perf_counter() - t0
    launches = dict(ts.LAUNCHES)
    expect = {k: 0 for k in launches}
    if layout == "rows":
        expect["panel_score_bits_int8"] = len(mesh.local_shards)
    expect = with_compactions(expect)
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    rec["join_launches"] = launches
    check_parity(res, want32, f"{label} join of the streamed index")
    if not all(np.array_equal(a, b) for a, b in zip(cand, ref["cand"])):
        raise AssertionError(f"{label}: candidate lists differ from phase "
                             f"11a's")
    if layout == "rows":  # both ranks check, rank 0 times (one card)
        rec["kernel3"] = compare_rows_shard(eng, mesh.local_shards[0],
                                            timed=rank == 0)
    if eng.topk(queries, 10) != ref["topk"]:
        raise AssertionError(f"{label}: top-k lists differ from phase 11a's")
    if frozen_output(eng, fq) != ref["frozen"]:
        raise AssertionError(f"{label}: frozen match differs from phase "
                             f"11a's")
    log(f"{label}: the union of {nb + 1} outputs and the streamed join equal "
        f"the fp64 oracle ({len(want32)} pairs); every insert output, the "
        f"join's candidate lists ({cand[0].size}), {len(queries)} top-k "
        f"lists and the frozen match equal phase 11a's one-process mesh "
        f"bit for bit; launches {launches}")
    rec["bytes_crossed"] = TRAFFIC["bytes"]
    rec["cross_process_calls"] = TRAFFIC["calls"]
    rec.update(p12_timings(eng, None, MESH_SPLIT, queries))
    log(f"{label} timings: {json.dumps(rec)}")
    return rec


def p12_chunked(dev, rank: int, csr: CSRMatrix, want: set, cand: set,
                fresh_want: set, smi: str, n_fresh: int, per: int) -> dict:
    """Phase 12b on one rank: ``MeshChunkedAllPairs`` over
    ``global_mesh((8,))``, ``per`` shards a rank, on phase 5's corpus:
    build, join (kernel 4 once a panel pair per own shard), the pair set
    and the candidate set of phases 5 and 6, kernel 4 against its plain
    version at one shard of this rank, a short stream of ``n_fresh`` rows
    on the rebuild route."""
    from apsim_tpu_torch.parallel import global_mesh
    from apsim_tpu_torch.parallel.collectives import TRAFFIC, reset_traffic

    label = f"phase 12b rank {rank}, chunked mesh, {per} of 8 shards"
    mesh = global_mesh((8,), devices=[dev] * per)
    eng = MeshChunkedAllPairs(AllPairsConfig(), mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    reset_traffic()
    rec = {"card": smi, "rank": rank, "shards": list(mesh.local_shards)}
    t0 = time.perf_counter()
    eng.build(csr)
    rec["build_seconds"] = time.perf_counter() - t0
    zero_launches()
    reset_traffic()
    t0 = time.perf_counter()
    res, found = join_with_candidates(eng, "_rescore_pairs")
    rec["join_seconds"] = time.perf_counter() - t0
    rec["join_cross_process_seconds"] = TRAFFIC["seconds"]
    rec["join_bytes_crossed"] = TRAFFIC["bytes"]
    launches = dict(ts.LAUNCHES)
    geom = eng._panel_geom()
    n_pairs = geom[3] * (geom[3] + 1) // 2
    expect = {k: 0 for k in launches}
    expect["int8_matmul"] = len(mesh.local_shards) * n_pairs
    # kernel 5 runs on the int32 sum, on the last shard's process only
    expect["pair_bits_int8"] = n_pairs * mesh.is_local(mesh.size - 1)
    expect = with_compactions(expect)
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    rec["join_launches"] = launches
    check_parity(res, want, f"{label} join")
    if pair_set(found) != cand:
        raise AssertionError(f"{label}: candidate set differs from the "
                             f"single-device join's")
    st = eng._panel_state()
    s = mesh.local_shards[0]
    last = geom[3] - 1
    rec["kernel4"] = compare_mm(eng._build_slab(st, 0)[s],
                                eng._build_slab(st, last)[s],
                                f"{label}, pair (0, {last}), shard {s}")
    del st
    fresh = synthetic_corpus(n_fresh, seed=31)
    n0 = eng.n_rows
    union, _, _, nb, secs = stream_rows(
        eng, CSRMatrix(n0 + fresh.n_rows, fresh.n_cols,
                       np.concatenate([np.zeros(n0, np.int64),
                                       fresh.indptr]),
                       fresh.indices, fresh.data),
        n0, [1] * 4 + [32] * 4, "device_rebuild")
    if union != fresh_want:
        raise AssertionError(f"{label}: streamed outputs differ from the "
                             f"fp64 oracle: {len(union ^ fresh_want)} pairs")
    rec.update(stream_seconds=secs, stream_batches=nb)
    log(f"{label}: join of {n0} rows equals the fp64 oracle ({len(want)} "
        f"pairs) and phases 5-6's candidate set ({len(cand)}); launches "
        f"{launches}; {nb} inserts of {n_fresh} fresh rows on the "
        f"rebuild route equal the fp64 oracle ({len(fresh_want)} pairs)")
    rec.update(p12_timings(eng, "device_rebuild", CMESH_SPLIT))
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"{label} timings: {json.dumps(rec)}")
    return rec


def phase12_rank(rank: int, port: int, work: str) -> int:
    """One rank of phase 12a and 12b (``--phase12-rank``): join the group
    the parent set up (``work``: its inputs, sizes and topology), run 12a
    over both layouts and 12b, write the records to
    ``work/rank<rank>.json``."""
    import pickle

    import torch.distributed as dist

    from apsim_tpu_torch.parallel import init_multihost

    with open(os.path.join(work, "refs.pkl"), "rb") as f:
        refs, sizes = pickle.load(f)
    world = sizes["world"]
    dev = torch.device("cuda", rank % sizes["cards"])
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    _build.kernels()  # built by the parent: this loads it
    init_multihost(f"127.0.0.1:{port}", world, rank,
                   backend=sizes["backend"])
    log(f"phase 12 rank {rank}: torch.distributed backend "
        f"{dist.get_backend()}, world {dist.get_world_size()}; {dev} of "
        f"{smi}")
    csr, z = load_csr(os.path.join(work, "dense.npz"))
    want32 = as_pairs(z["want"])
    queries, fq = query_lists(csr)
    out = {"backend": dist.get_backend()}
    for layout in ("rows", "dims"):
        out[layout] = p12_dense(dev, rank, csr, want32, refs[layout], layout,
                                queries, fq, smi, sizes["build"], 4 // world)
        torch.cuda.empty_cache()
    del csr, queries, fq
    ooc, z = load_csr(os.path.join(work, "ooc.npz"))
    out["chunked"] = p12_chunked(dev, rank, ooc, as_pairs(z["want"]),
                                 as_pairs(z["cand"]), as_pairs(z["fresh"]),
                                 smi, sizes["fresh"], 8 // world)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def start_ranks(argv, env_of, lines: dict, tag: str):
    """Start a rank process of ``argv(rank)`` for each key of ``lines``
    (``env_of(rank)`` added to the environment); a thread a rank copies
    its output lines, tagged, to this log and into ``lines[rank]``."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs, relays = [], []
    for r in lines:
        procs.append(subprocess.Popen(
            argv(r), cwd=here, env=dict(os.environ, **env_of(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

        def run(p=procs[-1], r=r):
            for line in p.stdout:
                lines[r].append(line.rstrip())
                log(f"{tag} rank {r} | {line.rstrip()}")

        relays.append(threading.Thread(target=run, daemon=True))
        relays[-1].start()
    return procs, relays


def stop_ranks(procs, relays, timeout: float, label: str) -> None:
    """Wait for the ranks (killing what outlives ``timeout``); every rank
    must have exited 0."""
    deadline = time.time() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for t in relays:
        t.join(5)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"{label} rank {r} exited {p.returncode}")


def cli_replicate(dev, work: str, smi: str, topo: dict) -> dict:
    """Phase 12c: ``python -m apsim_tpu_torch.cli serve --replicate`` in
    ``topo``'s processes (``--mesh-shape 4`` rows layout; by default two
    on the card over ``gloo``, 2 shards a rank): a client streams 2,048
    fresh rows into rank 0's RPC port, the ``all_pairs`` RPC equals the
    fp64 oracle, and after SIGINT every follower prints "leader closed"
    and exits 0.  Each rank prints its kernel launches at exit: one a
    shard of its own."""
    from apsim_tpu_torch.serve import ClientConnection

    fresh = synthetic_corpus(SERVE_ROWS, seed=31)
    want = {(str(a), str(b)) for a, b in oracle_pairs(fresh, TAU, dev)}
    cfgfile = os.path.join(work, "p12c.json")
    with open(cfgfile, "w") as f:
        json.dump({"shard_axis": "rows", "similarity_threshold": TAU,
                   "io_trigger_period_ms": 5}, f)
    coord, repl, rpc_port = free_port(), free_port(), free_port()
    argv = [sys.executable, "-c", CLI_WRAP, "serve", "--config", cfgfile,
            "--mesh-shape", "4", "--device", "cuda", "--dist-backend",
            topo["backend"], "--replicate", f"127.0.0.1:{repl}", "--host",
            "127.0.0.1", "--port", str(rpc_port)]
    world = topo["world"]
    lines = {r: [] for r in range(world)}
    rec = {"card": smi, "rows": SERVE_ROWS, "pairs": len(want)}
    t0 = time.perf_counter()
    procs, relays = start_ranks(
        lambda r: argv, lambda r: {"MASTER_ADDR": "127.0.0.1",
                                   "MASTER_PORT": str(coord),
                                   "WORLD_SIZE": str(world),
                                   "RANK": str(r)},
        lines, "phase 12c")
    try:
        cc = None
        deadline = time.time() + 180
        while cc is None and time.time() < deadline:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("phase 12c: a server process exited")
            try:
                cc = ClientConnection([f"127.0.0.1:{rpc_port}"], timeout=60)
            except OSError:
                time.sleep(0.5)
        if cc is None:
            raise AssertionError("phase 12c: the server never came up")
        rec["start_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for s0 in range(0, SERVE_ROWS, 64):
            cc.insert_new_vector([(str(i), fresh.row(i)) for i in
                                  range(s0, min(s0 + 64, SERVE_ROWS))])
        cc.flush()
        rec["stream_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = cc.all_pairs(TAU)
        rec["all_pairs_rpc_seconds"] = time.perf_counter() - t0
        cc.close()
        got = {(min(a, b, key=int), max(a, b, key=int)) for a, b, _ in served}
        if got != want or not want:
            raise AssertionError(f"phase 12c: the all_pairs RPC differs from "
                                 f"the fp64 oracle: {len(got ^ want)} pairs")
    finally:
        procs[0].send_signal(signal.SIGINT)
        stop_ranks(procs, relays, 60, "phase 12c")
    if not all(any("leader closed" in ln for ln in lines[r])
               for r in range(1, world)):
        raise AssertionError("phase 12c: a follower did not see the leader "
                             "close")
    rec["launches"] = []
    for r in range(world):
        got = [json.loads(ln.split(" ", 1)[1]) for ln in lines[r]
               if ln.startswith("LAUNCHES ")]
        if not got or got[-1]["panel_score_bits_int8"] != 4 // world:
            raise AssertionError(f"phase 12c rank {r}: launches {got}")
        rec["launches"].append(got[-1]["panel_score_bits_int8"])
    log(f"phase 12c serve --replicate, {world} processes: {SERVE_ROWS} rows "
        f"streamed, the all_pairs RPC equals the fp64 oracle ({len(want)} "
        f"pairs), the followers closed cleanly; {json.dumps(rec)}")
    return rec


def multihost_phase(dev, work: str, big_csr: CSRMatrix, want32: set,
                    refs: dict, ooc_csr: CSRMatrix, want: set,
                    cand100k: set, kernels: list, smi: str,
                    topo: dict = P12_TOPOLOGY) -> None:
    """Phase 12: one index from several processes (12a, 12b in
    ``--phase12-rank`` processes; 12c the command line); ``topo``: the
    ranks, the cards they are spread over and the backend."""
    import pickle

    t_phase = time.perf_counter()
    d = os.path.join(work, "p12")
    os.makedirs(d)
    save_csr(os.path.join(d, "dense.npz"), big_csr, want=pairs_array(want32))
    fresh = synthetic_corpus(P12_STREAM, seed=31)
    fresh_want = batch_oracle([ooc_csr], fresh, ooc_csr.n_rows, TAU, dev)
    save_csr(os.path.join(d, "ooc.npz"), ooc_csr, want=pairs_array(want),
             cand=pairs_array(cand100k), fresh=pairs_array(fresh_want))
    with open(os.path.join(d, "refs.pkl"), "wb") as f:
        pickle.dump(({k: refs[k] for k in ("rows", "dims")},
                     {"build": STREAM_BUILD, "fresh": P12_STREAM, **topo}), f)
    torch.cuda.empty_cache()
    port = free_port()
    here = os.path.abspath(__file__)
    procs, relays = start_ranks(
        lambda r: [sys.executable, here, "--phase12-rank", str(r), str(port),
                   d], lambda r: {}, {r: [] for r in range(topo["world"])},
        "phase 12")
    stop_ranks(procs, relays, P12_TIMEOUT, "phase 12")
    ranks = []
    for r in range(topo["world"]):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if {rk["backend"] for rk in ranks} != {topo["backend"]}:
        raise AssertionError(f"phase 12: backends {ranks}")
    rec12c = cli_replicate(dev, work, smi, topo)
    k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
    k3.update({
        "multihost_join_launches": [rk["rows"]["join_launches"][
            "panel_score_bits_int8"] for rk in ranks],
        "multihost_serve_launches": rec12c["launches"],
        "multihost_max_abs_err": max(rk["rows"]["kernel3"]["max_abs_err"]
                                     for rk in ranks),
        **{f"multihost_{k}": ranks[0]["rows"]["kernel3"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")}})
    k5 = next(k for k in kernels if k["name"] == "pair_bits_int8")
    k5["multihost_join_launches"] = [rk["chunked"]["join_launches"][
        "pair_bits_int8"] for rk in ranks]
    k4 = next(k for k in kernels if k["name"] == "int8_matmul")
    k4.update({
        "multihost_join_launches": [rk["chunked"]["join_launches"][
            "int8_matmul"] for rk in ranks],
        "multihost_max_abs_err": max(rk["chunked"]["kernel4"]["max_abs_err"]
                                     for rk in ranks),
        **{f"multihost_{k}": ranks[0]["chunked"]["kernel4"][k]
           for k in ("m", "n", "d", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms")}})
    log(f"phase 12 seconds: {time.perf_counter() - t_phase:.1f}")


def one_process_ref(dev, csr: CSRMatrix, layout: str, queries, fq) -> dict:
    """Phase 11a's reference for phase 12a, rebuilt alone: ``MeshEngine``
    over 4 shards of ``dev`` in one process, phase 8's build and schedule,
    the outputs, the streamed join's candidate lists, top-k and frozen
    match."""
    eng = MeshEngine(AllPairsConfig(shard_axis=layout,
                                    similarity_threshold=TAU),
                     mesh=make_mesh(4, devices=[dev] * 4))
    eng.build(csr_rows(csr, 0, STREAM_BUILD))
    eng.all_pairs(TAU)
    ref = {"outputs": []}
    stream_rows(eng, csr, STREAM_BUILD, [1] * 16 + [32] * 16,
                outputs=ref["outputs"])
    _, ref["cand"] = join_with_candidates(eng, "_finalize_pairs")
    ref["topk"] = eng.topk(queries, 10)
    ref["frozen"] = frozen_output(eng, fq)
    return ref


def multihost_main(world: int, backend: str) -> int:
    """``--multihost WORLD BACKEND``: phase 12 alone, its WORLD ranks one a
    card, and what it is compared with, rebuilt on the first card: phase
    11a's one-process meshes (rows and dims), the fp64 oracles of phases 3
    and 5 and phase 5's single-device candidate set.  The same last
    lines as the whole script."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < world:
        raise AssertionError(f"--multihost {world} needs {world} cards, "
                             f"have {torch.cuda.device_count()}")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    log(f"cards: {smi}")
    _build.kernels()
    big_csr = synthetic_corpus(32768, seed=0)
    want32 = oracle_pairs(big_csr, TAU, dev)
    queries, fq = query_lists(big_csr)
    refs = {layout: one_process_ref(dev, big_csr, layout, queries, fq)
            for layout in ("rows", "dims")}
    ooc_csr = synthetic_corpus(OOC_ROWS, seed=0)
    want = oracle_pairs(ooc_csr, TAU, dev)
    eng = ChunkedAllPairs(AllPairsConfig(), dev)
    eng.build(ooc_csr)
    cand100k = pair_set(eng._all_pairs_panel(eng._tau_eff(TAU)))
    del eng
    torch.cuda.empty_cache()
    log(f"phase 12 references: {time.perf_counter() - t_start:.1f} s")
    kernels = [{"name": n} for n in REPLACES]
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        multihost_phase(dev, work, big_csr, want32, refs, ooc_csr, want,
                        cand100k, kernels, smi,
                        {"world": world, "cards": world, "backend": backend})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"chip_smoke seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# ------------------------ phase 13: the benchmark suite and the stage probes
SUITE_ROWS = 8586
SUITE_TAUS = (0.5, 0.8)  # the five-tau suite runs through ``cli bench-suite``
JOIN_PROBE_ROWS = (8586, 32768)
INSERT_PROBE_ROWS = 20_000
SERVE_SECONDS = 10


def counted(label: str, fn, need=(), phase: int = 13):
    """``fn()`` between zeroed launch counters; every kernel of ``need``
    must have launched.  Returns ``(result, launches)``."""
    zero_launches()
    out = fn()
    got = dict(ts.LAUNCHES)
    log(f"phase {phase} {label} kernel launches: {got}")
    for k in need:
        if got[k] < 1:
            raise AssertionError(f"phase {phase} {label}: {k} was not "
                                 f"launched")
    return out, got


def bench_phase(dev, kernels: list, n_ooc_pairs: int) -> None:
    """Phase 13: the benchmark suite and the stage probes through their
    entry points, each between zeroed launch counters; ``n_ooc_pairs`` is
    phase 5's pair count on the 100,000 rows."""
    t_phase = time.perf_counter()
    csr = synthetic_corpus(SUITE_ROWS, seed=0)
    ids = [str(i) for i in range(csr.n_rows)]
    t0 = time.perf_counter()
    report, got = counted("suite", lambda: suite.run_suite(
        csr, ids, taus=SUITE_TAUS, stream_batch=256, topk_queries=1024,
        device=dev), need=("score_bits_int8", "panel_score_bits_int8"))
    log(f"phase 13 suite ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(report)}")
    bad = suite.failures(report)
    flags = [e.get("parity_full") for e in report["threshold_sweep"].values()]
    if bad or flags != [True] * len(SUITE_TAUS) or "mesh" not in report:
        raise AssertionError(f"phase 13 suite: {bad or report}")
    launches = {"suite": got}

    sc, launches["run_scale"] = counted("run_scale", lambda: scale.run_scale(
        (SUITE_ROWS,), device=dev), need=("score_bits_int8",))
    log(f"phase 13 run_scale: {json.dumps(sc)}")
    if sc[str(SUITE_ROWS)]["pairs"] != report["threshold_sweep"]["0.8"][
            "pairs"]:
        raise AssertionError("phase 13 run_scale: its pairs differ from the "
                             "suite's parity-checked join")

    def join_probes():
        out = {}
        for n in JOIN_PROBE_ROWS:
            out[n] = join_probe.probe_size(synthetic_corpus(n), device=dev,
                                           check_plain=n == JOIN_PROBE_ROWS[0])
            log(f"phase 13 join_probe {n}: {json.dumps(out[n])}")
        return out

    jp, got = counted("join_probe", join_probes, need=("score_bits_int8",))
    # per size: 2 warm joins, 5 kernel-only, 5 extract, 5 timed joins
    if got["score_bits_int8"] != 17 * len(JOIN_PROBE_ROWS):
        raise AssertionError(f"phase 13 join_probe launches: {got}")
    if jp[JOIN_PROBE_ROWS[0]].get("kernel_equals_plain") is not True:
        raise AssertionError("phase 13 join_probe: kernel 1 differs from "
                             "its plain version at the probe's operands")
    launches["join_probe"] = got

    ins, launches["insert_probe"] = counted(
        "insert_probe", lambda: insert_probe.main(
            [str(INSERT_PROBE_ROWS), "--stages"]))
    log(f"phase 13 insert_probe: {json.dumps(ins)}")

    pan, got = counted("panel_probe", lambda: panel_probe.main(
        [str(OOC_ROWS), "--joins-only"]), need=("panel_score_bits_int8",))
    n_pan = pan["geom"]["n_panels"]
    if (not pan["pairs_agree"]
            or pan["joins"]["default"]["pairs"] != n_ooc_pairs
            or got["panel_score_bits_int8"] != n_pan * (n_pan + 1)):
        raise AssertionError(f"phase 13 panel_probe: {pan}, launches {got}")
    launches["panel_probe"] = got

    srv, launches["serve_probe"] = counted(
        "serve_probe", lambda: serve_probe.main(
            [str(OOC_ROWS), "--rates", "1000", "--duration",
             str(SERVE_SECONDS)]))
    (ph,) = srv["phases"]
    log(f"phase 13 serve_probe: {json.dumps(dict(ph, flush_timeline=None))}")
    if ph["indexed"] != ph["offered_vectors"]:
        raise AssertionError(f"phase 13 serve_probe indexed {ph['indexed']} "
                             f"of {ph['offered_vectors']}")
    for k in kernels:
        k["bench_launches"] = {leg: n[k["name"]]
                               for leg, n in launches.items()}
    log(f"phase 13 seconds: {time.perf_counter() - t_phase:.1f}")


# ------------------------------------ phase 14: bench_torch.py's cells
BENCH_TORCH_CELLS = ((bench_torch.HEADLINE, ("score_bits_int8",)),
                     ("dense_insert_bs32", ()))
BENCH_TORCH_REPEATS = 3


def bench_torch_phase(dev, kernels: list) -> None:
    """Phase 14: ``bench_torch.run_cell`` for the headline join cell and
    the insert cell, each between zeroed launch counters."""
    t_phase = time.perf_counter()
    launches = {}
    for name, need in BENCH_TORCH_CELLS:
        (rec, _, _), got = counted(
            f"bench_torch {name}", lambda name=name: bench_torch.run_cell(
                name, dev, repeats=BENCH_TORCH_REPEATS, window=0),
            need=need, phase=14)
        log(f"phase 14 bench_torch {name}: {json.dumps(rec)}")
        insert = bench_torch.CELLS[name]["kind"] == "insert"
        metrics = (("insert_vectors_per_sec", "insert_p95_ms") if insert
                   else ("decided_pairs_per_sec", "seconds_median"))
        if not rec["parity"] or not all(rec[m] > 0 for m in metrics):
            raise AssertionError(f"phase 14 bench_torch {name}: {rec}")
        if insert and any(got.values()):
            raise AssertionError(f"phase 14 bench_torch {name} launched a "
                                 f"join kernel: {got}")
        launches[name] = got
    for k in kernels:
        k["bench_torch_launches"] = {cell: n[k["name"]]
                                     for cell, n in launches.items()}
    log(f"phase 14 seconds: {time.perf_counter() - t_phase:.1f}")


# ----------------------------- phase 15: the deploy scripts, on the card
DEPLOY_DOCS = 8_586  # Enron's row count
DEPLOY_BENCH = ["--total-message-count", "100", "--children-num", "4",
                "--write-batching-ms", "5"]
SBIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sbin_torch")


def sbin(name: str, args, env: dict, cwd: str, check: bool = True):
    """``sbin_torch/<name> args`` run as an operator runs it (from ``cwd``,
    outside the checkout); returns ``(process, seconds)``."""
    t0 = time.perf_counter()
    proc = subprocess.run([os.path.join(SBIN, name)] + list(args), cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    log(f"phase 15 {name} {args[0] if args else ''} -> {proc.returncode}: "
        f"{proc.stdout.strip()[-300:]} {proc.stderr.strip()[-1500:]}")
    if check and proc.returncode != 0:
        raise AssertionError(f"{name} {' '.join(args)} exited "
                             f"{proc.returncode}")
    return proc, time.perf_counter() - t0


def pid_alive(pid: int) -> bool:
    """True while ``pid`` runs; a zombie counts as gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            state = next(ln for ln in f if ln.startswith("State:"))
    except FileNotFoundError:
        return False
    return state.split()[1] != "Z"


def gpu_pids() -> list:
    """The PIDs ``nvidia-smi`` lists as compute processes on the cards, one
    a process (repeats kept)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return sorted(int(w) for w in out.stdout.split())


def card_files(pid: int) -> set:
    """The NVIDIA device files process ``pid`` holds open.  Where the
    driver cannot map a process into this PID namespace, ``nvidia-smi``
    lists every process on the card under one foreign PID (1 in the chip
    tool's sandbox); the open device files still name the process."""
    fds, out = f"/proc/{pid}/fd", set()
    for fd in os.listdir(fds):
        try:
            target = os.readlink(os.path.join(fds, fd))
        except OSError:  # closed meanwhile
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return out


def compact_columns(csr: CSRMatrix) -> CSRMatrix:
    """``csr`` with its used columns renumbered 0..k-1 (every dot product
    unchanged), so a dense fp64 oracle is k wide, not 2^20."""
    cols, idx = np.unique(csr.indices, return_inverse=True)
    return CSRMatrix(csr.n_rows, len(cols), csr.indptr,
                     idx.astype(csr.indices.dtype), csr.data)


def deploy_phase(dev, kernels: list) -> None:
    """Phase 15: ``sbin_torch/`` drives the daemon on the card.  ``etl`` of
    a seeded 8,586-document text corpus (the command the preprocess
    container runs); ``start-all.sh`` with no hosts file starts the local
    daemon, returning once it serves; a client bulk-loads the table, and
    the ``all_pairs`` RPC equals the fp64 oracle, with kernel 1 launched
    in the daemon (its counts read over the ``stats`` RPC just before and
    just after, and its ``kernel`` section), the card's device files open
    in the daemon and ``nvidia-smi`` listing compute processes;
    ``start-test.sh`` runs the load generator; a second start on the held
    port fails and leaves no PID file; ``stop-all.sh`` stops the daemon
    with SIGINT, and the checkpoint it writes on the way out loads with
    every row."""
    from apsim_tpu_torch.etl.store import VectorStore
    from apsim_tpu_torch.serve import ClientConnection

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    docs, store = os.path.join(work, "docs"), os.path.join(work, "store")
    ck, no_hosts = os.path.join(work, "ckpt"), os.path.join(work, "servers")
    env = dict(os.environ, APSIM_PYTHON=sys.executable,
               APSIM_PID_DIR=os.path.join(work, "pid"),
               APSIM_LOG_DIR=os.path.join(work, "logs"))
    pid_file = os.path.join(env["APSIM_PID_DIR"], "apsim-torch-server.pid")
    rec, pid = {}, None
    try:
        text_corpus(docs, DEPLOY_DOCS)
        _, rec["etl_seconds"] = cli(["etl", docs, "--store", store,
                                     "--table", "T"])
        csr, ids = VectorStore(store).read("T")
        if csr.n_rows != DEPLOY_DOCS:
            raise AssertionError(f"etl wrote {csr.n_rows} rows")
        port = free_port()
        addr = f"127.0.0.1:{port}"
        serve_args = ["--device", dev.type, "--port", str(port), "--store",
                      store, "--table", "T", "--checkpoint-dir", ck]
        _, rec["start_seconds"] = sbin("start-all.sh",
                                       [no_hosts] + serve_args, env, work)
        with open(pid_file) as f:
            pid = int(f.read())
        if not pid_alive(pid):
            raise AssertionError(f"start-all.sh returned, daemon {pid} gone")
        cc = ClientConnection([addr])
        try:
            t0 = time.perf_counter()
            cc.load_data("T", 0, csr.n_rows - 1)
            wait_for(lambda: cc.stats()["n_rows"] == csr.n_rows, 300,
                     f"the daemon to index {csr.n_rows} rows")
            rec["load_seconds"] = time.perf_counter() - t0
            before = cc.stats()
            t0 = time.perf_counter()
            pairs = cc.all_pairs(TAU)
            rec["join_rpc_seconds"] = time.perf_counter() - t0
            after = cc.stats()
        finally:
            cc.close()
        launches = {k: after["launches"][k] - before["launches"][k]
                    for k in after["launches"]}
        log(f"phase 15 kernel launches in the daemon on the all_pairs RPC: "
            f"{launches}; its kernel section "
            f"{json.dumps(after['timings'].get('kernel'))}")
        if (launches["score_bits_int8"] < 1
                or launches != with_compactions(
                    {k: 0 for k in launches}
                    | {"score_bits_int8": launches["score_bits_int8"]})
                or "kernel" not in after["timings"]):
            raise AssertionError(f"phase 15 join: launches {launches}, "
                                 f"timings {after['timings']}")
        row = {v: i for i, v in enumerate(ids)}
        got = {(min(row[a], row[b]), max(row[a], row[b]))
               for a, b, _ in pairs}
        want = batch_oracle([], compact_columns(csr), 0, TAU, dev)
        if got != want or not want:
            raise AssertionError(f"phase 15 all_pairs RPC: {len(got)} "
                                 f"pairs, fp64 oracle {len(want)}")
        apps, held = gpu_pids(), card_files(pid)
        if not apps or "/dev/nvidiactl" not in held or not any(
                re.fullmatch(r"/dev/nvidia\d+", f) for f in held):
            raise AssertionError(f"the daemon {pid} holds {sorted(held)}; "
                                 f"nvidia-smi lists {apps}")
        log(f"phase 15 all_pairs RPC over {csr.n_rows} rows: {len(got)} "
            f"pairs equal the fp64 oracle; the daemon {pid} holds "
            f"{sorted(held)} open, nvidia-smi lists compute processes "
            f"{apps}")
        proc, rec["loadgen_seconds"] = sbin(
            "start-test.sh", [addr, "--store", store, "--table", "T"]
            + DEPLOY_BENCH, env, work)
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        if rep.get("messages") != 400:
            raise AssertionError(f"start-test.sh: {rep}")
        rec["loadgen"] = rep
        log(f"phase 15 load generator through the daemon, insert -> first "
            f"result: {json.dumps(rep)}")
        cc = ClientConnection([addr])
        try:
            served = cc.stats()["n_rows"]
        finally:
            cc.close()
        if served != 2 * csr.n_rows:  # the table, then its warm-up copy
            raise AssertionError(f"the daemon holds {served} rows")
        env2 = dict(env, APSIM_PID_DIR=os.path.join(work, "pid2"),
                    APSIM_LOG_DIR=os.path.join(work, "logs2"))
        proc, _ = sbin("daemon.sh", ["start"] + serve_args, env2, work,
                       check=False)
        if proc.returncode == 0 or os.listdir(env2["APSIM_PID_DIR"]):
            raise AssertionError("a second start on the held port: exit "
                                 f"{proc.returncode}, PID dir "
                                 f"{os.listdir(env2['APSIM_PID_DIR'])}")
        if not pid_alive(pid):
            raise AssertionError("the failed start took the daemon down")
        _, rec["stop_seconds"] = sbin("stop-all.sh", [no_hosts], env, work)
        if pid_alive(pid) or os.path.exists(pid_file):
            raise AssertionError(f"daemon {pid} after stop-all.sh: alive "
                                 f"{pid_alive(pid)}")
        proc, _ = sbin("daemon.sh", ["status"], env, work)
        if proc.stdout.strip() != "stopped":
            raise AssertionError(f"status after the stop: {proc.stdout}")
        back = Engine.load(ck, device=dev)
        if back.n_rows != served:
            raise AssertionError(f"the SIGINT checkpoint: {back.n_rows} "
                                 f"rows, served {served}")
        del back
        log(f"phase 15 daemon stopped by SIGINT; its checkpoint loads with "
            f"{served} rows; timings {json.dumps(rec)}")
    finally:
        if pid is not None and pid_alive(pid):
            os.kill(pid, signal.SIGKILL)
        shutil.rmtree(work, ignore_errors=True)
    for k in kernels:
        k["deploy_launches"] = launches[k["name"]]
    log(f"phase 15 seconds: {time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------- phase 16: the studies
TRI_SHAPE = (8192, 16384)  # tri_probe's row_cap x dim_cap (its default)
MESH_TRI_ROWS = 8192
STUDY_SHARDS = 4
ELL_ROWS, ELL_K, ELL_BS, ELL_TAU = 98_304, 192, 256, 0.8
ELL_REF_BLOCK = 2048  # rows a block of the fp64 reference


def ell_fp64(idx, val, qd):
    """fp64 scores ``[rows, bs]`` of the ELL contraction of the same bf16
    operands on the card, and the sums of their terms' magnitudes."""
    v64, q64 = val.double(), qd.double()
    s, a = [], []
    for i in range(0, idx.shape[0], ELL_REF_BLOCK):
        g = q64.index_select(0, idx[i:i + ELL_REF_BLOCK].reshape(-1)).view(
            -1, idx.shape[1], qd.shape[1])
        v = v64[i:i + ELL_REF_BLOCK, None, :]
        s.append(torch.bmm(v, g)[:, 0])
        a.append(torch.bmm(v.abs(), g.abs())[:, 0])
        del g
    return torch.cat(s), torch.cat(a)


def ell_gate(label: str, counts, s64, a64, block: int) -> int:
    """Each block's count of fp32 scores >= ``ELL_TAU`` must lie between
    the fp64 counts of the cells at or above ``ELL_TAU + b`` and at or
    above ``ELL_TAU - b``, ``b = (K + 2) * 2^-23 * sum |terms|`` a cell: an
    fp32 sum of K exact bf16 products errs by at most ``(K - 1) * 2^-24 *
    sum |terms|`` rounding to nearest, twice that with the tensor cores'
    truncating adds.  Returns the cells within ``b`` of tau (the only
    cells whose side may differ)."""
    b = (ELL_K + 2) * 2.0 ** -23 * a64
    shape = (-1, block * s64.shape[1])
    sure = (s64 >= ELL_TAU + b).view(shape).sum(1)
    maybe = (s64 >= ELL_TAU - b).view(shape).sum(1)
    counts = counts.to(sure.device).long().view(-1)
    bad = (counts < sure) | (counts > maybe)
    if bool(bad.any()):
        raise AssertionError(
            f"phase 16 {label}: counts {counts[bad].tolist()} outside the "
            f"fp64 bracket [{sure[bad].tolist()}, {maybe[bad].tolist()}]")
    return int((maybe - sure).sum())


def ell_phase(dev, csr: CSRMatrix) -> dict:
    """``ell_probe``'s functions on the first ``ELL_ROWS`` rows of
    ``csr``: both formulations timed and held against the fp64
    contraction of the same operands."""
    ccsr, n_dims = ell_probe.compact_dims(csr_rows(csr, 0, ELL_ROWS))
    idx_h, val_h, spilled = ell_probe.to_ell(ccsr, ELL_ROWS, ELL_K, n_dims)
    idx = torch.from_numpy(idx_h).to(dev)
    val = torch.from_numpy(val_h).to(dev, torch.bfloat16)
    qd = torch.from_numpy(ell_probe.query_dense(ccsr, ELL_BS, n_dims)).to(
        dev, torch.bfloat16)
    nnz = int(ccsr.indices.size)
    rec = {"n_rows": ELL_ROWS, "K": ELL_K, "bs": ELL_BS, "nnz": nnz,
           "compact_dims": n_dims, "spilled": int(spilled),
           "gather_floor_ms": (nnz - spilled) * ELL_BS * 2 / HBM_BYTES_PER_S
           * 1e3}
    s64, a64 = ell_fp64(idx, val, qd)
    rec["fp64_hits"] = int((s64 >= ELL_TAU).sum())
    for block in ell_probe.BLOCKS:
        if ELL_ROWS % block:  # the study's rule: such a block is skipped
            continue
        counts = ell_probe.ell_match_blocked(idx, val, qd, block, ELL_TAU)
        rec[f"blocked_{block}_near_cells"] = ell_gate(
            f"ell blocked[{block}]", counts, s64, a64, block)
        rec[f"blocked_{block}_hits"] = int(counts.sum())
        rec[f"blocked_{block}_ms"] = tri_probe.timed_s(
            lambda: ell_probe.ell_match_blocked(idx, val, qd, block,
                                                ELL_TAU), dev) * 1e3
    count = ell_probe.ell_match_scan(idx, val, qd, ELL_TAU)
    rec["scan_near_cells"] = ell_gate("ell scan", count, s64, a64, ELL_ROWS)
    rec["scan_hits"] = int(count)
    rec["scan_ms"] = tri_probe.timed_s(
        lambda: ell_probe.ell_match_scan(idx, val, qd, ELL_TAU), dev) * 1e3
    if rec["fp64_hits"] < ELL_BS // 2:
        raise AssertionError(f"phase 16 ell: only {rec['fp64_hits']} fp64 "
                             f"hits; the gate would check little")
    return rec


def study_phase(dev, kernels: list, ooc_csr: CSRMatrix) -> None:
    """Phase 16: the schedule and slab studies (``bench/tri_probe.py``,
    ``mesh_tri_probe.py``, ``ell_probe.py``) between zeroed launch
    counters, none of the four kernels launching: ``tri_probe`` at its
    default size on one device and over a dims mesh of 4 shards of the
    card (its parity leg holds), ``mesh_tri_probe`` at 8,192 rows over 4
    shards (the rectangle's candidates folded equal the triangle's, and
    the dispatch counter's flops per device equal the closed form), and
    ``ell_probe``'s two formulations on phase 5's first 98,304 rows, K
    192, bs 256, each count inside the fp64 bracket of ``ell_gate``."""
    t_phase = time.perf_counter()
    zero_launches()
    args = [str(n) for n in TRI_SHAPE]
    for extra in ([], ["--shards", str(STUDY_SHARDS)]):
        rep = tri_probe.main(args + extra)
        if not rep["parity"]["equal"] or rep["n_devices"] != (
                STUDY_SHARDS if extra else 1):
            raise AssertionError(f"phase 16 tri_probe {extra}: {rep}")
        log(f"phase 16 tri_probe {' '.join(args + extra)}: "
            f"{json.dumps(rep)}")
        torch.cuda.empty_cache()

    rep = mesh_tri_probe.main([str(MESH_TRI_ROWS), "--shards",
                               str(STUDY_SHARDS)])
    log(f"phase 16 mesh_tri_probe: {json.dumps(rep)}")
    row_cap, tile, dim_cap = rep["row_cap"], rep["tile"], rep["dim_cap"]
    want = {"upper": rect_flops(row_cap, tile, dim_cap) // STUDY_SHARDS,
            "all": 2 * row_cap * row_cap * dim_cap // STUDY_SHARDS}
    got = {m: rep[m]["flops"] for m in want}
    if not rep["folded_all_equals_upper"] or got != want:
        raise AssertionError(f"phase 16 mesh_tri_probe: folded equal "
                             f"{rep['folded_all_equals_upper']}, flops per "
                             f"device {got}, closed form {want}")
    torch.cuda.empty_cache()

    rec = ell_phase(dev, ooc_csr)
    log(f"phase 16 ell_probe: {json.dumps(rec)}")
    got = dict(ts.LAUNCHES)
    log(f"phase 16 kernel launches: {got}")
    if any(got.values()):
        raise AssertionError(f"phase 16: a kernel launched in the studies: "
                             f"{got}")
    for k in kernels:
        k["study_launches"] = got[k["name"]]
    torch.cuda.empty_cache()
    log(f"phase 16 seconds: {time.perf_counter() - t_phase:.1f}")


# -------------- phase 17: the one-process meshes over distinct cards
CARDS_ROWS = 32_768  # 17a's and 17d's corpus: phase 3's
SCALE_ROWS = 500_000  # 17c: the size of panel_probe's single-card run
SCALE_GEN = (  # 17c's corpus, made in a process of its own meanwhile
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import chip_smoke as cs\n"
    "cs.save_csr(sys.argv[2], cs.synthetic_corpus(int(sys.argv[3]), "
    "seed=0))\n"
)


def equal_bits(a, b) -> bool:
    """``a`` and ``b`` equal bit for bit: arrays by dtype, shape and bytes,
    floats by their 64 bits (-0.0 is not 0.0), containers item by item."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, float) or isinstance(b, float):
        return (isinstance(a, float) and isinstance(b, float)
                and np.float64(a).tobytes() == np.float64(b).tobytes())
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(equal_bits(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(equal_bits(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


def same_as_card0(got: dict, ref: dict, keys, label: str) -> None:
    """Each of ``keys`` of the mesh over the cards equals the same mesh's
    on card 0, bit for bit."""
    for k in keys:
        if not equal_bits(got[k], ref[k]):
            raise AssertionError(f"{label}: {k} differs from the same mesh "
                                 f"on card 0")
    log(f"{label}: {', '.join(keys)} equal the same mesh on card 0, bit "
        f"for bit")


def card_topology(n: int) -> dict:
    """``nvidia-smi topo -m`` (printed) and, for each ordered pair of
    cards, whether PyTorch may copy between them peer to peer (else its
    copies go through the host)."""
    out = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                         text=True, timeout=60)
    log(f"nvidia-smi topo -m:\n{out.stdout.rstrip()}")
    peer = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
            for a in range(n) for b in range(n) if a != b}
    log(f"can_device_access_peer: {json.dumps(peer)}")
    return peer


def card_kernels(cards, smi: str) -> list:
    """Kernels 1 and 2 against their plain versions on every card (phase
    2's 4,096-row index with padding rows, built on that card, tiles
    (1024, 512), timed): each card builds and launches them.  Returns the
    kernel records of the mode, kernels 1 and 2 filled from card 0."""
    kernels = [{"name": n, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[n], "launches": 0, "library_ms": None}
               for n in REPLACES]
    per = {"score_bits_int8": [], "score_bits_bf16": []}
    for card in cards:
        small = Engine(AllPairsConfig(row_bucket=5120), card)
        small.build(synthetic_corpus(4096))
        tau_eff = small._tau_eff(TAU)
        q8 = ts.quantize_rows(small.x)
        xb = small.x.to(torch.bfloat16)
        bi, bj = blocks(small.row_cap, 1024, 512, card)
        for name, kind, ops in (("score_bits_int8", "int8", q8),
                                ("score_bits_bf16", "bf16", xb)):
            with torch.cuda.device(card):
                rec = compare(kind, ops, bi, bj, tau_eff, 1024, 512,
                              timed=True)
            opl = ops if kind == "int8" else (ops,)
            rec.update(score_bound(
                opl[:1], opl[1].numel() * 4 if kind == "int8" else 0, bi,
                bj, 1024, 512, (0, 0),
                PEAK_INT8 if kind == "int8" else PEAK_BF16))
            per[name].append({"card": card.index, **rec})
        del small, q8, xb
    for k in kernels[:2]:
        recs = per[k["name"]]
        k.update({"max_abs_err": max(r["max_abs_err"] for r in recs),
                  **{f: recs[0][f] for f in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")},
                  "per_card": [{f: r[f] for f in (
                      "card", "max_abs_err", "ms", "plain_ms")}
                      for r in recs]})
    log(f"phase 17 kernels 1 and 2 vs plain on each card ({smi}): "
        f"{json.dumps(per)}")
    return kernels


def join_wall(eng, reps: int = 5) -> tuple:
    """``reps`` warm joins at TAU (after one more): the median host-clock
    ms (each join ends with its pairs on the host) and the stage split
    per join; and the last result."""
    eng.all_pairs(TAU)
    before = dict(eng.timer.totals)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = eng.all_pairs(TAU)
        times.append((time.perf_counter() - t0) * 1e3)
    stages = {k: (v - before.get(k, 0.0)) / reps * 1e3
              for k, v in eng.timer.totals.items()
              if k != "all_pairs" and v != before.get(k, 0.0)}
    return {"join_ms": float(np.median(times)),
            "join_stages_ms": stages}, res


def mesh_dims_step(eng: MeshEngine, csr: CSRMatrix, dev,
                   label: str) -> dict:
    """Column growth and dormant activation on a streamed mesh: phase 8's
    64 shifted rows (``dim_cap`` grows: every block widens on its card,
    and a dims layout relays columns between cards), then 8 copies of
    them (their archived singleton dims activate, without growth).  The
    shifted rows share no dim with the index, so the outputs must equal
    the fp64 pairs among the 72 new rows."""
    vecs = shifted_rows(csr)
    vecs = vecs + vecs[:8]
    n0 = eng.n_rows
    ids = [str(n0 + k) for k in range(72)]
    cap0, dorm0 = eng.dim_cap, eng.stats["dormant_dims"]
    out1 = eng.insert(list(zip(ids[:64], vecs[:64])), tau=TAU).output
    cap1, dorm1 = eng.dim_cap, eng.stats["dormant_dims"]
    out2 = eng.insert(list(zip(ids[64:], vecs[64:])), tau=TAU).output
    dorm2 = eng.stats["dormant_dims"]
    if not (cap1 > cap0 and dorm1 > dorm0 and eng.dim_cap == cap1
            and dorm2 < dorm1):
        raise AssertionError(f"{label} new dims: dim_cap {cap0} -> {cap1} "
                             f"-> {eng.dim_cap}, dormant dims {dorm0} -> "
                             f"{dorm1} -> {dorm2}")
    q = dense_rows(CSRMatrix.from_vectors(vecs, csr.n_cols), 0, 72, 65536,
                   dev)
    ii, jj = torch.nonzero(torch.triu(q @ q.T >= TAU, diagonal=1),
                           as_tuple=True)
    want_new = {(n0 + i, n0 + j) for i, j in zip(ii.tolist(), jj.tolist())}
    got = {(min(int(a), int(c)), max(int(a), int(c)))
           for out in (out1, out2) for a, cs_ in out.items() for c in cs_}
    if got != want_new or not want_new:
        raise AssertionError(f"{label} new dims: {len(got ^ want_new)} pairs "
                             f"off the fp64 oracle")
    check_placement(eng.x_blocks, eng.mesh.devices, label)
    log(f"{label} new dims: dim_cap {cap0} -> {cap1}, dormant dims {dorm0} "
        f"-> {dorm1} -> {dorm2}; {len(got)} new pairs equal the fp64 oracle")
    return {"dims_outputs": [out1, out2], "new_pairs": want_new,
            "dims_caps": [cap0, cap1], "dormant": [dorm0, dorm1, dorm2]}


def index_by_id(eng: MeshEngine, dev) -> torch.Tensor:
    """A mesh's live rows assembled from its blocks on ``dev``, in the
    order of their sorted ids: two meshes that took the same rows in
    another order (the server's concurrent clients) give one tensor."""
    nr, nd = eng.grid
    x = torch.cat([torch.cat([eng.x_blocks[r * nd + d].to(dev)
                              for d in range(nd)], dim=1)
                   for r in range(nr)])
    order = np.argsort(np.array(eng.ids), kind="stable")
    return x[:eng.n_rows][torch.from_numpy(order).to(dev)]


def cards_dense(cards, csr: CSRMatrix, want32: set, qsets, kernels: list,
                smi: str) -> dict:
    """Phase 17a: ``MeshEngine`` in phase 11a's three layouts, first with
    the 4 shards on card 0, then one shard a card (``mesh_dense_stream``:
    build, join, stream with growth, the streamed join with kernel 3 once
    a card and bit for bit against its plain version on each card, top-k,
    frozen matching, the rows layout served in-process, the timings), then
    the warm join's wall time, the new dims and the join of the grown
    index.  Every output, candidate list, top-k list, frozen match and
    block over the cards equals the same mesh's on card 0, bit for bit
    (the rows the server's two clients raced in are compared by id: their
    order in the index differs from run to run); each pair set equals the
    fp64 oracle.  Returns each layout's timings
    and per-card peak memory, on card 0 and over the cards."""
    n = len(cards)
    keys = ("join", "outputs", "cand", "topk", "frozen", "dims_outputs",
            "join_grown")
    out = {}
    for layout, shape, axis in MESH_LAYOUTS:
        refs = {}
        for where_, devs in (("card0", [cards[0]] * n), ("cards", cards)):
            label = f"phase 17a {layout} mesh, {where(devs)}"
            torch.cuda.empty_cache()
            reset_peaks(cards)
            ref = mesh_dense_stream(
                devs, csr, want32, None, qsets, kernels, smi, layout, shape,
                axis, phase="17a",
                shards=tuple(range(n)) if where_ == "cards" else (0,),
                tag=f"mesh_{where_}", keep=True)
            eng = ref.pop("eng")
            wall, res0 = join_wall(eng)
            ref.update(mesh_dims_step(eng, csr, cards[0], label))
            res = eng.all_pairs(TAU)
            ref["join_grown"] = sorted((min(a, b), max(a, b), v)
                                       for a, b, v in res.id_pairs())
            if (set(zip(res.i.tolist(), res.j.tolist()))
                    != set(zip(res0.i.tolist(), res0.j.tolist()))
                    | ref["new_pairs"]):
                raise AssertionError(f"{label}: the grown index's join is "
                                     f"not the old pairs with the new")
            ref["timings"].update(wall, max_memory_allocated_per_card=peaks(
                cards))
            log(f"{label} join wall and memory: {json.dumps(wall)}; peaks "
                f"{ref['timings']['max_memory_allocated_per_card']}")
            x = index_by_id(eng, cards[0])
            if where_ == "card0":
                ref["x"] = x
            else:
                if not torch.equal(x, refs["card0"]["x"]):
                    raise AssertionError(f"{label}: the index differs from "
                                         f"card 0's")
                log(f"{label}: every block, assembled by row id, equals "
                    f"card 0's bit for bit ({eng.n_rows} rows)")
                del refs["card0"]["x"]
            del x
            del eng, res, res0
            refs[where_] = ref
        same_as_card0(refs["cards"], refs["card0"], keys,
                      f"phase 17a {layout} mesh over {n} cards")
        out[layout] = {w: refs[w]["timings"] for w in refs}
    return out


def cards_chunked(cards, csr: CSRMatrix, want: set, qsets, kernels: list,
                  smi: str) -> dict:
    """Phase 17b: ``MeshChunkedAllPairs`` over 4 shards on card 0, then
    one shard a card (``mesh_chunked_stream``: build, join, stream on the
    rebuild route, the streamed join with kernel 4 once a shard a panel
    pair and exactly its plain version on each card, top-k, frozen
    matching, a per-chunk capacity growth on every shard, its join, the
    timings), then the warm join's wall time.  Everything over the cards
    equals the same mesh's on card 0, bit for bit; each pair set equals
    the fp64 oracle."""
    n = len(cards)
    keys = ("join", "outputs", "cand", "topk", "frozen", "grown",
            "join_grown")
    refs = {}
    for where_, devs in (("card0", [cards[0]] * n), ("cards", cards)):
        torch.cuda.empty_cache()
        reset_peaks(cards)
        ref = mesh_chunked_stream(
            devs, csr, want, qsets, kernels, smi, n=n, phase="17b",
            shards=tuple(range(n)) if where_ == "cards" else (0,),
            tag=f"mesh_{where_}", keep=True)
        eng = ref.pop("eng")
        wall, _ = join_wall(eng)
        ref["timings"].update(wall, max_memory_allocated_per_card=peaks(
            cards))
        log(f"phase 17b chunked mesh, {where(devs)} join wall and memory: "
            f"{json.dumps(wall)}; peaks "
            f"{ref['timings']['max_memory_allocated_per_card']}")
        del eng
        refs[where_] = ref
    same_as_card0(refs["cards"], refs["card0"], keys,
                  f"phase 17b chunked mesh over {n} cards")
    return {w: refs[w]["timings"] for w in refs}


def cards_stripes(cards, csr: CSRMatrix, want: set, kernels: list,
                  smi: str) -> dict:
    """Phase 17b stripes: ``MeshChunkedAllPairs``' stripe joins on phase
    5's corpus, the bf16 stripes (``pallas_int8=False``) and the int8
    stripes (``use_pallas="off"``, ``_int8_stripes``), each with every
    shard on card 0, then one shard a card: two joins (the second timed,
    host clock, with its stage split), the launches by card (kernel 6, or
    kernels 4 and 5, each card once a stripe), the candidate lists
    (``_all_pairs_stripes``), the join's pairs and similarities over the
    cards bit for bit those on card 0, the pair set the fp64 oracle's;
    over the cards, kernel 6 (or 5) against its plain version on each
    card's row slice of the middle stripe.  Fills kernel 6's
    ``mesh_cards_*`` keys."""
    n = len(cards)
    out = {}
    k6_recs, k6_launches = None, 0
    for kind, cfg in (("bf16", AllPairsConfig(pallas_int8=False)),
                      ("int8", AllPairsConfig(use_pallas="off"))):
        int8 = kind == "int8"
        name = "pair_bits_int8" if int8 else "pair_bits_f32"
        refs = {}
        for where_, devs in (("card0", [cards[0]] * n), ("cards", cards)):
            label = f"phase 17b {kind} stripes, {where(devs)}"
            torch.cuda.empty_cache()
            reset_peaks(cards)
            eng = MeshChunkedAllPairs(cfg, mesh=make_mesh(n, devices=devs))
            eng._int8_stripes = int8
            eng.build(csr)
            eng.all_pairs(TAU)
            zero_launches()
            before = dict(eng.timer.totals)
            t0 = time.perf_counter()
            res = eng.all_pairs(TAU)
            secs = time.perf_counter() - t0
            st = eng._q_super()
            n_st = -(-eng.n_rows // st)
            by_card = {k: v for k, v in launches_by_card().items() if v}
            want_cards = {name: card_counts(list(dict.fromkeys(devs)), n_st)}
            if int8:
                want_cards["int8_matmul"] = card_counts(
                    devs, n_st * eng._n_chunks // n)
            if by_card != want_cards or (eng._int8_slabs() is None) == int8:
                raise AssertionError(f"{label}: launches by card {by_card}, "
                                     f"expected {want_cards}")
            timings = {
                "join_s": secs, "super_tile": st, "stripes": n_st,
                "stages_s": {k: v - before.get(k, 0.0)
                             for k, v in eng.timer.totals.items()
                             if k != "all_pairs" and v != before.get(k, 0.0)},
                "launches_by_card": by_card,
                "max_memory_allocated_per_card": peaks(cards)}
            check_parity(res, want, label)
            refs[where_] = {"join": (res.i, res.j, res.sims),
                            "cand": eng._all_pairs_stripes(eng._tau_eff(TAU)),
                            "timings": timings}
            log(f"{label}: {json.dumps(refs[where_]['timings'])}")
            if where_ == "cards":
                recs = compare_stripe(eng, n_st // 2 * st, label, int8)
                if not int8:
                    k6_recs, k6_launches = recs, by_card[name]
            del eng, res
        if (refs["card0"]["timings"]["super_tile"]
                != refs["cards"]["timings"]["super_tile"]):
            raise AssertionError(f"phase 17b {kind} stripes: the layouts "
                                 f"chose different stripe widths")
        same_as_card0(refs["cards"], refs["card0"], ("join", "cand"),
                      f"phase 17b {kind} stripes over {n} cards")
        out[kind] = {w: refs[w]["timings"] for w in refs}
    k6 = next(k for k in kernels if k["name"] == "pair_bits_f32")
    k6.update({"mesh_cards_join_launches": sum(k6_launches.values()),
               "mesh_cards_join_launches_by_card": k6_launches,
               **{f"mesh_cards_{k}": v for k, v in pair_bits_record(
                   k6_recs, 0, "pair_bits_f32").items()
                   if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "max_abs_err")},
               "mesh_cards_per_card": [
                   {k: r[k] for k in ("card", "rows", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms")}
                   for r in k6_recs]})
    return out


def cards_scale(cards, csr: CSRMatrix, kernels: list, smi: str) -> dict:
    """Phase 17c: ``MeshChunkedAllPairs`` joins the 500,000 rows twice with
    every shard on card 0, then twice with one shard a card; the two
    meshes' results must be equal bit for bit, and their pair set that of
    one-card ``ChunkedAllPairs`` on the same corpus (joined first).  Each
    leg's wall times (host clock, each join), the second join's stage
    split, the launches by card and each card's peak memory."""
    n = len(cards)
    rec = {"card": smi, "rows": csr.n_rows}
    res = {}
    for name, make in (
            ("one_card", lambda: ChunkedAllPairs(AllPairsConfig(),
                                                 cards[0])),
            ("card0", lambda: MeshChunkedAllPairs(
                AllPairsConfig(), mesh=make_mesh(n, devices=[cards[0]] * n))),
            ("cards", lambda: MeshChunkedAllPairs(
                AllPairsConfig(), mesh=make_mesh(n, devices=cards)))):
        torch.cuda.empty_cache()
        reset_peaks(cards)
        zero_launches()
        eng = make()
        t0 = time.perf_counter()
        eng.build(csr)
        r = {"build_s": time.perf_counter() - t0, "join_s": []}
        for _ in range(2):
            before = dict(eng.timer.totals)
            t0 = time.perf_counter()
            res[name] = eng.all_pairs(TAU)
            r["join_s"].append(time.perf_counter() - t0)
        r["stages_s"] = {k: v - before.get(k, 0.0)
                         for k, v in eng.timer.totals.items()
                         if k != "all_pairs" and v != before.get(k, 0.0)}
        geom = eng._panel_geom()
        pairs = geom[3] * (geom[3] + 1) // 2
        r.update(geom=list(geom), pairs=res[name].n_pairs,
                 launches=dict(ts.LAUNCHES), launches_by_card=(
                     launches_by_card()),
                 max_memory_allocated_per_card=peaks(cards))
        devs = [cards[0]] * n if name == "card0" else cards
        want_l = ({"panel_score_bits_int8": {cards[0].index: 2 * pairs}}
                  if name == "one_card" else
                  {"int8_matmul": card_counts(devs, 2 * pairs),
                   "pair_bits_int8": card_counts(
                       list(dict.fromkeys(devs)), 2 * pairs)})
        got_l = {k: v for k, v in r["launches_by_card"].items() if v}
        if got_l != want_l:
            raise AssertionError(f"phase 17c {name}: launches by card "
                                 f"{got_l}, expected {want_l}")
        rec[name] = r
        log(f"phase 17c {name}, {csr.n_rows} rows: {json.dumps(r)}")
        del eng
    if res["cards"].pair_set() != res["one_card"].pair_set() or not (
            res["cards"].n_pairs):
        raise AssertionError(
            f"phase 17c: the mesh over {n} cards found "
            f"{res['cards'].n_pairs} pairs, one card "
            f"{res['one_card'].n_pairs}; the sets differ")
    same_as_card0(
        {"join": tuple(getattr(res["cards"], a) for a in ("i", "j", "sims"))},
        {"join": tuple(getattr(res["card0"], a) for a in ("i", "j", "sims"))},
        ("join",), f"phase 17c mesh over {n} cards")
    k4 = next(k for k in kernels if k["name"] == "int8_matmul")
    k5 = next(k for k in kernels if k["name"] == "pair_bits_int8")
    for k in (k4, k5):
        k["scale_join_launches_by_card"] = rec["cards"][
            "launches_by_card"][k["name"]]
        k["launches"] += rec["cards"]["launches"][k["name"]]
    log(f"phase 17c: the {csr.n_rows}-row join over {n} cards equals "
        f"the same mesh on card 0 bit for bit and one-card "
        f"ChunkedAllPairs ({res['cards'].n_pairs} pairs); join seconds "
        f"{rec['cards']['join_s']} over the cards, {rec['card0']['join_s']} "
        f"with every shard on card 0, {rec['one_card']['join_s']} on one")
    return rec


def cards_serve(cards, work: str, csr: CSRMatrix, want32: set,
                kernels: list, smi: str) -> dict:
    """Phase 17d: ``python -m apsim_tpu_torch.cli serve --mesh
    --mesh-shape N`` (rows layout, its launch counts printed at exit) over
    the cards: a load RPC bulk-loads phase 3's rows from a store, the
    ``all_pairs`` RPC equals the fp64 oracle, two clients stream
    ``SERVE_ROWS`` fresh rows whose pushed outputs equal the fp64 oracle,
    SIGINT writes the final checkpoint (kernel 3 launched once a card).
    The checkpoint restores onto a mesh over the cards and onto a one-card
    ``Engine``, whose joins (kernel 3 once a card; kernel 1 on card 0,
    also bit for bit against its plain version at the restored operands)
    are equal, pairs and similarities."""
    from apsim_tpu_torch.etl.store import VectorStore
    from apsim_tpu_torch.serve import ClientConnection

    n = len(cards)
    dev = cards[0]
    ids = [str(i) for i in range(csr.n_rows)]
    store = os.path.join(work, "store17")
    VectorStore(store, run_mode="PRODUCT").write("P17", csr, ids)
    cfgfile = os.path.join(work, "p17d.json")
    with open(cfgfile, "w") as f:
        json.dump({"shard_axis": "rows", "similarity_threshold": TAU,
                   "io_trigger_period_ms": 5}, f)
    ck = os.path.join(work, "ck17")
    fresh = synthetic_corpus(SERVE_ROWS, seed=31)
    want_fresh = {(min(a, b), max(a, b)) for a, b in (
        (ids[a] if a < csr.n_rows else f"f{a - csr.n_rows}",
         ids[b] if b < csr.n_rows else f"f{b - csr.n_rows}")
        for a, b in batch_oracle([csr], fresh, csr.n_rows, TAU, dev))}
    cmd = [sys.executable, "-c", CLI_WRAP, "serve", "--mesh", "--mesh-shape",
           str(n), "--config", cfgfile, "--store", store, "--table", "P17",
           "--checkpoint-dir", ck, "--host", "127.0.0.1", "--port", "0",
           "--device", "cuda"]
    err_path = os.path.join(work, "serve17.err")
    rec = {"card": smi, "rows": csr.n_rows, "fresh_rows": SERVE_ROWS}
    here = os.path.dirname(os.path.abspath(__file__))
    with open(err_path, "w") as err:
        t0 = time.perf_counter()
        srv = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                               stderr=err, text=True)
        try:
            line = srv.stdout.readline()
            if not line.startswith("serving on "):
                raise AssertionError(f"phase 17d serve: {line!r}")
            rec["start_seconds"] = time.perf_counter() - t0
            addr = [line.split()[-1]]
            cc = ClientConnection(addr)
            t0 = time.perf_counter()
            cc.load_data("P17", 0, csr.n_rows - 1)
            cc.flush()
            rec["load_rpc_seconds"] = time.perf_counter() - t0
            if cc.stats()["n_rows"] != csr.n_rows:
                raise AssertionError(f"phase 17d load RPC: "
                                     f"{cc.stats()['n_rows']} rows")
            t0 = time.perf_counter()
            served = cc.all_pairs(TAU)
            rec["all_pairs_rpc_seconds"] = time.perf_counter() - t0
            got = {(int(a), int(b)) if int(a) < int(b) else (int(b), int(a))
                   for a, b, _ in served}
            if got != want32:
                raise AssertionError(f"phase 17d: the all_pairs RPC differs "
                                     f"from the fp64 oracle: "
                                     f"{len(got ^ want32)} pairs")
            rec.update(stream_two_clients(
                addr, fresh, want_fresh, lambda: cc.stats()["n_rows"],
                csr.n_rows + SERVE_ROWS, "phase 17d"))
            cc.close()
            t0 = time.perf_counter()
            srv.send_signal(signal.SIGINT)
            stdout, _ = srv.communicate(timeout=180)
            rec["sigint_to_exit_seconds"] = time.perf_counter() - t0
            if srv.returncode != 0:
                raise AssertionError(f"phase 17d serve exited "
                                     f"{srv.returncode}")
        finally:
            if srv.poll() is None:
                srv.kill()
                srv.wait()
    launched = [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines()
                if ln.startswith("LAUNCHES_BY_CARD ")]
    want_cards = json.loads(json.dumps(card_counts(cards)))
    if not launched or launched[-1]["panel_score_bits_int8"] != want_cards:
        with open(err_path) as f:
            tail = f.read()[-2000:]
        raise AssertionError(f"phase 17d serve: launches by card "
                             f"{launched}, expected kernel 3 {want_cards}; "
                             f"{tail}")
    rec["launches_by_card"] = launched[-1]
    log(f"phase 17d serve --mesh over {n} cards: the all_pairs RPC equals "
        f"the fp64 oracle ({len(want32)} pairs); {SERVE_ROWS} fresh rows "
        f"streamed by 2 clients, {len(want_fresh)} pushed pairs equal the "
        f"fp64 oracle; SIGINT wrote the checkpoint; kernel 3 launched "
        f"{launched[-1]['panel_score_bits_int8']}")

    joins = {}
    cfg = MeshEngine.checkpoint_engine_config(ck).replace(shard_axis="rows")
    for name, make in (
            ("cards", lambda: MeshEngine.load(
                ck, config=cfg, mesh=make_mesh(n, devices=cards))),
            ("one_card", lambda: Engine.load(ck, device=dev))):
        t0 = time.perf_counter()
        eng = make()
        rec[f"restore_{name}_seconds"] = time.perf_counter() - t0
        if eng.n_rows != csr.n_rows + SERVE_ROWS:
            raise AssertionError(f"phase 17d restore {name}: {eng.n_rows} "
                                 f"rows")
        zero_launches()
        res = eng.all_pairs(TAU)
        by_card = launches_by_card()
        expect = ({"panel_score_bits_int8": card_counts(cards),
                   "compact_bits": card_counts(cards)}
                  if name == "cards" else {"score_bits_int8": {dev.index: 1},
                                           "compact_bits": {dev.index: 1}})
        if {k: v for k, v in by_card.items() if v} != expect:
            raise AssertionError(f"phase 17d restore {name}: launches by "
                                 f"card {by_card}, expected {expect}")
        joins[name] = {(a, b): s for a, b, s in res.id_pairs()}
        if name == "one_card":
            tm, tn = eng._tiles()
            bi, bj = blocks(eng.row_cap, tm, tn, dev)
            k1rec = compare("int8", eng._operands(True), bi, bj,
                            eng._tau_eff(TAU), tm, tn, timed=True)
            ops = eng._operands(True)
            k1rec.update(score_bound(ops[:1], ops[1].numel() * 4, bi, bj,
                                     tm, tn, (0, 0), PEAK_INT8))
            k1 = next(k for k in kernels if k["name"] == "score_bits_int8")
            k1.update({"launches": k1["launches"] + 1,
                       "max_abs_err": max(k1["max_abs_err"],
                                          k1rec["max_abs_err"]),
                       **{f"restore_{f}": k1rec[f] for f in (
                           "ms", "plain_ms", "bound_ms", "bound_by")}})
            log(f"phase 17d kernel 1 vs plain at the one-card restore's "
                f"operands: {json.dumps(k1rec)}")
        del eng, res
    want_all = ({(min(str(a), str(b)), max(str(a), str(b)))
                 for a, b in want32} | want_fresh)
    got_pairs = {(min(a, b), max(a, b)) for a, b in joins["cards"]}
    if not equal_bits(sorted(joins["cards"].items()),
                      sorted(joins["one_card"].items())) or (
            got_pairs != want_all):
        raise AssertionError(f"phase 17d: the restored joins differ (over "
                             f"the cards {len(joins['cards'])}, one card "
                             f"{len(joins['one_card'])}, oracle "
                             f"{len(want_all)})")
    k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
    k3["launches"] += 2 * n
    k3["serve_launches_by_card"] = launched[-1]["panel_score_bits_int8"]
    log(f"phase 17d: the checkpoint restores onto {n} cards and onto one "
        f"card; their joins are equal, pairs and similarities, and equal "
        f"the fp64 oracle ({len(want_all)} pairs); {json.dumps(rec)}")
    return rec


def first_cards(n: int) -> list:
    """The first ``n`` visible cards, one for each shard."""
    return [torch.device("cuda", i) for i in range(n)]


def mesh_cards_main(n: int) -> int:
    """``--mesh-cards N``: phase 17 alone, on a machine with at least N
    cards: the one-process meshes with one shard a card, each leg held
    bit for bit against the same mesh with every shard on card 0 (built
    in the same run) and against the fp64 oracle; the references rebuilt
    on card 0.  The same last lines as the whole script."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if n < 2:
        raise ValueError(f"--mesh-cards {n}: a mesh over cards needs two")
    have = torch.cuda.device_count()
    if have < n:
        raise AssertionError(f"--mesh-cards {n} needs {n} cards, have "
                             f"{have}")
    t_start = time.perf_counter()
    cards = first_cards(n)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    log(f"cards: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {have}; phase 17 over {n}")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    here = os.path.dirname(os.path.abspath(__file__))
    scale_path = os.path.join(work, "scale.npz")
    gen = subprocess.Popen([sys.executable, "-c", SCALE_GEN, here,
                            scale_path, str(SCALE_ROWS)], cwd=here)
    try:
        summary = {"card": smi, "cards": n,
                   "peer": card_topology(n)}
        _build.kernels()
        kernels = card_kernels(cards, smi)
        dev = cards[0]
        big_csr = synthetic_corpus(CARDS_ROWS, seed=0)
        want32 = oracle_pairs(big_csr, TAU, dev)
        q8 = query_sets(big_csr, dev)
        summary["17a"] = cards_dense(cards, big_csr, want32, q8, kernels,
                                     smi)
        del q8
        torch.cuda.empty_cache()
        ooc_csr = synthetic_corpus(OOC_ROWS, seed=0)
        want = oracle_pairs(ooc_csr, TAU, dev)
        q9 = query_sets(ooc_csr, dev)
        summary["17b"] = cards_chunked(cards, ooc_csr, want, q9, kernels,
                                       smi)
        del q9
        summary["17b_stripes"] = cards_stripes(cards, ooc_csr, want,
                                               kernels, smi)
        del ooc_csr, want
        torch.cuda.empty_cache()
        if gen.wait(timeout=600) != 0:
            raise AssertionError("phase 17c: the corpus process failed")
        scale_csr, _ = load_csr(scale_path)
        summary["17c"] = cards_scale(cards, scale_csr, kernels, smi)
        del scale_csr
        torch.cuda.empty_cache()
        summary["17d"] = cards_serve(cards, work, big_csr, want32, kernels,
                                     smi)
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
        shutil.rmtree(work, ignore_errors=True)
    k3 = next(k for k in kernels if k["name"] == "panel_score_bits_int8")
    k4 = next(k for k in kernels if k["name"] == "int8_matmul")
    k5 = next(k for k in kernels if k["name"] == "pair_bits_int8")
    k6 = next(k for k in kernels if k["name"] == "pair_bits_f32")
    # 17a's rows join, 17b's streamed join, 17b's bf16 stripes
    for k in (k3, k4, k5, k6):
        k["launches"] += k["mesh_cards_join_launches"]
        k.update({f: k[f"mesh_cards_{f}"] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
            max_abs_err=k["mesh_cards_max_abs_err"])
    k4["library_ms"] = k4["mesh_cards_library_ms"]
    log(f"phase 17 summary: {json.dumps(summary)}")
    log(f"chip_smoke seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # ---- phase 1: build the kernels
    _build.kernels()
    info = _build.build_info()
    log(f"kernels built in {info['seconds']:.2f} s: {info['library']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
            if "spill" in line and (
                    "0 bytes spill stores, 0 bytes spill loads" not in line):
                raise AssertionError(f"a kernel spills registers: {line}")
    edge_phase(dev)
    bf16_edge_phase(dev)

    # ---- phase 2: kernel vs plain, 4,096 rows with padding rows
    small = Engine(AllPairsConfig(row_bucket=5120), dev)
    small.build(synthetic_corpus(4096))
    if small.row_cap <= small.n_rows:
        raise AssertionError("phase 2 needs padding rows")
    tau_eff = small._tau_eff(TAU)
    q8 = ts.quantize_rows(small.x)
    xb = small.x.to(torch.bfloat16)
    for tm, tn in ((1024, 512), (256, 256)):
        bi, bj = blocks(small.row_cap, tm, tn, dev)
        for kind, ops in (("int8", q8), ("bf16", xb)):
            rec = compare(kind, ops, bi, bj, tau_eff, tm, tn, timed=True)
            log(f"phase 2 {kind} rows={small.n_rows} row_cap={small.row_cap} "
                f"dim_cap={small.dim_cap}: {json.dumps(rec)}")
    del small, q8, xb

    # ---- phase 3: the main path, counters zeroed just before
    big_csr = synthetic_corpus(32768, seed=0)
    enron_csr = synthetic_corpus(8586, seed=0)
    eng8 = Engine(AllPairsConfig(), dev)
    eng16 = Engine(AllPairsConfig(pallas_int8=False), dev)
    zero_launches()
    build32 = eng8.build(big_csr)
    log(f"build int8 engine: {json.dumps(build32)}")
    j8 = timed_join(eng8, "main path int8, 32768 rows")
    log(f"build bf16 engine: {json.dumps(eng16.build(enron_csr))}")
    j16 = timed_join(eng16, "main path bf16, 8586 rows")
    launches = dict(ts.LAUNCHES)
    if "--profile" in sys.argv[1:]:
        for label, eng in (("int8, 32768 rows", eng8),
                           ("bf16, 8586 rows", eng16)):
            t0 = time.perf_counter()
            prof = profile_join(eng, TAU)
            prof["profiling_seconds"] = time.perf_counter() - t0
            log(f"main path {label}, one more join under torch.profiler: "
                f"{json.dumps(prof)}")
    log(f"kernel launches on the main path: {launches}")
    for k in ("score_bits_int8", "score_bits_bf16"):
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the main path")
    if not eng8._used_int8 or eng16._used_int8:
        raise AssertionError("the joins did not take the intended kernels")

    # ---- phase 4: kernels at the main path's operands, then parity
    kernels = []
    for name, kind, eng in (("score_bits_int8", "int8", eng8),
                            ("score_bits_bf16", "bf16", eng16)):
        tm, tn = eng._tiles()
        bi, bj = blocks(eng.row_cap, tm, tn, dev)
        rec = compare(kind, eng._operands(kind == "int8"), bi, bj,
                      eng._tau_eff(TAU), tm, tn, timed=True)
        ops = eng._operands(kind == "int8")
        ops = ops if kind == "int8" else (ops,)
        rec.update(score_bound(
            ops[:1], ops[1].numel() * 4 if kind == "int8" else 0, bi, bj,
            tm, tn, (0, 0), PEAK_INT8 if kind == "int8" else PEAK_BF16))
        rec["tops"] = (2 * upper_cells(bi, bj, tm, tn) * eng.dim_cap
                       / rec["ms"] / 1e9)
        rec["thread_block_tile"] = list(ts.thread_block_tile(tm, tn))
        log(f"phase 4 {kind} row_cap={eng.row_cap} dim_cap={eng.dim_cap}: "
            f"{json.dumps(rec)}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            # no one PyTorch call computes the bound epilogue + bit-pack
            "library_ms": None,
        })
    tm, tn = eng16._tiles()
    bi, bj = blocks(eng16.row_cap, tm, tn, dev)
    k7_dense = compare_compact(
        ts.score_bits_bf16(eng16._operands(False), bi, bj,
                           eng16._tau_eff(TAU), tm, tn),
        bi, bj, tm, tn, f"the bf16 join's, {eng16.n_rows} rows")
    want32 = oracle_pairs(big_csr, TAU, dev)
    check_parity(j8["res"], want32, "int8 join, 32768 rows")
    want8586 = oracle_pairs(enron_csr, TAU, dev)
    check_parity(j16["res"], want8586, "bf16 join, 8586 rows")
    for j in (j8, j16):
        if not j["res"].n_pairs or not np.all(np.isfinite(j["res"].sims)):
            raise AssertionError("join produced no pairs or non-finite sims")
    cand32 = pair_set(eng8._all_pairs_kernel(eng8._tau_eff(TAU)))
    del eng8, eng16, j8, j16
    torch.cuda.empty_cache()

    # ---- phase 5: the out-of-core path
    small = ChunkedAllPairs(AllPairsConfig(), dev, panel_rows=1024)
    small.build(synthetic_corpus(3000, seed=2))
    if small._panel_geom()[3] != 3 or small.row_cap <= small.n_rows:
        raise AssertionError("phase 5 needs three panels with padding rows")
    for tm, tn in ((1024, 512), (64, 128)):
        for pi, pj in ((0, 0), (0, 2), (1, 2)):
            for blank in (False, True):
                rec = compare_panel(small, pi, pj, tm, tn, timed=False,
                                    blank=blank)
                log(f"phase 5 panel kernel, 3000 rows: {json.dumps(rec)}")
    del small

    ooc_csr = synthetic_corpus(OOC_ROWS, seed=0)
    eng = ChunkedAllPairs(AllPairsConfig(), dev)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    build100k = eng.build(ooc_csr)
    log(f"build chunked engine: {json.dumps(build100k)}")
    jr = ooc_join(eng, f"out-of-core path, resident sweep, {OOC_ROWS} rows",
                  reps=3)
    ooc_launches = dict(ts.LAUNCHES)
    log(f"kernel launches on the out-of-core path: {ooc_launches}")
    n_pairs = jr["rec"]["geom"]["n_panels"] * (
        jr["rec"]["geom"]["n_panels"] + 1) // 2
    if ooc_launches["panel_score_bits_int8"] != 3 * n_pairs:
        raise AssertionError("the out-of-core join did not launch the panel "
                             "kernel once per panel pair")
    if ooc_launches["compact_bits"] != 3 * n_pairs:
        raise AssertionError("the out-of-core join did not launch kernel 7 "
                             "once per panel pair")
    launches["panel_score_bits_int8"] = ooc_launches["panel_score_bits_int8"]

    last = jr["rec"]["geom"]["n_panels"] - 1
    recs = []
    for pi, pj in ((0, 0), (0, last)):
        rec = compare_panel(eng, pi, pj, *eng._panel_geom()[1:3], timed=True)
        log(f"phase 5 panel kernel at the join's operands: {json.dumps(rec)}")
        recs.append(rec)
    off = recs[1]
    kernels.append({
        "name": "panel_score_bits_int8", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["panel_score_bits_int8"],
        "launches": launches["panel_score_bits_int8"],
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": off["ms"], "plain_ms": off["plain_ms"],
        "bound_ms": off["bound_ms"], "bound_by": off["bound_by"],
        "library_ms": None,
    })
    k7 = compare_compact(*sweep_pair_bits(eng), "an 8,192-row panel pair")
    kernels.append({
        "name": "compact_bits", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["compact_bits"],
        "launches": ooc_launches["compact_bits"], "max_abs_err": 0,
        **{k: k7[k] for k in ("ms", "launch_ms", "plain_ms", "bound_ms",
                              "bound_by", "hits")},
        **{f"dense_{k}": k7_dense[k] for k in ("ms", "launch_ms", "plain_ms",
                                               "bound_ms", "hits")},
        # no one PyTorch call compacts a bit-packed structure
        "library_ms": None,
    })

    eng._panel_resident_bytes = 0
    jroll = ooc_join(eng, f"out-of-core path, rolling sweep, {OOC_ROWS} rows",
                     reps=1)
    cand100k = pair_set(eng._all_pairs_panel(eng._tau_eff(TAU)))
    panel_pairs = jr["res"].pair_set()
    del eng
    torch.cuda.empty_cache()
    want = oracle_pairs(ooc_csr, TAU, dev)
    for label, j in (("resident", jr), ("rolling", jroll)):
        got = set(zip(j["res"].i.tolist(), j["res"].j.tolist()))
        if got != want:
            raise AssertionError(
                f"out-of-core {label} join differs from the fp64 oracle: "
                f"{len(got - want)} extra, {len(want - got)} missing"
            )
        if not got or not np.all(np.isfinite(j["res"].sims)):
            raise AssertionError("join produced no pairs or non-finite sims")
        log(f"out-of-core {label} join, {OOC_ROWS} rows: parity OK, "
            f"{len(got)} pairs equal the fp64 oracle")
    off2048_leg(dev, kernels)
    torch.cuda.empty_cache()

    # ---- phase 6: the mesh paths, their shards on the one card
    gen = torch.Generator(device=dev).manual_seed(6)
    for m, n, d in ((1024, 1024, 128), (256, 512, 384)):
        xi, xj = (torch.randint(-127, 128, (r, d), dtype=torch.int8,
                                device=dev, generator=gen) for r in (m, n))
        compare_mm(xi, xj, f"random [{m}, {d}] x [{n}, {d}]^T")
    del xi, xj
    mm_main = pb_main = None
    for n_shards, reps in ((1, 3), (8, 1)):
        mesh = (make_mesh(1) if n_shards == 1
                else make_mesh(8, devices=[dev] * 8))
        meng = MeshChunkedAllPairs(AllPairsConfig(), mesh=mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        log(f"build mesh chunked engine, {n_shards} shard(s) on one card: "
            f"{json.dumps(meng.build(ooc_csr))}")
        label = (f"mesh out-of-core path, {n_shards} shard(s) on one card, "
                 f"{OOC_ROWS} rows")
        jm = ooc_join(meng, label, reps=reps, ops_of=mesh_join_ops)
        got = dict(ts.LAUNCHES)
        log(f"kernel launches on the {label}: {got}")
        geom = jm["rec"]["geom"]
        n_pairs = geom["n_panels"] * (geom["n_panels"] + 1) // 2
        expect = {k: 0 for k in got}
        expect["int8_matmul"] = reps * n_shards * n_pairs
        expect["pair_bits_int8"] = reps * n_pairs  # one slice: one card
        expect = with_compactions(expect)
        if got != expect:
            raise AssertionError(f"{label}: launches {got}, expected {expect}")
        check_parity(jm["res"], want, label)
        if not np.all(np.isfinite(jm["res"].sims)):
            raise AssertionError(f"{label}: non-finite sims")
        if pair_set(meng._all_pairs_panel(meng._tau_eff(TAU))) != cand100k:
            raise AssertionError(f"{label}: candidate set differs from the "
                                 f"single-device join's")
        log(f"{label}: candidate set equals the single-device join's "
            f"({len(cand100k)}); d_local {geom['d_cap'] // n_shards}")
        st = meng._panel_state()
        x0 = meng._build_slab(st, 0)
        xl = meng._build_slab(st, geom["n_panels"] - 1)
        for pair, xj in (("(0, 0)", x0), (f"(0, {geom['n_panels'] - 1})", xl)):
            rec = compare_mm(x0[0], xj[0], f"{label}, pair {pair}, shard 0")
            if n_shards == 1 and xj is xl:
                mm_main = dict(rec, launches=got["int8_matmul"])
        del st, x0, xl
        last = geom["n_panels"] - 1
        diag = compare_pair_bits(meng, 0, 0, f"{label}, pair (0, 0)")
        off = compare_pair_bits(meng, 0, last, f"{label}, pair (0, {last})")
        if n_shards == 1:
            pb_main = pair_bits_record(diag + off, got["pair_bits_int8"])
            pb_main["diagonal_ms"] = diag[0]["ms"]
        else:
            pb_main.update({f"shards8_{k}": v for k, v in pair_bits_record(
                diag + off, got["pair_bits_int8"]).items()
                if k not in ("name", "route", "source", "replaces")})
        del meng, jm
    kernels.append({
        "name": "int8_matmul", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["int8_matmul"],
        **{k: mm_main[k] for k in ("launches", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
    })
    kernels.append(pb_main)

    mesh4 = make_mesh(4, devices=[dev] * 4)
    reng = MeshEngine(AllPairsConfig(shard_axis="rows"), mesh=mesh4)
    torch.cuda.empty_cache()
    zero_launches()
    log(f"build mesh rows engine, 4 shards on one card: "
        f"{json.dumps(reng.build(big_csr))}")
    label = "mesh rows path, 4 shards on one card, 32768 rows"
    jrows = timed_join(reng, label)
    got = dict(ts.LAUNCHES)
    log(f"kernel launches on the {label}: {got}")
    expect = {k: 0 for k in got}
    expect["panel_score_bits_int8"] = 3 * 4
    expect = with_compactions(expect)
    if got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    check_parity(jrows["res"], want32, label)
    if pair_set(reng._all_pairs_kernel(reng._tau_eff(TAU))) != cand32:
        raise AssertionError(f"{label}: candidate set differs from Engine's")
    log(f"{label}: candidate set equals Engine's ({len(cand32)})")
    for shard in (0, reng.n_shards - 1):
        rec = compare_rows_shard(reng, shard)
        log(f"phase 6 panel kernel at the rows path's operands: "
            f"{json.dumps(rec)}")

    # ---- phase 7: the full-rectangle join, the stripes, the mesh layouts
    # the rows mesh once more, demoted: its join is now the rectangle
    reng._int8_off = True
    zero_launches()
    t0 = time.perf_counter()
    res = reng.all_pairs(TAU)
    log(f"mesh rows path after int8 demotion, one join: "
        f"{time.perf_counter() - t0:.4f} s; launches {dict(ts.LAUNCHES)}")
    if reng._kernel_ok() or any(ts.LAUNCHES.values()):
        raise AssertionError("the demoted rows mesh still took a kernel")
    check_parity(res, want32, "mesh rows path after int8 demotion")
    del reng, res
    torch.cuda.empty_cache()

    rect_phase(AllPairsConfig(use_pallas="off"), big_csr, want32,
               "rectangle, default precision, 32768 rows", dev)
    torch.cuda.empty_cache()
    hi = AllPairsConfig(matmul_precision="highest")
    rect_phase(hi, enron_csr, want8586, "rectangle, highest, 8586 rows", dev)
    torch.backends.cuda.matmul.allow_tf32 = True  # must be restored as found
    rect_phase(hi, big_csr, want32, "rectangle, highest, 32768 rows, "
               "allow_tf32 on beforehand", dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    for shape, axis in ((4, "dims"), ((2, 2), "both")):
        mesh = make_mesh(shape, devices=[dev] * 4)
        j = rect_phase(
            AllPairsConfig(shard_axis="dims"), big_csr, want32,
            f"mesh rectangle, {axis}, {shape} shards on one card, 32768 rows",
            dev, make=lambda cfg: MeshEngine(cfg, mesh=mesh))
        del j
        torch.cuda.empty_cache()

    stripe_phase(dev, ooc_csr, want, panel_pairs, big_csr, want32, kernels)

    # ---- phase 8: the streaming path (insert, join, topk, frozen match)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        saved8, x8, qsets8 = stream_phase(dev, big_csr, want32, kernels,
                                          smi, os.path.join(work, "dense"))

        # ---- phase 9: the chunked engine's streaming path on phase 5's
        # corpus
        saved9, qsets9 = chunked_stream_phase(
            dev, ooc_csr, want, kernels, smi, os.path.join(work, "chunked"))

        # ---- phase 10: checkpoints, the server, the command line
        serving_phase(dev, work, big_csr, want32, want, kernels, smi,
                      (saved8, build32), (saved9, build100k))

        # ---- phase 11: the meshes' streaming path, shards on the one card
        refs = mesh_stream_phase(dev, big_csr, want32, x8, qsets8, ooc_csr,
                                 want, qsets9, kernels, smi)

        # ---- phase 12: one index served from two processes on the card
        multihost_phase(dev, work, big_csr, want32, refs, ooc_csr, want,
                        cand100k, kernels, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- phase 13: the benchmark suite and the stage probes
    torch.cuda.empty_cache()
    bench_phase(dev, kernels, len(want))

    # ---- phase 14: bench_torch.py's headline join and insert cells
    torch.cuda.empty_cache()
    bench_torch_phase(dev, kernels)

    # ---- phase 15: the deploy scripts drive the daemon on the card
    torch.cuda.empty_cache()
    deploy_phase(dev, kernels)

    # ---- phase 16: the schedule and slab studies
    torch.cuda.empty_cache()
    study_phase(dev, kernels, ooc_csr)

    log(f"chip_smoke seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase12-rank"]:
        sys.exit(phase12_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4]))
    if sys.argv[1:2] == ["--multihost"]:
        sys.exit(multihost_main(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--mesh-cards"]:
        sys.exit(mesh_cards_main(int(sys.argv[2])))
    sys.exit(main())
