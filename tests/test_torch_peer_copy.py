"""The mesh join's counters: ``collectives.gather_rows`` counts the bytes it
copies from one card to another (a view counts nothing), and
``MeshChunkedAllPairs.stats`` reports them as ``peer_copy_bytes`` beside
each shard's entry count, ``shard_entries``.  On the CPU every mesh repeats
one device, so nothing crosses; the ``cuda`` cases need two cards and skip
elsewhere."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from apsim_tpu_torch import AllPairsConfig, make_mesh
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.engine.chunked import ChunkedAllPairs
from apsim_tpu_torch.ops import panel_mesh
from apsim_tpu_torch.parallel.chunked_mesh import MeshChunkedAllPairs
from apsim_tpu_torch.parallel.collectives import gather_rows
from apsim_tpu_torch.vector.batch import CSRMatrix

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corpus():
    return synthetic_corpus(1500, seed=3)


def _parts(n_parts: int, rows: int = 256, cols: int = 128, device=CPU):
    return [(torch.arange(rows * cols, dtype=torch.int32).reshape(rows, cols)
             + k).to(device) for k in range(n_parts)]


@pytest.mark.parametrize("n_parts,n_slices", [(1, 1), (2, 2), (4, 4),
                                              (4, 2)])
def test_gather_rows_counts_no_view(n_parts, n_slices):
    """Slices on the device their parts live on are views: 0 bytes."""
    parts = _parts(n_parts)
    bounds = panel_mesh.row_slices(256, n_slices)
    stats = {"peer_copy_bytes": 0}
    placed = gather_rows(parts, bounds, [CPU] * n_slices, stats)
    assert stats["peer_copy_bytes"] == 0
    assert all(placed[k][s].data_ptr() == parts[s][a:].data_ptr()
               for k, (a, _) in enumerate(bounds) for s in range(n_parts))


def _mesh_engine(shards: int, **cfg):
    return MeshChunkedAllPairs(
        AllPairsConfig(similarity_threshold=0.5, **cfg),
        mesh=make_mesh(shards, devices=[CPU] * shards), chunk_dim=256)


@pytest.mark.parametrize("route", ["panel", "stripe"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_repeated_device_mesh_reads_zero(corpus, shards, route):
    """Every shard on one device: the join copies nothing between cards,
    whichever route it takes, and ``shard_entries`` are the shards' own
    entry counts, which add up to the index's."""
    extra = {} if route == "panel" else {"pallas_int8": False}
    eng = _mesh_engine(shards, **extra)
    assert eng.stats["peer_copy_bytes"] == 0
    assert eng.stats["shard_entries"] == [0] * shards
    eng.build(corpus)
    res = eng.all_pairs()
    assert res.n_pairs > 0
    assert eng.stats["peer_copy_bytes"] == 0
    entries = eng.stats["shard_entries"]
    assert len(entries) == shards and all(isinstance(e, int)
                                          for e in entries)
    assert sum(entries) == int(eng._counts.sum())
    assert entries == [v["n_entries"] for v in eng.shard_layout().values()]


def test_shard_entries_follow_appends(corpus):
    """A streamed batch moves the shards' entry counts with it."""
    eng = _mesh_engine(2)
    end = int(corpus.indptr[1000])
    eng.build(CSRMatrix(1000, corpus.n_cols, corpus.indptr[:1001],
                        corpus.indices[:end], corpus.data[:end]))
    before = list(eng.stats["shard_entries"])
    eng.insert([(f"s{k}", corpus.row(k)) for k in range(1000, 1100)])
    after = eng.stats["shard_entries"]
    assert sum(after) == int(eng._counts.sum()) > sum(before)


def test_one_device_engine_has_no_mesh_counters(corpus):
    """The single-device engine's stats are as they were."""
    eng = ChunkedAllPairs(AllPairsConfig(similarity_threshold=0.5), CPU,
                          chunk_dim=256)
    assert "peer_copy_bytes" not in eng.stats
    assert "shard_entries" not in eng.stats


def _cards(n: int) -> list:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    return [torch.device("cuda", k) for k in range(n)]


@pytest.mark.cuda
def test_gather_rows_counts_the_slices_that_cross():
    """Parts on two cards, slices on both: the bytes are those of the
    rows that left their card, and a part's own rows are views."""
    cards = _cards(2)
    parts = [p.to(cards[k]) for k, p in enumerate(_parts(2))]
    bounds = [(0, 64), (64, 256)]
    stats = {"peer_copy_bytes": 0}
    placed = gather_rows(parts, bounds, cards, stats)
    for dev in cards:
        torch.cuda.synchronize(dev)
    row_bytes = 128 * 4
    assert stats["peer_copy_bytes"] == (64 + 192) * row_bytes
    assert placed[0][0].data_ptr() == parts[0].data_ptr()
    assert torch.equal(placed[1][0].cpu(), parts[0][64:].cpu())


@pytest.mark.cuda
def test_mesh_join_over_two_cards_counts_its_copies(corpus):
    """One shard a card: each panel pair copies every card's rows of the
    other card's int32 partial, rb x rb x 4 bytes in all."""
    cards = _cards(2)
    eng = MeshChunkedAllPairs(AllPairsConfig(similarity_threshold=0.5),
                              mesh=make_mesh(2, devices=cards),
                              chunk_dim=256)
    eng.build(corpus)
    res = eng.all_pairs()
    rb, _, _, n_panels, _ = eng._panel_geom()
    pairs = n_panels * (n_panels + 1) // 2
    assert res.n_pairs > 0
    assert eng.stats["peer_copy_bytes"] == pairs * rb * rb * 4
    assert sum(eng.stats["shard_entries"]) == int(np.sum(eng._counts))
