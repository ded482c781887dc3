"""The CPU side of ``chip_smoke.py --mesh-cards N`` (phase 17: the
one-process meshes with one shard a card): the mode and ``make_mesh``
refuse too few cards, phase 11's helpers still put every shard on one
device when given one, the per-card launch counts, and the bit-for-bit
comparison phase 17 holds the cards' results to.  The mode itself needs
several cards and runs only there."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from apsim_tpu_torch import make_mesh
from apsim_tpu_torch.bench.scale import synthetic_corpus
from apsim_tpu_torch.ops import tri_score as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def test_make_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)


@pytest.mark.parametrize("shape", [4, (2, 2)])
def test_make_mesh_raises_on_too_few_devices(shape):
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        make_mesh(shape, devices=["cpu"] * 3)


class _WorkStarted(Exception):
    pass


def _no_work(*a, **k):
    raise _WorkStarted


@pytest.mark.parametrize("have", [0, 1, 3])
def test_mesh_cards_raises_before_any_work(monkeypatch, have):
    """Too few cards: the mode raises before it builds, generates or
    starts anything, and never shrinks the mesh."""
    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs.torch.cuda, "device_count", lambda: have)
    for name in ("smi_line", "card_topology", "first_cards",
                 "synthetic_corpus", "card_kernels"):
        monkeypatch.setattr(cs, name, _no_work)
    monkeypatch.setattr(cs._build, "kernels", _no_work)
    monkeypatch.setattr(cs.subprocess, "Popen", _no_work)
    monkeypatch.setattr(cs.tempfile, "mkdtemp", _no_work)
    with pytest.raises(AssertionError, match=f"needs 4 cards, have {have}"):
        cs.mesh_cards_main(4)


def test_mesh_cards_needs_two_cards(monkeypatch):
    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs.torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(cs, "smi_line", _no_work)
    with pytest.raises(ValueError, match="needs two"):
        cs.mesh_cards_main(1)


def test_mesh_cards_without_cuda_prints_no_result():
    """Here (no CUDA) the mode exits non-zero and prints no ``ok`` line."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--mesh-cards",
         "4"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "is_available() is false" in proc.stderr


def test_shard_devices():
    cards = [torch.device("cuda", i) for i in range(4)]
    assert cs.shard_devices(CPU, 4) == [CPU] * 4
    assert cs.shard_devices("cpu", 8) == [CPU] * 8
    assert cs.shard_devices(cards, 4) == cards
    with pytest.raises(ValueError, match="4-shard mesh given 3"):
        cs.shard_devices(cards[:3], 4)
    assert cs.where([CPU] * 4) == "4 shards on one card"
    assert cs.where(cards) == "4 shards over 4 cards"
    assert cs.card_counts(cards, 3) == {0: 3, 1: 3, 2: 3, 3: 3}
    assert cs.card_counts([cards[0]] * 4) == {0: 4}


class _Built(Exception):
    pass


@pytest.mark.parametrize("helper, n", [("mesh_dense_stream", 4),
                                       ("mesh_chunked_stream", 8)])
@pytest.mark.parametrize("given", ["one", "list"])
def test_phase11_helpers_build_one_device_meshes(monkeypatch, helper, n,
                                                 given):
    """Phase 11 passes ``[dev] * n`` (or one device): its meshes still
    hold every shard on that device; phase 17 passes a list."""
    seen = {}

    def engine(config, mesh):
        seen["devices"] = mesh.devices
        raise _Built

    cls = "MeshEngine" if helper == "mesh_dense_stream" else (
        "MeshChunkedAllPairs")
    monkeypatch.setattr(cs, cls, engine)
    devs = CPU if given == "one" else [CPU] * n
    args = (devs, None, set(), None, None, [], "cpu")
    with pytest.raises(_Built):
        if helper == "mesh_dense_stream":
            getattr(cs, helper)(*args, "rows", 4, "rows")
        else:
            getattr(cs, helper)(*args[:2], set(), None, [], "cpu", n=n)
    assert seen["devices"] == (CPU,) * n


def test_phase11_helpers_refuse_a_short_device_list():
    with pytest.raises(ValueError, match="4-shard mesh given 2"):
        cs.mesh_dense_stream([CPU] * 2, None, set(), None, None, [], "cpu",
                             "rows", 4, "rows")


def test_launches_by_card(monkeypatch):
    """``_launch`` counts a launch in ``LAUNCHES`` and, by the card it ran
    on, in ``LAUNCHES_BY_CARD``; ``zero_launches`` clears both."""
    class Lib:
        @staticmethod
        def int8_matmul(*args):
            return 0

    class Shard:
        def __init__(self, card):
            self.device = torch.device("cuda", card)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ts, "kernels", lambda: Lib)
    monkeypatch.setattr(ts.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(ts.torch.cuda, "current_stream", lambda d: Stream)
    before = dict(ts.LAUNCHES)
    ts.zero_launches()
    try:
        for card in (0, 1, 3, 3):
            ts._launch("int8_matmul", Shard(card), ())
        assert ts.LAUNCHES["int8_matmul"] == 4
        assert ts.LAUNCHES_BY_CARD["int8_matmul"] == {0: 1, 1: 1, 3: 2}
        assert cs.launches_by_card()["int8_matmul"] == {0: 1, 1: 1, 3: 2}
        assert all(not v for k, v in ts.LAUNCHES_BY_CARD.items()
                   if k != "int8_matmul")
        cs.zero_launches()
        assert not any(ts.LAUNCHES.values())
        assert not any(ts.LAUNCHES_BY_CARD.values())
    finally:
        ts.LAUNCHES.update(before)


def test_cli_wrap_prints_launches_by_card():
    proc = subprocess.run([sys.executable, "-c", cs.CLI_WRAP, "--help"],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    lines = proc.stdout.splitlines()
    by_card = [json.loads(ln.split(" ", 1)[1]) for ln in lines
               if ln.startswith("LAUNCHES_BY_CARD ")]
    assert by_card == [{k: {} for k in ts.LAUNCHES}]
    assert any(ln.startswith("LAUNCHES ") for ln in lines)


@pytest.mark.parametrize("a, b, same", [
    (0.0, 0.0, True), (0.0, -0.0, False), (1.0, 1.0 + 2 ** -52, False),
    (np.array([1, 2], np.int64), np.array([1, 2], np.int64), True),
    (np.array([1, 2], np.int64), np.array([1, 2], np.int32), False),
    ({"q": {"3": 0.5}}, {"q": {"3": 0.5}}, True),
    ({"q": {"3": 0.5}}, {"q": {"3": 0.5000000000000001}}, False),
    ([("1", 0.9), ("2", 0.8)], [("2", 0.8), ("1", 0.9)], False),
    ((np.arange(3), np.arange(3)), (np.arange(3), np.arange(3)), True),
    (1, 1.0, False),
])
def test_equal_bits(a, b, same):
    assert cs.equal_bits(a, b) is same


def test_same_as_card0_names_the_key():
    ref = {"topk": {"q": [("1", 0.5)]}, "cand": np.arange(4)}
    got = {"topk": {"q": [("1", 0.5)]}, "cand": np.arange(4)[::-1].copy()}
    cs.same_as_card0(got, ref, ("topk",), "t")
    with pytest.raises(AssertionError, match="cand differs"):
        cs.same_as_card0(got, ref, ("topk", "cand"), "t")


def test_mesh_dims_step_grows_and_activates():
    """Phase 17a's new-dims step on a small rows mesh of CPU shards:
    ``dim_cap`` grows, archived dims activate, every block stays on its
    shard's device and the outputs equal the fp64 pairs among the new
    rows."""
    csr = synthetic_corpus(1000, seed=0, active_dims=4096)
    eng = cs.MeshEngine(cs.AllPairsConfig(shard_axis="rows"),
                        mesh=make_mesh(4, devices=["cpu"] * 4))
    eng.build(csr)
    rec = cs.mesh_dims_step(eng, csr, CPU, "test")
    cap0, cap1 = rec["dims_caps"]
    d0, d1, d2 = rec["dormant"]
    assert cap1 > cap0 and d1 > d0 > -1 and d2 < d1
    assert rec["new_pairs"]
    assert all(b.device == CPU for b in eng.x_blocks)
