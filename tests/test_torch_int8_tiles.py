"""Host-side logic of the int8 kernels (kernels 1, 3 and 4): the choice of
thread-block tile, the live-first sub-tile list against a brute-force
enumeration, its cache, and the shape and alignment errors the wrappers
raise.  CPU only; the kernels themselves are held against their plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from apsim_tpu_torch.ops import panel as panel_ops
from apsim_tpu_torch.ops import panel_mesh
from apsim_tpu_torch.ops import tri_score as ts


@pytest.mark.parametrize("shape, tile", [
    ((1024, 512), (128, 256)), ((512, 512), (128, 256)),
    ((256, 256), (128, 256)), ((64, 128), (64, 128)),
    ((128, 128), (64, 128)), ((192, 256), (64, 128)),
    ((8192, 8192), (128, 256)), ((8192, 384), (64, 128)),
])
def test_int8_tile_choice(shape, tile):
    assert ts.int8_tile(*shape) == tile


@pytest.mark.parametrize("shape", [(32, 128), (64, 64), (96, 128)])
def test_int8_tile_refuses_untileable(shape):
    with pytest.raises(ValueError, match="no int8 thread-block tile"):
        ts.int8_tile(*shape)


def brute_force(bi, bj, tm, tn, off, valid):
    """Every sub-tile id in list order, the live ones first."""
    bm, bn = ts.int8_tile(tm, tn)
    live, dead = [], []
    for p, (i, j) in enumerate(zip(bi.tolist(), bj.tolist())):
        for cm in range(tm // bm):
            for cn in range(tn // bn):
                sid = (p * (tm // bm) + cm) * (tn // bn) + cn
                row_min = off[0] + i * tm + cm * bm
                col_max = off[1] + j * tn + cn * bn + bn - 1
                ok = valid is None or int(valid[p]) != 0
                (live if ok and row_min < col_max else dead).append(sid)
    return live + dead


@pytest.mark.parametrize("tiles", [(1024, 512), (512, 512), (256, 256),
                                   (64, 128)])
@pytest.mark.parametrize("grid", ["triangle", "rectangle"])
@pytest.mark.parametrize("off", [(0, 0), (0, 2048), (1024, 0), (512, 768)])
@pytest.mark.parametrize("blank", [False, True])
def test_live_subtiles_matches_brute_force(tiles, grid, off, blank):
    tm, tn = tiles
    g = (ts.upper_blocks_rect(2048, tm, tn) if grid == "triangle"
         else panel_ops.full_grid(2048, 2048, tm, tn))
    bi, bj = (torch.from_numpy(a) for a in g)
    valid = None
    if blank:
        valid = torch.ones_like(bi)
        valid[::3] = 0
    got = ts.live_subtiles(bi, bj, tm, tn, off, valid)
    assert got.dtype == torch.int32
    assert got.tolist() == brute_force(bi, bj, tm, tn, off, valid)


def test_live_subtiles_empty_list():
    e = torch.zeros(0, dtype=torch.int32)
    assert ts.live_subtiles(e, e, 1024, 512).numel() == 0


def test_tile_list_cache():
    """The cached list equals ``live_subtiles``; off-diagonal panel pairs
    (offset differences beyond the operands) share one entry; an in-place
    change of a block tensor gives a fresh list."""
    ts._TILE_LISTS.clear()
    bi, bj = (torch.from_numpy(a)
              for a in panel_ops.full_grid(1024, 1024, 256, 256))
    valid = torch.ones_like(bi)
    a = ts.tile_list(bi, bj, 256, 256, (0, 8192), valid, 1024, 1024)
    b = ts.tile_list(bi, bj, 256, 256, (1024, 40960), valid, 1024, 1024)
    assert a is b and len(ts._TILE_LISTS) == 1
    assert torch.equal(a, ts.live_subtiles(bi, bj, 256, 256, (0, 8192),
                                           valid))
    diag = ts.tile_list(bi, bj, 256, 256, (1024, 1024), valid, 1024, 1024)
    assert torch.equal(diag, ts.live_subtiles(bi, bj, 256, 256, (0, 0),
                                              valid))
    valid[0] = 0
    c = ts.tile_list(bi, bj, 256, 256, (0, 8192), valid, 1024, 1024)
    assert c is not a
    assert torch.equal(c, ts.live_subtiles(bi, bj, 256, 256, (0, 8192),
                                           valid))
    for _ in range(ts._TILE_LISTS_MAX + 4):
        ts.tile_list(bi.clone(), bj, 256, 256, (0, 0), None, 1024, 1024)
    assert len(ts._TILE_LISTS) == ts._TILE_LISTS_MAX
    ts._TILE_LISTS.clear()


def misaligned(rows: int, cols: int) -> torch.Tensor:
    """A contiguous int8 [rows, cols] view that starts 1 byte past a
    16-byte boundary."""
    buf = torch.zeros(rows * cols + 16, dtype=torch.int8)
    start = (16 - buf.data_ptr() % 16) % 16 + 1
    v = buf[start:start + rows * cols].view(rows, cols)
    assert v.is_contiguous() and v.data_ptr() % 16 == 1
    return v


def test_wrappers_refuse_misaligned_operands():
    x = misaligned(256, 128)
    aux = torch.zeros((3, 256))
    bi, bj = (torch.from_numpy(a) for a in ts.upper_blocks_rect(256, 64, 128))
    with pytest.raises(ValueError, match="16-byte boundary"):
        ts.score_bits_int8(x, aux, bi, bj, 0.5, 64, 128)
    ok = torch.zeros((256, 128), dtype=torch.int8)
    for xi, xj in ((x, ok), (ok, x)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            panel_ops.panel_score_bits_int8(xi, xj, aux, aux, bi, bj, (0, 0),
                                            0.5, 64, 128)
        with pytest.raises(ValueError, match="16-byte boundary"):
            panel_mesh.int8_matmul(xi, xj)


def test_row_slices_stay_aligned():
    """A row slice of an operand whose width is a multiple of the K
    quantum stays aligned, as the benchmarks' ``q[8192:16384]`` does."""
    q = torch.randint(-127, 128, (512, 256), dtype=torch.int8)
    view = q[64:192]
    ts.check_aligned(view)
    assert torch.equal(panel_mesh.int8_matmul(view, q[:128]),
                       panel_mesh.int8_matmul_plain(view, q[:128]))


@pytest.mark.parametrize("m, n, d", [(32, 128, 128), (64, 96, 128),
                                     (64, 128, 100)])
def test_int8_matmul_refuses_shapes(m, n, d):
    xi = torch.zeros((m, d), dtype=torch.int8)
    xj = torch.zeros((n, d), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8_matmul needs"):
        panel_mesh.int8_matmul(xi, xj)


@pytest.mark.parametrize("tiles", [(32, 128), (64, 64), (1000, 512)])
def test_score_refuses_tiles(tiles):
    tm, tn = tiles
    q = torch.zeros((2048, 128), dtype=torch.int8)
    aux = torch.zeros((3, 2048))
    b = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ts.score_bits_int8(q, aux, b, b, 0.5, tm, tn)


def test_live_subtiles_is_a_permutation():
    """The list is built with torch ops on the block list's device (here
    the CPU) and holds every sub-tile id once."""
    bi, bj = (torch.from_numpy(a) for a in ts.upper_blocks_rect(4096, 1024,
                                                                  512))
    t = ts.live_subtiles(bi, bj, 1024, 512)
    assert t.device == bi.device
    assert sorted(t.tolist()) == list(range(bi.numel() * 16))
    assert np.unique(t.numpy()).size == t.numel()
