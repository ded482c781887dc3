"""Host-side logic of the four kernels, int8 and bf16: the choice of
thread-block tile, the live-first sub-tile list against a brute-force
enumeration, its cache, the shape, type and alignment errors the wrappers
raise, and the binding's argument lists against the wrappers' and the C
entries'.  CPU only; the kernels themselves are held against their plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import ast
import inspect
import re

import numpy as np
import pytest
import torch

from apsim_tpu_torch.ops import _build
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
    assert ts.thread_block_tile(*shape) == tile


@pytest.mark.parametrize("shape", [(32, 128), (64, 64), (96, 128)])
def test_int8_tile_refuses_untileable(shape):
    with pytest.raises(ValueError, match="no thread-block tile"):
        ts.thread_block_tile(*shape)


def brute_force(bi, bj, tm, tn, off, valid):
    """Every sub-tile id in list order, the live ones first."""
    bm, bn = ts.thread_block_tile(tm, tn)
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


def misaligned_bf16(rows: int, cols: int) -> torch.Tensor:
    """A contiguous bf16 [rows, cols] view that starts 2 bytes past a
    16-byte boundary."""
    buf = torch.zeros(rows * cols + 16, dtype=torch.bfloat16)
    start = (16 - buf.data_ptr() % 16) % 16 // 2 + 1
    v = buf[start:start + rows * cols].view(rows, cols)
    assert v.is_contiguous() and v.data_ptr() % 16 == 2
    return v


def test_bf16_wrapper_refuses_misaligned_operand():
    bi, bj = (torch.from_numpy(a) for a in ts.upper_blocks_rect(256, 64, 128))
    before = dict(ts.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ts.score_bits_bf16(misaligned_bf16(256, 64), bi, bj, 0.5, 64, 128)
    assert ts.LAUNCHES == before


def test_bf16_row_slices_stay_aligned():
    """A row slice of a bf16 operand whose width is a multiple of 64
    elements (one 128-byte stage) stays aligned and scores as its copy."""
    x = torch.randn((512, 64)).to(torch.bfloat16)
    view = x[128:384]
    ts.check_aligned(view)
    bi, bj = (torch.from_numpy(a) for a in ts.upper_blocks_rect(256, 64, 128))
    for a, b in zip(ts.score_bits_bf16(view, bi, bj, 0.1, 64, 128),
                    ts.score_bits_bf16_plain(view.clone(), bi, bj, 0.1, 64,
                                             128)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int8])
def test_bf16_wrapper_refuses_dtype(dtype):
    x = torch.zeros((256, 64), dtype=dtype)
    b = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="bfloat16"):
        ts.score_bits_bf16(x, b, b, 0.5, 64, 128)


@pytest.mark.parametrize("rows, k, tiles", [
    (2048, 64, (32, 128)), (2048, 64, (64, 64)), (2048, 64, (1000, 512)),
    (2048, 32, (64, 128)), (2048, 96, (256, 256)), (1000, 64, (256, 256)),
])
def test_bf16_score_refuses_shapes(rows, k, tiles):
    """Tiles the thread blocks cannot take, a width that is no whole
    128-byte stage (K % 64), and rows the tiles do not divide."""
    x = torch.zeros((rows, k), dtype=torch.bfloat16)
    b = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ts.score_bits_bf16(x, b, b, 0.5, *tiles)


@pytest.mark.parametrize("tiles", [(1024, 512), (512, 512), (256, 256),
                                   (64, 128)])
def test_bf16_tile_list_is_the_int8_one(tiles):
    """The sub-tile list depends on the block list and the tiles, not on the
    operand type: for one block list both dense wrappers get one cached
    entry, equal to ``live_subtiles``."""
    tm, tn = tiles
    ts._TILE_LISTS.clear()
    bi, bj = (torch.from_numpy(a) for a in ts.upper_blocks_rect(2048, tm, tn))
    int8_list = ts.tile_list(bi, bj, tm, tn, (0, 0), None, 2048, 2048)
    bf16_list = ts.tile_list(bi, bj, tm, tn, (0, 0), None, 2048, 2048)
    assert bf16_list is int8_list and len(ts._TILE_LISTS) == 1
    assert torch.equal(int8_list, ts.live_subtiles(bi, bj, tm, tn))
    ts._TILE_LISTS.clear()


def launch_arguments() -> dict:
    """name -> number of arguments in each wrapper's ``_launch(name, x,
    (...))`` call, read from the wrappers' source."""
    found = {}
    for mod in (ts, panel_ops, panel_mesh):
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id",
                                getattr(node.func, "attr", "")) == "_launch"
                    and isinstance(node.args[0], ast.Constant)):
                assert node.args[0].value not in found
                found[node.args[0].value] = len(node.args[2].elts)
    return found


def c_entries() -> dict:
    """name -> parameter types ("void*", "int", "float", "long long") of
    each ``extern "C"`` entry of the CUDA source."""
    src = open(_build.SRC).read()
    src = src[src.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"^int (\w+)\(([^)]*)\)\s*\{", src, re.M):
        out[name] = [" ".join(p.replace("const ", "").split()[:-1])
                     for p in params.split(",")]
    return out


@pytest.mark.parametrize("name", ["score_bits_int8", "score_bits_bf16",
                                  "panel_score_bits_int8", "int8_matmul",
                                  "pair_bits_int8", "pair_bits_f32"])
def test_binding_matches_wrapper_and_source(name):
    """A ctypes call with a missing or mistyped argument corrupts the launch
    instead of failing: the binding's list must be the wrapper's arguments
    plus the stream, and type for type the C entry's parameters."""
    argtypes = _build.ARGTYPES[name]
    assert len(argtypes) == launch_arguments()[name] + 1
    ctype = {"void*": _build._P, "int": _build._I, "float": _build._F}
    assert [ctype[t] for t in c_entries()[name]] == argtypes
    # every C entry is a counted kernel launch but the copy between cards
    assert set(_build.ARGTYPES) == set(c_entries()) == (
        set(ts.LAUNCHES) | {"peer_copy"})


def test_peer_copy_binding_matches_source():
    """``collectives._peer_copy`` passes the destination, its card, the
    source, its card, the bytes and the stream, type for type the C
    entry's parameters."""
    ctype = {"void*": _build._P, "int": _build._I, "long long": _build._L}
    assert [ctype[t] for t in c_entries()["peer_copy"]] == (
        _build.ARGTYPES["peer_copy"])
