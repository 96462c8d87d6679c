"""The RHS tangent kernel's plan (``ops/cuda/sia_kernel.jvp_layout``) on
the CPU: the kernel (``csrc/sia2d_rhs_jvp.cu``) builds and runs only on a
CUDA card, so its index arithmetic is re-derived here from the plan and the
source's constants, and held to cover every cell, corner and ring point of
a plane exactly once, at the shapes the port launches it on and at ragged
ones, on every plan."""

import re

import pytest
import torch

from odinn_tpu_torch.ops.cuda import sia_kernel
from odinn_tpu_torch.ops.cuda.build import SRC_DIR
from odinn_tpu_torch.ops.cuda.sia_kernel import (JVP_GROUPS, JVP_LANES, JVP_ROWS, JVP_THREADS,
                                                 jvp_layout)

torch.set_num_threads(1)

SHAPES = [(16, 128, 128), (4, 128, 128), (2, 36, 36), (3, 41, 101), (3, 37, 128), (1, 3, 3),
          (2, 130, 66)]


def _thread_cells(lay, tid):
    """The tile's cells (row, column) thread ``tid`` forms: lane = column,
    warp = a band of ``rows`` rows."""
    lane, grp = tid % JVP_LANES, tid // JVP_LANES
    return [(grp * lay.rows + k, lane) for k in range(lay.rows)]


def _thread_corners(lay, tid):
    """The tile's corner-grid points (row, column) thread ``tid`` forms:
    the (tile_rows + 1) x 33 grid in row order, a point a thread a pass."""
    n = (lay.tile_rows + 1) * (JVP_LANES + 1)
    return [divmod(idx, JVP_LANES + 1) for idx in range(tid, n, JVP_THREADS)]


def _thread_loads(lay, tid):
    """The ring points (row, column; column 0 left of the tile) thread
    ``tid`` loads: the own columns of each ring row in units of ``width``,
    then, for the first 2 (tile_rows + 2) threads, one edge point."""
    per_row = JVP_LANES // lay.width
    units = [divmod(u, per_row) for u in range(tid, (lay.tile_rows + 2) * per_row, JVP_THREADS)]
    pts = [(r, 1 + q * lay.width + w) for r, q in units for w in range(lay.width)]
    if tid < 2 * (lay.tile_rows + 2):
        pts.append((tid >> 1, JVP_LANES + 1 if tid & 1 else 0))
    return pts, units


def _layouts(shape, dtype):
    """The wrapper's plan and every other plan the kernel takes."""
    plan = jvp_layout(*shape, dtype)
    return [plan] + [jvp_layout(*shape, dtype, vec=vec, rows=r)
                     for r in JVP_ROWS for vec in (True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_every_cell_corner_and_ring_point_covered_once(shape, dtype):
    """On every plan: each cell of a glacier's plane is formed by exactly one
    thread of one block; each block forms each point of its corner grid
    once, which holds every corner its cells read; each block loads each
    point of its tile's ring once, and no 16-byte vector straddles the
    plane's last column. The grid tiles the plane and the glaciers."""
    n_g, nx, ny = shape
    for lay in _layouts(shape, dtype):
        assert lay.tile_rows == JVP_GROUPS * lay.rows
        assert lay.grid == (-(-ny // JVP_LANES), -(-nx // lay.tile_rows), n_g)
        written = torch.zeros((nx, ny), dtype=torch.int64)
        cells = [c for tid in range(JVP_THREADS) for c in _thread_cells(lay, tid)]
        corners = [c for tid in range(JVP_THREADS) for c in _thread_corners(lay, tid)]
        assert sorted(corners) == [(r, c) for r in range(lay.tile_rows + 1)
                                   for c in range(JVP_LANES + 1)]
        assert sorted(cells) == [(r, c) for r in range(lay.tile_rows) for c in range(JVP_LANES)]
        for r, c in cells:      # a cell reads corners (r..r+1, c..c+1) of the grid
            assert {(r, c), (r + 1, c), (r, c + 1), (r + 1, c + 1)} <= set(corners)
        loads = [_thread_loads(lay, tid) for tid in range(JVP_THREADS)]
        ring = [p for pts, _ in loads for p in pts]
        assert sorted(ring) == [(r, c) for r in range(lay.tile_rows + 2)
                                for c in range(JVP_LANES + 2)]
        for by in range(lay.grid[1]):
            for bx in range(lay.grid[0]):
                i0, j0 = by * lay.tile_rows, bx * JVP_LANES
                for r, c in cells:
                    if i0 + r < nx and j0 + c < ny:
                        written[i0 + r, j0 + c] += 1
                for _, units in loads:
                    for _, q in units:
                        first = j0 + q * lay.width
                        assert (first < ny) == (first + lay.width - 1 < ny)
        assert torch.equal(written, torch.ones_like(written)), lay


@pytest.mark.parametrize("dtype,ny,width", [
    (torch.float32, 128, 4), (torch.float32, 101, 1), (torch.float32, 102, 1),
    (torch.float32, 36, 4), (torch.float64, 128, 2), (torch.float64, 101, 1),
    (torch.float64, 102, 2)])
def test_vector_width_falls_back_at_odd_widths(dtype, ny, width):
    """16-byte loads (4 float32 or 2 float64 values) where ny is a multiple
    of the vector; one value otherwise, and whenever the caller's planes
    are not 16-byte aligned (``vec=False``)."""
    assert jvp_layout(3, 37, ny, dtype).width == width
    assert jvp_layout(3, 37, ny, dtype, vec=False).width == 1
    for r in JVP_ROWS:
        assert jvp_layout(3, 37, ny, dtype, rows=r).width == width


@pytest.mark.parametrize("args,match", [
    ((2, 36, 36, torch.float16), "float32 or float64"),
    ((2, 36, 36, torch.int32), "float32 or float64"),
    ((0, 36, 36, torch.float32), "at least 1 glacier"),
    ((2, 2, 36, torch.float32), "at least 1 glacier"),
    ((2, 36, 2, torch.float64), "at least 1 glacier"),
    ((70000, 36, 36, torch.float32), "grid"),
    ((1, 16 * 65536, 36, torch.float32), "grid"),
])
def test_plan_refuses_what_the_kernel_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        jvp_layout(*args)
    with pytest.raises(ValueError, match="rows a thread"):
        jvp_layout(2, 36, 36, torch.float32, rows=3)


@pytest.mark.parametrize("shape,rows", [
    ((16, 128, 128), 4), ((128, 128, 128), 4), ((4, 128, 128), 1), ((8, 128, 128), 2),
    ((2, 36, 36), 1), ((3, 41, 101), 1)])
def test_plan_takes_the_most_rows_that_keep_two_blocks_an_sm(shape, rows):
    """R is the largest of 4, 2, 1 whose launch has at least two blocks on
    each of the H100's 132 SMs (JVP_MIN_BLOCKS), else 1, in both dtypes."""
    for dtype in (torch.float32, torch.float64):
        lay = jvp_layout(*shape, dtype)
        assert lay.rows == rows
        blocks = lay.grid[0] * lay.grid[1] * lay.grid[2]
        assert blocks >= sia_kernel.JVP_MIN_BLOCKS or rows == 1


def test_plan_constants_match_the_source():
    """The block (32 lanes, 4 warps), the instantiated rows a thread and
    the C entries' plan arguments are the source's."""
    source = (SRC_DIR / "sia2d_rhs_jvp.cu").read_text()
    assert f"constexpr int kLanes = {JVP_LANES};" in source
    assert f"constexpr int kGroups = {JVP_GROUPS};" in source
    assert sorted(int(r) for r in re.findall(r"launch_plan<T, (\d+), kStage>", source)) == \
        sorted(JVP_ROWS)
    for name in ("sia2d_rhs_jvp_f32", "sia2d_rhs_jvp_f64"):
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', source, re.S).group(1)
        assert "int ny, int rows, int vec, double eta0" in " ".join(sig.split())
