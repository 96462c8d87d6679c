"""The plan of the large-plane pullback (``csrc/si_plane_vjp.cu``):
:func:`~odinn_tpu_torch.ops.cuda.si_kernel.plane_vjp_layout` tiles the batch
in 32 × 4R cells, one block a tile and one slot of each of the glacier's two
sums a block, and ``si_step_vjp`` takes it exactly where ``si_plan`` sends
the step to the large-plane path. The kernel runs only on a CUDA card, where
``chip_smoke.py`` holds it against its plain version; here the plan's
arithmetic and the route are checked on the CPU (the occupancy queries
faked): the tiles hold every cell of every plane once and own every corner
once, the slots of a glacier are its blocks, the route follows ``si_plan``
over a table of shapes, a plane the kernel does not take is refused before
any launch, and the constants the plan uses stand in the source.
"""

import numpy as np
import pytest
import torch

from odinn_tpu_torch.ops.cuda import si_kernel
from odinn_tpu_torch.ops.cuda.build import SRC_DIR
from odinn_tpu_torch.ops.cuda.common import derived_scalars

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64

# (n_g, nx, ny): the large-plane check's 2 x 300^2 and 1 x 300^2, the ice
# sheet's planes, four 512^2 glaciers, ragged and odd planes, a small one
COVER_SHAPES = [(1, 300, 300), (2, 300, 300), (1, 1024, 1024), (1, 2048, 2048),
                (4, 512, 512), (1, 257, 301), (2, 301, 333), (2, 10, 33)]
# an H100's SMs, and a card so large that every launch takes R = 1
SMS = (132, 100_000)


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("shape", COVER_SHAPES)
def test_plane_vjp_tiles_cover_the_plane_once(shape, dtype, sms):
    """Block (bx, by, g) holds glacier g's cells of rows by·4R .. (by+1)·4R
    and columns 32·bx .. 32·(bx+1) (csrc/si_plane_vjp.cu): every cell of
    every glacier in one tile, every corner owned (its d(creep) and d(slide)
    terms summed) by one; R = 4 where that launch has 2 blocks an SM, else
    1; 16-byte loads where ny allows them."""
    n_g, nx, ny = shape
    lay = si_kernel.plane_vjp_layout(n_g, nx, ny, dtype, sms)
    assert lay.tile_rows == 4 * lay.rows and lay.threads == 128
    assert lay.grid == (-(-ny // 32), -(-nx // lay.tile_rows), n_g)
    blocks4 = n_g * -(-nx // 16) * -(-ny // 32)
    assert lay.rows == (4 if blocks4 >= si_kernel.PLANE_VJP_BLOCKS_PER_SM * sms else 1)
    v = 16 // _itemsize(dtype)
    assert lay.width == (v if ny % v == 0 else 1)
    assert si_kernel.plane_vjp_layout(n_g, nx, ny, dtype, sms, vec=False).width == 1
    cells = np.zeros((nx, ny), dtype=np.int32)
    corners = np.zeros((nx - 1, ny - 1), dtype=np.int32)
    for by in range(lay.grid[1]):
        i0 = by * lay.tile_rows
        for bx in range(lay.grid[0]):
            j0 = 32 * bx
            cells[i0:i0 + lay.tile_rows, j0:j0 + 32] += 1
            # the corners (a, c) the tile owns: a in [i0, i0 + 4R), c in
            # [j0, j0 + 32), those right of and below the ring's
            corners[i0:i0 + lay.tile_rows, j0:j0 + 32] += 1
    # every glacier's tiles are the same
    assert (cells == 1).all() and (corners == 1).all()


@pytest.mark.parametrize("shape", COVER_SHAPES)
def test_plane_vjp_slots(shape):
    """A glacier has one slot of each of its two sums a block, slot by·
    grid[0] + bx of block (bx, by): its blocks fill its slots once; the
    wrapper's buffer of 2·n_g·slots values holds glacier g's sums at
    [(2g + sum)·slots, (2g + sum + 1)·slots), disjoint over glaciers."""
    n_g, nx, ny = shape
    lay = si_kernel.plane_vjp_layout(n_g, nx, ny, F32, 132)
    assert lay.slots == lay.grid[0] * lay.grid[1]
    seen = sorted(by * lay.grid[0] + bx for by in range(lay.grid[1]) for bx in range(lay.grid[0]))
    assert seen == list(range(lay.slots))
    used = np.zeros(si_kernel.PLANE_VJP_SUMS * n_g * lay.slots, dtype=np.int32)
    for g in range(n_g):
        for k in range(si_kernel.PLANE_VJP_SUMS):
            used[(2 * g + k) * lay.slots:(2 * g + k + 1) * lay.slots] += 1
    assert (used == 1).all()


def test_plane_vjp_layout_icesheet():
    """On an H100's 132 SMs: 1 x 1024^2 takes 2048 tiles of 32 x 16 cells,
    1 x 2048^2 8192, 4 x 512^2 2048 (512 a glacier), 2 x 300^2 380 (2.9 an
    SM); 1 x 257 x 301 takes R = 1 (170 blocks at R = 4 are fewer than 2 an
    SM): 650 tiles of 32 x 4; the odd 301 x 333 plane loads one value at a
    time."""
    lay = si_kernel.plane_vjp_layout(1, 1024, 1024, F32, 132)
    assert (lay.rows, lay.grid, lay.slots, lay.width) == (4, (32, 64, 1), 2048, 4)
    lay = si_kernel.plane_vjp_layout(1, 2048, 2048, F32, 132)
    assert (lay.rows, lay.grid, lay.slots) == (4, (64, 128, 1), 8192)
    lay = si_kernel.plane_vjp_layout(4, 512, 512, F64, 132)
    assert (lay.rows, lay.grid, lay.slots, lay.width) == (4, (16, 32, 4), 512, 2)
    lay = si_kernel.plane_vjp_layout(2, 300, 300, F64, 132)
    assert (lay.rows, lay.grid, lay.slots) == (4, (10, 19, 2), 190)
    lay = si_kernel.plane_vjp_layout(1, 257, 301, F32, 132)
    assert (lay.rows, lay.grid, lay.slots) == (1, (10, 65, 1), 650)
    assert si_kernel.plane_vjp_layout(2, 301, 333, F32, 132).width == 1


@pytest.fixture
def faked_card(monkeypatch):
    """The plans' device queries faked (device -1 selects no device): 132
    SMs; si_step's and si_step_vjp's cluster occupancy, 15 clusters of 8
    and 7 of 16 resident. The plans' caches are emptied before and after."""

    class Lib:
        def si_step_occupancy(self, f64, glen, c, bx, by, smem, cells, active):
            active._obj.value = {8: 15, 16: 7}[c]
            return 0

        def si_step_vjp_occupancy(self, f64, glen, vec, c, smem, active):
            active._obj.value = {8: 15, 16: 7}[c]
            return 0

    caches = (si_kernel._plan, si_kernel._vjp_plan)
    for c in caches:
        c.cache_clear()
    monkeypatch.setattr(si_kernel, "_library", lambda: Lib())
    monkeypatch.setattr(si_kernel, "_vjp_library", lambda: Lib())
    monkeypatch.setattr(si_kernel, "_sm_count", lambda index: 132)
    yield
    for c in caches:
        c.cache_clear()


# (n_g, nx, ny): the main path's and the trainings' 128^2 batches, the folded
# batches, a rank's slab, the mid-size planes, the large-plane check's and
# the odd shape, the ice sheet's planes, four 512^2 glaciers, small planes
ROUTE_SHAPES = [(4, 128, 128), (16, 128, 128), (128, 128, 128), (512, 64, 64), (16, 66, 128),
                (1, 256, 256), (2, 192, 192), (3, 97, 131), (2, 10, 33), (2, 300, 300),
                (2, 301, 333), (1, 1024, 1024), (1, 2048, 2048), (4, 512, 512),
                (4, 516, 1024)]


@pytest.mark.parametrize("dtype", [F32, F64])
def test_pullback_route_is_the_steps(faked_card, dtype):
    """``si_step_vjp`` takes the large-plane pullback exactly where
    ``si_plan`` sends the step (and so its transpose solve) to the
    large-plane path, on the plan of ``plane_vjp_layout`` at the card's
    SMs, and the cluster kernel's layout everywhere else: every plane of
    256^2 or less, the rows axis's slab and the folded batches."""
    large = []
    for n_g, nx, ny in ROUTE_SHAPES:
        for glen in (True, False):
            for vec in (True, False):
                step = si_kernel._plan(dtype, nx, ny, n_g, glen, -1)
                lay = si_kernel._pullback_plan(dtype, nx, ny, n_g, glen, vec, -1)
                if step.layout is None:
                    assert lay == si_kernel.plane_vjp_layout(n_g, nx, ny, dtype, 132, vec)
                else:
                    assert isinstance(lay, si_kernel.SIVjpLayout) and lay.fits
                    assert lay.cluster == (16 if n_g <= 7 else 8)
                    assert lay == si_kernel.si_vjp_layout(nx, ny, dtype, lay.cluster)
        if si_kernel._plan(dtype, nx, ny, n_g, True, -1).layout is None:
            large.append((n_g, nx, ny))
    assert large == [(2, 300, 300), (2, 301, 333), (1, 1024, 1024), (1, 2048, 2048),
                     (4, 512, 512), (4, 516, 1024)]


def test_pullback_refuses_before_any_launch(faked_card):
    """A plane of 2^31 cells or more takes the large-plane route, whose plan
    refuses it (32-bit cell indices) with ValueError before any launch."""
    with pytest.raises(ValueError, match="a plane of at most 2147483647 cells"):
        si_kernel._pullback_plan(F64, 65_536, 32_768, 1, True, True, -1)


@pytest.mark.parametrize("bad, match", [
    ((1, 2, 128, F32, 132), "at least 1 glacier of 3 x 3"),
    ((0, 300, 300, F64, 132), "at least 1 glacier of 3 x 3"),
    ((1, 300, 300, torch.float16, 132), "float32 or float64"),
    ((1, 50_000, 50_000, F32, 132), "a plane of at most 2147483647 cells"),
    ((1, 1024, 1024, F32, 0), "at least one SM"),
    ((70_000, 300, 300, F32, 132), "exceed the launch's grid"),
    ((1, 16 * 65_535 + 1, 3, F64, 1), "exceed the launch's grid"),
])
def test_plane_vjp_layout_refuses(bad, match):
    """A plane or launch the kernel does not take raises ValueError naming
    why."""
    with pytest.raises(ValueError, match=match):
        si_kernel.plane_vjp_layout(*bad)


def test_plane_vjp_source_constants():
    """The tile, the threads, the instantiated rows a thread and the slots
    stand in the source as the plan counts them; the sums use no
    floating-point atomics, only the glacier's integer ticket."""
    source = (SRC_DIR / "si_plane_vjp.cu").read_text()
    # the assembly's tiles, which the plan shares
    for name, value in (("kLanes", si_kernel.ASM_LANES), ("kGroups", si_kernel.ASM_GROUPS)):
        assert f"constexpr int {name} = {value};" in source
    assert "constexpr int kThreads = kLanes * kGroups;" in source
    assert si_kernel.ASM_THREADS == 128
    assert "rows == 4 ? launch_rows<T, E, 4>" in source
    assert set(si_kernel.ASM_ROWS) == {4, 1}
    assert "T* partial;           // [n_g][2][blocks a glacier]" in source
    assert "T* const slots = p.partial + 2L * g * nblk;" in source
    assert si_kernel.PLANE_VJP_SUMS == 2
    assert source.count("atomicAdd(") == 1 and "atomicAdd(p.counter + g, 1u)" in source
    assert '#include "si_vjp_common.cuh"' in source


def test_cpu_pullback_launches_nothing():
    """On a CPU tensor ``si_step_vjp`` at a large plane is the plain version:
    no launch counted, on either counter."""
    n_g, nx, ny = 1, 300, 300
    rng = np.random.default_rng(3)
    H = torch.tensor(rng.uniform(0.0, 300.0, (n_g, nx, ny)))
    B = torch.tensor(rng.uniform(0.0, 10.0, (n_g, nx, ny)))
    lam = torch.tensor(rng.standard_normal((n_g, nx, ny)))
    x = H - 1.0
    raw = torch.tensor([[100.0, 100.0, 8e-19, 0.0, 3.0, 3.0, 0.0]])
    table = derived_scalars(*(raw[:, k] for k in range(7)), 900.0, 9.81)
    before = (si_kernel.si_step_vjp.launches, si_kernel.si_step_vjp.plane_launches)
    got = si_kernel.si_step_vjp(lam, H, H, B, x, table, 1.0 / 12.0, 1.0)
    want = si_kernel.si_step_vjp_reference(lam, H, H, B, x, table, 1.0 / 12.0, 1.0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (si_kernel.si_step_vjp.launches, si_kernel.si_step_vjp.plane_launches) == before
