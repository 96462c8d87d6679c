"""The plans of the large-plane SI path (``csrc/si_plane.cu``):
:func:`~odinn_tpu_torch.ops.cuda.si_kernel.plane_layout` gives each glacier
an equal share of the cooperative PCG's resident blocks, one band of full
rows a block, and :func:`~odinn_tpu_torch.ops.cuda.si_kernel.assemble_layout`
tiles the assembly. The kernels run only on a CUDA card, where
``chip_smoke.py`` holds them against their plain versions; here the plans'
arithmetic is checked on the CPU: the bands cover every row of every
glacier once and in order, the blocks never exceed the resident count they
are given, the scratch holds 8 planes, the constants the plans use stand in
the source, and a plane or launch the kernels do not take is refused.
"""

import re

import pytest
import torch

from odinn_tpu_torch.ops.cuda import si_kernel
from odinn_tpu_torch.ops.cuda.build import SRC_DIR

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64

# (n_g, nx, ny): the ice-sheet domains, the large-plane check's 2 x 300^2,
# a rank's slab, a ragged and an odd width, small planes, and batches with
# more glaciers than the card holds blocks
SHAPES = [(1, 1024, 1024), (1, 2048, 2048), (2, 300, 300), (16, 66, 128), (3, 97, 131),
          (4, 301, 257), (1, 3, 3), (5, 7, 9), (600, 260, 260), (1000, 300, 301)]
# resident blocks: an H100's SMs at one, two and three blocks each, and small
# counts
RESIDENT = [132, 264, 396, 1, 7]
# an H100's SMs, the count the assembly's plan is given
SMS = 132


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _bands(lay, n_g, nx):
    """Each (glacier, band)'s rows [a, b), in launch order, as the kernel
    cuts them (csrc/si_plane.cu, Band)."""
    return [(g, k * nx // lay.bands, (k + 1) * nx // lay.bands)
            for g in range(n_g) for k in range(lay.bands)]


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plane_layout_bands(shape, dtype, resident):
    """Every row of every glacier in exactly one band, in order, each band
    of ⌊nx/bands⌋ or ⌈nx/bands⌉ rows (at most ``rows``, none empty); each
    glacier the same share, min(nx, ⌊resident/n_g⌋) bands, or one where
    the glaciers outnumber the blocks; the blocks at most ``resident`` and
    the bands they walk at most ``walk`` each; 16-byte vectors where ny
    allows them."""
    n_g, nx, ny = shape
    lay = si_kernel.plane_layout(n_g, nx, ny, dtype, resident)
    bands = _bands(lay, n_g, nx)
    covered = [[0] * nx for _ in range(n_g)]
    for g, a, b in bands:
        assert 1 <= nx // lay.bands <= b - a <= lay.rows == -(-nx // lay.bands)
        for i in range(a, b):
            covered[g][i] += 1
    assert covered == [[1] * nx for _ in range(n_g)]
    for g in range(n_g):
        own = [(a, b) for gg, a, b in bands if gg == g]
        assert [a for a, _ in own] == [0] + [b for _, b in own[:-1]] and own[-1][1] == nx
    assert lay.bands == max(1, min(nx, resident // n_g))
    assert 1 <= lay.blocks <= resident and lay.blocks == min(resident, n_g * lay.bands)
    # block b walks the bands b, b + blocks, ...: every band once
    walked = sorted(k for b in range(lay.blocks) for k in range(b, len(bands), lay.blocks))
    assert walked == list(range(len(bands)))
    assert max(len(range(b, len(bands), lay.blocks)) for b in range(lay.blocks)) == lay.walk
    assert lay.threads == si_kernel.PLANE_THREADS
    assert lay.vec == (ny % (16 // _itemsize(dtype)) == 0)
    assert not si_kernel.plane_layout(n_g, nx, ny, dtype, resident, vec=False).vec


def test_plane_layout_icesheet():
    """On an H100's 132 resident blocks (one of 512 threads an SM): 1 x
    1024^2 takes them all, bands of 7 or 8 rows; 2 x 300^2 takes 66 a
    glacier; 1000 glaciers of 300 x 301 one band each, 8 a block at most,
    one value a thread a step; on 264, 1 x 1024^2 takes bands of 3 or 4."""
    lay = si_kernel.plane_layout(1, 1024, 1024, F32, 132)
    assert (lay.blocks, lay.bands, lay.rows, lay.walk, lay.threads) == (132, 132, 8, 1, 512)
    lay = si_kernel.plane_layout(2, 300, 300, F64, 132)
    assert (lay.blocks, lay.bands, lay.rows, lay.walk) == (132, 66, 5, 1)
    lay = si_kernel.plane_layout(1000, 300, 301, F32, 132)
    assert (lay.blocks, lay.bands, lay.walk, lay.vec) == (132, 1, 8, False)
    lay = si_kernel.plane_layout(1, 1024, 1024, F32, 264)
    assert (lay.blocks, lay.bands, lay.rows, lay.walk) == (264, 264, 4, 1)


def test_plane_source_constants():
    """The scratch holds 8 planes, in the order the source names them; the
    threads, the slot arrays and the assembly's tile stand in the source as
    the plans count them."""
    source = (SRC_DIR / "si_plane.cu").read_text()
    assert si_kernel.PLANE_SCRATCH == 8
    assert "enum Plane { kD = 0, kRhs, kInvDiag, kX, kR, kP, kAp, kP2, kPlanes };" in source
    for name, value in (("kPcgThreads", si_kernel.PLANE_THREADS),
                        ("kLanes", si_kernel.ASM_LANES), ("kGroups", si_kernel.ASM_GROUPS)):
        assert f"constexpr int {name} = {value};" in source
    assert "T* slots;           // [3][n_g * bands]" in source
    assert si_kernel.PLANE_SLOT_ARRAYS == 3
    # the rows axis's scratch opens with the assembly's three planes
    rows = (SRC_DIR / "si_rows.cu").read_text()
    assert re.search(r"enum Plane \{ kD = 0, kRhs, kInvDiag,", rows)
    # the instantiated rows a thread of the assembly
    assert "rows == 4 ? launch_assemble_rows<T, E, 4>" in source
    assert set(si_kernel.ASM_ROWS) == {4, 1}


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("shape", SHAPES)
def test_assemble_layout_tiles(shape, dtype):
    """The assembly's tiles cover the plane: ⌈ny/32⌉ tiles along y, ⌈nx/4R⌉
    along x, the glaciers in z; R = 4 where that launch still has eight
    blocks an SM, else 1; 16-byte loads where ny allows them."""
    n_g, nx, ny = shape
    lay = si_kernel.assemble_layout(n_g, nx, ny, dtype, SMS)
    assert lay.tile_rows == 4 * lay.rows and lay.threads == 128
    assert lay.grid == (-(-ny // 32), -(-nx // lay.tile_rows), n_g)
    assert lay.grid[0] * 32 >= ny and lay.grid[1] * lay.tile_rows >= nx
    blocks4 = n_g * -(-nx // 16) * -(-ny // 32)
    assert lay.rows == (4 if blocks4 >= si_kernel.ASM_BLOCKS_PER_SM * SMS else 1)
    assert lay.width == (16 // _itemsize(dtype) if ny % (16 // _itemsize(dtype)) == 0 else 1)
    assert si_kernel.assemble_layout(n_g, nx, ny, dtype, SMS, vec=False).width == 1


def test_assemble_layout_rank_slab():
    """A rank's 16 x 66 x 128 slab on 132 SMs: tiles of 32 x 4, 1088 blocks
    (R = 4's 320 are too few); 1 x 1024^2: tiles of 32 x 16, 2048 blocks;
    the slab on a card of 40 SMs or fewer, where 320 blocks are eight an
    SM: tiles of 32 x 16."""
    lay = si_kernel.assemble_layout(16, 66, 128, F32, SMS)
    assert (lay.rows, lay.grid, lay.width) == (1, (4, 17, 16), 4)
    lay = si_kernel.assemble_layout(1, 1024, 1024, F64, SMS)
    assert (lay.rows, lay.grid, lay.width) == (4, (32, 64, 1), 2)
    assert si_kernel.assemble_layout(16, 66, 128, F32, 40).grid == (4, 5, 16)
    assert si_kernel.assemble_layout(16, 66, 128, F32, 41).grid == (4, 17, 16)


@pytest.mark.parametrize("bad, match", [
    ((1, 2, 128, F32, 264), "at least 1 glacier of 3 x 3"),
    ((0, 66, 128, F64, 264), "at least 1 glacier of 3 x 3"),
    ((1, 66, 128, torch.float16, 264), "float32 or float64"),
    ((1, 50000, 50000, F32, 264), "a plane of at most 2147483647 cells"),
    ((1, 65536, 32768, F64, 264), "a plane of at most 2147483647 cells"),
    ((1, 1024, 1024, F32, 0), "cannot be co-scheduled"),
    ((4, 300, 300, F64, -3), "cannot be co-scheduled"),
])
def test_plane_layout_refuses(bad, match):
    """A plane the kernel does not take (2^31 cells or more among them), or
    a launch with no block resident, raises ValueError naming why."""
    with pytest.raises(ValueError, match=match):
        si_kernel.plane_layout(*bad)


@pytest.mark.parametrize("bad, match", [
    ((1, 2, 128, F32, SMS), "at least 1 glacier of 3 x 3"),
    ((1, 66, 128, torch.int32, SMS), "float32 or float64"),
    ((70000, 66, 128, F32, SMS), "exceed the launch's grid"),
    ((1, 66, 128, F32, 0), "at least one SM"),
])
def test_assemble_layout_refuses(bad, match):
    with pytest.raises(ValueError, match=match):
        si_kernel.assemble_layout(*bad)
