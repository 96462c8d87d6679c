"""The plan of the row PCG's kernels (``csrc/si_rows.cu``):
:func:`~odinn_tpu_torch.ops.cuda.si_kernel.rows_layout` cuts each glacier's
own rows into one band a block of a cluster. The kernels run only on a CUDA
card, where ``chip_smoke.py`` holds them against their plain versions; here
the plan's arithmetic is checked on the CPU: the bands cover every own row
once and in order, a glacier gets at most 8 blocks, the shared memory fits
a block, the shared memory the plan counts is the kernel's, and a slab the
kernels do not take is refused.
"""

import pytest
import torch

from odinn_tpu_torch.ops.cuda import si_kernel
from odinn_tpu_torch.ops.cuda.build import SRC_DIR
from odinn_tpu_torch.ops.cuda.common import SMEM_PER_BLOCK

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64

# (n_g, nx, ny, r0, r1): a rank's slabs of the rows mesh (the top rank of a
# 128-row plane cut in two, a middle rank, a ragged one whose ny is not a
# multiple of 32, half of a 1024^2 plane with ghosts on both sides), the
# (2 x 2) cut's, a folded batch, and small and odd ones
SLABS = [(16, 66, 128, 0, 64), (16, 68, 128, 2, 66), (3, 41, 100, 2, 39),
         (4, 516, 1024, 2, 514), (2, 65, 128, 0, 63), (128, 66, 128, 0, 64),
         (1, 3, 3, 1, 2), (2, 9, 7, 2, 7), (1, 40, 4000, 2, 38), (5, 300, 301, 1, 299)]


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _bands(lay, r0, r1):
    """Each block's band of rows [a, b), in block order, as the kernels cut
    them (csrc/si_rows.cu, Band)."""
    own = r1 - r0
    return [(r0 + k * own // lay.cluster, r0 + (k + 1) * own // lay.cluster)
            for k in range(lay.cluster)]


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("slab", SLABS)
def test_rows_layout_tiles(slab, dtype):
    """Every own row in exactly one block's band, in order; bands of
    ⌊own/cluster⌋ or ⌈own/cluster⌉ rows, at most ``rows``, none empty; at
    most 8 blocks a glacier and 512 threads a block, in warps; 16-byte
    vectors where ny allows them; the shared memory within a block's."""
    n_g, nx, ny, r0, r1 = slab
    lay = si_kernel.rows_layout(n_g, nx, ny, r0, r1, dtype)
    own = r1 - r0
    bands = _bands(lay, r0, r1)
    assert [a for a, _ in bands] == [r0] + [b for _, b in bands[:-1]] and bands[-1][1] == r1
    assert all(1 <= own // lay.cluster <= b - a <= lay.rows == -(-own // lay.cluster)
               for a, b in bands)
    covered = [0] * nx
    for a, b in bands:
        for i in range(a, b):
            covered[i] += 1
    assert covered == [0] * r0 + [1] * own + [0] * (nx - r1)
    assert 1 <= lay.cluster <= 8 and lay.cluster == min(8, own)
    assert lay.threads % 32 == 0 and 64 <= lay.threads <= 512
    assert lay.vec == (ny % (16 // _itemsize(dtype)) == 0)
    assert lay.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [F32, F64])
def test_rows_layout_rank_slab(dtype):
    """A rank's 16 x 66 x 128 slab: a cluster of 8 blocks a glacier, 128
    blocks in all, a band of 8 full rows a block, one 16-byte vector a
    thread (4 float32 or 2 float64 values), the head alone in shared
    memory."""
    lay = si_kernel.rows_layout(16, 66, 128, 0, 64, dtype)
    assert 16 * lay.cluster >= 128
    assert (lay.cluster, lay.rows) == (8, 8)
    item = _itemsize(dtype)
    assert lay.vec and lay.threads == 8 * 128 * item // 16
    assert lay.smem == 16 + 32 * item


def test_rows_layout_counts_the_kernels_smem():
    """The shared memory the plan counts is the kernel's: the mbarrier's
    bytes, the head values, the cluster and thread bounds stand in the
    source as the plan uses them, and the plan holds the head alone,
    whatever the vector width; a pointer off a 16-byte boundary takes one
    value a thread a step."""
    source = (SRC_DIR / "si_rows.cu").read_text()
    for name, value in (("kBarBytes", si_kernel._ROWS_BAR_BYTES),
                        ("kHeadValues", si_kernel._ROWS_HEAD_VALUES),
                        ("kMaxCluster", si_kernel._ROWS_MAX_CLUSTER),
                        ("kMaxThreads", si_kernel._ROWS_MAX_THREADS)):
        assert f"constexpr int {name} = {value};" in source
    lay = si_kernel.rows_layout(3, 41, 100, 2, 39, F32, vec=False)
    assert not lay.vec and lay.rows == 5 and lay.threads == 512
    assert lay.smem == 16 + 32 * 4
    for dtype in (F32, F64):
        for vec in (True, False):
            lay = si_kernel.rows_layout(1, 40, 4000, 2, 38, dtype, vec=vec)
            assert lay.vec == vec and lay.smem == 16 + 32 * _itemsize(dtype)


def test_rows_layout_large_slab():
    """Half a 1024^2 plane with ghosts (4 x 516 x 1024): 32 blocks, each a
    band of 64 full rows walked by 512 threads, the head alone in shared
    memory."""
    for dtype in (F32, F64):
        lay = si_kernel.rows_layout(4, 516, 1024, 2, 514, dtype)
        assert 4 * lay.cluster == 32 and lay.rows == 64 and lay.threads == 512
        assert lay.smem == 16 + 32 * _itemsize(dtype)


@pytest.mark.parametrize("bad, match", [
    ((1, 2, 128, 0, 1, F32), "at least 1 x 3 x 3"),
    ((1, 66, 2, 0, 64, F64), "at least 1 x 3 x 3"),
    ((0, 66, 128, 0, 64, F32), "at least 1 x 3 x 3"),
    ((1, 66, 128, 0, 67, F32), r"own rows \[0, 67\) outside a slab of 66 rows"),
    ((1, 66, 128, 5, 5, F32), r"own rows \[5, 5\)"),
    ((1, 66, 128, 0, 64, torch.float16), "float32 or float64"),
    ((1, 50000, 50000, 0, 8, F64), "a plane of at most 2147483647 cells"),
])
def test_rows_layout_refuses(bad, match):
    """A slab the kernels do not take raises ValueError naming the limit."""
    with pytest.raises(ValueError, match=match):
        si_kernel.rows_layout(*bad)
