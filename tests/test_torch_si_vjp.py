"""The Python side of the ``si_step_vjp`` pullback kernel
(``csrc/si_step_vjp.cu``): its tiles (:func:`si_vjp_layout`), the cluster
choice (:func:`si_vjp_plan`, with the occupancy query faked), the shapes no
plan takes, and the table it reads in place. The kernel runs only on a CUDA
card, where ``chip_smoke.py`` holds it against its plain version
(``si_step_vjp_reference``, itself held to the JAX package in
``tests/test_torch_si_adjoint.py``). Here: arithmetic, and on the CPU the
wrapper's plain route against JAX's gradient of the same step.
"""

import re

import numpy as np
import pytest
import torch

from odinn_tpu_torch.ops.cuda import si_kernel
from odinn_tpu_torch.ops.cuda.build import SRC_DIR
from odinn_tpu_torch.ops.cuda.common import SMEM_PER_BLOCK, derived_scalars, pick_cluster

F32, F64 = torch.float32, torch.float64

# (nx, ny, dtype) -> (rows, cols, tiles, per_block) at each cluster size:
# bands of full rows, rows = the fewest staged rows a block (per_block ×
# (rows + 2)), then the fewest tiles; at 300² in float64 a band of 19 rows
# does not fit 227 KB, so blocks walk bands of 5 rows through the two-stage
# ring
_TILES = {
    8: {(128, 128, F32): (16, 128, 8, 1), (128, 128, F64): (16, 128, 8, 1),
        (97, 131, F32): (13, 131, 8, 1), (10, 33, F64): (2, 33, 5, 1),
        (300, 300, F32): (10, 300, 30, 4), (300, 300, F64): (5, 300, 60, 8)},
    16: {(128, 128, F32): (8, 128, 16, 1), (128, 128, F64): (8, 128, 16, 1),
         (97, 131, F32): (7, 131, 14, 1), (10, 33, F64): (1, 33, 10, 1),
         (300, 300, F32): (19, 300, 16, 1), (300, 300, F64): (5, 300, 60, 4)},
}


def _smem(rows, cols, itemsize, stages):
    """The kernel's shared memory, counted by hand: 16 bytes of mbarrier,
    64 values, the staged planes (16-byte aligned each) and the corners."""
    pitch = cols + 2 * (16 // itemsize)
    plane = -(-(rows + 2) * pitch * itemsize // 16) * 16
    return 16 + 64 * itemsize + stages * 5 * plane + 4 * (rows + 1) * (cols + 1) * itemsize


def test_vjp_layout_constants_are_the_kernels():
    """The layout counts the shared memory the kernel lays out: the
    constants it uses are the kernel source's."""
    source = (SRC_DIR / "si_step_vjp.cu").read_text()
    for name, value in (("kThreads", si_kernel._VJP_THREADS),
                        ("kBarBytes", si_kernel._VJP_BAR_BYTES),
                        ("kHeadValues", si_kernel._VJP_HEAD_VALUES),
                        ("kPlanes", si_kernel._VJP_PLANES)):
        assert f"constexpr int {name} = {value};" in source
    # the corner's four values, in the arithmetic the kernel shares with the
    # large-plane pullback
    assert '#include "si_vjp_common.cuh"' in source
    common = (SRC_DIR / "si_vjp_common.cuh").read_text()
    assert re.search(r"struct alignas\(16\) Corner \{\s*T D, Q, PX, PY;", common)
    assert si_kernel._VJP_CORNER_VALUES == 4
    # the pullback sums its blocks over distributed shared memory
    assert "ticket" not in source and "__threadfence" not in source and "atomicAdd" not in source


@pytest.mark.parametrize("cluster", [8, 16])
def test_vjp_layout_arithmetic(cluster):
    """Rows, columns, tiles and tiles a block at each cluster size, the
    shared memory against a count by hand, and the two-stage ring exactly
    where a block walks more than one tile."""
    for (nx, ny, dtype), want in _TILES[cluster].items():
        lay = si_kernel.si_vjp_layout(nx, ny, dtype, cluster)
        assert (lay.rows, lay.cols, lay.tiles, lay.per_block) == want, (nx, ny, dtype)
        itemsize = torch.empty((), dtype=dtype).element_size()
        assert lay.stages == (2 if lay.per_block > 1 else 1)
        assert lay.smem == _smem(lay.rows, lay.cols, itemsize, lay.stages) <= SMEM_PER_BLOCK
        assert lay.fits and lay.cluster == cluster and lay.bx == si_kernel._VJP_THREADS
        assert lay.tiles == -(-nx // lay.rows) * -(-ny // lay.cols)
        assert lay.per_block == -(-lay.tiles // cluster)
    # the main path's bands: one halo row above and below 16 (8) rows
    lay = si_kernel.si_vjp_layout(128, 128, F32, 8)
    assert lay.smem == 16 + 256 + 5 * 18 * 136 * 4 + 4 * 17 * 129 * 4


@pytest.mark.parametrize("shape", [(128, 128), (97, 131), (10, 33), (30, 17), (12, 700),
                                   (300, 300)])
def test_vjp_tiles_cover_the_plane_once(shape):
    """The blocks' tiles (block rank walks rank, rank + cluster, ...) hold
    every cell of the plane once, and own every corner once; a row wider
    than the shared memory takes column chunks of a multiple of 16 bytes."""
    nx, ny = shape
    for dtype in (F32, F64):
        for cluster in (8, 16):
            lay = si_kernel.si_vjp_layout(nx, ny, dtype, cluster)
            ntc = -(-ny // lay.cols)
            if ntc > 1:
                assert lay.cols * torch.empty((), dtype=dtype).element_size() % 16 == 0
            cells = np.zeros((nx, ny), dtype=int)
            corners = np.zeros((nx - 1, ny - 1), dtype=int)
            for rank in range(cluster):
                walked = range(rank, lay.tiles, cluster)
                assert len(walked) <= lay.per_block
                for tile in walked:
                    r0, c0 = (tile // ntc) * lay.rows, (tile % ntc) * lay.cols
                    cells[r0:r0 + lay.rows, c0:c0 + lay.cols] += 1
                    corners[r0:r0 + lay.rows, c0:c0 + lay.cols] += 1
            assert (cells == 1).all() and (corners == 1).all(), (shape, dtype, cluster)


def test_vjp_plan_choice():
    """The cluster choice the SI and RKC plans share, on the pullback's
    layouts (occupancy faked; device -1 selects no device): 16 blocks when
    all n_g clusters of 16 are resident at once, else 8; nothing that can
    be scheduled raises."""

    def occupancy(active):
        def query(c, lay, n):
            n._obj.value = active[c]
            return 0
        return query

    lay = {c: si_kernel.si_vjp_layout(128, 128, F32, c) for c in (8, 16)}
    resident = {8: 30, 16: 21}
    assert pick_cluster("si_step_vjp", lay, occupancy(resident), 16, -1) == (lay[16], resident)
    assert pick_cluster("si_step_vjp", lay, occupancy({8: 15, 16: 14}), 16, -1)[0] == lay[8]
    assert pick_cluster("si_step_vjp", lay, occupancy({8: 15, 16: 7}), 4, -1)[0] == lay[16]
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        pick_cluster("si_step_vjp", lay, occupancy({8: 0, 16: 0}), 4, -1)


@pytest.mark.parametrize("shape", [(3, 100_000), (65_536, 32_768)])
def test_vjp_unplannable_shape_raises(shape):
    """A row too wide for 64 column chunks in shared memory, or a plane of
    2³¹ cells (the kernel's 32-bit index), fits no layout: the plan raises
    before it asks any device."""
    nx, ny = shape
    for c in (8, 16):
        assert not si_kernel.si_vjp_layout(nx, ny, F32, c).fits
    with pytest.raises(ValueError, match="no cluster layout"):
        si_kernel.si_vjp_plan(2, nx, ny, F32, device="cuda:0")


def test_vjp_reads_the_table_in_place():
    """The kernel reads the derived (n_g, 8) table in place, with its row
    stride, when it is in the planes' dtype or in float64 (the training's
    float32 planes with the float64 table of the laws), so no copy is
    launched; any other table is copied to (n_g, 4) in the planes' dtype."""
    raw = torch.tensor([[100.0, 90.0, 8e-19, 0.0, 3.0, 3.0, 0.0],
                        [100.0, 90.0, 3e-18, 2e-18, 3.0, 3.0, 0.0]], dtype=F64)
    d64 = derived_scalars(*(raw[:, k] for k in range(7)), 900.0, 9.81).requires_grad_(True)
    for table, dtype in ((d64, F32), (d64, F64), (d64.detach().float(), F32)):
        got = si_kernel._vjp_table(table, dtype)
        assert got.data_ptr() == table.data_ptr() and got.stride() == (8, 1)
        assert not got.requires_grad
    for table, dtype in ((d64.detach().float(), F64), (d64.detach().half(), F32),
                         (d64.detach().t().contiguous().t(), F32)):
        got = si_kernel._vjp_table(table, dtype)
        assert got.data_ptr() != table.data_ptr() and got.dtype == dtype
        assert got.shape == (2, 4) and got.is_contiguous()
        torch.testing.assert_close(got, table[:, :4].to(dtype), rtol=0, atol=0)


def test_si_step_vjp_on_cpu_is_jax_pullback():
    """On a CPU tensor the wrapper is the plain version: the residual's
    pullback at λ, whose (dH, dH_D, dB) and table cotangents equal JAX's
    vector-Jacobian product of the same residual b − A(D)·x (x fixed) on
    a ragged plane, with sliding on one glacier, θ = ½; 1e-10."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_kernels import _inputs

    H, B, raw = _inputs(n_g=2, nx=13, ny=21)
    rng = np.random.default_rng(3)
    H_D = 0.97 * H - 1.0
    x = 0.99 * H + rng.standard_normal(H.shape)
    lam = rng.standard_normal(H.shape)
    dt, theta = 1.0 / 12.0, 0.5
    t = torch.from_numpy
    table = derived_scalars(*(t(raw[:, k]) for k in range(7)), 900.0, 9.81)
    got = si_kernel.si_step_vjp(t(lam), t(H), t(H_D), t(B), t(x), table, dt, theta)
    want = si_kernel.si_step_vjp_reference(t(lam), t(H), t(H_D), t(B), t(x), table, dt, theta)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    jt = table.numpy()
    inv = 1.0 / jt[:, :2]

    def residual(Hj, HDj, Bj, creep, slide):
        """b − A(D)·x of the θ-step, D frozen at H_D, written out in jnp."""
        hc = jnp.maximum(HDj, 0.0)
        S = Bj + hc
        idx, idy = inv[:, 0, None, None], inv[:, 1, None, None]
        gx = 0.5 * ((S[:, 1:, :-1] - S[:, :-1, :-1]) * idx + (S[:, 1:, 1:] - S[:, :-1, 1:]) * idx)
        gy = 0.5 * ((S[:, :-1, 1:] - S[:, :-1, :-1]) * idy + (S[:, 1:, 1:] - S[:, 1:, :-1]) * idy)
        sq = gx * gx + gy * gy
        gn = jnp.sqrt(jnp.where(sq > 0, sq, 1.0)) * (sq > 0)
        hb = 0.25 * (hc[:, :-1, :-1] + hc[:, 1:, :-1] + hc[:, :-1, 1:] + hc[:, 1:, 1:])
        D = (slide[:, None, None] * hb ** 4 * gn ** 2 + creep[:, None, None] * hb ** 5 * gn ** 2)
        M = np.zeros(H.shape[1:])
        M[1:-1, 1:-1] = 1.0
        u = Bj + (1 - M) * Hj + M * ((1 - theta) * Hj + theta * x)

        def div(v):
            out = jnp.zeros_like(v)
            fx = 0.5 * (D[:, :, :-1] + D[:, :, 1:]) * (v[:, 1:, 1:-1] - v[:, :-1, 1:-1]) * idx
            fy = 0.5 * (D[:, :-1, :] + D[:, 1:, :]) * (v[:, 1:-1, 1:] - v[:, 1:-1, :-1]) * idy
            inner = (fx[:, 1:, :] - fx[:, :-1, :]) * idx + (fy[:, :, 1:] - fy[:, :, :-1]) * idy
            return out.at[:, 1:-1, 1:-1].set(inner)

        return Hj - x + dt * M * div(u)

    _, pull = jax.vjp(residual, *(jnp.asarray(a) for a in (H, H_D, B)),
                      jnp.asarray(jt[:, 2]), jnp.asarray(jt[:, 3]))
    j_dH, j_dHD, j_dB, j_dc, j_ds = pull(jnp.asarray(lam))
    for a, b in zip(got, (j_dH, j_dHD, j_dB, j_dc, j_ds)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()
