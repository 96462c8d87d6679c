"""Fused semi-implicit θ-step (A target, per-glacier scalar laws).

``si_step`` launches the hand-written CUDA kernels of ``csrc/si_step.cu``
(or, on a large plane, ``csrc/si_plane.cu``) on a CUDA tensor and runs
their plain PyTorch version, :func:`si_step_reference`, on a CPU tensor.
It replaces the TPU kernel ``odinn_tpu.ops.pallas.si_kernel.si_step_pallas``:
the frozen staggered diffusivity at ``H_D``, the right-hand side
b = H + dt·M·∇·(D∇(B + ring·H + (1−θ)·M·H)), the Jacobi inverse diagonal,
``cg_iters`` preconditioned-CG iterations from ``x0`` on
A = I − θ·dt·M·∇·(D∇(M·)), and a final relu. M is the interior mask.

On the card the step is one launch (two on a large plane): one
thread-block cluster of 8 or 16 blocks per glacier (:func:`si_layout`,
chosen by occupancy in :func:`si_plan`), with each thread's cells' CG state
in registers, p in shared memory and the dot products summed across the
cluster in a fixed order, the blocks' partials exchanged through
distributed shared memory and counted on mbarriers. A plane whose layout fits no cluster takes the
large-plane path of ``csrc/si_plane.cu``, chosen by shape alone: the
assembly over tiles of the batch (:func:`assemble_layout`), then one
cooperative launch of as many blocks as the card holds at once
(:func:`plane_plan`), each glacier an equal share of them, a block a band of
its rows, with the CG vectors in a global scratch of ``PLANE_SCRATCH``
planes, two grid barriers an iteration and each glacier's dot products
summed over its bands in one fixed order in every block; a launch of it
also counts on ``si_step.plane_launches``.

``si_step`` is differentiable in H, H_D, B and the creep and slide columns
(2, 3) of the table, with the gradient of the JAX package's production step
``implicit.semi_implicit_step`` (``lax.custom_linear_solve``), not the TPU
kernel's ``_bwd``, which differentiates the unrolled PCG: x0, the spacings
and the Jacobi preconditioner get none. Under grad the forward also keeps
the pre-relu solution x. The backward (module doc of
:mod:`odinn_tpu_torch.ops.si_math`) is two launches on the card:
:func:`si_step_transpose`, the same kernel in its transpose-solve mode
(λ = PCG(A, g) from g = ḡ·[x > 0], at the forward's layout, so α and β are
again bit-identical in every block), and :func:`si_step_vjp`, the pullback
kernel ``csrc/si_step_vjp.cu`` (the residual's cotangents at λ through b and
the frozen D, down to H, H_D, B, creep and slide; one thread-block cluster
per glacier, tiles of :func:`si_vjp_layout`, cluster size by
:func:`si_vjp_plan`), or, on a plane whose step takes the large-plane path,
``csrc/si_plane_vjp.cu``: tiles of 32 × 4R cells over the whole batch
(:func:`plane_vjp_layout`), each glacier's two sums finished by its last
block in block order; a launch of it also counts on
``si_step_vjp.plane_launches``. Their plain versions are
:func:`si_step_transpose_reference` and :func:`si_step_vjp_reference`;
autograd through :func:`si_step_reference` is the whole plain backward. The
two contracts agree where PCG has converged (``tests/test_torch_si_adjoint.py``).

Its tangent (forward mode through ``torch.autograd.forward_ad``; module doc
of :mod:`odinn_tpu_torch.ops.cuda.common`) is ``lax.custom_linear_solve``'s,
as :mod:`odinn_tpu_torch.ops.si_math` states it: the residual's tangent ṙ,
formed by PyTorch ops (:func:`si_step_residual_tangent`: Ḋ from the
tangents of H_D, B and the creep and slide columns, then
``si_math.residual_tangent``), then :func:`si_step_tangent`, the kernel in
its tangent-solve mode at the forward's layout (ẋ = PCG(A, ṙ) from the
primal guess x0, masked by the forward's x > 0; one launch counted on
``si_step_tangent.launches``; plain version :func:`si_step_tangent_reference`).
A tangent on the spacings or the exponent columns raises; x0's is ignored,
as JAX ignores the guess's.

``precondition=False`` runs the step and the transpose solve as plain CG
(the kernels' no-preconditioner mode, plain version ``si_math.cg`` with no
preconditioner): the solves of the hand-written SI/SI2 transposes,
:mod:`odinn_tpu_torch.inverse.gradient`, which also read the forward's
pre-relu solution (``keep_x``).

On a row shard (``parallel.spatial.RowShard``; :func:`si_rows_step`) the
step runs on the slab of the own rows plus two ghost rows on each side:
:func:`si_assemble`, the large-plane path's assembly kernel alone (its
C entry ``si_assemble_*`` of ``csrc/si_plane.cu``), into a scratch of
``si_math.ROWS_PLANES`` planes, then the PCG split at its two
reductions (``si_math.rows_cg``) on the kernels of ``csrc/si_rows.cu``:
:func:`si_rows_apply` (A·p on the own rows after p = z + β·p on the whole
slab, and each glacier's partial p·Ap; in its start mode r = b − A·x0,
z and the partial r·z) and :func:`si_rows_update` (x += α·p, r −= α·Ap,
z = M⁻¹r and the partial r·z). Each launch gives a glacier one
thread-block cluster of up to 8 blocks, each a band of its own rows
(:func:`rows_layout`); the apply reads its band with a halo through L1, and
each glacier's partials are summed in a fixed order across the cluster
through distributed shared memory, so a rerun is bitwise the same. Their plain
versions, :func:`si_rows_apply_reference` and
:func:`si_rows_update_reference`, are built from ``si_math``'s pieces. The
backward is the transpose solve by the same PCG (its b = ḡ·[x > 0] formed
on the own rows and exchanged, so the assembly runs in its tangent mode, b
as given) and :func:`si_step_vjp` on the slab (routed by the slab's shape,
as the whole plane's is) with λ zero on the ghost rows; the tangent is the
residual's tangent on the slab and the tangent solve.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from odinn_tpu_torch.ops import si_math
from odinn_tpu_torch.ops import stencils as st
from odinn_tpu_torch.ops.cuda.build import load_library
from odinn_tpu_torch.ops.cuda.common import (
    GLEN_EXPS, SMEM_PER_BLOCK, block_shape, check_inputs, diffusivity_tangent, has_tangent,
    needs_function, pick_cluster, pow_pos, refuse_tangent, shared_exps, ticket_buffers,
    uses_glen)

__all__ = ["si_step", "si_step_reference", "si_step_transpose", "si_step_transpose_reference",
           "si_step_vjp", "si_step_vjp_reference", "si_step_tangent", "si_step_tangent_reference",
           "si_step_residual_tangent", "si_layout", "si_fits", "si_plan", "si_vjp_layout",
           "si_vjp_plan", "si_assemble", "si_assemble_reference", "si_rows_apply",
           "si_rows_apply_reference", "si_rows_update", "si_rows_update_reference",
           "RowsLayout", "rows_layout", "rows_occupancy", "rows_step_x", "rows_step_transpose",
           "si_rows_step", "AssembleLayout", "assemble_layout", "assemble_plan",
           "PlaneLayout", "plane_layout",
           "plane_occupancy", "plane_plan", "PlaneVjpLayout", "plane_vjp_layout",
           "plane_vjp_plan"]

# the kernel's modes (csrc/si_step.cu): the step, the transpose solve of its
# backward, the tangent solve of its jvp
_FORWARD, _TRANSPOSE, _TANGENT = 0, 1, 2
# the derived table's columns the step differentiates: creep and slide
_RATE_COLS = (2, 3)
_FIXED_COLS = (0, 1, 4, 5, 6, 7)

# csrc/si_step.cu's cluster kernel: the cells a thread owns at most, the
# cluster sizes, and the shared memory a block holds besides its slab of
# rows + 2 rows (two halo rows of z; 64 values: the blocks' partials of the
# two dot products, two rounds of the warps' partials; two 8-byte mbarriers
# ahead of them). The kernel has no static shared memory: this is all of it.
_MAX_CELLS = 8
_CLUSTERS = (8, 16)
_EXTRA_ROWS = 2
_EXTRA_VALUES = 64
_BAR_BYTES = 16


def _frozen_D_scalar(H_D, B, dx, dy, creep, slide, exps):
    """D = creep·H̄^{n+2}·|∇S|^{n−1} + slide·H̄^{p−q+1}·|∇S|^{p−1} at H_D."""
    e_hc, e_sc, e_hs, e_ss = exps
    Hc = st.relu_strict(H_D)
    S = B + Hc
    gsx, gsy = st.grad_slope(S, dx, dy)
    grad_s = st.safe_norm(gsx, gsy)
    hbar = st.avg(Hc)
    return creep * pow_pos(hbar, e_hc) * pow_pos(grad_s, e_sc) + slide * pow_pos(
        hbar, e_hs) * pow_pos(grad_s, e_ss)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library, its entry points' signatures declared once."""
    lib = load_library("si_step")
    for fn in (lib.si_step_cluster_f32, lib.si_step_cluster_f64):
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_double] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_double] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.si_step_occupancy.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.si_step_occupancy.restype = ctypes.c_int
    return lib


@functools.cache
def _plane_library() -> ctypes.CDLL:
    """``csrc/si_plane.cu``: the assembly and the large-plane path."""
    lib = load_library("si_plane")
    for fn in (lib.si_assemble_f32, lib.si_assemble_f64):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_double] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_double] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for fn in (lib.si_plane_f32, lib.si_plane_f64):
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_double] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_double] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.si_pcg_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.si_pcg_occupancy.restype = ctypes.c_int
    return lib


# csrc/si_plane.cu's assembly: tiles of 32 cells along y by 4·R rows, one
# block of 128 threads a tile, R among the instantiated rows a thread; the
# blocks an SM below which R = 1's launch is taken: on an H100 (132 SMs) at
# a rank's 16 x 66 x 128 slab (320 blocks at R = 4) R = 1 took 0.0036 ms
# and R = 4 0.0042, at 1 x 1024^2 (2048) R = 4 0.0124 and R = 1 0.0169
# (PERF.md, profile_plane.py); the launch's grid limit along x and glaciers
ASM_LANES = 32
ASM_GROUPS = 4
ASM_THREADS = ASM_LANES * ASM_GROUPS
ASM_ROWS = (4, 1)
ASM_BLOCKS_PER_SM = 8
_GRID_LIMIT = 65535


class AssembleLayout(NamedTuple):
    """How the assembly tiles a launch (:func:`assemble_layout`)."""

    rows: int                      # cells a thread owns down its column (R)
    tile_rows: int                 # rows of a tile: ASM_GROUPS × rows
    width: int                     # values a load of H_D, B and H along y: 16 bytes, or 1
    grid: Tuple[int, int, int]     # (tiles along y, tiles along x, glaciers)
    threads: int = ASM_THREADS

    def launch_args(self):
        """The C entries' plan arguments: rows a thread, 16-byte loads."""
        return self.rows, int(self.width > 1)


def assemble_layout(n_g, nx, ny, dtype, sms, vec=True) -> AssembleLayout:
    """The assembly's plan for n_g glaciers of nx × ny on a card of ``sms``
    SMs: tiles of 32 cells along y by 4·R rows, R 4 where that launch still
    has ASM_BLOCKS_PER_SM blocks an SM, else 1: fewer rows a block, more
    blocks in flight at once and less arithmetic after each block's loads;
    loads of 16 bytes where ``vec`` (the caller's H, H_D and B 16-byte
    aligned) and ny a multiple of the vector allow it, else of one value.
    What the kernel does not take raises ValueError."""
    rows, width, grid = _tiles("si_assemble", n_g, nx, ny, dtype, sms, vec, ASM_BLOCKS_PER_SM)
    return AssembleLayout(rows, ASM_GROUPS * rows, width, grid)


def _tiles(name, n_g, nx, ny, dtype, sms, vec, blocks_per_sm):
    """(R, load width, grid) of a launch of ASM_LANES × ASM_GROUPS·R tiles,
    the glacier in z (si_assemble's and si_plane_vjp's): R 4 where that
    launch has ``blocks_per_sm`` blocks an SM, else 1; 16-byte loads where
    ``vec`` and ny allow them. What the kernel ``name`` does not take raises
    ValueError."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: float32 or float64, got {dtype}")
    if n_g < 1 or nx < 3 or ny < 3:
        raise ValueError(f"{name}: at least 1 glacier of 3 x 3 cells, got {n_g} x {nx} x {ny}")
    if sms < 1:
        raise ValueError(f"{name}: a card of at least one SM, got {sms}")
    v = 16 // torch.empty((), dtype=dtype).element_size()
    tiles_y = -(-ny // ASM_LANES)
    rows = next((r for r in ASM_ROWS
                 if n_g * -(-nx // (ASM_GROUPS * r)) * tiles_y >= blocks_per_sm * sms),
                ASM_ROWS[-1])
    grid = (tiles_y, -(-nx // (ASM_GROUPS * rows)), n_g)
    if grid[1] > _GRID_LIMIT or n_g > _GRID_LIMIT:
        raise ValueError(f"{name}: {n_g} glaciers of {nx} rows exceed the launch's grid "
                         f"({grid}, at most {_GRID_LIMIT} along x and glaciers)")
    return rows, v if vec and ny % v == 0 else 1, grid


def _device_index(device) -> int:
    """A CUDA device's index (None: the current device)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _sm_count(device_index) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def assemble_plan(n_g, nx, ny, dtype, vec=True, device=None) -> AssembleLayout:
    """:func:`assemble_layout` at the CUDA device's SM count."""
    index = _device_index(device)
    return assemble_layout(n_g, nx, ny, dtype, _sm_count(index), vec)


# csrc/si_plane.cu's PCG: threads a block, the scratch's planes (D, b, the
# inverse diagonal, x, r, p, Ap and p's second buffer), the slot arrays (p·Ap
# and the two r·z rounds), and the cells a plane may hold (32-bit indices)
PLANE_THREADS = 512
PLANE_SCRATCH = 8
PLANE_SLOT_ARRAYS = 3
_PLANE_MAX_CELLS = 2 ** 31 - 1


class PlaneLayout(NamedTuple):
    """How the large-plane PCG lays a batch on the card (:func:`plane_layout`):
    glacier g's band k (of ``bands``) is rows ⌊k·nx/bands⌋ to
    ⌊(k+1)·nx/bands⌋, the full width; block b walks the bands b, b +
    blocks, … of the n_g·bands in glacier order."""

    blocks: int       # blocks of the cooperative launch
    bands: int        # bands a glacier
    rows: int         # rows a band at most: ⌈nx / bands⌉
    threads: int      # threads a block
    walk: int         # bands a block walks at most
    vec: bool         # 16-byte vectors (ny and the pointers allow them)

    def launch_args(self):
        """The C entries' plan arguments: blocks, bands, threads, vectors."""
        return self.blocks, self.bands, self.threads, int(self.vec)


def plane_layout(n_g, nx, ny, dtype, resident, vec=True) -> PlaneLayout:
    """The large-plane PCG's plan for n_g glaciers of nx × ny on a card that
    holds ``resident`` blocks of it at once (occupancy × SMs): every glacier
    an equal share of them, min(nx, ⌊resident / n_g⌋) bands of full rows,
    one a block; with more glaciers than resident blocks one band a
    glacier, and each of the ``resident`` blocks walks several. The blocks
    never exceed ``resident``: a grid barrier needs them all resident at
    once. 16-byte vectors where ``vec`` (the pointers aligned) and ny allow
    them. A plane the kernel does not take, or a launch that cannot be
    co-scheduled (no block resident), raises ValueError."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"si_plane: float32 or float64, got {dtype}")
    if n_g < 1 or nx < 3 or ny < 3:
        raise ValueError(f"si_plane: at least 1 glacier of 3 x 3 cells, got "
                         f"{n_g} x {nx} x {ny}")
    if nx * ny > _PLANE_MAX_CELLS:
        raise ValueError(f"si_plane: a plane of at most {_PLANE_MAX_CELLS} cells (32-bit "
                         f"indices), got {nx} x {ny}")
    if resident < 1:
        raise ValueError(f"si_plane: no block of the cooperative PCG is resident on the card "
                         f"({resident}); a grid barrier cannot be co-scheduled")
    v = 16 // torch.empty((), dtype=dtype).element_size()
    bands = max(1, min(nx, resident // n_g))
    total = n_g * bands
    blocks = min(resident, total)
    if PLANE_SLOT_ARRAYS * total > _PLANE_MAX_CELLS:
        raise ValueError(f"si_plane: {n_g} glaciers need more slots than 32-bit indices hold")
    return PlaneLayout(blocks, bands, -(-nx // bands), PLANE_THREADS, -(-total // blocks),
                       bool(vec and ny % v == 0))


@functools.lru_cache(maxsize=None)
def _plane_resident(dtype, vec, device_index) -> int:
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _plane_library().si_pcg_occupancy(int(dtype == torch.float64), int(vec),
                                                PLANE_THREADS, ctypes.byref(per_sm),
                                                ctypes.byref(sms))
    if err != 0:
        raise RuntimeError(f"si_plane: the occupancy query failed with CUDA error {err}")
    return per_sm.value * sms.value


def plane_occupancy(dtype, vec=True, device=None) -> int:
    """The large-plane PCG's blocks resident at once on a CUDA device:
    cudaOccupancyMaxActiveBlocksPerMultiprocessor × the SM count."""
    index = _device_index(device)
    return _plane_resident(dtype, bool(vec), index)


def plane_plan(n_g, nx, ny, dtype, vec=True, device=None) -> PlaneLayout:
    """:func:`plane_layout` at the device's resident blocks
    (:func:`plane_occupancy`)."""
    return plane_layout(n_g, nx, ny, dtype, plane_occupancy(dtype, vec, device), vec)


@functools.cache
def _plane_vjp_library() -> ctypes.CDLL:
    """``csrc/si_plane_vjp.cu``: the pullback on a large plane."""
    lib = load_library("si_plane_vjp")
    for fn in (lib.si_plane_vjp_f32, lib.si_plane_vjp_f64):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_long, ctypes.c_int]
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_double] * 2
                       + [ctypes.c_int] + [ctypes.c_double] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# csrc/si_plane_vjp.cu: the assembly's tiles (ASM_LANES × ASM_GROUPS·R
# cells, one block of ASM_THREADS a tile, R among ASM_ROWS), R = 4 where
# that launch still has PLANE_VJP_BLOCKS_PER_SM blocks an SM: on an H100
# (132 SMs) R = 4 beat R = 1 at every plane timed, 2 x 300^2 (380 blocks)
# 0.0066 ms against 0.0086, 1 x 1024^2 0.020 against 0.031 (PERF.md,
# profile_plane.py); each block one slot of each of the glacier's two sums
PLANE_VJP_BLOCKS_PER_SM = 2
PLANE_VJP_SUMS = 2


class PlaneVjpLayout(NamedTuple):
    """How the large-plane pullback tiles a launch (:func:`plane_vjp_layout`):
    block (bx, by, g) takes glacier g's cells of rows by·tile_rows to
    (by + 1)·tile_rows and columns 32·bx to 32·(bx + 1), and its slot by·
    grid[0] + bx of each of the glacier's two sums."""

    rows: int                      # cells a thread owns down its column (R)
    tile_rows: int                 # rows of a tile: ASM_GROUPS × rows
    width: int                     # values a load along y: 16 bytes, or 1
    grid: Tuple[int, int, int]     # (tiles along y, tiles along x, glaciers)
    slots: int                     # blocks a glacier: grid[0] × grid[1]
    threads: int = ASM_THREADS

    def launch_args(self):
        """The C entries' plan arguments: rows a thread, 16-byte loads."""
        return self.rows, int(self.width > 1)


def plane_vjp_layout(n_g, nx, ny, dtype, sms, vec=True) -> PlaneVjpLayout:
    """The large-plane pullback's plan for n_g glaciers of nx × ny on a card
    of ``sms`` SMs: tiles of 32 cells along y by 4·R rows, R 4 where that
    launch still has PLANE_VJP_BLOCKS_PER_SM blocks an SM, else 1; loads of
    16 bytes where ``vec`` (the caller's input planes 16-byte aligned) and
    ny a multiple of the vector allow it, else of one value; a slot of each
    sum a block. What the kernel does not take raises ValueError."""
    if nx * ny > _PLANE_MAX_CELLS:
        raise ValueError(f"si_plane_vjp: a plane of at most {_PLANE_MAX_CELLS} cells (32-bit "
                         f"indices), got {nx} x {ny}")
    rows, width, grid = _tiles("si_plane_vjp", n_g, nx, ny, dtype, sms, vec,
                               PLANE_VJP_BLOCKS_PER_SM)
    return PlaneVjpLayout(rows, ASM_GROUPS * rows, width, grid, grid[0] * grid[1])


def plane_vjp_plan(n_g, nx, ny, dtype, vec=True, device=None) -> PlaneVjpLayout:
    """:func:`plane_vjp_layout` at the CUDA device's SM count."""
    return plane_vjp_layout(n_g, nx, ny, dtype, _sm_count(_device_index(device)), vec)


@functools.cache
def _rows_library() -> ctypes.CDLL:
    lib = load_library("si_rows")
    for fn in (lib.si_rows_apply_f32, lib.si_rows_apply_f64):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_double]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    for fn in (lib.si_rows_update_f32, lib.si_rows_update_f64):
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    lib.si_rows_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.si_rows_occupancy.restype = ctypes.c_int
    return lib


# csrc/si_rows.cu: blocks a glacier at most (a portable cluster), threads a
# block at most, and the dynamic shared memory (all of it): an 8-byte
# mbarrier padded to 16 bytes, then 32 values (block 0's slots, the warps'
# partials); the cells a plane may hold (32-bit indices).
_ROWS_MAX_CLUSTER = 8
_ROWS_MAX_THREADS = 512
_ROWS_BAR_BYTES = 16
_ROWS_HEAD_VALUES = 32
_ROWS_MAX_CELLS = 2 ** 31 - 1


class RowsLayout(NamedTuple):
    """How the row PCG's kernels cut each glacier's own rows [r0, r1) over a
    cluster: block k of ``cluster`` owns the band of rows r0 + ⌊k·own /
    cluster⌋ to r0 + ⌊(k + 1)·own / cluster⌋, the full width."""

    cluster: int      # blocks a glacier
    rows: int         # rows a band at most: ⌈own / cluster⌉
    threads: int      # threads a block
    smem: int         # shared memory a block, bytes
    vec: bool         # 16-byte vectors (ny and the pointers allow them)

    def launch_args(self):
        """The C entries' plan arguments: cluster, threads, shared memory
        and the vector width."""
        return self.cluster, self.threads, self.smem, int(self.vec)


@functools.lru_cache(maxsize=None)
def rows_layout(n_g, nx, ny, r0, r1, dtype, vec=True) -> RowsLayout:
    """The row PCG kernels' plan for n_g glaciers' slabs of nx × ny with own
    rows [r0, r1): min(8, own) blocks a glacier, each a band of the own
    rows; threads one a vector of the widest band, in warps, 64 to 512 (a
    vector is 16 bytes where ``vec``, the caller's pointers being 16-byte
    aligned, and ny allow it, else one value); shared memory for the
    cluster's sum alone. A slab the kernels do not take raises
    ValueError."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"si_rows: float32 or float64, got {dtype}")
    if n_g < 1 or nx < 3 or ny < 3:
        raise ValueError(f"si_rows: a slab of at least 1 x 3 x 3 cells, got {n_g} x {nx} x {ny}")
    if nx * ny > _ROWS_MAX_CELLS:
        raise ValueError(f"si_rows: a plane of at most {_ROWS_MAX_CELLS} cells (32-bit "
                         f"indices), got {nx} x {ny}")
    if not 0 <= r0 < r1 <= nx:
        raise ValueError(f"si_rows: own rows [{r0}, {r1}) outside a slab of {nx} rows")
    itemsize = torch.empty((), dtype=dtype).element_size()
    v = 16 // itemsize if vec and ny % (16 // itemsize) == 0 else 1
    own = r1 - r0
    cluster = min(_ROWS_MAX_CLUSTER, own)
    rows = -(-own // cluster)
    threads = min(_ROWS_MAX_THREADS, max(64, -(-(rows * ny // v) // 32) * 32))
    return RowsLayout(cluster, rows, threads, _ROWS_BAR_BYTES + _ROWS_HEAD_VALUES * itemsize,
                      v > 1)


def rows_occupancy(lay: RowsLayout, dtype, device=None) -> int:
    """cudaOccupancyMaxActiveClusters of si_rows_apply's iteration mode at
    the plan ``lay``: the clusters resident at once on the device."""
    device = torch.device("cuda") if device is None else torch.device(device)
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _rows_library().si_rows_occupancy(int(dtype == torch.float64), int(lay.vec),
                                                lay.cluster, lay.threads, lay.smem,
                                                ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"si_rows: the occupancy query failed with CUDA error {err}")
    return n.value


class SILayout(NamedTuple):
    """How the cluster kernel lays one glacier's (nx, ny) plane on a cluster."""

    cluster: int      # blocks per glacier
    rows: int         # rows a block owns: ⌈nx / cluster⌉
    bx: int           # threads along ny (a multiple of 32)
    by: int           # threads along rows
    cells: int        # cells a thread owns
    smem: int         # shared memory per block, bytes
    idle_blocks: int  # blocks of the cluster that own no row

    @property
    def fits(self) -> bool:
        return self.smem <= SMEM_PER_BLOCK and self.cells <= _MAX_CELLS


@functools.lru_cache(maxsize=None)
def si_layout(nx, ny, dtype, cluster) -> SILayout:
    """The cluster kernel's layout at a cluster size: rows = ⌈nx/cluster⌉ a
    block, the threads of :func:`~odinn_tpu_torch.ops.cuda.common.block_shape`,
    and shared memory for two mbarriers, M·p over rows + 2 rows, two halo
    rows of z and 64 values."""
    rows = -(-nx // cluster)
    bx, by, cells = block_shape(rows, ny)
    itemsize = torch.empty((), dtype=dtype).element_size()
    smem = _BAR_BYTES + ((rows + 2 + _EXTRA_ROWS) * ny + _EXTRA_VALUES) * itemsize
    return SILayout(cluster, rows, bx, by, cells, smem, cluster - -(-nx // rows))


def si_fits(nx, ny, dtype) -> bool:
    """Whether one glacier's (nx, ny) plane of ``dtype`` takes the cluster
    kernel (at some cluster size); any other plane takes the large-plane
    path."""
    return any(si_layout(nx, ny, dtype, c).fits for c in _CLUSTERS)


class SIPlan(NamedTuple):
    layout: Optional[SILayout]   # the chosen cluster layout; None: the large-plane path
    max_active: dict             # cluster size -> cudaOccupancyMaxActiveClusters (0: no fit)

    @property
    def path(self) -> str:
        return "large-plane" if self.layout is None else f"cluster of {self.layout.cluster}"


@functools.lru_cache(maxsize=None)
def _plan(dtype, nx, ny, n_g, glen, device_index) -> SIPlan:
    if not si_fits(nx, ny, dtype):
        return SIPlan(None, {})
    lib = _library()

    def occupancy(c, lay, active):
        return lib.si_step_occupancy(int(dtype == torch.float64), int(glen), c, lay.bx, lay.by,
                                     lay.smem, lay.cells, active)

    layouts = {c: si_layout(nx, ny, dtype, c) for c in _CLUSTERS}
    return SIPlan(*pick_cluster("si_step", layouts, occupancy, n_g, device_index))


def si_plan(n_g, nx, ny, dtype, exps=GLEN_EXPS, device=None) -> SIPlan:
    """How a launch over n_g glaciers runs on a CUDA device. A plane that
    fits a cluster (:func:`si_fits`) takes the cluster kernel, of 16 blocks
    when the occupancy API says all n_g clusters of 16 are resident at once,
    or when the plane fits only at 16, else of 8; a size that cannot be
    scheduled raises. Any other plane takes the large-plane path. Cached per
    (dtype, nx, ny, n_g, exponent path)."""
    index = _device_index(device)
    return _plan(dtype, nx, ny, n_g, uses_glen(exps), index)


@functools.cache
def _vjp_library() -> ctypes.CDLL:
    lib = load_library("si_step_vjp")
    for fn in (lib.si_step_vjp_f32, lib.si_step_vjp_f64):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_long, ctypes.c_int]
                       + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_double] * 2 + [ctypes.c_int]
                       + [ctypes.c_double] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.si_step_vjp_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.si_step_vjp_occupancy.restype = ctypes.c_int
    return lib


# csrc/si_step_vjp.cu: threads a block; its dynamic shared memory (all of
# it): an 8-byte mbarrier padded to 16 bytes, 64 values (block 0's slots of
# the blocks' two sums, the warps' partials), ``stages`` × 5 staged planes
# (λ, H, H_D, B, x) of (rows + 2) × (cols + 2·16/itemsize) values, each
# 16-byte aligned, and (rows + 1) × (cols + 1) corners of 4 values (D, Q,
# PX, PY); the per-glacier index is a 32-bit int. The search's bounds:
# rows a tile and column chunks a row.
_VJP_THREADS = 256
_VJP_BAR_BYTES = 16
_VJP_HEAD_VALUES = 64
_VJP_PLANES = 5
_VJP_CORNER_VALUES = 4
_VJP_MAX_CELLS = 2 ** 31 - 1
_VJP_MAX_ROWS = 64
_VJP_MAX_CHUNKS = 64


class SIVjpLayout(NamedTuple):
    """How the pullback kernel cuts one glacier's (nx, ny) plane into tiles
    for a cluster; block ``rank`` walks tiles rank, rank + cluster, …"""

    cluster: int      # blocks per glacier
    rows: int         # rows a tile
    cols: int         # columns a tile (ny: one chunk a row)
    tiles: int        # tiles of the plane
    per_block: int    # tiles a block walks at most
    smem: int         # shared memory per block, bytes
    cells: int        # cells of the plane

    bx = _VJP_THREADS
    by = 1

    @property
    def stages(self) -> int:
        """Staged copies of the inputs: two, a ring, where a block walks
        more than one tile."""
        return 2 if self.per_block > 1 else 1

    @property
    def fits(self) -> bool:
        return self.smem <= SMEM_PER_BLOCK and self.cells <= _VJP_MAX_CELLS


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _vjp_smem(rows, cols, itemsize, stages) -> int:
    pitch = cols + 2 * (16 // itemsize)
    return (_VJP_BAR_BYTES + _VJP_HEAD_VALUES * itemsize
            + stages * _VJP_PLANES * _align16((rows + 2) * pitch * itemsize)
            + _VJP_CORNER_VALUES * (rows + 1) * (cols + 1) * itemsize)


@functools.lru_cache(maxsize=None)
def si_vjp_layout(nx, ny, dtype, cluster) -> SIVjpLayout:
    """The pullback kernel's tiles at a cluster size: bands of full rows
    where some band fits a block's shared memory, else the fewest column
    chunks (of a multiple of 16 bytes, at most 64 a row) for which one
    does; of those, rows ≤ 64 a tile, the band height whose blocks stage
    the fewest rows, per_block × (rows + 2), then the one with fewest
    tiles. ``fits`` is False where nothing fits, or where the plane has 2³¹
    cells or more."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // itemsize
    for chunks in range(1, min(_VJP_MAX_CHUNKS, -(-ny // vec)) + 1):
        cols = ny if chunks == 1 else -(-(-(-ny // chunks)) // vec) * vec
        if -(-ny // cols) != chunks:
            continue
        best = None
        for rows in range(1, min(nx, _VJP_MAX_ROWS) + 1):
            tiles = -(-nx // rows) * chunks
            per_block = -(-tiles // cluster)
            smem = _vjp_smem(rows, cols, itemsize, 2 if per_block > 1 else 1)
            key = (per_block * (rows + 2), tiles)
            if smem <= SMEM_PER_BLOCK and (best is None or key < best[0]):
                best = key, SIVjpLayout(cluster, rows, cols, tiles, per_block, smem, nx * ny)
        if best is not None:
            return best[1]
    return SIVjpLayout(cluster, 0, 0, 0, 0, SMEM_PER_BLOCK + 1, nx * ny)


class SIVjpPlan(NamedTuple):
    layout: SIVjpLayout
    max_active: dict             # cluster size -> cudaOccupancyMaxActiveClusters (0: no fit)


def _vjp_layouts(nx, ny, dtype) -> dict:
    """The layouts at 8 and 16 blocks; raises where neither fits."""
    layouts = {c: si_vjp_layout(nx, ny, dtype, c) for c in _CLUSTERS}
    if not any(lay.fits for lay in layouts.values()):
        raise ValueError(f"si_step_vjp: no cluster layout takes a {nx} x {ny} {dtype} plane "
                         f"(at most {_VJP_MAX_CELLS} cells)")
    return layouts


@functools.lru_cache(maxsize=None)
def _vjp_plan(dtype, nx, ny, n_g, glen, vec, device_index) -> SIVjpPlan:
    layouts = _vjp_layouts(nx, ny, dtype)
    lib = _vjp_library()

    def occupancy(c, lay, active):
        return lib.si_step_vjp_occupancy(int(dtype == torch.float64), int(glen), int(vec), c,
                                         lay.smem, active)

    return SIVjpPlan(*pick_cluster("si_step_vjp", layouts, occupancy, n_g, device_index))


def _pullback_plan(dtype, nx, ny, n_g, glen, vec, device_index):
    """The pullback's launch on device ``device_index``: where
    :func:`si_plan` sends the step to the large-plane path, the large-plane
    pullback's plan (:func:`plane_vjp_layout`), else the cluster kernel's
    layout (:func:`si_vjp_plan`), so that a gradient's three launches share
    a path."""
    if _plan(dtype, nx, ny, n_g, glen, device_index).layout is None:
        return plane_vjp_layout(n_g, nx, ny, dtype, _sm_count(device_index), vec)
    return _vjp_plan(dtype, nx, ny, n_g, glen, vec, device_index).layout


def si_vjp_plan(n_g, nx, ny, dtype, exps=GLEN_EXPS, vec=True, device=None) -> SIVjpPlan:
    """How a pullback launch over n_g glaciers runs on a CUDA device: the
    layout (:func:`si_vjp_layout`) at 16 blocks when the occupancy API says
    all n_g clusters of 16 are resident at once, or when the plane fits
    only at 16, else at 8; a plane that fits neither, or a cluster that
    cannot be scheduled, raises. ``vec``: the 16-byte copy route. Cached
    per (dtype, nx, ny, n_g, exponent path, route)."""
    index = _device_index(device)
    return _vjp_plan(dtype, nx, ny, n_g, uses_glen(exps), bool(vec), index)


def _row(scalars, dtype):
    """The derived table's (dx, dy, creep, slide) in ``dtype``, as (n_g, 1, 1)
    columns cut from the graph."""
    sc = scalars[:, :4].detach().to(dtype)
    return tuple(sc[:, k].reshape(-1, 1, 1) for k in range(4))


def _si_solve_reference(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, precondition=True):
    """The plain version's pre-relu solution x."""
    dx, dy, creep, slide = _row(scalars, H.dtype)
    D = _frozen_D_scalar(H_D, B, dx, dy, creep, slide, exps)
    return si_math.theta_solve_x(H, D, B, x0, dt, theta, cg_iters, dx, dy, precondition)


def si_step_reference(H, H_D, B, x0, scalars, dt, theta=1.0, cg_iters=6, exps=None,
                      precondition=True):
    """Plain PyTorch version of the kernel on (n_g, nx, ny) planes.

    ``scalars``: the derived (n_g, 8) table (first 4 columns used, cast to
    H's dtype); ``exps`` = (n+2, n−1, p−q+1, p−1) as Python numbers, read
    from the table's shared exponent set when None. dt, theta, cg_iters are
    Python numbers; ``precondition=False`` solves by plain CG.
    Differentiable by autograd as ``si_step`` is: the solve is
    :func:`odinn_tpu_torch.ops.si_math.theta_solve` (the implicit-function
    adjoint), D is differentiated in H_D, B and the creep
    and slide columns, and dx, dy get no gradient.
    """
    exps = _resolve_exps(scalars, exps)
    dx, dy, _, _ = _row(scalars, H.dtype)
    rates = scalars[:, 2:4].to(H.dtype)
    creep, slide = (rates[:, k].reshape(-1, 1, 1) for k in range(2))
    D = _frozen_D_scalar(H_D, B, dx, dy, creep, slide, exps)
    return si_math.theta_solve(H, D, B, x0, dt, theta, cg_iters, dx, dy, precondition)


def si_step_transpose_reference(gbar, x, H_D, B, scalars, dt, theta=1.0, cg_iters=6,
                                exps=None, precondition=True):
    """Plain version of the transpose-solve mode: λ = ``cg_iters`` Jacobi-PCG
    iterations (plain CG without ``precondition``) on the step's A (D frozen
    at H_D) from the right-hand side and guess g = ḡ·[x > 0], x the
    forward's pre-relu solution."""
    exps = _resolve_exps(scalars, exps)
    dx, dy, creep, slide = _row(scalars, x.dtype)
    D = _frozen_D_scalar(H_D, B, dx, dy, creep, slide, exps)
    return si_math.transpose_solve(gbar, x, D, float(dt), float(theta), int(cg_iters), dx, dy,
                                   bool(precondition))


def si_step_residual_tangent(dH, dHD, dB, dscalars, H, H_D, B, x, scalars, dt, theta=1.0,
                             exps=None):
    """ṙ, the tangent of the step's residual b − A·x with x fixed
    (:func:`odinn_tpu_torch.ops.si_math.residual_tangent`), with Ḋ from the
    tangents of H_D, B and the table's creep and slide columns; a None
    tangent is zero. PyTorch ops, on the card too."""
    exps = _resolve_exps(scalars, exps)
    dx, dy, creep, slide = _row(scalars, H.dtype)
    d_creep = d_slide = None
    if dscalars is not None:
        rates = dscalars[:, 2:4].to(H.dtype)
        d_creep, d_slide = (rates[:, k].reshape(-1, 1, 1) for k in range(2))
    pos = H_D > 0.0
    h = torch.where(pos, H_D, torch.zeros_like(H_D))
    dh = None if dHD is None else torch.where(pos, dHD, torch.zeros_like(dHD))
    dS = dh if dB is None else (dB if dh is None else dB + dh)
    D, dD = diffusivity_tangent(h, dh, B + h, dS, dx, dy, creep, d_creep, slide, d_slide, exps)
    return si_math.residual_tangent(dH, dD, dB, H, D, B, x, float(dt), float(theta), dx, dy)


def si_step_tangent_reference(rdot, x, x0, H_D, B, scalars, dt, theta=1.0, cg_iters=6,
                              exps=None, precondition=True):
    """Plain version of the tangent-solve mode: ẋ·[x > 0], ẋ = ``cg_iters``
    Jacobi-PCG iterations (plain CG without ``precondition``) on the step's
    A (D frozen at H_D) from the primal guess x0 on the right-hand side ṙ,
    x the forward's pre-relu solution."""
    exps = _resolve_exps(scalars, exps)
    dx, dy, creep, slide = _row(scalars, x.dtype)
    D = _frozen_D_scalar(H_D, B, dx, dy, creep, slide, exps)
    return si_math.tangent_solve(rdot, x, x0, D, float(dt), float(theta), int(cg_iters), dx, dy,
                                 bool(precondition))


def si_step_vjp_reference(lam, H, H_D, B, x, scalars, dt, theta=1.0, exps=None):
    """Plain version of the pullback kernel: (dH, dH_D, dB, d_creep,
    d_slide), the residual b − A·x's vector-Jacobian product at λ with x
    fixed (:func:`odinn_tpu_torch.ops.si_math.residual_pullback`), its D
    cotangent taken on to H_D, B, creep and slide by autograd through the
    frozen diffusivity. d_creep and d_slide have shape (n_g,)."""
    exps = _resolve_exps(scalars, exps)
    dx, dy, creep, slide = _row(scalars, H.dtype)
    with torch.enable_grad():
        hd, b = H_D.detach().requires_grad_(True), B.detach().requires_grad_(True)
        c, s = (v.reshape(-1).clone().requires_grad_(True) for v in (creep, slide))
        D = _frozen_D_scalar(hd, b, dx, dy, c.reshape(-1, 1, 1), s.reshape(-1, 1, 1), exps)
        dH, dD, dB = si_math.residual_pullback(lam, H, D.detach(), B, x, float(dt), float(theta),
                                               dx, dy)
        dHD, dB_D, dcreep, dslide = torch.autograd.grad(D, (hd, b, c, s), dD)
    return dH, dHD, dB + dB_D, dcreep, dslide


def _resolve_exps(scalars, exps):
    if exps is not None:
        return tuple(float(e) for e in exps)
    found = shared_exps(scalars)
    if found is None:
        raise ValueError(
            "si_step: the glaciers of the batch have different exponent sets "
            "(n+2, n−1, p−q+1, p−1); the kernel takes one set per launch")
    return found


def _device_of(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


def _forward(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, keep_x=False,
             precondition=True):
    """relu(x), and with ``keep_x`` also x, on H's device without autograd."""
    if _device_of("si_step", H) == "cpu":
        x = _si_solve_reference(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, precondition)
        out = st.relu_strict(x)
        return (out, x) if keep_x else out
    # x0's tangent is dropped by the contract (as custom_linear_solve drops
    # the guess's): no other input may carry one here
    _refuse_all("si_step", H, H_D, B, scalars)
    n_g, nx, ny = H.shape
    lay = si_plan(n_g, nx, ny, H.dtype, exps, H.device).layout
    x = torch.empty_like(H) if keep_x else None
    out = _launch(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, lay, x_out=x,
                  precondition=precondition)
    si_step.launches += 1
    return (out, x) if keep_x else out


class _SIStep(torch.autograd.Function):
    """The step with the implicit-function adjoint and its tangent (module
    doc)."""

    @staticmethod
    def forward(ctx, H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, precondition):
        ctx.set_materialize_grads(False)
        out, x = _forward(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, keep_x=True,
                          precondition=precondition)
        ctx.save_for_backward(H, H_D, B, x, scalars)
        # the jvp cannot read saved_tensors
        ctx.primals = (H, H_D, B, x0, x, scalars)
        ctx.consts = (dt, theta, cg_iters, exps, precondition)
        return out

    @staticmethod
    def jvp(ctx, dH, dHD, dB, _dx0, dscalars, *_):
        H, H_D, B, x0, x, scalars = ctx.primals
        dt, theta, cg_iters, exps, precondition = ctx.consts
        refuse_tangent("si_step", "the spacings or exponent columns of the table", dscalars,
                       _FIXED_COLS)
        rdot = si_step_residual_tangent(dH, dHD, dB, dscalars, H, H_D, B, x, scalars, dt, theta,
                                        exps)
        return si_step_tangent(rdot.contiguous(), x, x0, H_D, B, scalars, dt, theta, cg_iters,
                               exps, precondition)

    @staticmethod
    def backward(ctx, gbar):
        if gbar is None:       # grads are not materialised (for the jvp's Nones)
            return (None,) * 10
        H, H_D, B, x, scalars = ctx.saved_tensors
        dt, theta, cg_iters, exps, precondition = ctx.consts
        lam = si_step_transpose(gbar.contiguous(), x, H_D, B, scalars, dt, theta, cg_iters, exps,
                                precondition)
        dH, dHD, dB, dcreep, dslide = si_step_vjp(lam, H, H_D, B, x, scalars, dt, theta, exps)
        need = ctx.needs_input_grad
        d_scal = None
        if need[4]:
            d_scal = torch.zeros_like(scalars)
            d_scal[:, 2], d_scal[:, 3] = dcreep, dslide
        return ((dH if need[0] else None), (dHD if need[1] else None), (dB if need[2] else None),
                None, d_scal, None, None, None, None, None)


def si_step(H, H_D, B, x0, scalars, dt, theta=1.0, cg_iters=6, exps=None, precondition=True,
            keep_x=False):
    """One fused semi-implicit θ-step for a batch (see the module doc).

    H, H_D, B, x0: (n_g, nx, ny) float32/float64 planes; ``scalars`` the
    derived (n_g, 8) table; ``exps`` the batch's shared exponent set
    (n+2, n−1, p−q+1, p−1) as Python numbers, or None to read it from the
    table, which refuses a batch whose glaciers differ. A CUDA tensor
    launches the kernel (:func:`si_plan` picks the cluster kernel or the
    large-plane path); a CPU tensor takes :func:`si_step_reference`.
    Differentiable in H, H_D, B and the table's creep and slide columns by
    the implicit-function adjoint, and in forward mode by its tangent
    (module doc); x0 gets neither. ``precondition=False`` solves by plain
    CG; ``keep_x`` returns (relu(x), x) with the pre-relu solution x,
    without autograd, and refuses an input that carries a tangent.
    """
    check_inputs("si_step", (H, H_D, B, x0), scalars, 8)
    exps = _resolve_exps(scalars, exps)
    dt, theta, cg_iters, precondition = float(dt), float(theta), int(cg_iters), bool(precondition)
    if keep_x:
        if has_tangent(H, H_D, B, scalars):
            raise NotImplementedError("si_step: keep_x takes no forward-mode tangent")
        with torch.no_grad():
            return _forward(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, keep_x=True,
                            precondition=precondition)
    if needs_function(H, H_D, B, scalars):
        return _SIStep.apply(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, precondition)
    return _forward(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps,
                    precondition=precondition)


def si_step_transpose(gbar, x, H_D, B, scalars, dt, theta=1.0, cg_iters=6, exps=None,
                      precondition=True):
    """λ, the transpose solve of ``si_step``'s backward
    (:func:`si_step_transpose_reference`'s contract). A CUDA tensor launches
    the step's kernel in its transpose-solve mode at the forward's layout,
    one launch counted on ``si_step_transpose.launches``; a CPU tensor takes
    the plain version. ``precondition=False`` solves by plain CG."""
    check_inputs("si_step_transpose", (gbar, x, H_D, B), scalars, 8)
    exps = _resolve_exps(scalars, exps)
    dt, theta, cg_iters, precondition = float(dt), float(theta), int(cg_iters), bool(precondition)
    if _device_of("si_step_transpose", x) == "cpu":
        return si_step_transpose_reference(gbar, x, H_D, B, scalars, dt, theta, cg_iters, exps,
                                           precondition)
    n_g, nx, ny = x.shape
    lay = si_plan(n_g, nx, ny, x.dtype, exps, x.device).layout
    # the kernel's transpose mode reads ḡ where the forward reads H, and x
    # where it reads x0
    _refuse_all("si_step_transpose", gbar, x, H_D, B, scalars)
    lam = _launch(gbar, H_D, B, x, scalars, dt, theta, cg_iters, exps, lay, mode=_TRANSPOSE,
                  precondition=precondition)
    si_step_transpose.launches += 1
    return lam


def si_step_tangent(rdot, x, x0, H_D, B, scalars, dt, theta=1.0, cg_iters=6, exps=None,
                    precondition=True):
    """ẋ·[x > 0], the tangent solve of ``si_step``'s jvp
    (:func:`si_step_tangent_reference`'s contract). A CUDA tensor launches
    the step's kernel in its tangent-solve mode at the forward's layout, one
    launch counted on ``si_step_tangent.launches``; a CPU tensor takes the
    plain version. ``precondition=False`` solves by plain CG."""
    check_inputs("si_step_tangent", (rdot, x, x0, H_D, B), scalars, 8)
    exps = _resolve_exps(scalars, exps)
    dt, theta, cg_iters, precondition = float(dt), float(theta), int(cg_iters), bool(precondition)
    if _device_of("si_step_tangent", x) == "cpu":
        return si_step_tangent_reference(rdot, x, x0, H_D, B, scalars, dt, theta, cg_iters, exps,
                                         precondition)
    _refuse_all("si_step_tangent", rdot, x, x0, H_D, B, scalars)
    n_g, nx, ny = x.shape
    lay = si_plan(n_g, nx, ny, x.dtype, exps, x.device).layout
    # the kernel's tangent mode reads ṙ where the forward reads H, and the
    # forward's x (its mask) through the pointer the forward writes x to
    out = _launch(rdot, H_D, B, x0, scalars, dt, theta, cg_iters, exps, lay, x_out=x,
                  mode=_TANGENT, precondition=precondition)
    si_step_tangent.launches += 1
    return out


def _refuse_all(name, *tensors):
    """A kernel launch reads data pointers: an input that carries a
    forward-mode tangent would lose it, so it raises (the Functions hand
    the kernels primals only)."""
    if has_tangent(*tensors):
        raise NotImplementedError(f"{name}: a forward-mode tangent reached the kernel launch; "
                                  f"differentiate through si_step")


def _vjp_table(scalars, dtype):
    """The table the pullback kernel reads: ``scalars`` itself (detached,
    with its row stride) when it is in ``dtype`` or float64 with unit
    column stride, else a (n_g, 4) copy in ``dtype``."""
    table = scalars.detach()
    if table.dtype not in (dtype, torch.float64) or table.stride(1) != 1:
        table = table[:, :4].to(dtype).contiguous()
    return table


# the large-plane pullback's slots of the glaciers' sums and its ticket
# counters
_plane_vjp_buffers = {}


def si_step_vjp(lam, H, H_D, B, x, scalars, dt, theta=1.0, exps=None):
    """(dH, dH_D, dB, d_creep, d_slide) of ``si_step``'s backward at λ
    (:func:`si_step_vjp_reference`'s contract). A CUDA tensor launches one
    pullback kernel, counted on ``si_step_vjp.launches``: where
    :func:`si_plan` sends the step to the large-plane path,
    ``csrc/si_plane_vjp.cu`` on the tiles of :func:`plane_vjp_plan` (also
    counted on ``si_step_vjp.plane_launches``), else ``csrc/si_step_vjp.cu``
    (one clustered launch, :func:`si_vjp_plan`); a plane neither takes
    raises. A CPU tensor takes the plain version. The kernels read the
    table in place when it is in H's dtype or in float64, with its row
    stride."""
    check_inputs("si_step_vjp", (lam, H, H_D, B, x), scalars, 8)
    exps = _resolve_exps(scalars, exps)
    dt, theta = float(dt), float(theta)
    if _device_of("si_step_vjp", H) == "cpu":
        return si_step_vjp_reference(lam, H, H_D, B, x, scalars, dt, theta, exps)
    _refuse_all("si_step_vjp", lam, H, H_D, B, x, scalars)
    n_g, nx, ny = H.shape
    planes = (lam, H, H_D, B, x)
    vec = (ny * H.element_size()) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in planes)
    glen = int(uses_glen(exps))
    lay = _pullback_plan(H.dtype, nx, ny, n_g, bool(glen), vec, _device_index(H.device))
    table = _vjp_table(scalars, H.dtype)
    dH, dHD, dB = (torch.empty_like(H) for _ in range(3))
    dcreep, dslide = (torch.empty(n_g, dtype=H.dtype, device=H.device) for _ in range(2))
    f32 = H.dtype == torch.float32
    head = (*(t.data_ptr() for t in planes), table.data_ptr(), table.stride(0),
            int(table.dtype == torch.float64), dH.data_ptr(), dHD.data_ptr(), dB.data_ptr())
    stream = torch.cuda.current_stream(H.device).cuda_stream
    if isinstance(lay, PlaneVjpLayout):
        partial, counter = ticket_buffers(_plane_vjp_buffers, H.device, H.dtype,
                                          PLANE_VJP_SUMS * n_g * lay.slots, n_g)
        lib = _plane_vjp_library()
        fn = lib.si_plane_vjp_f32 if f32 else lib.si_plane_vjp_f64
        err = fn(*head, partial.data_ptr(), counter.data_ptr(), dcreep.data_ptr(),
                 dslide.data_ptr(), n_g, nx, ny, dt, theta, glen, *exps, *lay.launch_args(),
                 stream)
        if err == 0:
            si_step_vjp.plane_launches += 1
    else:
        lib = _vjp_library()
        fn = lib.si_step_vjp_f32 if f32 else lib.si_step_vjp_f64
        err = fn(*head, dcreep.data_ptr(), dslide.data_ptr(), n_g, nx, ny, dt, theta, glen,
                 *exps, lay.cluster, lay.rows, lay.cols, lay.smem, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"si_step_vjp: kernel launch failed with CUDA error {err}")
    si_step_vjp.launches += 1
    return dH, dHD, dB, dcreep, dslide


def _launch(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, lay, x_out=None,
            mode=_FORWARD, precondition=True):
    """The step on the card with the cluster layout ``lay``, or on the
    large-plane path when ``lay`` is None. ``x_out`` receives the pre-relu
    solution; ``mode`` _TRANSPOSE runs the transpose-solve mode, which reads
    ḡ in H's place and x in x0's, and returns λ; _TANGENT the tangent-solve
    mode, which reads ṙ in H's place, the primal guess in x0's and the
    forward's x in ``x_out``'s, and returns ẋ·[x > 0];
    ``precondition=False`` runs any mode as plain CG. The wrappers count
    their launches; a launch of the large-plane path (``csrc/si_plane.cu``:
    the assembly and the cooperative PCG) also counts one on
    ``si_step.plane_launches``, whichever mode it runs."""
    n_g, nx, ny = H.shape
    table = scalars[:, :4].detach().to(H.dtype).contiguous()
    out = torch.empty_like(H)
    f32 = H.dtype == torch.float32
    stream = torch.cuda.current_stream(H.device).cuda_stream
    planes = (H.data_ptr(), H_D.data_ptr(), B.data_ptr(), x0.data_ptr(), table.data_ptr())
    xp = x_out.data_ptr() if x_out is not None else None
    if lay is not None:
        lib = _library()
        fn = lib.si_step_cluster_f32 if f32 else lib.si_step_cluster_f64
        err = fn(*planes, out.data_ptr(), xp, n_g, nx, ny, dt, theta, cg_iters, mode,
                 int(precondition), int(uses_glen(exps)), *exps, lay.cluster, lay.bx, lay.by,
                 lay.smem, lay.cells, stream)
    else:
        n_bytes = H.element_size()
        vec_in = (ny * n_bytes) % 16 == 0 and _aligned16(H, H_D, B)
        alay = assemble_plan(n_g, nx, ny, H.dtype, vec_in, H.device)
        work = torch.empty((PLANE_SCRATCH,) + tuple(H.shape), dtype=H.dtype, device=H.device)
        play = plane_plan(n_g, nx, ny, H.dtype, _aligned16(work, x0, out), H.device)
        slots = torch.empty(PLANE_SLOT_ARRAYS * n_g * play.bands, dtype=H.dtype, device=H.device)
        lib = _plane_library()
        fn = lib.si_plane_f32 if f32 else lib.si_plane_f64
        err = fn(*planes, work.data_ptr(), slots.data_ptr(), out.data_ptr(), xp, n_g, nx, ny, dt,
                 theta, cg_iters, mode, int(precondition), int(uses_glen(exps)), *exps,
                 *alay.launch_args(), *play.launch_args(), stream)
        if err == 0:
            si_step.plane_launches += 1
    if err != 0:
        raise RuntimeError(f"si_step: kernel launch failed with CUDA error {err}")
    return out


# ---------------------------------------------------------------------------
# The row-sharded step (module doc)
# ---------------------------------------------------------------------------

def si_assemble_reference(work, H, H_D, B, X, scalars, dt, theta, mode, precondition=True,
                          exps=None):
    """Plain version of :func:`si_assemble`: D at H_D, b and the inverse
    Jacobi diagonal into ``work`` (``si_math.rows_assemble``)."""
    exps = _resolve_exps(scalars, exps)
    dx, dy, creep, slide = _row(scalars, H.dtype)
    D = _frozen_D_scalar(H_D, B, dx, dy, creep, slide, exps)
    si_math.rows_assemble(work, H, D, B, float(dt), float(theta), int(mode), bool(precondition),
                          dx, dy, X)


def si_assemble(work, H, H_D, B, X, scalars, dt, theta=1.0, mode=si_math.FORWARD,
                precondition=True, exps=None):
    """The step's assembly alone on (n_g, nx, ny) planes into the scratch
    ``work`` (``si_math.ROWS_PLANES`` planes of that shape): D's corners,
    b of ``mode`` (the step's; ḡ·[X > 0] with ḡ in H; H as given) and the
    inverse Jacobi diagonal. A CUDA tensor launches the large-plane path's
    assembly kernel (``csrc/si_plane.cu``), counted on
    ``si_assemble.launches``, on the tiles of :func:`assemble_plan`; a
    CPU tensor takes :func:`si_assemble_reference`."""
    check_inputs("si_assemble", (H, H_D, B, X), scalars, 8)
    exps = _resolve_exps(scalars, exps)
    if _device_of("si_assemble", H) == "cpu":
        return si_assemble_reference(work, H, H_D, B, X, scalars, dt, theta, mode, precondition,
                                     exps)
    _refuse_all("si_assemble", H, H_D, B, X, scalars)
    if work.shape[1:] != H.shape or not work.is_contiguous() or work.dtype != H.dtype:
        raise ValueError("si_assemble: the scratch must be contiguous planes of H's shape")
    n_g, nx, ny = H.shape
    table = scalars[:, :4].detach().to(H.dtype).contiguous()
    vec = (ny * H.element_size()) % 16 == 0 and _aligned16(H, H_D, B)
    lay = assemble_plan(n_g, nx, ny, H.dtype, vec, H.device)
    lib = _plane_library()
    fn = lib.si_assemble_f32 if H.dtype == torch.float32 else lib.si_assemble_f64
    err = fn(H.data_ptr(), H_D.data_ptr(), B.data_ptr(), X.data_ptr(), table.data_ptr(),
             work.data_ptr(), n_g, nx, ny, float(dt), float(theta), int(mode), int(precondition),
             int(uses_glen(exps)), *exps, *lay.launch_args(),
             torch.cuda.current_stream(H.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_assemble: kernel launch failed with CUDA error {err}")
    si_assemble.launches += 1


def _spacings_of(table, dtype):
    return tuple(table[:, k].to(dtype).reshape(-1, 1, 1) for k in range(2))


def si_rows_apply_reference(work, x0, beta, src, dst, r0, r1, table, coef, init,
                            precondition=True):
    """Plain version of :func:`si_rows_apply` on the scratch ``work``."""
    dx, dy = _spacings_of(table, work.dtype)
    D = work[si_math.ROWS_D][..., :-1, :-1]
    interior, _ = si_math._masks(work[si_math.ROWS_X])

    def matvec(u):
        return u - coef * interior * si_math.div_flux(interior * u, D, dx, dy)

    own = slice(r0, r1)
    if init:
        work[si_math.ROWS_X].copy_(x0)
        r = work[si_math.ROWS_RHS] - matvec(x0)
        z = r * work[si_math.ROWS_INV] if precondition else r
        work[si_math.ROWS_R][..., own, :] = r[..., own, :]
        work[si_math.ROWS_Z][..., own, :] = z[..., own, :]
        return si_math.dot(r[..., own, :], z[..., own, :]).reshape(-1)
    p = work[si_math.ROWS_Z] + beta.reshape(-1, 1, 1) * work[src]
    work[dst] = p
    Ap = matvec(p)
    work[si_math.ROWS_AP][..., own, :] = Ap[..., own, :]
    return si_math.dot(p[..., own, :], Ap[..., own, :]).reshape(-1)


def si_rows_update_reference(work, alpha, p_plane, r0, r1, precondition=True):
    """Plain version of :func:`si_rows_update` on the scratch ``work``."""
    own = slice(r0, r1)
    a = alpha.reshape(-1, 1, 1)
    x, r = work[si_math.ROWS_X][..., own, :], work[si_math.ROWS_R][..., own, :]
    p, Ap = work[p_plane][..., own, :], work[si_math.ROWS_AP][..., own, :]
    x_new = x + a * p
    r_new = r - a * Ap
    z = r_new * work[si_math.ROWS_INV][..., own, :] if precondition else r_new
    work[si_math.ROWS_X][..., own, :] = x_new
    work[si_math.ROWS_R][..., own, :] = r_new
    work[si_math.ROWS_Z][..., own, :] = z
    return si_math.dot(r_new, z).reshape(-1)


def _rows_args(name, work, table, r0, r1):
    if work.ndim != 4 or work.shape[0] != si_math.ROWS_PLANES or not work.is_contiguous():
        raise ValueError(f"{name}: the scratch is {si_math.ROWS_PLANES} contiguous planes")
    if work.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: float32 or float64, got {work.dtype}")
    _, n_g, nx, ny = work.shape
    if not 0 <= r0 < r1 <= nx:
        raise ValueError(f"{name}: own rows [{r0}, {r1}) outside a plane of {nx} rows")
    return n_g, nx, ny, table.detach().to(work.dtype).contiguous()


def _aligned16(*tensors) -> bool:
    """Whether every given tensor starts on a 16-byte boundary (the rows
    kernels' 16-byte vectors)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def si_rows_apply(work, x0, beta, src, dst, r0, r1, table, coef, init, precondition=True):
    """One half of a row-sharded PCG iteration on the scratch ``work``
    (module doc): p[dst] = z + β·p[src] on the whole slab, then Ap = A·p
    on the own rows [r0, r1) and each glacier's partial p·Ap; with
    ``init``, x = x0, r = b − A·x0, z = M⁻¹r (r without
    ``precondition``) and the partial r·z. ``table`` holds each glacier's
    (dx, dy) in its first columns, ``coef`` is θ·dt. Returns the (n_g,)
    partials on ``work``'s device. A CUDA scratch launches
    ``csrc/si_rows.cu`` on the plan of :func:`rows_layout` (a slab it does
    not take raises ValueError), counted on ``si_rows_apply.launches``; a
    CPU one takes :func:`si_rows_apply_reference`."""
    n_g, nx, ny, table = _rows_args("si_rows_apply", work, table, r0, r1)
    if work.device.type == "cpu":
        return si_rows_apply_reference(work, x0, beta, src, dst, r0, r1, table, coef, init,
                                       precondition)
    partial = torch.empty(n_g, dtype=work.dtype, device=work.device)
    if init:
        x0 = x0.contiguous()
        if x0.shape != work.shape[1:] or x0.dtype != work.dtype:
            raise ValueError("si_rows_apply: x0 must be a plane of the scratch's shape")
        beta_ptr, x0_ptr = None, x0.data_ptr()
    else:
        beta = beta.to(device=work.device, dtype=work.dtype).contiguous()
        beta_ptr, x0_ptr = beta.data_ptr(), None
    lay = rows_layout(n_g, nx, ny, int(r0), int(r1), work.dtype,
                      _aligned16(work, x0 if init else None))
    lib = _rows_library()
    fn = lib.si_rows_apply_f32 if work.dtype == torch.float32 else lib.si_rows_apply_f64
    err = fn(work.data_ptr(), x0_ptr, table.data_ptr(), beta_ptr, int(src), int(dst), n_g, nx, ny,
             int(r0), int(r1), float(coef), int(bool(init)), int(bool(precondition)),
             *lay.launch_args(), partial.data_ptr(),
             torch.cuda.current_stream(work.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_rows_apply: kernel launch failed with CUDA error {err}")
    si_rows_apply.launches += 1
    return partial


def si_rows_update(work, alpha, p_plane, r0, r1, precondition=True):
    """The other half (module doc): x += α·p, r −= α·Ap, z = M⁻¹r on the
    own rows [r0, r1) with p the plane ``p_plane``, and each glacier's
    partial r·z. A CUDA scratch launches ``csrc/si_rows.cu`` on the plan
    of :func:`rows_layout`, counted on ``si_rows_update.launches``; a CPU
    one takes :func:`si_rows_update_reference`."""
    n_g, nx, ny, _ = _rows_args("si_rows_update", work, alpha.new_zeros(1, 2), r0, r1)
    if work.device.type == "cpu":
        return si_rows_update_reference(work, alpha, p_plane, r0, r1, precondition)
    alpha = alpha.to(device=work.device, dtype=work.dtype).contiguous()
    partial = torch.empty(n_g, dtype=work.dtype, device=work.device)
    lay = rows_layout(n_g, nx, ny, int(r0), int(r1), work.dtype, _aligned16(work))
    lib = _rows_library()
    fn = lib.si_rows_update_f32 if work.dtype == torch.float32 else lib.si_rows_update_f64
    err = fn(work.data_ptr(), alpha.data_ptr(), int(p_plane), n_g, nx, ny, int(r0), int(r1),
             int(bool(precondition)), *lay.launch_args(), partial.data_ptr(),
             torch.cuda.current_stream(work.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_rows_update: kernel launch failed with CUDA error {err}")
    si_rows_update.launches += 1
    return partial


def _rows_table(scalars, dtype):
    return scalars[:, :4].detach().to(dtype).contiguous()


def rows_step_x(shard, H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, precondition=True):
    """The own rows of the step's pre-relu x on a row shard, from the slabs
    (halo 2) H, H_D, B and x0: :func:`si_assemble`, then the row PCG."""
    return si_math.rows_solve(
        shard, lambda w: si_assemble(w, H, H_D, B, H, scalars, dt, theta, si_math.FORWARD,
                                     precondition, exps),
        x0, _rows_table(scalars, H.dtype), float(theta) * float(dt), cg_iters, precondition)


def rows_step_transpose(shard, gbar, x, H_D, B, scalars, dt, theta, cg_iters, exps,
                        precondition=True):
    """The own rows of λ, the step's transpose solve on a row shard, for
    the own-row cotangent ``gbar`` and pre-relu x (module doc)."""
    g = shard.exchange(si_math.relu_cotangent(gbar, x), si_math.ROWS_HALO).contiguous()
    return si_math.rows_solve(
        shard, lambda w: si_assemble(w, g, H_D, B, g, scalars, dt, theta, si_math.TANGENT,
                                     precondition, exps),
        g, _rows_table(scalars, g.dtype), float(theta) * float(dt), cg_iters, precondition)


class _RowsSIStep(torch.autograd.Function):
    """:class:`_SIStep` on a row shard: slab inputs (halo 2), own-row
    output; slab cotangents and own-row tangents (module doc)."""

    @staticmethod
    def forward(ctx, H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, precondition, shard):
        ctx.set_materialize_grads(False)
        x = rows_step_x(shard, H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, precondition)
        ctx.save_for_backward(H, H_D, B, x, scalars)
        ctx.primals = (H, H_D, B, x0, x, scalars)
        ctx.consts = (dt, theta, cg_iters, exps, precondition, shard)
        return st.relu_strict(x)

    @staticmethod
    def jvp(ctx, dH, dHD, dB, _dx0, dscalars, *_):
        H, H_D, B, x0, x, scalars = ctx.primals
        dt, theta, cg_iters, exps, precondition, shard = ctx.consts
        refuse_tangent("si_step", "the spacings or exponent columns of the table", dscalars,
                       _FIXED_COLS)
        x_s = shard.exchange(x, si_math.ROWS_HALO)
        rdot = si_step_residual_tangent(dH, dHD, dB, dscalars, H, H_D, B, x_s, scalars, dt, theta,
                                        exps).contiguous()
        xd = si_math.rows_solve(
            shard, lambda w: si_assemble(w, rdot, H_D, B, rdot, scalars, dt, theta,
                                         si_math.TANGENT, precondition, exps),
            x0, _rows_table(scalars, x.dtype), theta * dt, cg_iters, precondition)
        return si_math.relu_cotangent(xd, x)

    @staticmethod
    def backward(ctx, gbar):
        H, H_D, B, x, scalars = ctx.saved_tensors
        dt, theta, cg_iters, exps, precondition, shard = ctx.consts
        if gbar is None:       # every rank joins the exchanges
            gbar = torch.zeros_like(x)
        lam = rows_step_transpose(shard, gbar, x, H_D, B, scalars, dt, theta, cg_iters, exps,
                                  precondition)
        x_s = shard.exchange(x, si_math.ROWS_HALO).contiguous()
        dH, dHD, dB, dcreep, dslide = si_step_vjp(shard.pad(lam, si_math.ROWS_HALO).contiguous(),
                                                  H, H_D, B, x_s, scalars, dt, theta, exps)
        need = ctx.needs_input_grad
        d_scal = None
        if need[4]:
            d_scal = torch.zeros_like(scalars)
            d_scal[:, 2], d_scal[:, 3] = dcreep, dslide
        return ((dH if need[0] else None), (dHD if need[1] else None), (dB if need[2] else None),
                None, d_scal, None, None, None, None, None, None)


def si_rows_step(shard, H, H_D, B, x0, scalars, dt, theta=1.0, cg_iters=6, exps=None,
                 precondition=True):
    """:func:`si_step` on a row shard (module doc): H, H_D, B and x0 on the
    slab of halo 2, the own rows of relu(x) out; differentiable as
    ``si_step`` is."""
    H, H_D, B, x0 = (t.contiguous() for t in (H, H_D, B, x0))
    check_inputs("si_rows_step", (H, H_D, B, x0), scalars, 8)
    exps = _resolve_exps(scalars, exps)
    dt, theta, cg_iters, precondition = float(dt), float(theta), int(cg_iters), bool(precondition)
    if needs_function(H, H_D, B, scalars):
        return _RowsSIStep.apply(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps, precondition,
                                 shard)
    with torch.no_grad():
        return st.relu_strict(rows_step_x(shard, H, H_D, B, x0, scalars, dt, theta, cg_iters,
                                          exps, precondition))


si_assemble.launches = 0
si_rows_apply.launches = 0
si_rows_update.launches = 0
si_step.launches = 0
si_step.plane_launches = 0
si_step_transpose.launches = 0
si_step_tangent.launches = 0
si_step_vjp.launches = 0
si_step_vjp.plane_launches = 0
