"""The plain versions of odinn_tpu_torch's CUDA kernels against the JAX
package's Pallas kernels (interpret mode on the CPU) and references, and the
kernel wrappers' contract on the CPU: a CPU tensor takes the plain version;
``sia2d_rhs`` and ``rkc_interval`` differentiate with the TPU kernels'
custom-VJP contracts, ``si_step`` with the production SI step's
implicit-function adjoint (held to the JAX package in
``tests/test_torch_si_adjoint.py``), and mixed exponent sets and
unsupported inputs are refused.

The kernels themselves run only on a CUDA card; ``chip_smoke.py`` holds them
against these plain versions there. Float64; tolerance 1e-10 relative to
max|H| (or max|dH/dt|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odinn_tpu.ops.pallas.rkc_kernel import derived_scalars as j_derived
from odinn_tpu.ops.pallas.rkc_kernel import rkc_interval_pallas
from odinn_tpu.ops.pallas.rkc_kernel import rkc_interval_reference as j_rkc_ref
from odinn_tpu.ops.pallas.si_kernel import si_step_pallas, si_step_reference as j_si_ref
from odinn_tpu.ops.pallas.sia_kernel import sia2d_rhs_pallas
from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel, sia_kernel
from odinn_tpu_torch.ops.cuda.common import derived_scalars, pow_pos, shared_exps
from tests.torch_parity import assert_rel

RTOL = 1e-10
RHO, G, ETA0 = 900.0, 9.81, 1.0
DT = 1.0 / 12.0


def _inputs(n_g=3, nx=28, ny=34, seed=0):
    """Domes of varied size on a rough bed; the raw (dx, dy, A, C, n, p, q)
    table with sliding on one glacier."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) - nx / 2) * 100.0
    y = (np.arange(ny) - ny / 2) * 90.0
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    radius = 0.35 * nx * 100.0 * (0.8 + 0.4 * rng.random(n_g))
    H = (400.0 * (0.6 + 0.6 * rng.random(n_g)))[:, None, None] * np.clip(
        1.0 - r2 / radius[:, None, None] ** 2, 0.0, None) ** (3.0 / 7.0)
    B = 20.0 * rng.random((n_g, nx, ny))
    A = np.array([8e-19, 3e-18, 1.5e-18])[:n_g]
    C = np.array([0.0, 2e-18, 0.0])[:n_g]
    raw = np.stack([np.full(n_g, 100.0), np.full(n_g, 90.0), A, C,
                    np.full(n_g, 3.0), np.full(n_g, 3.0), np.zeros(n_g)], axis=1)
    return H, B, raw


def _j_table(raw):
    return j_derived(*(jnp.asarray(raw[:, k]) for k in range(7)), RHO, G)


def _t_table(raw):
    return derived_scalars(*(torch.from_numpy(raw[:, k]) for k in range(7)), RHO, G)


def test_derived_table_matches():
    _, _, raw = _inputs()
    assert_rel(_t_table(raw), _j_table(raw), 1e-14)


@pytest.mark.parametrize("theta,hd_scale,n", [(1.0, 1.0, 3.0), (0.5, 1.0, 3.0), (0.5, 0.97, 3.0),
                                              (1.0, 1.03, 3.0), (1.0, 1.0, 4.0)],
                         ids=["1.0-1.0", "0.5-1.0", "0.5-0.97", "1.0-1.03", "1.0-1.0-n4"])
def test_si_step_reference_matches_jax(theta, hd_scale, n):
    """n = 4 (exponents (6, 3, 4, 2), sliding on glacier 1) is the set the
    kernel takes at run time (RuntimeExps); n = 3 its fixed-multiply set."""
    H, B, raw = _inputs()
    if n != 3.0:
        raw[:, 4] = n
        raw[:, 2:4] /= RHO * G * 400.0   # D of the same size as at n = 3
    H_D, x0 = hd_scale * H, 0.99 * H
    jt, tt = _j_table(raw), _t_table(raw)
    exps = tuple(float(e) for e in np.asarray(jt[0, 4:8]))
    assert (exps == (5.0, 2.0, 4.0, 2.0)) == (n == 3.0) and raw[1, 3] > 0.0
    args_j = (jnp.asarray(H), jnp.asarray(H_D), jnp.asarray(B), jnp.asarray(x0), jt, DT, theta, 8,
              exps)
    ref_j = j_si_ref(*args_j)
    pal_j = si_step_pallas(*args_j)
    t = torch.from_numpy
    out = si_kernel.si_step_reference(t(H), t(H_D), t(B), t(x0), tt, DT, theta, 8)
    assert_rel(out, ref_j, RTOL, "vs jax si_step_reference")
    assert_rel(out, pal_j, RTOL, "vs si_step_pallas (interpret)")
    # the wrapper on CPU tensors is the plain version, bit for bit
    wrapped = si_kernel.si_step(t(H), t(H_D), t(B), t(x0), tt, DT, theta, 8)
    assert torch.equal(wrapped, out)


@pytest.mark.parametrize("with_bed", [True, False])
def test_sia2d_rhs_reference_matches_jax(with_bed):
    import odinn_tpu.physics.sia2d as jsia
    from odinn_tpu.core.params import PhysicalParameters
    from odinn_tpu.physics.targets import ATarget

    H, B, raw = _inputs(seed=1)
    if not with_bed:
        B = np.zeros_like(B)
    pal = sia2d_rhs_pallas(jnp.asarray(H), jnp.asarray(B), jnp.asarray(raw), RHO, G, ETA0)

    def one(h, b, row):
        vals = jsia.SIAValues(A=row[2], C=row[3], n=3.0, p=3.0, q=0.0)
        return jsia.sia2d_rhs(h, b, row[0], row[1], lambda hb, gs: vals, ATarget(),
                              PhysicalParameters())

    ref = jax.vmap(one)(jnp.asarray(H), jnp.asarray(B), jnp.asarray(raw))
    t = torch.from_numpy
    out = sia_kernel.sia2d_rhs_reference(t(H), t(B), t(raw), RHO, G, ETA0)
    assert_rel(out, pal, RTOL, "vs sia2d_rhs_pallas (interpret)")
    assert_rel(out, ref, RTOL, "vs physics.sia2d.sia2d_rhs")
    assert torch.equal(sia_kernel.sia2d_rhs(t(H), t(B), t(raw), RHO, G, ETA0), out)


def test_sia2d_rhs_reference_mixed_exponents():
    """Glaciers with their own Glen n run in groups, each with its own
    exponent set — the same as one glacier at a time."""
    H, B, raw = _inputs(seed=2)
    raw[1, 4] = raw[1, 5] = 4.0
    raw[2, 4] = raw[2, 5] = 2.5
    t = torch.from_numpy
    out = sia_kernel.sia2d_rhs_reference(t(H), t(B), t(raw), RHO, G, ETA0)
    for k in range(3):
        one = sia_kernel.sia2d_rhs_reference(t(H[k:k + 1]), t(B[k:k + 1]), t(raw[k:k + 1]),
                                             RHO, G, ETA0)
        assert torch.equal(out[k:k + 1], one)
    pal = sia2d_rhs_pallas(jnp.asarray(H), jnp.asarray(B), jnp.asarray(raw), RHO, G, ETA0)
    assert_rel(out, pal, RTOL)


def test_pow_pos_semantics():
    x = torch.tensor([0.0, 0.5, 2.0, 3.0], dtype=torch.float64)
    x2 = x * x
    assert torch.equal(pow_pos(x, 5.0), x * (x2 * x2))   # integer_pow's multiplies
    assert torch.equal(pow_pos(x, 2.0), x2)
    assert torch.equal(pow_pos(x, 0.0), torch.ones_like(x))
    non_int = pow_pos(x, 2.5)
    assert non_int[0] == 0.0
    assert torch.allclose(non_int[1:], x[1:] ** 2.5, rtol=1e-14, atol=0)


@pytest.mark.parametrize("case", ["si_step H", "si_step table", "sia2d_rhs H",
                                  "sia2d_rhs table", "rkc_interval H", "rkc_interval table"])
def test_wrappers_refuse_gradients(case):
    """Which inputs each wrapper differentiates. sia2d_rhs and rkc_interval
    give gradients for H and for the A (raw table) or creep (derived table)
    column, zero for the other columns, and none for B. si_step gives them
    for H and for the creep and slide columns (2, 3), zero for the spacings
    and exponents, and none for x0."""
    H, B, raw = _inputs(nx=12, ny=14)
    t = torch.from_numpy
    wrt_H = case.endswith(" H")
    kernel = case.split()[0]
    table = t(raw) if kernel == "sia2d_rhs" else _t_table(raw)
    Hi = t(H).requires_grad_(wrt_H)
    table.requires_grad_(not wrt_H)
    Bi = t(B).requires_grad_(True)
    x0 = t(0.99 * H).requires_grad_(True)
    if kernel == "sia2d_rhs":
        out = sia_kernel.sia2d_rhs(Hi, Bi, table, RHO, G, ETA0)
    elif kernel == "si_step":
        out = si_kernel.si_step(Hi, Hi, Bi, x0, table, DT)
    else:
        out = rkc_kernel.rkc_interval(Hi, Bi, table, 0.002, 4, ETA0)
    grad, grad_x0 = torch.autograd.grad((out * out).sum(), [Hi if wrt_H else table, x0],
                                        allow_unused=True)
    assert torch.isfinite(grad).all() and grad_x0 is None
    trained = [2, 3] if kernel == "si_step" else [2]
    if wrt_H:
        assert grad.abs().max() > 0.0
    else:
        assert (grad[:, trained] != 0.0).all()
        rest = [k for k in range(grad.shape[1]) if k not in trained]
        assert torch.equal(grad[:, rest], torch.zeros_like(grad[:, rest]))
    assert Bi.grad is None


def _rkc_args(s):
    """RKC inputs at a step length stable for s stages."""
    H, B, raw = _inputs(nx=24, ny=26, seed=5)
    return H, B, raw, 0.002 * s * s / 4.0


@pytest.mark.parametrize("s", [2, 5, 8])
def test_rkc_interval_reference_matches_jax(s):
    H, B, raw, dt = _rkc_args(s)
    jt, tt = _j_table(raw), _t_table(raw)
    ref = j_rkc_ref(jnp.asarray(H), jnp.asarray(B), jt, dt, s, ETA0)
    pal = rkc_interval_pallas(jnp.asarray(H), jnp.asarray(B), jt, dt, s, ETA0)
    t = torch.from_numpy
    out = rkc_kernel.rkc_interval_reference(t(H), t(B), tt, dt, s, ETA0)
    assert float((out - t(H)).abs().max()) > 1e-3 * float(np.abs(H).max())
    assert_rel(out, ref, RTOL, "vs jax rkc_interval_reference")
    assert_rel(out, pal, RTOL, "vs rkc_interval_pallas (interpret)")
    assert torch.equal(rkc_kernel.rkc_interval(t(H), t(B), tt, dt, s, ETA0), out)


@pytest.mark.parametrize("mixed", [False, True])
def test_sia2d_rhs_vjp_reference_matches_jax(mixed):
    """The pullback's plain version against jax.vjp through
    sia2d_rhs_pallas's custom VJP: dH, and dA from d(creep) through the
    table math (also through the RHS Function), 1e-10."""
    H, B, raw = _inputs(seed=3)
    if mixed:
        raw[1, 4] = raw[1, 5] = 4.0
    lam = np.random.default_rng(7).standard_normal(H.shape)
    _, pb = jax.vjp(lambda h, sc: sia2d_rhs_pallas(h, jnp.asarray(B), sc, RHO, G, ETA0),
                    jnp.asarray(H), jnp.asarray(raw))
    jdH, jdsc = pb(jnp.asarray(lam))
    t = torch.from_numpy
    derived = sia_kernel.derive_table(t(raw), RHO, G)
    dH, dcreep = sia_kernel.sia2d_rhs_vjp_reference(t(lam), t(H), t(B), derived, ETA0)
    assert_rel(dH, jdH, RTOL, "dH")
    dA = sia_kernel.a_cotangent(t(raw), dcreep, RHO, G)
    assert_rel(dA[:, 2], jdsc[:, 2], RTOL, "dA")
    assert torch.equal(sia_kernel.sia2d_rhs_vjp(t(lam), t(H), t(B), derived, ETA0)[0], dH)
    Hg, rawg = t(H).requires_grad_(True), t(raw).requires_grad_(True)
    gH, graw = torch.autograd.grad(sia_kernel.sia2d_rhs(Hg, t(B), rawg, RHO, G, ETA0),
                                   (Hg, rawg), t(lam))
    assert_rel(gH, jdH, RTOL, "Function dH")
    assert_rel(graw, jdsc, RTOL, "Function d(raw table)")


@pytest.mark.parametrize("s", [2, 4, 5, 8])
def test_rkc_interval_backward_matches_jax(s):
    """The RKC Function's backward (rematerialised stages, stage-by-stage
    pullback through stage_pullback's plain version) against jax.vjp of
    rkc_interval_pallas: dH and d(creep), 1e-9. s = 2 has one inner stage,
    s = 5 an odd count."""
    H, B, raw = _inputs(n_g=2, nx=16, ny=18, seed=5)
    dt = 0.002 * s * s / 4.0
    lam = np.random.default_rng(8).standard_normal(H.shape)
    jt = _j_table(raw)
    _, pb = jax.vjp(lambda h, sc: rkc_interval_pallas(h, jnp.asarray(B), sc, dt, s, ETA0),
                    jnp.asarray(H), jt)
    jdH, jdsc = pb(jnp.asarray(lam))
    t = torch.from_numpy
    Hg, tg = t(H).requires_grad_(True), _t_table(raw).requires_grad_(True)
    gH, gt = torch.autograd.grad(rkc_kernel.rkc_interval(Hg, t(B), tg, dt, s, ETA0),
                                 (Hg, tg), t(lam))
    assert_rel(gH, jdH, 1e-9, "dH")
    assert_rel(gt[:, 2], jdsc[:, 2], 1e-9, "d(creep)")
    assert_rel(gt, jdsc, 1e-9, "d(table)")


@pytest.mark.parametrize("kernel", ["sia2d_rhs", "rkc_interval"])
def test_functions_pass_gradcheck(kernel):
    """torch.autograd.gradcheck of both Functions in float64, on a fully
    glaciated 8×9 patch (away from the relu kink at H = 0), in H and in a
    scale factor on A (raw table) or creep (derived table)."""
    H, B, raw = _inputs(nx=24, ny=26)
    t = torch.from_numpy
    Hs = t(H[:2, 8:16, 8:17].copy()).requires_grad_(True)
    Bs = t(B[:2, 8:16, 8:17].copy())
    assert float(Hs.detach().min()) > 0.0
    scale = torch.ones(2, dtype=torch.float64, requires_grad=True)
    raw2 = t(raw[:2].copy())

    def fn(h, c):
        if kernel == "sia2d_rhs":
            table = torch.cat([raw2[:, :2], (c * raw2[:, 2])[:, None], raw2[:, 3:]], dim=1)
            return sia_kernel.sia2d_rhs(h, Bs, table, RHO, G, ETA0)
        d = _t_table(raw[:2])
        table = torch.cat([d[:, :2], (c * d[:, 2])[:, None], d[:, 3:]], dim=1)
        return rkc_kernel.rkc_interval(h, Bs, table, 0.01, 3, ETA0)

    assert torch.autograd.gradcheck(fn, (Hs, scale), eps=1e-6, atol=1e-5, rtol=1e-4)


def test_rkc_interval_checks():
    H, B, raw = _inputs()
    t = torch.from_numpy
    mixed = raw.copy()
    mixed[1, 4] = mixed[1, 5] = 4.0
    with pytest.raises(ValueError, match="different exponent sets"):
        rkc_kernel.rkc_interval(t(H), t(B), _t_table(mixed), DT, 4, ETA0)
    with pytest.raises(ValueError, match="s >= 2"):
        rkc_kernel.rkc_interval(t(H), t(B), _t_table(raw), DT, 1, ETA0)
    assert rkc_kernel.rkc_fits(128, 128, torch.float64)
    assert rkc_kernel.rkc_fits(256, 256, torch.float32)
    assert rkc_kernel.rkc_fits(256, 256, torch.float64)      # at 16 blocks only
    assert not rkc_kernel.rkc_fits(384, 384, torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        rkc_kernel.check_rkc_shape(512, 512, torch.float32)


# (nx, ny, dtype) -> (rows, bx, by, cells, smem bytes, blocks owning no row)
# at each cluster size, from csrc/rkc_interval.cu's layout: rows = ⌈nx/C⌉,
# by = min(rows, 16), bx = 32·min(⌈ny/32⌉, ⌊16/by⌋), 4 slabs of
# (rows + 2)·ny values
_LAYOUTS = {
    8: {(128, 128, torch.float32): (16, 32, 16, 4, 4 * 18 * 128 * 4, 0),
        (128, 128, torch.float64): (16, 32, 16, 4, 4 * 18 * 128 * 8, 0),
        (256, 256, torch.float32): (32, 32, 16, 16, 4 * 34 * 256 * 4, 0),
        (256, 256, torch.float64): (32, 32, 16, 16, 4 * 34 * 256 * 8, 0),
        (97, 131, torch.float32): (13, 32, 13, 5, 4 * 15 * 131 * 4, 0),
        (10, 33, torch.float64): (2, 64, 2, 1, 4 * 4 * 33 * 8, 3)},
    16: {(128, 128, torch.float32): (8, 64, 8, 2, 4 * 10 * 128 * 4, 0),
         (128, 128, torch.float64): (8, 64, 8, 2, 4 * 10 * 128 * 8, 0),
         (256, 256, torch.float32): (16, 32, 16, 8, 4 * 18 * 256 * 4, 0),
         (256, 256, torch.float64): (16, 32, 16, 8, 4 * 18 * 256 * 8, 0),
         (97, 131, torch.float32): (7, 64, 7, 3, 4 * 9 * 131 * 4, 2),
         (10, 33, torch.float64): (1, 64, 1, 1, 4 * 3 * 33 * 8, 6)},
}


@pytest.mark.parametrize("cluster", [8, 16])
def test_rkc_layout_arithmetic(cluster):
    """The RKC kernel's layout per cluster size: rows a block, threads,
    cells a thread, shared memory, blocks that own no row (10 and 97 rows
    leave some), and what fits: 256² in float64 and in float32 only at 16
    blocks (shared memory, cells a thread), 128² at both."""
    for (nx, ny, dtype), want in _LAYOUTS[cluster].items():
        lay = rkc_kernel.rkc_layout(nx, ny, dtype, cluster)
        assert (lay.rows, lay.bx, lay.by, lay.cells, lay.smem, lay.idle_blocks) == want
        assert lay.cluster == cluster and lay.bx % 32 == 0 and lay.bx * lay.by <= 512
        # every row is owned, by the first cluster - idle blocks
        owners = cluster - lay.idle_blocks
        assert (owners - 1) * lay.rows < nx <= owners * lay.rows
        big = (nx, ny) == (256, 256)
        assert lay.fits == (cluster == 16 or not big)
    assert rkc_kernel.rkc_layout(256, 256, torch.float64, 8).smem > 232448
    assert rkc_kernel.rkc_layout(256, 256, torch.float32, 8).smem <= 232448


# (nx, ny, dtype) -> (rows, bx, by, cells, smem bytes, blocks owning no row)
# at each cluster size, from csrc/si_step.cu's layout: rows = ⌈nx/C⌉, the
# threads of rkc_interval's layout, shared memory for two 8-byte mbarriers,
# M·p over rows + 2 rows, two halo rows of z and 64 values; None: no fit
# (too many cells)
_SI_LAYOUTS = {
    8: {(128, 128, torch.float32): (16, 32, 16, 4, 16 + (20 * 128 + 64) * 4, 0),
        (128, 128, torch.float64): (16, 32, 16, 4, 16 + (20 * 128 + 64) * 8, 0),
        (97, 131, torch.float32): (13, 32, 13, 5, 16 + (17 * 131 + 64) * 4, 0),
        (10, 33, torch.float64): (2, 64, 2, 1, 16 + (6 * 33 + 64) * 8, 3),
        (256, 256, torch.float64): None,
        (300, 300, torch.float32): None},
    16: {(128, 128, torch.float32): (8, 64, 8, 2, 16 + (12 * 128 + 64) * 4, 0),
         (128, 128, torch.float64): (8, 64, 8, 2, 16 + (12 * 128 + 64) * 8, 0),
         (97, 131, torch.float32): (7, 64, 7, 3, 16 + (11 * 131 + 64) * 4, 2),
         (10, 33, torch.float64): (1, 64, 1, 1, 16 + (5 * 33 + 64) * 8, 6),
         (256, 256, torch.float64): (16, 32, 16, 8, 16 + (20 * 256 + 64) * 8, 0),
         (300, 300, torch.float32): None},
}


@pytest.mark.parametrize("cluster", [8, 16])
def test_si_layout_arithmetic(cluster):
    """The SI cluster kernel's layout per cluster size (rows a block,
    threads, cells a thread, shared memory, blocks that own no row) and
    what fits; a plane that fits no cluster takes the large-plane path,
    chosen by shape alone (no device is asked)."""
    from odinn_tpu_torch.ops.cuda.build import SRC_DIR

    # the mbarrier bytes the layout counts are those the kernel skips
    source = (SRC_DIR / "si_step.cu").read_text()
    assert f"constexpr int kBarBytes = {si_kernel._BAR_BYTES};" in source
    for (nx, ny, dtype), want in _SI_LAYOUTS[cluster].items():
        lay = si_kernel.si_layout(nx, ny, dtype, cluster)
        assert lay.cluster == cluster and lay.bx % 32 == 0 and lay.bx * lay.by <= 512
        assert lay.fits == (want is not None)
        if want is not None:
            assert (lay.rows, lay.bx, lay.by, lay.cells, lay.smem, lay.idle_blocks) == want
            owners = cluster - lay.idle_blocks
            assert (owners - 1) * lay.rows < nx <= owners * lay.rows
        else:
            assert lay.cells > 8
    for nx, ny, dtype, fits in [(128, 128, torch.float32, True), (256, 256, torch.float64, True),
                                (128, 512, torch.float32, True), (128, 520, torch.float32, False),
                                (300, 300, torch.float32, False), (512, 256, torch.float64, False)]:
        assert si_kernel.si_fits(nx, ny, dtype) == fits
        if not fits:
            plan = si_kernel.si_plan(2, nx, ny, dtype, device="cuda:0")
            assert plan.layout is None and plan.path == "large-plane"


def test_pick_cluster():
    """The cluster choice the RKC and SI plans share, with the occupancy
    query faked (device -1 selects no device): 16 blocks when all n_g
    clusters of 16 are resident at once, or when the plane fits only at 16;
    else 8; a choice that cannot be scheduled, or a failed query, raises."""
    from odinn_tpu_torch.ops.cuda.common import pick_cluster

    def occupancy(active, err=0):
        def query(c, lay, n):
            n._obj.value = active[c]
            return err
        return query

    lay = {c: si_kernel.si_layout(128, 128, torch.float32, c) for c in (8, 16)}
    resident = {8: 15, 16: 7}
    assert pick_cluster("si_step", lay, occupancy(resident), 4, -1) == (lay[16], resident)
    assert pick_cluster("si_step", lay, occupancy(resident), 16, -1)[0] == lay[8]
    only16 = {c: si_kernel.si_layout(256, 256, torch.float64, c) for c in (8, 16)}
    assert not only16[8].fits and only16[16].fits
    assert pick_cluster("si_step", only16, occupancy(resident), 16, -1) == (only16[16],
                                                                          {8: 0, 16: 7})
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        pick_cluster("si_step", lay, occupancy({8: 0, 16: 0}), 4, -1)
    with pytest.raises(RuntimeError, match="occupancy query at 8 blocks failed"):
        pick_cluster("rkc_interval", lay, occupancy(resident, err=1), 4, -1)


def test_exponent_dispatch():
    """The RKC wrapper's exponent dispatch: (5, 2, 4, 2) takes the kernel's
    fixed-multiply specialisation; a non-integer set takes the runtime
    path; a batch whose glaciers differ is refused as before. (The
    pullback kernel picks the path per glacier from the table itself.)"""
    from odinn_tpu_torch.ops.cuda.common import GLEN_EXPS, uses_glen

    _, _, raw = _inputs()
    table = _t_table(raw)
    assert shared_exps(table) == GLEN_EXPS and uses_glen(shared_exps(table))
    glen3 = raw.copy()
    glen3[:, 4] = glen3[:, 5] = 3.5
    assert not uses_glen(shared_exps(_t_table(glen3)))
    assert not uses_glen((5.0, 2.0, 4.0, 3.0))
    mixed = raw.copy()
    mixed[1, 4] = mixed[1, 5] = 4.0
    assert shared_exps(_t_table(mixed)) is None and not uses_glen(None)
    H, B, _ = _inputs()
    with pytest.raises(ValueError, match="different exponent sets"):
        rkc_kernel.rkc_interval(torch.from_numpy(H), torch.from_numpy(B), _t_table(mixed), DT,
                                4, ETA0)


def test_si_step_refuses_mixed_exponent_sets():
    H, B, raw = _inputs()
    raw[1, 4] = raw[1, 5] = 4.0
    table = _t_table(raw)
    assert shared_exps(table) is None
    assert shared_exps(_t_table(_inputs()[2])) == (5.0, 2.0, 4.0, 2.0)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="different exponent sets"):
        si_kernel.si_step(t(H), t(H), t(B), t(H), table, DT)


@pytest.mark.parametrize("bad", ["small", "2d", "dtype", "shape", "table", "noncontig"])
def test_wrappers_check_inputs(bad):
    H, B, raw = _inputs()
    H, B, table = torch.from_numpy(H), torch.from_numpy(B), _t_table(raw)
    if bad == "small":
        H, B = H[:, :2].contiguous(), B[:, :2].contiguous()
    elif bad == "2d":
        H, B = H[0], B[0]
    elif bad == "dtype":
        H, B = H.to(torch.int64), B.to(torch.int64)
    elif bad == "shape":
        B = B[:, :-1].contiguous()
    elif bad == "table":
        table = table[:, :7]
    elif bad == "noncontig":
        H = H.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        si_kernel.si_step(H, H, B, H, table, DT, exps=(5.0, 2.0, 4.0, 2.0))
