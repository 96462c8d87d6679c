"""Scale-out axis 2: grid-row sharding over a ``("glaciers", "rows")`` mesh.

The glacier axis (:mod:`odinn_tpu_torch.parallel.mesh`) stops helping when
one glacier's grid is the problem: an ice-sheet-scale domain, or planes that
outgrow one device. The JAX package adds a second mesh axis over grid rows
and lets XLA's SPMD partitioner insert the stencils' halo exchanges and the
CG dot products' ``psum``. The port's kernels each take a whole plane, so
the port writes the exchange out itself:

- the mesh is a 2-D ``DeviceMesh`` ``("glaciers", "rows")`` over every rank
  of a gloo job, rows the minor dimension (:func:`make_mesh_2d`);
- a rank holds its block of the glacier axis and its block of grid rows
  ``[lo, hi)`` of the padded plane (:func:`shard_spatial`). Every grid field
  of its batch is the own rows; the batch's :class:`RowShard` keeps the
  static fields (the bed, the observations) with ``halo`` ghost rows on
  each side, sliced once from the whole batch every rank loaded;
- every stencil reads at most one row beyond the cell it writes, and every
  kernel treats the outermost row of the plane it is given as the Dirichlet
  ring. So an operator runs, unchanged, on its rows plus ``h`` ghost rows
  copied from the neighbours (:class:`RowHalo`), and the rows it writes on
  the ghost rows are dropped: ``h`` = 1 for the RHS and the velocity, 2 for
  the semi-implicit assembly and pullback (the local ring then falls on a
  row no own equation reads), ``s`` for one RKC step of ``s`` stages. The
  own rows' outputs are, as functions, the global map's; the reverse
  direction is the exact transpose (ghost rows get a zero cotangent, and
  the cotangents landing on ghost-row inputs are sent back to their owners
  and added there);
- the semi-implicit step's PCG spans the whole grid: its two dot products
  are own-row partials summed over the row group (:func:`rows_sum`), and
  ``p`` gets one fresh ghost row each iteration
  (:func:`odinn_tpu_torch.ops.si_math.rows_cg`);
- θ stays whole on every rank; the loss and the θ gradient are summed over
  the whole mesh by the trainer's one ``all_reduce`` a step, with terms
  that do not read the grid counted on row rank 0 only;
- the host-driven controllers (the adaptive BS3(2) forward, the continuous
  adjoint's reverse solve) read each glacier's error norm through
  :func:`plane_mean`, summed over the row group only: glacier groups take
  different numbers of steps, so a collective over the whole job inside
  such a loop would deadlock. A decision over the whole job (a probe's
  step count, a calibration's distance) is one :func:`job_max` after the
  loop;
- a law that reads a grid (gridded temperature, degree-days, roughness)
  takes its inputs on the own rows, gathers them to the whole plane
  (:meth:`RowShard.whole`) and is applied there, as the JAX package's
  partitioned program computes it; each operator then reads the values of
  its slab (:func:`slab_rows`).

Transport is gloo on host buffers, as on the glacier axis: an exchange is
one host round trip (counted, with its wall seconds, in :data:`EXCHANGES`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from odinn_tpu_torch.core.glacier import is_in_glacier, map_tensors
from odinn_tpu_torch.ops.cuda.common import has_tangent
from odinn_tpu_torch.parallel.mesh import (
    GLACIER_AXIS, _world_size, mesh_rank, mesh_size, pad_batch_to, replicate, shard_glacier_axis)

__all__ = [
    "GRID_AXIS",
    "make_mesh_2d",
    "pad_batch_rows",
    "shard_spatial",
    "row_slab",
    "shard_theta_spatial",
    "shard_inversion_spatial",
    "RowShard",
    "RowHalo",
    "rows_sum",
    "plane_mean",
    "plane_max",
    "job_max",
    "job_sum",
    "slab_rows",
    "row_shard_of",
    "static_halo",
    "in_glacier",
    "gather_grid",
]

GRID_AXIS = "rows"
# every row-group collective of this process: its count and the wall
# seconds spent in it (reset it to 0 to measure a span)
EXCHANGES = {"calls": 0, "seconds": 0.0}
# the static slabs' ghost rows by default: the semi-implicit step's 2 and
# the loss masks' erosion distance, 3 by default (is_in_glacier)
DEFAULT_HALO = 3


def make_mesh_2d(n_glaciers: Optional[int] = None, n_rows: int = 2):
    """The 2-D ``DeviceMesh`` ``("glaciers", "rows")`` over the job's ranks,
    rows the minor dimension: ``n_rows`` ranks share each glacier's grid,
    ``n_glaciers`` groups (default: ranks // n_rows) split the glaciers.
    Raises ``ValueError`` when the job has fewer ranks than the mesh needs,
    and when it has more (one process per device: a mesh spans every rank).
    A job of one rank and a mesh of one device give None (no mesh)."""
    world = _world_size()
    if n_glaciers is None:
        n_glaciers = world // n_rows
    need = n_glaciers * n_rows
    if n_glaciers < 1 or need > world:
        raise ValueError(f"mesh ({n_glaciers}×{n_rows}) needs {max(need, n_rows)} devices, "
                         f"have {world} ranks in the torch.distributed job (one process per "
                         "device)")
    if need == 1:
        return None
    if need < world:
        raise ValueError(f"mesh ({n_glaciers}×{n_rows}) of {need} devices in a job of {world} "
                         "ranks: a mesh spans every rank (one process per device); start the "
                         f"job with {need} processes")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (n_glaciers, n_rows), mesh_dim_names=(GLACIER_AXIS, GRID_AXIS))


def _pad_rows(a, px, mode):
    """``a`` padded by ``px`` rows at the far end of axis −2."""
    if a is None:
        return None
    if mode == "edge":
        tail = a[..., -1:, :].expand(*a.shape[:-2], px, a.shape[-1])
        return torch.cat([a, tail], dim=-2)
    return torch.nn.functional.pad(a, (0, 0, 0, px))


def pad_batch_rows(batch, k: int):
    """A stacked batch's row (nx) axis padded to a multiple of ``k``, with
    the zero-dynamics contract of ``core.glacier.pad_glacier``: zero H₀,
    mask, observations, velocities and dh/dt; edge-replicated bed and
    gridded temperatures; ``npix`` pinned to the pre-padding pixel count
    and ``coords_x`` edge-padded. Returns ``(padded batch, original nx)``;
    the batch itself when nx divides by ``k``."""
    nx = batch.H0.shape[-2]
    if nx % k == 0:
        return batch, nx
    px = k - nx % k

    def zero(a):
        return _pad_rows(a, px, "zero")

    npix = batch.npix if batch.npix is not None else torch.full(
        (batch.H0.shape[0],), float(nx * batch.H0.shape[-1]), dtype=torch.float64,
        device=batch.H0.device)
    cx = batch.coords_x
    if cx is not None:
        cx = torch.cat([cx, cx[..., -1:].expand(*cx.shape[:-1], px)], dim=-1)
    g = batch.replace(H0=zero(batch.H0), B=_pad_rows(batch.B, px, "edge"), mask=zero(batch.mask),
                      npix=npix, coords_x=cx)
    if g.thickness_data is not None:
        g = g.replace(thickness_data=dataclasses.replace(g.thickness_data,
                                                         H=zero(g.thickness_data.H)))
    if g.velocity_data is not None:
        vd = g.velocity_data
        g = g.replace(velocity_data=dataclasses.replace(vd, vx=zero(vd.vx), vy=zero(vd.vy),
                                                        vabs=zero(vd.vabs)))
    if g.dhdt_data is not None:
        g = g.replace(dhdt_data=dataclasses.replace(g.dhdt_data, dhdt=zero(g.dhdt_data.dhdt)))
    clim = g.climate
    if clim is not None and getattr(clim, "longterm_temps_gridded", None) is not None:
        g = g.replace(climate=dataclasses.replace(
            clim, longterm_temps_gridded=_pad_rows(clim.longterm_temps_gridded, px, "edge")))
    return g, nx


# ---------------------------------------------------------------------------
# The row shard and its exchanges
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RowShard:
    """A rank's block of grid rows: ``[lo, hi)`` of the padded plane of
    ``nx`` rows, ``rank`` of ``size`` in the row group ``group`` (None: a
    group of one, no collective). ``ext`` is the batch's static slab, rows
    ``[lo − top, hi + bot)`` with (top, bot) = :meth:`extent` (``halo``):
    fewer ghost rows at the global edges, where the kernels' own ring is
    the plane's true ring."""

    lo: int = 0
    hi: int = 0
    nx: int = 0
    halo: int = DEFAULT_HALO
    rank: int = 0
    size: int = 1
    ext: Any = None
    group: Any = None

    @property
    def own(self) -> int:
        return self.hi - self.lo

    def extent(self, h: int):
        """(top, bottom) ghost rows of a slab of halo ``h``."""
        return min(h, self.lo), min(h, self.nx - self.hi)

    def _check(self, h):
        if h > self.halo:
            raise ValueError(f"an operator needs {h} ghost rows of the static fields; the row "
                             f"shard holds {self.halo} (shard_spatial(halo=…), static_halo)")

    def static(self, x, h: int):
        """A static slab field (carrying ``halo`` ghost rows) cut to ``h``."""
        self._check(h)
        pt, _ = self.extent(self.halo)
        t, b = self.extent(h)
        return x[..., pt - t:pt + self.own + b, :]

    def bed(self, h: int, dtype=None):
        """The bed on the slab of halo ``h``."""
        B = self.static(self.ext.B, h)
        return (B if dtype is None else B.to(dtype)).contiguous()

    def crop(self, y, h: int):
        """The own rows of a slab of halo ``h``."""
        t, _ = self.extent(h)
        return y[..., t:t + self.own, :]

    def pad(self, lam, h: int):
        """Own rows zero-padded to the slab of halo ``h`` (:meth:`crop`'s transpose)."""
        t, b = self.extent(h)
        return torch.nn.functional.pad(lam, (0, 0, t, b))

    def rows_of(self, x):
        """The own rows of a whole-plane field (nx rows)."""
        return x[..., self.lo:self.hi, :]

    def whole(self, x):
        """``x`` (own rows) joined over the row group into the whole
        (padded) plane: :meth:`halo_rows` with a halo that reaches the
        plane's ends, differentiable in both modes."""
        return self.halo_rows(x, self.nx)

    def halo_rows(self, x, h: int):
        """``x`` (own rows) extended by ``h`` ghost rows: :class:`RowHalo`,
        differentiable in both modes."""
        if x.requires_grad or has_tangent(x):
            return RowHalo.apply(x, self, int(h))
        return _halo_forward(self, x, int(h))

    def exchange(self, x, h: int):
        """``x`` (own rows) extended by ``h`` ghost rows by one all-gather,
        outside autograd."""
        return _halo_forward(self, x, int(h))

    def ghosts(self, x, h: int, extra=None):
        """The ghost rows of :meth:`exchange` alone, (top or None, bottom or
        None), and ``extra``'s rank-order sum on the host."""
        return _ghosts(self, x, int(h), extra)

    def rows_total(self, partial):
        """Per-rank partials summed over the row group in rank order, on the
        host: the same on every rank."""
        return _rank_sum(self.gather(partial.detach().to("cpu")), partial.dtype)

    def halo_transpose(self, g, h: int):
        """The transpose of :meth:`halo_rows`: the slab cotangent ``g`` (halo
        ``h``) on the own rows, each ghost row's cotangent sent back to its
        owner and added there."""
        return _halo_backward(self, g, int(h))

    def gather(self, host: torch.Tensor) -> list:
        """Every row rank's ``host`` buffer (equal shapes), in rank order."""
        if self.size == 1:
            return [host]
        import time

        import torch.distributed as dist

        t0 = time.perf_counter()
        parts = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(parts, host.contiguous(), group=self.group)
        EXCHANGES["calls"] += 1
        EXCHANGES["seconds"] += time.perf_counter() - t0
        return parts


def _rank_sum(parts, dtype):
    """The parts summed in rank order: bitwise the same on every rank."""
    total = parts[0].clone()
    for p in parts[1:]:
        total = total + p
    return total.to(dtype)


def _ghosts(shard: RowShard, x, h: int, extra=None):
    """One all-gather over the row group: (top ghost rows or None, bottom
    ghost rows or None, ``extra`` summed in rank order on the host or None)."""
    own = shard.own
    if x.shape[-2] != own:
        raise ValueError(f"a row-sharded field has {x.shape[-2]} rows, the shard owns {own}")
    t, b = shard.extent(h)
    k = min(h, own)
    lead, ny = tuple(x.shape[:-2]), x.shape[-1]
    send = torch.cat([x[..., :k, :], x[..., own - k:, :]], dim=-2).detach()
    n_rows = send.numel()
    flat = send.reshape(-1)
    if extra is not None:
        flat = torch.cat([flat, extra.detach().reshape(-1).to(flat.dtype)])
    parts = shard.gather(flat.to("cpu"))
    blocks = [p[:n_rows].reshape(lead + (2 * k, ny)) for p in parts]
    top, bot = [], []
    for q, blk in enumerate(blocks):
        qlo, qhi = q * own, (q + 1) * own
        a, e = max(shard.lo - t, qlo), min(shard.lo, qhi)          # q's rows above ours
        if a < e:
            base = qhi - k
            top.append(blk[..., k + a - base:k + e - base, :])
        a, e = max(shard.hi, qlo), min(shard.hi + b, qhi)          # q's rows below ours
        if a < e:
            bot.append(blk[..., a - qlo:e - qlo, :])

    def dev(pieces):
        return torch.cat(pieces, dim=-2).to(device=x.device, dtype=x.dtype) if pieces else None

    total = None
    if extra is not None:
        total = _rank_sum([p[n_rows:].reshape(extra.shape) for p in parts], extra.dtype)
    return dev(top), dev(bot), total


def _halo_forward(shard: RowShard, x, h: int):
    top, bot, _ = _ghosts(shard, x, h)
    pieces = [p for p in (top, x, bot) if p is not None]
    return torch.cat(pieces, dim=-2) if len(pieces) > 1 else x


def _halo_backward(shard: RowShard, g, h: int):
    own = shard.own
    t, b = shard.extent(h)
    # this rank's ghost cotangents, as two blocks of h rows: the top one
    # zero-padded in front (rows above the plane), the bottom one behind
    send = torch.cat([torch.nn.functional.pad(g[..., :t, :], (0, 0, h - t, 0)),
                      torch.nn.functional.pad(g[..., t + own:, :], (0, 0, 0, h - b))],
                     dim=-2).detach().to("cpu")
    parts = shard.gather(send)
    # the own rows that can receive: the first and last k, or all of them
    k = min(h, own)
    regions = [(0, own)] if 2 * k >= own else [(0, k), (own - k, own)]
    out = g[..., t:t + own, :].clone()
    for r0, r1 in regions:
        delta = torch.zeros(send.shape[:-2] + (r1 - r0, send.shape[-1]), dtype=send.dtype)
        hit = False
        for q, blk in enumerate(parts):
            if q == shard.rank:
                continue
            qlo, qhi = q * own, (q + 1) * own
            # q's top ghosts are rows [qlo − h, qlo), its bottom ones [qhi, qhi + h)
            for start, rows in ((qlo - h, blk[..., :h, :]), (qhi, blk[..., h:, :])):
                a, e = max(start, shard.lo + r0), min(start + h, shard.lo + r1)
                if a < e:
                    delta[..., a - shard.lo - r0:e - shard.lo - r0, :] += \
                        rows[..., a - start:e - start, :]
                    hit = True
        if hit:
            out[..., r0:r1, :] += delta.to(device=g.device, dtype=g.dtype)
    return out


class RowHalo(torch.autograd.Function):
    """Own rows → the slab of halo ``h`` (module doc). Forward: one
    all-gather over the row group of every rank's top and bottom ``h`` own
    rows (fewer if it owns fewer); each rank takes its ghost rows from the
    ranks that own them, so a halo wider than a neighbour's block reaches
    further ranks. Backward: the transpose, by the same kind of gather of
    the ghost rows' cotangents, each owner adding what lands on its rows in
    rank order. JVP: the forward applied to the tangent. Every rank of the
    row group calls it in the same order; a missing cotangent or tangent
    joins the collective as zeros."""

    @staticmethod
    def forward(ctx, x, shard, h):
        ctx.set_materialize_grads(False)
        ctx.shard, ctx.h = shard, h
        ctx.like = (x.shape, x.dtype, x.device)
        return _halo_forward(shard, x, h)

    @staticmethod
    def jvp(ctx, dx, *_):
        if dx is None:
            shape, dtype, dev = ctx.like
            dx = torch.zeros(shape, dtype=dtype, device=dev)
        return _halo_forward(ctx.shard, dx, ctx.h)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            shape, dtype, dev = ctx.like
            t, b = ctx.shard.extent(ctx.h)
            g = torch.zeros(shape[:-2] + (shape[-2] + t + b, shape[-1]), dtype=dtype, device=dev)
        return _halo_backward(ctx.shard, g, ctx.h), None, None


class _RowsSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, shard):
        ctx.shard = shard
        return _sum_over_rows(shard, v)

    @staticmethod
    def jvp(ctx, dv, _):
        return _sum_over_rows(ctx.shard, dv)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_over_rows(shard, v):
    parts = shard.gather(v.detach().to("cpu"))
    return _rank_sum(parts, v.dtype).to(v.device)


def rows_sum(v, shard: Optional[RowShard]):
    """``v`` (per-rank partials) summed over the row group in rank order,
    the same on every rank; ``v`` itself without a shard. Backward: the
    identity on each rank, the contract for a downstream value that every
    rank of the row group computes alike and counts once. JVP: the sum of
    the tangents."""
    if shard is None:
        return v
    if v.requires_grad or has_tangent(v):
        return _RowsSum.apply(v, shard)
    return _sum_over_rows(shard, v)


def plane_mean(q, shard: Optional[RowShard] = None):
    """Each glacier's mean of ``q`` over its plane (the last two axes). On a
    row shard: the own rows' sums summed over the row group
    (:func:`rows_sum`) and divided by the padded plane's cell count, the
    mean the JAX package's partitioned program takes over the padded plane;
    the same on every rank of the group."""
    if shard is None:
        return torch.mean(q, dim=(-2, -1))
    return rows_sum(torch.sum(q, dim=(-2, -1)), shard) / float(shard.nx * q.shape[-1])


def plane_max(x, shard: Optional[RowShard] = None):
    """Each glacier's max of ``x`` over its plane (the last two axes); on a
    row shard over the row group's rows (one gather), the same on every
    rank of the group."""
    m = torch.amax(x, dim=(-2, -1))
    if shard is None or shard.size == 1:
        return m
    parts = shard.gather(m.detach().to("cpu"))
    return torch.stack(parts).amax(dim=0).to(m.device)


def job_max(value: float) -> float:
    """A host number's max over every rank of the job (one ``all_reduce``
    of the world group, which a mesh spans): the same on every rank.
    Every rank must call it, so it stands outside the per-glacier loops."""
    import time

    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    EXCHANGES["calls"] += 1
    EXCHANGES["seconds"] += time.perf_counter() - t0
    return float(buf.item())


def job_sum(x: torch.Tensor) -> torch.Tensor:
    """A host tensor summed over every rank of the job (one ``all_reduce``
    of the world group, in its dtype), the same on every rank."""
    import time

    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = x.detach().to("cpu").clone().contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    EXCHANGES["calls"] += 1
    EXCHANGES["seconds"] += time.perf_counter() - t0
    return buf


def slab_rows(x, shard: RowShard, rows: int):
    """The rows of a whole-plane field ``x`` (``nx`` rows, or ``nx − 1`` on
    the staggered grid) that lie on this rank's slab of ``rows`` grid rows
    (the slab of the halo whose extent gives that count; its staggered
    grid has ``rows − 1``). Anything else (a number, a per-glacier column)
    is returned as it is."""
    if not isinstance(x, torch.Tensor) or x.ndim < 2:
        return x
    k = shard.nx - x.shape[-2]
    if k not in (0, 1):
        return x
    need = rows - shard.own              # the slab's ghost rows, top and bottom
    for h in range(max(need, 0) + 1):
        t, b = shard.extent(h)
        if t + b == need:
            return x[..., shard.lo - t:shard.hi + b - k, :]
    raise ValueError(f"no slab of the row shard [{shard.lo}, {shard.hi}) has {rows} rows")


def row_shard_of(glacier) -> Optional[RowShard]:
    """The glacier batch's row shard, or None (a whole plane)."""
    return None if glacier is None else getattr(glacier, "row_shard", None)


def in_glacier(H, distance: int, shard: Optional[RowShard] = None, static: bool = False):
    """``is_in_glacier(H, distance)`` on the own rows: on a row shard the
    erosion runs on ``H`` with ``distance`` ghost rows (a dynamic field,
    exchanged) or on the static slab ``H`` (``static``), then is cropped."""
    if shard is None:
        return is_in_glacier(H, distance)
    d = max(int(distance), 0)
    if static:
        return shard.crop(is_in_glacier(shard.static(H, d), distance), d)
    return shard.crop(is_in_glacier(shard.exchange(H.detach(), d), distance), d)


def static_halo(params, model=None) -> int:
    """The static slabs' ghost rows a training with ``params`` (and
    ``model``) reads: the semi-implicit step's 2, an RKC step's stages, the
    loss terms' erosion distances, and the ghost rows of the static fields
    that ``model``'s law inputs read (``halo``: roughness's stencil)."""
    h = max(DEFAULT_HALO, 2)
    if model is not None:
        for law in model.iceflow.laws.values():
            for spec in law.inputs:
                h = max(h, int(getattr(spec, "halo", 0)))
    if params.solver.solver == "RKC":
        h = max(h, int(params.solver.rkc_stages))
    seen = []

    def walk(obj):
        if obj is None or id(obj) in seen:
            return
        seen.append(id(obj))
        if isinstance(obj, (list, tuple)):
            for o in obj:
                walk(o)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if f.name == "distance" and isinstance(v, int):
                    nonlocal h
                    h = max(h, v)
                else:
                    walk(v)

    walk(params.UDE.empirical_loss_function)
    return h


def row_slab(batch, mesh, halo: int = DEFAULT_HALO):
    """Every glacier of ``batch`` on this rank's block of grid rows, its
    :class:`RowShard` attached with the static slab of ``halo`` ghost rows
    (the rows must divide by the mesh's rows dimension)."""
    n_r = mesh.size(1)
    nx, ny = batch.H0.shape[-2], batch.H0.shape[-1]
    if nx % n_r != 0:
        raise ValueError(f"a grid of {nx} rows does not split over {n_r} row ranks: pad it to a "
                         "multiple first (pad_batch_rows)")
    own = nx // n_r
    if own < 2:
        raise ValueError(f"{n_r} row ranks would own {own} row of a {nx}-row grid each; a "
                         "rank owns at least 2")
    r = int(mesh.get_local_rank(GRID_AXIS))
    lo, hi = r * own, (r + 1) * own
    top, bot = min(halo, lo), min(halo, nx - hi)

    def grid(a, a0, a1):
        return a[..., a0:a1, :] if (a.ndim >= 3 and a.shape[-2] == nx
                                    and a.shape[-1] == ny) else a

    if batch.npix is None:
        batch = batch.replace(npix=torch.full((batch.H0.shape[0],), float(nx * ny),
                                              dtype=torch.float64, device=batch.H0.device))
    ext = map_tensors(batch, lambda a: grid(a, lo - top, hi + bot))
    shard = RowShard(lo=lo, hi=hi, nx=nx, halo=int(halo), rank=r, size=n_r, ext=ext,
                     group=mesh.get_group(GRID_AXIS) if n_r > 1 else None)
    local = map_tensors(batch, lambda a: grid(a, lo, hi))
    return local.replace(row_shard=shard)


def shard_spatial(batch, mesh, halo: int = DEFAULT_HALO):
    """This rank's block of the glacier axis (``shard_glacier_axis``) on its
    block of grid rows, its :class:`RowShard` attached with the static slab
    of ``halo`` ghost rows. The glacier count and the row count must divide
    by the mesh's dimensions (``pad_batch_to``, :func:`pad_batch_rows`)."""
    return row_slab(shard_glacier_axis(batch, mesh), mesh, halo)


def shard_theta_spatial(theta, mesh, per_glacier_keys=("IC",)):
    """θ with this rank's glacier rows of its per-glacier entries (under
    ``per_glacier_keys``, leading axis divisible by the glacier dimension),
    and of those that are grids (rank ≥ 3) its block of grid rows when they
    divide by the rows dimension; shared entries are left whole."""
    from odinn_tpu_torch.parallel.mesh import _per_key

    n_g, n_r = mesh.size(0), mesh.size(1)
    g, r = mesh_rank(mesh), int(mesh.get_local_rank(GRID_AXIS))

    def place(key, x):
        if not (key in per_glacier_keys and isinstance(x, torch.Tensor) and x.ndim >= 1
                and x.shape[0] % n_g == 0):
            return x
        k = x.shape[0] // n_g
        x = x[g * k:(g + 1) * k]
        if x.ndim >= 3 and x.shape[-2] % n_r == 0:
            own = x.shape[-2] // n_r
            x = x[..., r * own:(r + 1) * own, :]
        return x

    return _per_key(theta, place)


def shard_inversion_spatial(theta, batch, mesh, halo: int = DEFAULT_HALO):
    """An inversion's (θ, glacier batch) placed on a 2-D mesh: the glacier
    axis padded to a multiple of the glacier dimension (``pad_batch_to``),
    the rows to a multiple of the rows dimension (:func:`pad_batch_rows`),
    this rank's block of both (:func:`shard_spatial`), and θ whole, as rank
    0 holds it. Returns ``(theta, local batch, original glacier count)``.
    Grid-shaped θ under row padding raises ``NotImplementedError``."""
    nx0 = batch.H0.shape[-2]
    batch, n_orig = pad_batch_to(batch, mesh_size(mesh))
    batch, _ = pad_batch_rows(batch, mesh.size(1))
    if batch.H0.shape[-2] != nx0:
        for path, x in _leaves_with_path(theta):
            if isinstance(x, torch.Tensor) and x.ndim >= 3 and x.shape[-2] == nx0:
                raise NotImplementedError(
                    f"spatial sharding with row padding ({nx0} → {batch.H0.shape[-2]}) is "
                    f"not supported with grid-shaped trainable θ ({path}); choose nx "
                    f"divisible by the mesh's 'rows' axis ({mesh.size(1)})")
    return replicate(theta, mesh), shard_spatial(batch, mesh, halo), n_orig


def _leaves_with_path(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def gather_grid(x, mesh, nx: int):
    """Rank blocks of a (glaciers, …, rows, ny) field joined over the whole
    2-D mesh, on ``x``'s device: the row group's blocks along axis −2,
    cropped to the first ``nx`` rows (the unpadded grid), then the glacier
    groups' blocks along axis 0."""
    import torch.distributed as dist

    host = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(mesh.size(1))]
    dist.all_gather(parts, host, group=mesh.get_group(GRID_AXIS))
    rows = torch.cat(parts, dim=-2)[..., :nx, :].contiguous()
    parts = [torch.empty_like(rows) for _ in range(mesh.size(0))]
    dist.all_gather(parts, rows, group=mesh.get_group(GLACIER_AXIS))
    return torch.cat(parts).to(x.device)
