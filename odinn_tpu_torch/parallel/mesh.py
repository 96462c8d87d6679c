"""Scale-out: the glacier axis split over the ranks of a torch.distributed job.

The JAX package shards the stacked glacier batch over a 1-D device mesh
axis ``"glaciers"`` and lets XLA insert the gradient ``psum``, or pins it
by hand (``make_shard_map_value_and_grad``). The port follows PyTorch's
idiom and that explicit variant:

- one process per device, joined by ``torch.distributed``
  (:mod:`odinn_tpu_torch.parallel.multiprocess`); the mesh is a 1-D
  ``DeviceMesh`` named ``("glaciers",)`` over every rank of the job
  (:func:`make_mesh`);
- every rank holds the whole inversion and solves its own contiguous block
  of the glacier axis (:func:`shard_glacier_axis`, through
  ``gather_batch``, so ``glacier_ids`` stay global and per-glacier θ rows
  still resolve), launching the kernels on its own glaciers only;
- the loss and the θ gradient are summed over the ranks by one explicit
  ``all_reduce`` a step (:func:`allreduce_sum`). θ stays whole on every
  rank: a per-glacier row's gradient is zero on the ranks that do not hold
  its glacier, so the sum is exact, and every host decision reads the same
  reduced numbers on every rank.

Collectives run over gloo on host buffers: they move θ-sized vectors (a few
kB) and the final gathers, which go to the host anyway, and gloo, unlike
NCCL, allows two ranks on one card. A mesh of one device, or None, runs as
no mesh. A 2-D mesh ``("glaciers", "rows")`` also splits each glacier's
grid rows (:mod:`odinn_tpu_torch.parallel.spatial`): :func:`mesh_size`,
:func:`mesh_rank` and the glacier padding then read its glacier dimension,
:func:`shard_inversion` dispatches to the spatial placement, and
:func:`allreduce_sum` and :func:`replicate` span every rank of the mesh. A
mesh is a ``DeviceMesh``, or, for one device, a sequence of one device (or
anything with a ``size`` of 1).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from odinn_tpu_torch.utils.flatten import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "GLACIER_AXIS",
    "make_mesh",
    "has_rows",
    "mesh_devices",
    "mesh_flat_rank",
    "mesh_size",
    "mesh_rank",
    "glacier_mesh",
    "shard_glacier_axis",
    "replicate",
    "shard_theta",
    "allreduce_sum",
    "gather_rows",
    "make_shard_map_value_and_grad",
    "pad_batch_to",
    "shard_inversion",
    "set_active_mesh",
    "active_mesh",
]

GLACIER_AXIS = "glaciers"
ROWS_AXIS = "rows"

_ACTIVE_MESH: Optional[Any] = None


def has_rows(mesh) -> bool:
    """Whether ``mesh`` has a ``"rows"`` dimension (grid-row sharding)."""
    return ROWS_AXIS in (getattr(mesh, "mesh_dim_names", None) or ())


def mesh_devices(mesh) -> int:
    """The devices of ``mesh``: a ``DeviceMesh``'s ``size()``, a JAX-style
    ``size`` attribute, or a sequence's length; 1 for None."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    if callable(size):
        size = size()
    return int(size) if size is not None else len(mesh)


def mesh_size(mesh) -> int:
    """The size of the mesh's glacier dimension: every device of a 1-D
    mesh, the glacier groups of a ``("glaciers", "rows")`` mesh; 1 for None."""
    if has_rows(mesh):
        return int(mesh.size(mesh.mesh_dim_names.index(GLACIER_AXIS)))
    return mesh_devices(mesh)


def mesh_rank(mesh) -> int:
    """This process's index along the mesh's glacier axis (0 without one)."""
    if mesh_devices(mesh) <= 1:
        return 0
    return int(mesh.get_local_rank(GLACIER_AXIS))


def mesh_flat_rank(mesh) -> int:
    """This process's index among every rank of the mesh, rows the minor
    dimension of a 2-D one (0 without a mesh)."""
    if mesh_devices(mesh) <= 1:
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def glacier_mesh(mesh, what: str = "odinn_tpu_torch"):
    """``mesh`` as the trainers take it: None for no mesh or one of one
    device, else the ``DeviceMesh`` (1-D, or 2-D with a ``"rows"``
    dimension). A sequence of several devices raises ``TypeError`` (a mesh
    of several devices spans the ranks of a job)."""
    if mesh is None:
        return None
    n = mesh_devices(mesh)
    if n <= 1:
        return None
    if not hasattr(mesh, "get_group"):
        raise TypeError(
            f"{what}: a mesh of {n} devices is a DeviceMesh over the ranks of a "
            "torch.distributed job, one process per device: call init_distributed "
            "in each process, then make_mesh()")
    return mesh


def set_active_mesh(mesh):
    """Register (or clear, with None) the process-wide mesh that
    ``train_ude``, ``multistart_train`` and ``eki_train`` take by default."""
    global _ACTIVE_MESH
    glacier_mesh(mesh, "set_active_mesh")
    _ACTIVE_MESH = mesh
    return mesh


def active_mesh():
    """The mesh registered by :func:`set_active_mesh`, if any."""
    return _ACTIVE_MESH


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None):
    """The 1-D ``DeviceMesh`` ``("glaciers",)`` over the job's ranks, or
    None for a job of one rank (no mesh). Raises ``ValueError`` when the
    job has fewer than ``n_devices`` ranks, and when it has more: one
    process drives one device, so a mesh spans every rank of its job."""
    world = _world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world} ranks in the "
                         "torch.distributed job (one process per device)")
    if n <= 1:
        return None
    if n < world:
        raise ValueError(f"mesh of {n} devices in a job of {world} ranks: a mesh spans "
                         "every rank (one process per device); start the job with "
                         f"{n} processes")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (n,), mesh_dim_names=(GLACIER_AXIS,))


def _group(mesh):
    return mesh.get_group(GLACIER_AXIS)


def _mesh_group(mesh):
    """The process group of every rank of ``mesh``: its glacier group for a
    1-D mesh; for a 2-D one the job's (a mesh spans every rank of its job,
    as :func:`make_mesh` and ``make_mesh_2d`` build it)."""
    return None if has_rows(mesh) else _group(mesh)


def _flat_host(tensors):
    """The tensors raveled into one host buffer of their promoted dtype."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.detach().reshape(-1).to(device="cpu", dtype=dtype) for t in tensors])


def _unflat(flat, like):
    out, i = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[i:i + n].reshape(t.shape).to(device=t.device, dtype=t.dtype))
        i += n
    return out


def allreduce_sum(tensors, mesh) -> list:
    """Each tensor summed over every rank of the mesh (both dimensions of a
    2-D one), on its own device and in its own dtype: one ``all_reduce`` of
    one host buffer in the promoted dtype. Every rank gets the same
    numbers."""
    return _allreduce(tensors, _mesh_group(mesh))


def _allreduce(tensors, group) -> list:
    import torch.distributed as dist

    tensors = list(tensors)
    flat = _flat_host(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return _unflat(flat, tensors)


def gather_rows(x: torch.Tensor, mesh=None, nx: Optional[int] = None) -> torch.Tensor:
    """The ranks' blocks of ``x`` (equal shapes) concatenated along axis 0
    in rank order, on ``x``'s device: an ``all_gather`` of host copies over
    the mesh's ranks (None: every rank of the job). On a 2-D mesh ``x`` is
    a (glaciers, …, rows, ny) block: joined along the rows dimension first,
    cropped to the first ``nx`` rows (the unpadded grid; default all), then
    along the glacier dimension (``spatial.gather_grid``)."""
    import torch.distributed as dist

    if has_rows(mesh):
        from odinn_tpu_torch.parallel.spatial import gather_grid

        return gather_grid(x, mesh, x.shape[-2] * mesh.size(1) if nx is None else nx)
    group = None if mesh is None else _group(mesh)
    host = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts).to(x.device)


def replicate(tree, mesh):
    """``tree`` (θ, optimizer state) as rank 0 holds it, on every rank: one
    broadcast of one host buffer; each leaf keeps its device and dtype."""
    import torch.distributed as dist

    mesh = glacier_mesh(mesh, "replicate")
    if mesh is None:
        return tree
    leaves = tree_leaves(tree)
    flat = _flat_host(leaves)
    group = _mesh_group(mesh)
    dist.broadcast(flat, src=0 if group is None else dist.get_global_rank(group, 0), group=group)
    return tree_unflatten(tree, _unflat(flat, leaves))


def _block(n: int, mesh):
    size = mesh_size(mesh)
    if n % size != 0:
        raise ValueError(f"a glacier axis of {n} does not split over {size} ranks: pad it "
                         "to a multiple first (pad_batch_to)")
    k = n // size
    r = mesh_rank(mesh)
    return r * k, (r + 1) * k


def shard_glacier_axis(batch, mesh):
    """This rank's contiguous block of the stacked batch's glacier axis
    (``gather_batch``: ``glacier_ids`` stay the batch's own indices). The
    glacier count must divide by the mesh size (:func:`pad_batch_to`)."""
    from odinn_tpu_torch.simulation.inversion import gather_batch

    mesh = glacier_mesh(mesh, "shard_glacier_axis")
    if mesh is None:
        return batch
    lo, hi = _block(batch.H0.shape[0], mesh)
    return gather_batch(batch, torch.arange(lo, hi))


def _is_per_glacier(key, x, keys, n_g, size) -> bool:
    return (key in keys and isinstance(x, torch.Tensor) and x.ndim >= 1
            and (n_g is None or x.shape[0] == n_g) and x.shape[0] % size == 0)


def _per_key(theta, fn):
    """``fn(key, leaf)`` over a θ dict's leaves, keyed by their top-level
    slot (a non-dict θ has no slot)."""
    if isinstance(theta, dict):
        return {k: tree_map(lambda x, k=k: fn(k, x), v) for k, v in theta.items()}
    return tree_map(lambda x: fn(None, x), theta)


def shard_theta(theta, mesh, per_glacier_keys=("IC",)):
    """θ with this rank's rows of its per-glacier entries (those under
    ``per_glacier_keys`` whose leading axis divides by the mesh size);
    shared entries are left whole."""
    mesh = glacier_mesh(mesh, "shard_theta")
    if mesh is None:
        return theta
    size = mesh_size(mesh)

    def place(key, x):
        if _is_per_glacier(key, x, per_glacier_keys, None, size):
            lo, hi = _block(x.shape[0], mesh)
            return x[lo:hi]
        return x

    return _per_key(theta, place)


def make_shard_map_value_and_grad(model, params, tstops, mesh, per_glacier_keys=("IC", "A")):
    """The explicit-collective step: ``value_and_grad(theta, batch)`` →
    (loss, gradient tree). Each rank takes its block of the glacier axis
    and of θ's per-glacier entries (under ``per_glacier_keys``, leading
    axis = the glacier count), computes its loss and gradient by autograd
    with shard-local glacier indices, and sums the loss and the shared
    entries' gradients over the ranks in one ``all_reduce``; the
    per-glacier entries' gradients stay local, this rank's rows. On a 2-D
    mesh the glacier axis alone is mapped, as the JAX package's
    ``shard_map`` maps it: each rank takes its glacier group's block with
    whole planes (the ranks of a row group hold replicas), and the sums run
    over the glacier axis only."""
    from odinn_tpu_torch.simulation.inversion import batch_transient_loss

    mesh = glacier_mesh(mesh, "make_shard_map_value_and_grad")
    size = mesh_size(mesh)

    def value_and_grad(theta, batch):
        n_g = batch.H0.shape[0]
        local = shard_glacier_axis(batch, mesh).replace(glacier_ids=None)

        def per_glacier(key, x):
            return size > 1 and _is_per_glacier(key, x, per_glacier_keys, n_g, size)

        def place(key, x):
            x = x.detach()
            if per_glacier(key, x):
                lo, hi = _block(n_g, mesh)
                x = x[lo:hi]
            return x.clone().requires_grad_(True)

        th = _per_key(theta, place)
        sharded = tree_leaves(_per_key(theta, per_glacier))
        leaves = tree_leaves(th)
        loss = batch_transient_loss(th, local, model, params, tstops)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if size > 1:
            shared = [i for i, s in enumerate(sharded) if not s]
            summed = _allreduce([loss.detach()] + [grads[i] for i in shared], _group(mesh))
            loss = summed[0]
            for i, g in zip(shared, summed[1:]):
                grads[i] = g
        return loss.detach(), tree_unflatten(th, grads)

    return value_and_grad


def pad_batch_to(batch, n: int):
    """The glacier axis padded to a multiple of ``n`` by repeating the last
    glacier with its thickness and velocity observations and its mask
    zeroed, so the padded lanes add exactly zero loss and gradient; their
    ``glacier_ids`` point at the last glacier's θ rows. Returns
    (padded batch, original glacier count)."""
    from odinn_tpu_torch.simulation.inversion import gather_batch

    b = batch.H0.shape[0]
    if b % n == 0:
        return batch, b
    pad = n - b % n
    idx = torch.cat([torch.arange(b), torch.full((pad,), b - 1, dtype=torch.long)])
    padded = gather_batch(batch, idx)

    def zero_padded(x):
        if x is None or x.ndim < 1 or x.shape[0] != b + pad:
            return x
        x = x.clone()
        x[b:] = 0.0
        return x

    td, vd = padded.thickness_data, padded.velocity_data
    if td is not None:
        padded = padded.replace(thickness_data=td.__class__(t=td.t, H=zero_padded(td.H)))
    if vd is not None:
        import dataclasses

        padded = padded.replace(velocity_data=dataclasses.replace(
            vd, vx=zero_padded(vd.vx), vy=zero_padded(vd.vy), vabs=zero_padded(vd.vabs)))
    return padded.replace(mask=zero_padded(padded.mask)), b


def shard_inversion(theta, batch, mesh, halo: Optional[int] = None):
    """An inversion's (θ, glacier batch) placed for training on ``mesh``:
    the glacier axis padded to a multiple of the mesh size
    (:func:`pad_batch_to`), this rank's block of it, and θ whole, as rank 0
    holds it (:func:`replicate`). Returns ``(theta, local batch,
    original glacier count)``. A mesh with a ``"rows"`` dimension takes the
    spatial placement (``spatial.shard_inversion_spatial``), its static
    slabs with ``halo`` ghost rows (default ``spatial.DEFAULT_HALO``)."""
    mesh = glacier_mesh(mesh, "shard_inversion")
    if mesh is None:
        return theta, batch, batch.H0.shape[0]
    if has_rows(mesh):
        from odinn_tpu_torch.parallel.spatial import DEFAULT_HALO, shard_inversion_spatial

        return shard_inversion_spatial(theta, batch, mesh,
                                       DEFAULT_HALO if halo is None else halo)
    padded, n_orig = pad_batch_to(batch, mesh_size(mesh))
    return replicate(theta, mesh), shard_glacier_axis(padded, mesh), n_orig
