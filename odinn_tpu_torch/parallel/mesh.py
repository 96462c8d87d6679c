"""The registered scale-out mesh, single device only.

The JAX package registers a 1-D device mesh here
(``odinn_tpu.parallel.mesh.set_active_mesh``) that multi-start training and
ensemble Kalman inversion read to shard their member axis. The port runs
on one card: no mesh (``None``) or a mesh of one device behaves as in the
JAX package, where nothing is sharded; a mesh of more devices is refused
until the parallel layouts are ported (``ROADMAP.md``, Queue 1 item 9).
A mesh is anything with a ``size`` (the JAX package's ``Mesh`` has one),
or a sequence of devices.
"""

from __future__ import annotations

from typing import Any, Optional

__all__ = ["set_active_mesh", "active_mesh", "mesh_size", "check_single_device"]

_ACTIVE_MESH: Optional[Any] = None


def mesh_size(mesh) -> int:
    """The devices of ``mesh``: its ``size``, or its length."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    return int(size) if size is not None else len(mesh)


def check_single_device(mesh, what: str = "odinn_tpu_torch") -> None:
    """Raises for a mesh of more than one device."""
    n = mesh_size(mesh)
    if n > 1:
        raise NotImplementedError(
            f"{what}: a mesh of {n} devices shards work across cards, which "
            "comes with the parallel layouts (ROADMAP.md, Queue 1 item 9); "
            "the port runs on one card: pass mesh=None")


def set_active_mesh(mesh):
    """Register (or clear, with None) the process-wide mesh; a mesh of more
    than one device is refused."""
    global _ACTIVE_MESH
    check_single_device(mesh, "set_active_mesh")
    _ACTIVE_MESH = mesh
    return mesh


def active_mesh():
    """The mesh registered by :func:`set_active_mesh`, if any."""
    return _ACTIVE_MESH
