"""Mesh construction on ``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes
over the ranks that ``repro_torch.distributed.run_ranks`` started.  Each is
a FUNCTION, called inside a rank, so importing this module touches no
process group.  Rank ``r`` sits at the row-major coordinate of ``r`` in the
mesh's shape, where ``jax.make_mesh`` of the same shape puts device ``r``.
The mesh's device type is the group's: the card unless the ranks were
started with ``device="cpu"``.

Production shapes as in the JAX package:
  single-pod mesh: (data=16, model=16)
  multi-pod mesh:  (pod=2, data=16, model=16) = 512 ranks
"""
from __future__ import annotations

import contextlib
import math

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.group import current


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> DeviceMesh:
    """The ranks of this process group as a mesh of ``shape``, row-major."""
    comm = current()
    if math.prod(shape) != comm.topology.world_size:
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} ranks; "
                         f"the group has {comm.topology.world_size}")
    return init_device_mesh(comm.device.type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def debug_mesh_shape(n: int) -> tuple[int, int]:
    """(data, model) for ``n`` ranks: the largest model axis of 4, 2, 1
    that divides ``n``."""
    model = next(cand for cand in (4, 2, 1) if n % cand == 0)
    return (n // model, model)


def make_debug_mesh(n_devices: int | None = None) -> DeviceMesh:
    """Tiny mesh over every rank of the group (tests/CI)."""
    n = n_devices or current().topology.world_size
    return make_mesh(debug_mesh_shape(n), ("data", "model"))


def use_mesh(mesh):
    """A no-op context: every call site here passes ``mesh`` explicitly."""
    return contextlib.nullcontext(mesh)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axis bundle: ('pod','data') on multi-pod meshes."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)
