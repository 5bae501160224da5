"""Per-rank code on a named mesh: the installed mesh, axis arithmetic, and
collectives that autograd can differentiate.

The JAX package writes its sharded regions under ``shard_map`` and reads
its mesh from the abstract-mesh context that ``jit`` installs.  Here each
rank runs the region itself: ``use_mesh(mesh)`` installs a
``DeviceMesh`` (``current_mesh()`` reads it back), and the collectives
below move tensors between the ranks of named axes through the counted
collectives of ``distributed/group.py``.

Axes are named by a string or a tuple of strings.  A tuple is flattened
row-major in mesh order, as ``PartitionSpec(("data", "model"))`` cuts a
dim: the rank at data coordinate d and model coordinate m holds block
``d * n_model + m``.

Each collective has its exact adjoint, so a loss that is the SUM of the
ranks' local losses gets the right gradient on every rank:

  psum    forward: sum over the axes;  backward: sum over the axes.
  gather  forward: every rank's block, concatenated along ``dim``;
          backward: a reduce-scatter over the axes (this rank's block of
          the sum).
  psum_scatter  forward: this rank's block of the sum over the axes (a
          reduce-scatter);  backward: gather.
  permute forward: this rank's tensor goes to one rank, and one rank's
          comes here;  backward: the inverse permutation.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import group

_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` for the sharded variants of the models in this
    block (the JAX package's ``jax.set_mesh``)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost installed mesh, or None."""
    return _MESHES[-1] if _MESHES else None


def as_axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes) -> int:
    names = mesh.mesh_dim_names
    n = 1
    for ax in as_axes(axes):
        n *= mesh.shape[names.index(ax)]
    return n


def axis_index(mesh, axes) -> int:
    """This rank's block index over ``axes``, flattened row-major."""
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    i = 0
    for ax in as_axes(axes):
        i = i * mesh.shape[names.index(ax)] + coord[names.index(ax)]
    return i


def _psum(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    x = x.clone()
    for ax in axes:
        if axis_size(mesh, ax) > 1:
            group.all_reduce(x, mesh.get_group(ax))
    return x


def _gather(x: torch.Tensor, mesh, axes: tuple[str, ...], dim: int):
    # innermost axis first: its blocks are adjacent in the flattened order
    for ax in reversed(axes):
        if axis_size(mesh, ax) == 1:
            continue
        stacked = group.all_gather(x, mesh.get_group(ax))  # [n, ...]
        x = stacked.movedim(0, dim).flatten(dim, dim + 1)
    return x


def block(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes``, a copy of
    its own: a view would hold all of ``x`` for as long as the block lives
    (a gathered weight's whole gradient, held by its layer's block until
    the stacked leaf's gradient is formed)."""
    n = axis_size(mesh, as_axes(axes))
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, as_axes(axes)) * size, size).clone(
        memory_format=torch.contiguous_format)


def _reduce_scatter(g: torch.Tensor, mesh, axes: tuple[str, ...], dim: int):
    # the adjoint of _gather: outermost axis first
    for ax in axes:
        if axis_size(mesh, ax) > 1:
            g = group.reduce_scatter(g.movedim(dim, 0),
                                     mesh.get_group(ax)).movedim(0, dim)
    return g.contiguous()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x.contiguous(), mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim), None,
                None, None)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst, src):
        ctx.dst, ctx.src = dst, src
        return group.permute(x, None, dst, src)

    @staticmethod
    def backward(ctx, g):
        return group.permute(g, None, ctx.src, ctx.dst), None, None


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a new tensor)."""
    mesh = mesh or current_mesh()
    axes = tuple(a for a in as_axes(axes) if axis_size(mesh, a) > 1)
    if not axes:
        return x
    return _Psum.apply(x, mesh, axes)


def gather(x: torch.Tensor, axes, dim: int, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, concatenated along ``dim`` in
    block order (the inverse of ``block``)."""
    mesh = mesh or current_mesh()
    axes = tuple(a for a in as_axes(axes) if axis_size(mesh, a) > 1)
    if not axes:
        return x
    return _Gather.apply(x, mesh, axes, dim % x.dim())


def psum_scatter(x: torch.Tensor, axes, dim: int, mesh=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``axes``
    (the adjoint of ``gather``)."""
    mesh = mesh or current_mesh()
    axes = tuple(a for a in as_axes(axes) if axis_size(mesh, a) > 1)
    if not axes:
        return x
    return _PsumScatter.apply(x, mesh, axes, dim % x.dim())


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axes`` (no gradient)."""
    mesh = mesh or current_mesh()
    axes = tuple(a for a in as_axes(axes) if axis_size(mesh, a) > 1)
    if not axes:
        return x
    x = x.detach().clone(memory_format=torch.contiguous_format)
    for ax in axes:
        group.all_reduce(x, mesh.get_group(ax), op=torch.distributed.ReduceOp.MAX)
    return x


def permute(x: torch.Tensor, dest: list[int], mesh=None) -> torch.Tensor:
    """A collective permute over every rank of the mesh: the rank at block
    index ``i`` over every axis (row-major) sends ``x`` to the rank at
    ``dest[i]`` and receives the ``x`` of the rank whose ``dest`` is its
    own index.  ``dest`` is a permutation; every rank's ``x`` has one
    shape.  The mesh spans the whole process group."""
    mesh = mesh or current_mesh()
    every = tuple(mesh.mesh_dim_names)
    n = axis_size(mesh, every)
    if sorted(dest) != list(range(n)):
        raise ValueError(f"dest must be a permutation of range({n})")
    if n == 1:
        return x
    if torch.distributed.get_world_size() != n:
        raise ValueError("permute: the mesh must span the whole process group")
    ranks = mesh.mesh.flatten().tolist()
    i = axis_index(mesh, every)
    return _Permute.apply(x, ranks[dest[i]], ranks[dest.index(i)])
