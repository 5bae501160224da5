"""The port's sharding rules and cell registry (``launch/shardings.py``,
``configs/registry.build_cell``) against the JAX package's, for every cell
of ``all_cells()`` on both production meshes.

The JAX side builds its cells against ``AbstractMesh`` (eval_shape only,
no devices); the port's against a ``MeshShape`` (no process group).  For
each argument of each cell the key sets are compared first, then per key
the spec, the global shape and dtype, and the block shape: the port's
``shard_shape`` against ``NamedSharding(AbstractMesh, spec).shard_shape``.
Specs compare with every entry as a tuple of axis names and trailing
unsplit dims dropped (``P(("data",), None)`` is JAX's ``P(dp, None)``).
The placements are held against DTensor's own cut on a fake 256-rank mesh.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jregistry
from repro_torch.configs import registry as tregistry
from repro_torch.launch import shardings as sh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = jregistry.all_cells()


def _jkey(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                    for p in path)


def _norm(spec) -> tuple:
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in spec]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _cells(name):
    shape, axes = MESHES[name]
    tmesh = sh.MeshShape(axes, shape)
    return {c: (jregistry.build_cell(*c, _jax_mesh(name)),
                tregistry.build_cell(*c, tmesh), tmesh) for c in CELLS}


def _jax_leaves(tree, specs):
    leaves = dict((_jkey(p), x) for p, x in
                  jax.tree_util.tree_flatten_with_path(tree)[0])
    spec_of = dict((_jkey(p), s) for p, s in jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0])
    return leaves, spec_of


def test_all_cells_are_the_jax_packages():
    assert tregistry.all_cells() == CELLS
    assert len(CELLS) == 38
    assert [(a, s) for a, s in CELLS if s == "long_500k"] == [
        ("gemma2-2b", "long_500k"), ("gemma3-27b", "long_500k"),
        ("mixtral-8x7b", "long_500k")]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cell_specs_shapes_and_flops_equal_jax(cell, mesh_name):
    jcell, tcell, tmesh = _cells(mesh_name)[cell]
    jmesh = _jax_mesh(mesh_name)
    assert tcell.model_flops_per_step == jcell.model_flops_per_step
    assert tcell.donate == jcell.donate
    assert len(tcell.arg_shapes) == len(jcell.arg_shapes) == len(tcell.in_specs)
    total = 0
    for i, (ja, js, ta, ts) in enumerate(zip(jcell.arg_shapes, jcell.in_specs,
                                             tcell.arg_shapes, tcell.in_specs)):
        j_leaves, j_specs = _jax_leaves(ja, js)
        t_leaves, t_specs = dict(sh.tree_items(ta)), dict(sh.tree_items(ts))
        assert set(t_leaves) == set(j_leaves) == set(t_specs) == set(j_specs), i
        for k, jl in j_leaves.items():
            tl, tspec, jspec = t_leaves[k], t_specs[k], j_specs[k]
            assert tuple(tl.shape) == tuple(jl.shape), k
            assert str(tl.dtype).split(".")[-1] == str(jl.dtype), k
            assert _norm(tspec) == _norm(jspec), (k, tspec, jspec)
            block = sh.shard_shape(tl.shape, tspec, tmesh)
            assert block == tuple(NamedSharding(jmesh, jspec).shard_shape(
                jl.shape)), k
            total += int(np.prod(block)) * jl.dtype.itemsize
    assert tcell.argument_bytes(tmesh) == total


def test_optimizer_specs_mirror_the_params():
    tmesh = sh.MeshShape(("data", "model"), (16, 16))
    cell = tregistry.build_cell("mixtral-8x7b", "train_4k", tmesh)
    state = cell.in_specs[0]
    assert state.opt.step == sh.P()
    assert state.opt.mu == state.params == state.opt.nu
    moments = dict(sh.tree_items(cell.arg_shapes[0].opt.mu))
    assert {s.dtype for s in moments.values()} == {torch.bfloat16}


def test_block_slices_tile_each_leaf_data_major():
    mesh = sh.MeshShape(("data", "model"), (2, 2))
    spec = sh.P(None, ("data", "model"))
    full = torch.arange(3 * 8).reshape(3, 8)
    seen = []
    for d in range(2):
        for m in range(2):
            block = sh.local_block(full, spec, mesh, {"data": d, "model": m})
            assert block.shape == (3, 2)
            seen.append(block)
    assert torch.equal(torch.cat(seen, dim=1), full)  # block d * 2 + m
    assert sh.local_block(full, spec, mesh, {"data": 1, "model": 0})[0, 0] == 4
    with pytest.raises(ValueError, match="mesh order"):
        sh.shard_shape((4, 8), sh.P(None, ("model", "data")), mesh)
    with pytest.raises(ValueError, match="does not split"):
        sh.shard_shape((3, 6), sh.P(None, ("data", "model")), mesh)


def test_placements_cut_as_dtensor_does():
    """``placements`` on rank 0 of a fake 256-rank mesh: DTensor's block
    of each family's spec is the port's ``shard_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import group
    from repro_torch.launch.mesh import make_production_mesh

    cases = [((2304, 18432), sh.P(None, ("data", "model"))),
             ((256_000, 2304), sh.P("model", None)),
             ((8, 4096, 28672), sh.P(None, None, ("data", "model"))),
             ((128, 32768, 4, 256), sh.P(("data",), "model", None, None)),
             ((4096, 16), sh.P(("data", "model"), None))]
    with group.fake_ranks(256):
        mesh = make_production_mesh()
        assert sh.placements(cases[0][1], mesh) == (Shard(1), Shard(1))
        assert sh.placements(sh.P("model", None), mesh) == (Replicate(), Shard(0))
        with FakeTensorMode():
            for shape, spec in cases:
                dt = distribute_tensor(torch.empty(shape), mesh,
                                       sh.placements(spec, mesh))
                assert tuple(dt.to_local().shape) == sh.shard_shape(
                    shape, spec, mesh), (shape, spec)
