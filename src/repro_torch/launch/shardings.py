"""Sharding rules: per-leaf specs per architecture family, and their
placements on a ``DeviceMesh``.

The port of ``repro/launch/shardings.py``.  A spec is a ``P``: one entry
per dim, each None, an axis name or a tuple of axis names, as a JAX
``PartitionSpec`` holds them.  Each builder returns the port's tree (dicts
and lists of the params, ``TrainState`` / ``AdamWState`` / ``KVCache``
fields, a ``GraphBatch``) with a ``P`` at every leaf.  ``placements``
turns a spec into DTensor placements, ``shard_shape`` and ``block_slices``
give a rank's block; the builders and these take any mesh with
``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``, or a ``MeshShape`` for
planning without a process group).

Conventions (as in the JAX package):
  LM params     — attention weights Megatron-split on "model" (qkv on
                  columns, o on rows); embeddings and the head split on
                  the vocab; FFN / expert weights split on d_ff over EVERY
                  axis (ZeRO-3 storage, gathered at use).
  LM batch      — tokens over the data-parallel bundle ("pod", "data").
  KV cache      — decode: S over "model" (over every axis at batch 1);
                  prefill: head_dim over "model".
  GNN           — nodes and edges over every axis; params replicated.
  FM            — table rows over "model" (table-parallel), batch over DP.
  Optimizer     — moments inherit their parameter's spec; step replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.common.struct import is_static
from repro_torch.launch.mesh import dp_axes


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(("data", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A global argument's shape and dtype (JAX's ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without a process group."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


# ------------------------------------------------------------- trees --

def _is_leaf(x) -> bool:
    if isinstance(x, (P, ShapeDtype)):
        return True
    return not (isinstance(x, (dict, list, tuple))
                or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def _children(tree) -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if dataclasses.is_dataclass(tree):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree) if not is_static(f)]
    return [(str(i), x) for i, x in enumerate(tree)]


def tree_items(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs, keys joined by "/", in JAX's flattening order
    (dict keys sorted, sequences and NamedTuple fields in order)."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for k, v in _children(tree):
        out += tree_items(v, f"{prefix}/{k}" if prefix else k)
    return out


def tree_map(fn: Callable, tree, *rest, prefix: str = ""):
    """``tree``'s structure with ``fn(key, leaf, *leaves of rest)``;
    static fields are kept as they are."""
    if _is_leaf(tree):
        return fn(prefix, tree, *rest)

    def sub(k, v, others):
        return tree_map(fn, v, *others, prefix=f"{prefix}/{k}" if prefix else k)

    if isinstance(tree, dict):
        return {k: sub(k, tree[k], [r[k] for r in rest]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[sub(f, getattr(tree, f),
                                [getattr(r, f) for r in rest])
                            for f in tree._fields])
    if dataclasses.is_dataclass(tree):
        upd = {f.name: sub(f.name, getattr(tree, f.name),
                           [getattr(r, f.name) for r in rest])
               for f in dataclasses.fields(tree) if not is_static(f)}
        return dataclasses.replace(tree, **upd)
    return type(tree)(sub(str(i), x, [r[i] for r in rest])
                      for i, x in enumerate(tree))


def _replicated(leaf) -> P:
    return P(*((None,) * len(leaf.shape)))


# ---------------------------------------------------------- placements --

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check(spec: P, ndim: int, mesh) -> None:
    names = mesh.mesh_dim_names
    if len(spec) > ndim:
        raise ValueError(f"{spec} has more entries than the {ndim} dims")
    seen = []
    for entry in spec:
        axes = _entry_axes(entry)
        for ax in axes:
            if ax not in names:
                raise ValueError(f"{spec}: no mesh axis {ax!r} in {names}")
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"{spec}: the axes of one dim must come in mesh "
                             f"order {names}")
        seen += axes
    if len(set(seen)) != len(seen):
        raise ValueError(f"{spec} names an axis twice")


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on each axis that cuts dim d, else ``Replicate()``.  A dim
    cut by several axes is cut by them in mesh order, each within the
    last's block, as JAX cuts it (data-major)."""
    from torch.distributed.tensor import Replicate, Shard

    _check(spec, len(spec), mesh)
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for ax in _entry_axes(entry):
            out[mesh.mesh_dim_names.index(ax)] = Shard(d)
    return tuple(out)


def _ways(entry, mesh) -> int:
    return math.prod(mesh.shape[mesh.mesh_dim_names.index(a)]
                     for a in _entry_axes(entry))


def shard_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` array under ``spec``."""
    shape = tuple(shape)
    _check(spec, len(shape), mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _ways(entry, mesh)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {shape} does not split {n} ways "
                             f"under {spec}")
        out[d] = shape[d] // n
    return tuple(out)


def block_slices(shape, spec: P, mesh, coord: dict) -> tuple[slice, ...]:
    """The slices of the block held by the rank at ``coord`` ({axis:
    index}) of a ``shape`` array under ``spec``."""
    local = shard_shape(shape, spec, mesh)
    names = mesh.mesh_dim_names
    out = []
    for d, size in enumerate(local):
        entry = spec[d] if d < len(spec) else None
        i = 0
        for ax in _entry_axes(entry):
            i = i * mesh.shape[names.index(ax)] + coord[ax]
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def mesh_coord(mesh) -> dict:
    """This rank's {axis: index} on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_block(full: torch.Tensor, spec: P, mesh, coord: dict | None = None):
    """The block of ``full`` that this rank (or the rank at ``coord``)
    holds under ``spec``, as a copy of its own."""
    coord = mesh_coord(mesh) if coord is None else coord
    return full[block_slices(full.shape, spec, mesh, coord)].clone(
        memory_format=torch.contiguous_format)


def local_shapes(shapes, specs, mesh):
    """A tree of ``ShapeDtype``: each leaf's block on one rank."""
    return tree_map(lambda _k, s, p: ShapeDtype(shard_shape(s.shape, p, mesh),
                                                s.dtype), shapes, specs)


def bytes_per_rank(shapes, specs, mesh) -> int:
    """The exact sum of one rank's blocks' bytes."""
    return sum(s.nbytes for _, s in tree_items(local_shapes(shapes, specs, mesh))
               if isinstance(s, ShapeDtype))


def shard_tree(tree, specs, mesh, coord: dict | None = None):
    """Each tensor of ``tree`` cut to this rank's block of its spec."""
    def cut(_k, x, p):
        if not isinstance(x, torch.Tensor):
            return x
        out = local_block(x.detach(), p, mesh, coord)
        return out.requires_grad_(x.requires_grad)
    return tree_map(cut, tree, specs)


# ------------------------------------------------------------------- LM ---

def lm_param_specs(params_shape: Any, mesh) -> Any:
    """Map each param leaf to a spec by name and rank.

    FFN weights (the parameter bulk, all of it for MoE archs) are split
    over EVERY mesh axis on d_ff (ZeRO-3 storage, gathered per layer at
    use); attention weights stay Megatron-split on "model" only."""
    ff_axes = tuple(mesh.mesh_dim_names)

    def rule(key, leaf):
        nd = len(leaf.shape)
        base = key.split("/")[-1]

        def spec(*tail):  # stacked layer leaves carry a leading (n_per,) dim
            return P(*((None,) * (nd - len(tail)) + tail))

        if "embed" in base or "lm_head" in base:
            return P("model", None) if base == "embed" else P(None, "model")
        if base in ("wq", "wk", "wv"):
            return spec(None, "model")
        if base == "wo":
            return spec("model", None)
        if base == "w_in":  # dense (D,F) or moe (E,D,F): F over all axes
            return spec(None, ff_axes)
        if base == "w_out":  # dense (F,D) or moe (E,F,D): F over all axes
            return spec(ff_axes, None)
        if base == "router":
            return spec(None, None)
        return _replicated(leaf)  # norms, biases, gates

    return tree_map(rule, params_shape)


def lm_batch_specs(mesh) -> dict:
    dp = dp_axes(mesh)
    return {"tokens": P(dp, None), "labels": P(dp, None)}


def lm_cache_specs(cache_shape, mesh, *, batch: int, kind: str = "decode") -> Any:
    """KV-cache specs.  decode: S over "model" (over every axis at batch
    1); prefill writes the whole prompt at once, so S stays whole and
    head_dim goes over "model"."""
    dp = dp_axes(mesh)
    every = tuple(mesh.mesh_dim_names)

    def rule(_key, leaf):
        nd = len(getattr(leaf, "shape", ()))  # the port's length is an int
        if nd == 0:  # length scalar
            return P()
        if nd == 6:  # (n_per, per, B, S, KV, Dh)
            if kind == "prefill":
                return P(None, None, dp, None, None, "model")
            if batch == 1:
                return P(None, None, None, every, None, None)
            return P(None, None, dp, "model", None, None)
        if nd == 5:  # tail cache (rem, B, S, KV, Dh)
            if kind == "prefill":
                return P(None, dp, None, None, "model")
            if batch == 1:
                return P(None, None, every, None, None)
            return P(None, dp, "model", None, None)
        return _replicated(leaf)

    return tree_map(rule, cache_shape)


def opt_state_specs(param_specs: Any) -> Any:
    """AdamWState(step, mu, nu): moments mirror params."""
    from repro_torch.training.optimizer import AdamWState

    return AdamWState(step=P(), mu=param_specs, nu=param_specs)


# ------------------------------------------------------------------ GNN ---

def gnn_graph_specs(mesh, n_graphs: int = 1) -> Any:
    """GraphBatch leaf specs: nodes and edges over every axis."""
    from repro_torch.models.gnn.graph import GraphBatch

    ax = tuple(mesh.mesh_dim_names)
    return GraphBatch(
        node_feat=P(ax, None), edge_src=P(ax), edge_dst=P(ax),
        edge_feat=P(ax, None), positions=P(ax, None), node_mask=P(ax),
        edge_mask=P(ax), graph_id=P(ax), n_graphs=n_graphs)


def gnn_param_specs(params_shape: Any) -> Any:
    return tree_map(lambda _k, leaf: _replicated(leaf), params_shape)


# ------------------------------------------------------------------- FM ---

def fm_param_specs(params_shape: Any, mesh) -> Any:
    def rule(key, leaf):
        if key.endswith("emb") or key.endswith("lin"):
            return P("model", None)
        return _replicated(leaf)

    return tree_map(rule, params_shape)


def fm_batch_specs(mesh) -> dict:
    dp = dp_axes(mesh)
    return {"ids": P(dp, None), "labels": P(dp)}

