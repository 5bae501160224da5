"""Memory-bounded edge aggregation for web-scale graphs.

The port of ``repro/models/gnn/chunked.py``, whose ``jax.custom_vjp``
becomes a ``torch.autograd.Function``.  Message aggregation is LINEAR in
per-chunk contributions:

    agg = sum_i segment_sum(msg(carry, edge_slice_i), dst_i)

so its backward needs no per-chunk residuals: d_carry = sum_i vjp_i(d_agg),
each chunk's vjp recomputed on the fly.  The forward loops over chunks
without autograd; the backward recomputes each chunk's messages and calls
``torch.autograd.grad`` on them with the chunk's rows of d_agg, so both
directions hold O(chunk) extra memory.  The backward is itself
differentiable (its graph is kept when autograd records the backward, as
for a force loss, which differentiates forces that came from a gradient).

Contract (the JAX package's):
  * ``carry_args`` and ``edge_args`` are trees (dicts, tuples, lists) of
    float tensors; integer per-edge data (source ids, ...) goes in
    ``int_edge_args`` and takes no gradient, as ``dst`` does;
  * per-edge leaves have leading dim E, divisible by ``n_chunks`` (callers
    pad with masked slots).

A message function gathers node rows with :func:`gather_rows`, whose
gradient is sparse (the chunk's rows only): the backward adds it into its
accumulator row by row, where a dense gradient would write a zero tensor of
every node's rows for each chunk.

``aggregate_unchunked`` is the plain version: every message at once, one
``index_add``, ordinary autograd (all messages and their residuals held).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.training.optimizer import tree_leaves, tree_map, tree_unflatten


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        # dense when autograd records the backward itself, and on "meta"
        # (a planning trace), where sparse sums have no kernel
        if torch.is_grad_enabled() or g.is_meta:
            return g.new_zeros(ctx.shape).index_add(0, idx, g), None
        return torch.sparse_coo_tensor(idx.long()[None], g, ctx.shape,
                                       check_invariants=False), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first dimension.  Its gradient is a sparse COO
    tensor holding the gathered rows only (dense when autograd records the
    backward itself)."""
    return _GatherRows.apply(x, idx)


def pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` zero rows appended (masked edge slots that make E
    a multiple of the chunk count)."""
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def _slice_tree(tree: Any, start: int, size: int) -> Any:
    return tree_unflatten(tree, [x[start:start + size]
                                 for x in tree_leaves(tree)])


class _ChunkedAggregate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, msg_fn, n_nodes, n_chunks, trees, dst, *leaves):
        carry_t, edge_t, int_t = trees
        n_c, n_e = len(tree_leaves(carry_t)), len(tree_leaves(edge_t))
        ctx.msg_fn, ctx.n_nodes, ctx.n_chunks = msg_fn, n_nodes, n_chunks
        ctx.trees, ctx.counts = trees, (n_c, n_e)
        ctx.save_for_backward(dst, *leaves)
        carry = tree_unflatten(carry_t, leaves[:n_c])
        edges = tree_unflatten(edge_t, leaves[n_c:n_c + n_e])
        ints = tree_unflatten(int_t, leaves[n_c + n_e:])
        e = dst.shape[0]
        chunk = e // n_chunks
        assert chunk * n_chunks == e, (e, n_chunks)
        acc = None
        for i in range(n_chunks):
            start = i * chunk
            msg = msg_fn(carry, _slice_tree(edges, start, chunk),
                         _slice_tree(ints, start, chunk))
            if acc is None:
                acc = msg.new_zeros((n_nodes, *msg.shape[1:]))
            acc.index_add_(0, dst[start:start + chunk], msg)
        return acc

    @staticmethod
    def backward(ctx, g):
        dst, *leaves = ctx.saved_tensors
        n_c, n_e = ctx.counts
        carry_t, edge_t, int_t = ctx.trees
        needs = ctx.needs_input_grad[5:]
        # Differentiable backward (create_graph): recompute from the saved
        # inputs themselves, so the graph reaches what made them.  Else a
        # detached copy per leaf keeps each chunk's graph local.
        create = torch.is_grad_enabled()
        if not create:
            leaves = [x.detach().requires_grad_(need)
                      for x, need in zip(leaves, needs)]
        e = dst.shape[0]
        chunk = e // ctx.n_chunks
        d_carry: list = [None] * n_c
        d_edge: list = [[] for _ in range(n_e)]
        for i in range(ctx.n_chunks):
            start = i * chunk
            with torch.enable_grad():
                carry = tree_unflatten(carry_t, leaves[:n_c])
                e_slices = [x[start:start + chunk]
                            for x in leaves[n_c:n_c + n_e]]
                ints = _slice_tree(tree_unflatten(int_t, leaves[n_c + n_e:]),
                                   start, chunk)
                msg = ctx.msg_fn(carry, tree_unflatten(edge_t, e_slices), ints)
                wrt = [(k, x) for k, x in enumerate(leaves[:n_c] + e_slices)
                       if needs[k]]
                grads = torch.autograd.grad(
                    msg, [x for _, x in wrt],
                    grad_outputs=g[dst[start:start + chunk]],
                    create_graph=create, allow_unused=True,
                    materialize_grads=True) if wrt else ()
            for (k, x), gk in zip(wrt, grads):
                if k >= n_c:
                    d_edge[k - n_c].append(gk)
                elif gk.is_sparse:  # rows of a gather_rows: add them alone
                    if d_carry[k] is None:
                        d_carry[k] = torch.zeros_like(x)
                    d_carry[k].index_add_(0, gk._indices()[0], gk._values())
                elif d_carry[k] is None:
                    d_carry[k] = gk
                elif create:
                    d_carry[k] = d_carry[k] + gk
                else:
                    d_carry[k].add_(gk)
        d_edges = [torch.cat(parts) if parts else None for parts in d_edge]
        n_int = len(leaves) - n_c - n_e
        return (None, None, None, None, None, *d_carry, *d_edges,
                *([None] * n_int))


def chunked_edge_aggregate(
    msg_fn: Callable,  # (carry_args, edge_slice, int_slice) -> msg [chunk, ...]
    n_nodes: int,
    n_chunks: int,
    carry_args: Any,  # float tree (node features, layer params, ...)
    edge_args: Any,  # float per-edge tree, leading dim E
    int_edge_args: Any,  # int per-edge tree (src ids, ...), leading dim E
    dst: torch.Tensor,  # int32[E] destination ids
) -> torch.Tensor:
    """sum over chunks of ``index_add(msg_fn(carry, chunk's edges), dst)``
    into ``n_nodes`` rows, recomputing each chunk's messages in the
    backward instead of holding them."""
    trees = (carry_args, edge_args, int_edge_args)
    leaves = [x for t in trees for x in tree_leaves(t)]
    # the structure alone: the Function holds no tensor but what it saves
    specs = tuple(tree_map(lambda _: True, t) for t in trees)
    return _ChunkedAggregate.apply(msg_fn, n_nodes, n_chunks, specs, dst,
                                   *leaves)


def aggregate_unchunked(msg_fn: Callable, n_nodes: int, carry_args: Any,
                        edge_args: Any, int_edge_args: Any,
                        dst: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`chunked_edge_aggregate`: every message at
    once, one ``index_add``, ordinary autograd."""
    msg = msg_fn(carry_args, edge_args, int_edge_args)
    return msg.new_zeros((n_nodes, *msg.shape[1:])).index_add(0, dst, msg)
