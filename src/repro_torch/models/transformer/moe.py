"""Top-k MoE FFN with sort-based dispatch.

The port of ``repro/models/transformer/moe.py``: flatten the (token, k)
assignments, sort them by expert (a stable argsort), give each its rank
within its expert (a running max of group starts, ``torch.cummax``, where
the JAX package uses ``associative_scan(max)``), and write the rows into
an (E, C, D) buffer.  Assignments past an expert's capacity C are
dropped: they write a slot C that is cut off (the JAX package's
``mode="drop"``), and their combine weight is 0.  ``jax.lax.top_k``
breaks ties by the lower index; so does the stable descending sort here.
A Switch-style load-balance loss is returned for training.

``moe_ffn_grouped`` splits the tokens into dispatch groups as the JAX
package does off a mesh.  On a mesh (``mesh=``) it is the JAX package's
shard_map branch, written as this rank's code: the rank's tokens are its
data shard's group, the expert weights arrive ZeRO-split on d_ff over
every axis and are gathered to a d_ff slice of their own per model rank
(``local_ffn_weights``), and the partial outputs are summed over "model".
For gated experts the slice of ``w_out`` is the one that meets the
columns of ``w_in``: gate and up pair on the same d_ff indices, and so do
``w_out``'s rows (the JAX branch takes other rows there; ROADMAP.md, §C).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import mesh_ops
from repro_torch.models.common import ACTIVATIONS


def local_ffn_weights(w_in: torch.Tensor, w_out: torch.Tensor, gated: bool,
                      mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """This model rank's d_ff slice of the FFN / expert weights, from
    their ZeRO blocks (``w_in`` (.., D, F*) and ``w_out`` (.., F, D), d_ff
    split over every axis, data-major, "model" last): the ZeRO-3
    gather-at-use.

    ``w_in`` is gathered over the data axes: model rank m then holds the
    blocks j = d * n_model + m of F*.  Ungated, ``w_out``'s rows are
    gathered the same way.  Gated (F* = 2F), the blocks of the first half
    of d are gate columns and those of the second half the up columns of
    the same d_ff indices; gate block j covers the rows of ``w_out``'s
    blocks 2j and 2j + 1.  A permutation sends ``w_out`` block 2j + e to
    the rank at data index 2 (j // n_model) + e and model index
    j % n_model, and a gather over the data axes then gives model rank m
    exactly the rows of its gate columns, in their order."""
    dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
    if mesh.mesh_dim_names[-1] != "model":
        raise ValueError(f"'model' must be the mesh's last axis, got "
                         f"{mesh.mesh_dim_names}")
    w_in_l = mesh_ops.gather(w_in, dp, -1, mesh)
    if not gated:
        return w_in_l, mesh_ops.gather(w_out, dp, -2, mesh)
    n_dp = mesh_ops.axis_size(mesh, dp)
    if n_dp % 2:
        raise ValueError(f"a gated FFN split over {n_dp} data ranks: gate and "
                         "up pair only over an even number")
    n_model = mesh_ops.axis_size(mesh, "model")
    dest = [(2 * (b // 2 // n_model) + b % 2) * n_model + b // 2 % n_model
            for b in range(n_dp * n_model)]
    return w_in_l, mesh_ops.gather(mesh_ops.permute(w_out, dest, mesh), dp,
                                   -2, mesh)


def moe_ffn_grouped(x: torch.Tensor, router_w: torch.Tensor,
                    w_in: torch.Tensor, w_out: torch.Tensor, *, top_k: int,
                    capacity_factor: float, act: str, gated: bool,
                    groups: int = 1,
                    mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` over ``groups`` equal groups of the (T, D) tokens (one
    group when T does not divide); the aux loss is the groups' mean.

    With ``mesh``: ``x`` is this rank's group (its data shard's tokens,
    the same on every model rank), ``w_in`` / ``w_out`` its ZeRO blocks;
    returns the group's output, summed over "model", and its aux loss."""
    if mesh is not None:
        w_in_l, w_out_l = local_ffn_weights(w_in, w_out, gated, mesh)
        y, aux = moe_ffn(x, router_w, w_in_l, w_out_l, top_k=top_k,
                         capacity_factor=capacity_factor, act=act,
                         gated=gated)
        return mesh_ops.psum(y, "model", mesh), aux
    t, d = x.shape
    if t % groups != 0:  # e.g. batch-1 decode: one group
        groups = 1
    outs = [moe_ffn(xi, router_w, w_in, w_out, top_k=top_k,
                    capacity_factor=capacity_factor, act=act, gated=gated)
            for xi in x.reshape(groups, t // groups, d)]
    y = torch.cat([o[0] for o in outs], dim=0)
    return y, torch.stack([o[1] for o in outs]).mean()


def moe_ffn(x: torch.Tensor,  # (T, D) flattened tokens
            router_w: torch.Tensor,  # (D, E)
            w_in: torch.Tensor,  # (E, D, F), gate+up fused when gated: (E, D, 2F)
            w_out: torch.Tensor,  # (E, F, D)
            *, top_k: int, capacity_factor: float, act: str,
            gated: bool) -> tuple[torch.Tensor, torch.Tensor]:
    t, d = x.shape
    e = router_w.shape[-1]
    cap = int(t * top_k * capacity_factor / e)
    cap = max(cap, top_k)
    dev = x.device

    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = srt.values[:, :top_k]
    expert_ids = srt.indices[:, :top_k]  # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # Switch-style load-balance loss: E * sum_e f_e * p_e.
    me = probs.mean(dim=0)
    counts = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, expert_ids.reshape(-1),
        torch.ones(t * top_k, dtype=torch.float32, device=dev))
    aux_loss = e * torch.sum(me * (counts / (t * top_k)))

    # ---- sort-based dispatch ---------------------------------------------
    flat_e = expert_ids.reshape(-1)  # (T*K,)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    pos = torch.arange(n, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = e_sorted[1:] != e_sorted[:-1]
    start_of_group = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start_of_group
    keep = rank < cap

    # dropped assignments write slot ``cap``, which is cut off (the JAX
    # package's mode="drop"): every shape is known before the data
    slot = torch.where(keep, rank, cap)
    token_of = torch.arange(n, device=dev) // top_k
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=dev).index_put(
        (flat_e, slot), x[token_of])[:, :cap]

    # ---- expert computation ----------------------------------------------
    h = torch.bmm(buf, w_in)
    if gated:
        g, u = torch.chunk(h, 2, dim=-1)
        h = ACTIVATIONS[act](g) * u
    else:
        h = ACTIVATIONS[act](h)
    out_buf = torch.bmm(h, w_out)  # (E, C, D)

    # ---- combine ----------------------------------------------------------
    rows = out_buf[flat_e, torch.clamp(rank, max=cap - 1)]  # (T*K, D)
    w_flat = torch.where(keep, gate_vals.reshape(-1), 0.0)
    y = torch.zeros((t, d), dtype=torch.float32, device=dev).index_add(
        0, token_of, rows.float() * w_flat[:, None])
    return y.to(x.dtype), aux_loss
