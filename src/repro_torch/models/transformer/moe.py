"""Top-k MoE FFN with sort-based dispatch.

The port of ``repro/models/transformer/moe.py``: flatten the (token, k)
assignments, sort them by expert (a stable argsort), give each its rank
within its expert (a running max of group starts, ``torch.cummax``, where
the JAX package uses ``associative_scan(max)``), and write the kept rows
into an (E, C, D) buffer.  Assignments past an expert's capacity C are
dropped: only kept slots are written (the JAX package writes to slot C
with ``mode="drop"``), and their combine weight is 0.  ``jax.lax.top_k``
breaks ties by the lower index; so does the stable descending sort here.
A Switch-style load-balance loss is returned for training.

``moe_ffn_grouped`` splits the tokens into dispatch groups as the JAX
package does off a mesh; its shard_map variant, like the ZeRO-3 gather
and the sharded embedding, exists only for a mesh and comes with the
shardings slice (ROADMAP.md, §A).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ACTIVATIONS


def moe_ffn_grouped(x: torch.Tensor, router_w: torch.Tensor,
                    w_in: torch.Tensor, w_out: torch.Tensor, *, top_k: int,
                    capacity_factor: float, act: str, gated: bool,
                    groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` over ``groups`` equal groups of the (T, D) tokens (one
    group when T does not divide); the aux loss is the groups' mean."""
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

    token_of = torch.arange(n, device=dev) // top_k
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev).index_put(
        (flat_e[keep], rank[keep]), x[token_of[keep]])

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
