"""Train-step builders: the port of ``repro/training/steps.py`` for the FM,
the transformer family and the GNN family.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``.
Gradients come from ``torch.autograd.grad`` over the parameter leaves (no
``.grad`` is accumulated), and ``adamw_update`` writes the parameters in
place, so the returned state holds the same parameter tensors.

Microbatch accumulation (``accum_steps``) runs the microbatches in a
Python loop and averages their gradients in float32, as the JAX package's
``lax.scan`` does; by linearity it equals the full-batch gradient.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_unflatten,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def _grads(loss_fn, params, batch, leaves):
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), metrics, grads


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, *,
                    accum_steps: int = 1) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics dict)``; the batch is a
    dict of tensors whose first dimension is split into ``accum_steps``
    microbatches."""

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        leaves = tree_leaves(state.params)
        if accum_steps == 1:
            loss, metrics, grads = _grads(loss_fn, state.params, batch, leaves)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves]
            for i in range(accum_steps):
                mb = {k: x.reshape(accum_steps, x.shape[0] // accum_steps,
                                   *x.shape[1:])[i] for k, x in batch.items()}
                l, metrics, g = _grads(loss_fn, state.params, mb, leaves)
                loss = loss + l / accum_steps
                grads = [a + b / accum_steps for a, b in zip(grads, g)]
        params, opt, opt_metrics = adamw_update(
            opt_cfg, tree_unflatten(state.params, grads), state.opt,
            state.params)
        metrics = {k: v.detach() for k, v in (metrics or {}).items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return step


def _cut_axes(param_specs) -> list[frozenset]:
    from repro_torch.launch.shardings import tree_items

    return [frozenset(a for e in p for a in ((e,) if isinstance(e, str)
                                             else (e or ())))
            for _, p in tree_items(param_specs)]


def mesh_grads(loss_fn: Callable, params, batch: dict, param_specs, mesh):
    """(loss, metrics, gradient blocks) on one rank of ``mesh``:
    ``params`` holds this rank's blocks (``param_specs``) and ``loss_fn``
    returns this rank's SHARE of the loss (the ranks' shares sum to it, as
    the models' mesh variants give it).  Each gradient block is summed
    over the axes its spec does not cut (the ranks that hold the same
    block computed parts of it); loss and metrics are the shares' sums."""
    from repro_torch.distributed import mesh_ops

    every = tuple(mesh.mesh_dim_names)
    cut = _cut_axes(param_specs)
    leaves = tree_leaves(params)
    if len(leaves) != len(cut):
        raise ValueError(f"{len(leaves)} leaves, {len(cut)} specs")
    loss, metrics, grads = _grads(loss_fn, params, batch, leaves)
    grads = [mesh_ops.psum(g, tuple(a for a in every if a not in c), mesh)
             for g, c in zip(grads, cut)]
    metrics = {k: mesh_ops.psum(v.detach(), every, mesh)
               for k, v in (metrics or {}).items()}
    return mesh_ops.psum(loss, every, mesh), metrics, grads


def make_mesh_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                         param_specs, mesh) -> Callable:
    """``make_train_step`` for one rank of ``mesh``: ``mesh_grads``, then
    ``mesh_update`` of the state's blocks in place.  Loss and metrics are
    the same on every rank."""
    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss, metrics, grads = mesh_grads(loss_fn, state.params, batch,
                                          param_specs, mesh)
        state, opt_metrics = mesh_update(opt_cfg, state, grads, param_specs,
                                         mesh)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return state, metrics

    return step


def mesh_update(opt_cfg: AdamWConfig, state: TrainState, grads: list,
                param_specs, mesh) -> tuple[TrainState, dict]:
    """AdamW on this rank's blocks, ``grads`` from ``mesh_grads``: the
    global norm from the blocks' squares, each summed over the axes that
    cut its leaf."""
    from repro_torch.distributed import mesh_ops

    every = tuple(mesh.mesh_dim_names)
    by_axes: dict = {}
    for g, c in zip(grads, _cut_axes(param_specs)):
        by_axes[c] = by_axes.get(c, 0.0) + torch.sum(torch.square(g.float()))
    total = sum(mesh_ops.psum(sq, tuple(a for a in every if a in c), mesh)
                for c, sq in by_axes.items())
    params, opt, metrics = adamw_update(
        opt_cfg, tree_unflatten(state.params, grads), state.opt, state.params,
        grad_norm=torch.sqrt(total))
    return TrainState(params, opt), metrics


def init_train_state(params, opt_cfg: AdamWConfig) -> TrainState:
    return TrainState(params=params, opt=adamw_init(opt_cfg, params))


# ------------------------------------------------------- family loss fns --

def lm_loss_fn(cfg):
    from repro_torch.models.transformer.model import lm_loss

    def loss_fn(params, batch):
        return lm_loss(cfg, params, batch["tokens"], batch["labels"])

    return loss_fn


def gnn_node_class_loss_fn(cfg, forward, n_classes: int):
    """Masked mean cross-entropy over the nodes; on a mesh (a split graph)
    this rank's share of it."""
    from repro_torch.models.gnn.graph import summed

    def loss_fn(params, batch):
        g, labels = batch["graph"], batch["labels"]
        logits = forward(cfg, params, g)[..., :n_classes]
        lse = torch.logsumexp(logits, dim=-1)
        true = torch.take_along_dim(logits, labels.long()[:, None], dim=-1)[:, 0]
        loss = torch.sum((lse - true) * g.node_mask) / torch.clamp_min(
            summed(g.node_mask.sum()), 1.0)
        return loss, {"ce": loss}

    return loss_fn


def gnn_regression_loss_fn(cfg, forward):
    def loss_fn(params, batch):
        g, target = batch["graph"], batch["target"]
        pred = forward(cfg, params, g)
        loss = torch.mean((pred - target) ** 2)
        return loss, {"mse": loss}

    return loss_fn


def energy_loss_fn(cfg, energy_fn, *, force_weight: float = 0.0):
    """Molecular potential loss; optional force matching (grad-of-grad:
    ``energy_fn`` then returns (energies, forces) with the forces' graph
    kept)."""

    def loss_fn(params, batch):
        g, e_target = batch["graph"], batch["energy"]
        if force_weight > 0:
            e, forces = energy_fn(cfg, params, g)
            f_loss = torch.mean(torch.sum((forces - batch["forces"]) ** 2, -1))
        else:
            e = energy_fn(cfg, params, g)
            if isinstance(e, tuple):
                e = e[0]
            f_loss = 0.0
        e_loss = torch.mean((e - e_target) ** 2)
        loss = e_loss + force_weight * f_loss
        return loss, {"e_mse": e_loss}

    return loss_fn


def fm_loss_fn(cfg):
    from repro_torch.models.recsys.fm import bce_loss

    def loss_fn(params, batch):
        loss = bce_loss(cfg, params, batch["ids"], batch["labels"])
        return loss, {"bce": loss}

    return loss_fn
