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


def init_train_state(params, opt_cfg: AdamWConfig) -> TrainState:
    return TrainState(params=params, opt=adamw_init(opt_cfg, params))


# ------------------------------------------------------- family loss fns --

def lm_loss_fn(cfg):
    from repro_torch.models.transformer.model import lm_loss

    def loss_fn(params, batch):
        return lm_loss(cfg, params, batch["tokens"], batch["labels"])

    return loss_fn


def gnn_node_class_loss_fn(cfg, forward, n_classes: int):
    def loss_fn(params, batch):
        g, labels = batch["graph"], batch["labels"]
        logits = forward(cfg, params, g)[..., :n_classes]
        lse = torch.logsumexp(logits, dim=-1)
        true = torch.take_along_dim(logits, labels.long()[:, None], dim=-1)[:, 0]
        loss = torch.sum((lse - true) * g.node_mask) / torch.clamp_min(
            g.node_mask.sum(), 1.0)
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
