"""AdamW, the cosine schedule with warm-up, and global-norm clipping.

The port of ``repro/training/optimizer.py``, plain PyTorch (the JAX
optimizer is plain ``jnp``, outside any Pallas kernel).  Parameters are a
tree: a dict (leaves in sorted-key order, as JAX flattens it), a list or
tuple (in order), a tensor, or an ``nn.Module``, which counts as the dict
of its named parameters (the FM's ``{"bias", "emb", "lin"}``, the JAX
package's params dict).  Moments are trees of the same shape, with
modules replaced by dicts.

Where JAX returns new arrays, ``adamw_update`` writes parameters and
moments in place under ``torch.no_grad()``: an optimizer step at full
width would otherwise hold a second copy of every parameter and moment.
Each write goes through the tensor itself, so its version counter moves
and anything derived from a parameter (the FM's squared table) is derived
again.  The arithmetic is the JAX package's, in float32 whatever the
parameters' and moments' dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # tree like params
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # bf16 halves optimizer memory


def _as_tree(tree):
    return dict(tree.named_parameters()) if isinstance(tree, nn.Module) else tree


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in JAX's flattening order."""
    tree = _as_tree(tree)
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``tree``'s structure (modules as dicts) with ``fn`` of every leaf."""
    tree = _as_tree(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_unflatten(template, leaves) -> Any:
    """``template``'s structure (modules as dicts) holding ``leaves``, which
    come in ``tree_leaves`` order."""
    it = iter(leaves)
    out = _fill(_as_tree(template), it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _fill(tree, it):
    tree = _as_tree(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        filled = {k: _fill(tree[k], it) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(t, it) for t in tree)
    return next(it)


def cosine_warmup_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int), float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """(``tree`` scaled to global norm at most ``max_norm``, its norm);
    ``norm``: the norm when it is known (a tree of blocks on a mesh)."""
    norm = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw_init(cfg: AdamWConfig, params) -> AdamWState:
    dt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when it is float32 (so in-place ops write it), else a
    float32 copy."""
    return x if x.dtype == torch.float32 else x.float()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params, *,
                 grad_norm=None):
    """One AdamW step: ``params`` and the moments updated in place.
    Returns ``(params, AdamWState, {"lr", "grad_norm"})``; weight decay
    applies to leaves of two or more dimensions only.  ``grad_norm``: the
    global norm of the gradient when ``grads`` holds only blocks of it."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, grad_norm)
    step = state.step + 1
    lr = cosine_warmup_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = _as_f32(m).mul_(b1).add_((1 - b1) * g32)
        v32 = _as_f32(v).mul_(b2).add_((1 - b2) * g32 * g32)
        update = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(cfg.eps))
        if p.dim() >= 2:  # decay matrices and embeddings, not norms or biases
            update.add_(cfg.weight_decay * p.float())
        p32 = _as_f32(p).sub_(lr * update)
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if src is not dst:
                dst.copy_(src)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu),
                          strict=True):
        upd(p, g, m, v)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
