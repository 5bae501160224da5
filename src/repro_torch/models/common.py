"""Shared model-layer primitives: initialisation, norms, activations and
parameter counts.

The port's copy of ``repro/models/common.py``.  Initialisers draw from an
explicit ``torch.Generator`` on the tensor's device; a torch generator gives
other numbers than a JAX key of the same seed, so tests that compare the
packages carry weights over (``repro_torch.interop``).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

Params = dict  # nested dict of tensor leaves


def uniform_init(generator: torch.Generator, shape, scale: float,
                 dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Uniform(-scale, scale) draws from ``generator`` (on ``device``)."""
    out = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return out.mul_(2 * scale).sub_(scale)


def normal_init(generator: torch.Generator, shape, stddev: float,
                dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Normal(0, stddev) draws from ``generator``, which must live on
    ``device``."""
    out = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return out.mul_(stddev)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """LeCun-normal fan-in init of a (d_in, d_out) matrix."""
    return normal_init(generator, (d_in, d_out), 1.0 / math.sqrt(d_in),
                       dtype, device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm in float32; ``zero_centered`` follows the Gemma (1 + gamma)
    convention, the sum taken in gamma's own dtype as the JAX package
    takes it."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = (1.0 + gamma) if zero_centered else gamma
    return (x * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# gelu is the tanh approximation, ``jax.nn.gelu``'s default
ACTIVATIONS: dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
}


def unstack_layers(layers: dict, n_layers: int) -> list[dict]:
    """Each layer's parameter dict from leaves stacked over the layers (one
    unbind per leaf, so a leaf's gradient is one stack)."""
    cols = {k: v.unbind(0) for k, v in layers.items()}
    return [{k: cols[k][i] for k in layers} for i in range(n_layers)]


def count_params(params) -> int:
    """Number of parameters of a module, a (nested) dict or list of
    tensors, or a tensor."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel()
