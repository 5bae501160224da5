"""Shared model-layer primitives: initialisation and parameter counts.

The port's copy of the parts of ``repro/models/common.py`` that the FM
needs; the rest comes with the model-zoo slice (ROADMAP.md, item 16).
"""
from __future__ import annotations

import torch
from torch import nn


def normal_init(generator: torch.Generator, shape, stddev: float,
                dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Normal(0, stddev) draws from ``generator``, which must live on
    ``device``.  A torch generator gives other numbers than a JAX key of
    the same seed; tests that compare the packages carry weights over."""
    out = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return out.mul_(stddev)


def count_params(params) -> int:
    """Number of parameters of a module, a (nested) dict of tensors, or a
    tensor."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()
