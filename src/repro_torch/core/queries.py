"""Reachability on kMatrix sketches.

A pair is declared reachable only if EVERY layer's closure agrees
(one-sided error, like CountMin).  The closure of a layer is O(log w)
boolean squarings; each squaring of all d layers is one launch of the
``reach_step`` kernel.  ``build_closure`` and the per-pair lookup are split
so that a caller can close the layers once and answer many pairs.
"""
from __future__ import annotations

import torch

from repro_torch.core import kmatrix as km
from repro_torch.core import kmatrix_accel as kma
from repro_torch.kernels.ops import accel_reach_closure
from repro_torch.kernels.reach_closure import reach_step, reach_step_plain

CLOSURE_BACKENDS = ("kernel", "plain")


def _closure_steps(w: int, max_hops: int | None) -> int:
    """Number of squarings covering paths of length ``max_hops`` (or any)."""
    return (max(1, (w - 1).bit_length()) if max_hops is None
            else max(1, max_hops.bit_length()))


def closure_backend(backend: str | None = None) -> str:
    """Resolve the closure backend: the ``reach_step`` kernel unless the
    caller names ``"plain"`` (the plain PyTorch squaring, on any device)."""
    backend = backend or "kernel"
    if backend not in CLOSURE_BACKENDS:
        raise ValueError(f"unknown closure backend {backend!r} "
                         f"(expected one of {CLOSURE_BACKENDS})")
    return backend


def build_closure(adj_layers: torch.Tensor, max_hops: int | None = None, *,
                  backend: str | None = None) -> torch.Tensor:
    """Per-layer boolean closure: counter layers [d, w, w] -> bool [d, w, w].

    Equal to the JAX package's ``build_closure`` under either of its
    backends: squarings of a 0/1 float32 matrix are exact for w < 2^24.
    """
    step = reach_step if closure_backend(backend) == "kernel" else reach_step_plain
    return accel_reach_closure(
        adj_layers, n_steps=_closure_steps(adj_layers.shape[-1], max_hops),
        step=step)


def reachability_from_closure(closure: torch.Tensor, hi: torch.Tensor,
                              hj: torch.Tensor) -> torch.Tensor:
    """Pair lookup against a prebuilt closure; ``hi``/``hj`` are per-layer
    node slots [d, *S]."""
    d = closure.shape[0]
    rows = torch.arange(d, device=closure.device).view(
        (d,) + (1,) * (hi.dim() - 1))
    return closure[rows, hi.long(), hj.long()].all(dim=0)


def closure_layers(sk) -> torch.Tensor:
    """The [d, w, w] adjacency layers a kMatrix uses for connectivity."""
    if isinstance(sk, (km.KMatrix, kma.KMatrixAccel)):
        if sk.conn_w == 0:
            raise ValueError(
                "kMatrix built with conn_frac=0 cannot answer reachability")
        return sk.conn
    raise ValueError(
        f"reachability is not answerable by {type(sk).__name__}: "
        "no [d, w, w] adjacency layers")


def reach_cells(sk, v: torch.Tensor) -> torch.Tensor:
    """Per-layer connectivity-matrix slot of vertex ``v`` -> int32[d, *S]."""
    if isinstance(sk, km.KMatrix):
        return km.conn_cells(sk, v)
    if isinstance(sk, kma.KMatrixAccel):
        return kma.conn_cells(sk, v)
    raise ValueError(
        f"reachability is not answerable by {type(sk).__name__}: "
        "no [d, w, w] adjacency layers")
