"""Evaluation metrics from paper §V-C: ARE (Eq. 9-10), NEQ/PEQ (Eq. 11-12)."""
from __future__ import annotations

import numpy as np
import torch


def relative_error(est: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Per-query relative error  er(Q) = est/true - 1   (Eq. 9), float32."""
    true = torch.clamp(true.to(torch.float32), min=1e-9)
    return est.to(torch.float32) / true - 1.0


def average_relative_error(est: torch.Tensor, true: torch.Tensor,
                           valid: torch.Tensor | None = None) -> torch.Tensor:
    """ARE over a query set (Eq. 10). ``valid`` masks padding queries."""
    er = relative_error(est, true)
    if valid is None:
        return er.mean()
    valid = valid.to(torch.float32)
    return (er * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def effective_queries(est: torch.Tensor, true: torch.Tensor, g0: float,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """NEQ (Eq. 11): #queries with |est - true| <= G0."""
    ok = (est.to(torch.float32) - true.to(torch.float32)).abs() <= g0
    if valid is not None:
        ok = ok & valid
    return ok.sum(dtype=torch.int32)


def percent_effective_queries(est: torch.Tensor, true: torch.Tensor, g0: float,
                              valid: torch.Tensor | None = None) -> torch.Tensor:
    """PEQ (Eq. 12)."""
    n = est.shape[0] if valid is None else torch.clamp(valid.sum(), min=1)
    return effective_queries(est, true, g0, valid) * 100.0 / n


def exact_edge_frequencies(src: np.ndarray, dst: np.ndarray,
                           weight: np.ndarray | None = None) -> dict:
    """Host-side ground-truth frequency map for evaluation oracles."""
    if weight is None:
        weight = np.ones_like(src, dtype=np.int64)
    keys = src.astype(np.int64) << 32 | dst.astype(np.uint32)
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=weight.astype(np.float64))
    return {int(k): float(v) for k, v in zip(uniq, sums)}


def lookup_exact(freq_map: dict, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    keys = src.astype(np.int64) << 32 | dst.astype(np.uint32)
    return np.asarray([freq_map.get(int(k), 0.0) for k in keys], dtype=np.float64)
