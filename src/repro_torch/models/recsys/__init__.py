"""Recommendation models: the Factorization Machine."""
from repro_torch.models.recsys import fm

__all__ = ["fm"]
