"""Recommendation models: the Factorization Machine."""
