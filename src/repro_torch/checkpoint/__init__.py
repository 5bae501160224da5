"""Atomic sketch checkpoints in the JAX package's on-disk layout."""
