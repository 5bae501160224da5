"""repro_torch — the kMatrix system in PyTorch for NVIDIA Hopper.

A port of the JAX package ``repro`` that imports neither JAX nor ``repro``.
It mirrors ``repro``'s module layout; the TPU kernels on its path are
hand-written CUDA kernels (``repro_torch.kernels``).  Every constructor and
entry point takes a ``device`` that defaults to ``"cuda"``.
"""
