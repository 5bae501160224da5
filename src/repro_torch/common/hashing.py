"""Pairwise-independent hash families on tensors.

The same Dietzfelbinger multiply-shift family as the JAX package, followed
by one xorshift-multiply round and the ``fastrange`` reduction
``(h * w) >> 32``.  The arithmetic is uint32, but torch has no unsigned
shifts on the CPU, so every uint32 value is held in an int64 tensor in
``[0, 2^32)``: products are taken in 16-bit limbs so that no int64 product
overflows, and the result is masked back to 32 bits.  Vertex ids map to
uint32 as numpy's ``astype(np.uint32)`` does (two's complement).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.struct import tensor_dataclass

_MASK32 = 0xFFFFFFFF
_XS_MUL = 0x7FEB352D


def sample_hash_params(seed: int, n_funcs: int) -> tuple[np.ndarray, np.ndarray]:
    """Draw (a, b) for ``n_funcs`` independent 2-universal hash functions;
    ``a`` is forced odd."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, size=n_funcs, dtype=np.uint32) | np.uint32(1)
    b = rng.integers(0, 1 << 32, size=n_funcs, dtype=np.uint32)
    return a, b


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> its uint32 value, held in int64."""
    return x.to(torch.int64) & _MASK32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``(a * b) mod 2^32`` for uint32 values held in int64.

    ``b`` is split into 16-bit limbs: each partial product stays below 2^48.
    """
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & _MASK32


@tensor_dataclass
class HashFamily:
    """A bank of ``d`` pairwise-independent hash functions.

    Attributes:
      a, b: int64[d] multiply-shift parameters (uint32 values).
    """

    a: torch.Tensor
    b: torch.Tensor

    @staticmethod
    def create(seed: int, d: int, *, device="cuda") -> "HashFamily":
        a, b = sample_hash_params(seed, d)
        return HashFamily(
            a=torch.as_tensor(a.astype(np.int64), device=device),
            b=torch.as_tensor(b.astype(np.int64), device=device))

    @property
    def depth(self) -> int:
        return self.a.shape[0]

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        """Full-width 32-bit hash of ``x`` under every function.

        Args:
          x: integer tensor of shape ``S``.
        Returns:
          int64 tensor of shape ``(d, *S)`` holding uint32 values.
        """
        x = _as_u32(x)
        shape = (-1,) + (1,) * x.ndim
        h = (_mul32(self.a.view(shape), x[None]) + self.b.view(shape)) & _MASK32
        h = h ^ (h >> 16)
        h = _mul32(h, _XS_MUL)
        return h ^ (h >> 15)

    def hash_into(self, x: torch.Tensor, w) -> torch.Tensor:
        """Hash ``x`` into ``[0, w)`` under every function -> int32[d, *S]."""
        return fastrange(self.mix(x), w)


def families_match(a: HashFamily, b: HashFamily) -> bool:
    """Whether two hash families hold the same parameters.  Used by sketch
    ``merge``: layouts can agree while the hash functions do not."""
    return (a.a.shape == b.a.shape
            and torch.equal(a.a.cpu(), b.a.cpu())
            and torch.equal(a.b.cpu(), b.b.cpu()))


def fastrange(h: torch.Tensor, w) -> torch.Tensor:
    """Map uniform uint32 ``h`` (held in int64) to ``[0, w)`` via
    ``(h * w) >> 32``.  Exact in int64: h < 2^32 and w < 2^31.

    ``w`` is an int or an integer tensor broadcastable against ``h``.
    """
    if isinstance(w, torch.Tensor):
        w = w.to(torch.int64)
    return ((h * w) >> 32).to(torch.int32)


def hash_pair_mix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Combine two uint32 streams into one key (for edge-keyed hashing);
    int64 tensor holding uint32 values."""
    x = _as_u32(x)
    y = _as_u32(y)
    h = (_mul32(x, 0x85EBCA6B) + _mul32(y ^ (y >> 13), 0xC2B2AE35)) & _MASK32
    return h ^ (h >> 16)


def np_hash_into(a: np.ndarray, b: np.ndarray, x: np.ndarray, w: int) -> np.ndarray:
    """NumPy oracle mirroring ``HashFamily.hash_into``.
    Shapes: a, b -> [d], x -> [*S]; returns int32[d, *S]."""
    x = x.astype(np.uint32)
    a = a.reshape((-1,) + (1,) * x.ndim).astype(np.uint32)
    b = b.reshape((-1,) + (1,) * x.ndim).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = a * x[None] + b
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(_XS_MUL)
        h = h ^ (h >> np.uint32(15))
        prod = h.astype(np.uint64) * np.uint64(w)
    return (prod >> np.uint64(32)).astype(np.int32)
