"""Counter-based uniform hash for stochastic rounding (murmur3 finalizer).

``hash_uniform(idx, seed)`` maps uint32 element indices XOR a uint32 seed
through the murmur3 32-bit finalizer and keeps the top 24 bits as a float32
in [0, 1). It gives the same bits as ``repro.kernels.hashrng.hash_uniform``
and as the CUDA copy in ``csrc/hashrng.cuh``, so the plain quantizer, the
CUDA kernel and the JAX reference draw identical noise from the same seed.

torch has few uint32 operations, so the arithmetic runs in int64 masked to
32 bits. Each multiply splits its constant into 16-bit halves, so that no
product leaves int64: ``x*c mod 2^32 == x*c_lo + ((x*c_hi mod 2^16) << 16)``.
"""

from __future__ import annotations

import torch

__all__ = ["hash_uniform", "murmur3_fmix"]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def murmur3_fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_uniform(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """U[0, 1) float32 from integer element indices (taken mod 2^32) and a
    uint32 scalar seed."""
    x = (idx.to(torch.int64) & _M32) ^ (int(seed) & _M32)
    h = murmur3_fmix(x)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
