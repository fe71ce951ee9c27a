"""Parameter initializers (port of ``repro/models/layers.py:28-40``).

They draw from an explicit ``torch.Generator``, so the same seed gives the
same parameters on every device. They do not reproduce ``jax.random``'s
bits: parity tests carry the JAX parameters across instead
(``models.kgnn.params_from_jax``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["glorot", "normal_init", "param_leaves"]


def glorot(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniform(-lim, lim), lim = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return u * (2.0 * lim) - lim


def normal_init(gen: torch.Generator, shape, stddev=0.02,
                dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype) * stddev


def param_leaves(params: dict) -> list:
    """The parameter tensors in the reference's pytree leaf order: keys
    sorted, list entries in order (sums over them round as the reference's
    do)."""
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(v if isinstance(v, (list, tuple)) else [v])
    return out
