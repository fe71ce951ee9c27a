"""Parameter initializers and the MLP (port of ``repro/models/layers.py:
28-82``).

The initializers draw from an explicit ``torch.Generator``: the same seed
on a generator of the same device type gives the same parameters. They do
not reproduce ``jax.random``'s bits: parity tests carry the JAX parameters
across instead (``models.kgnn.params_from_jax``, ``models.recsys.
params_from_jax``).

An MLP's parameters are two lists, ``{"w": [W_0, ...], "b": [b_0, ...]}``
(the reference's list of ``{w, b}`` dicts; a model stores them as two
top-level lists, so every parameter dict stays one level of tensors and
lists of tensors). ``mlp_apply`` runs its layers through the ACT ops at
the reference's sites, ``<scope>/fc<i>`` and ``<scope>/relu<i>``.
``embedding_bag`` is not ported (ROADMAP Queue 1).
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch

from repro_torch.core.act import act_dense, act_nonlin, act_relu
from repro_torch.core.context import current_context

__all__ = ["glorot", "lecun", "normal_init", "dense_params", "mlp_params",
           "mlp_apply", "param_leaves"]


def glorot(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniform(-lim, lim), lim = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return u * (2.0 * lim) - lim


def lecun(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1 / fan_in)."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) / math.sqrt(shape[-2])


def normal_init(gen: torch.Generator, shape, stddev=0.02,
                dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * stddev


def dense_params(gen: torch.Generator, d_in: int, d_out: int) -> dict:
    """``{"w": glorot (d_in, d_out), "b": zeros (d_out,)}``."""
    return {"w": glorot(gen, (d_in, d_out)),
            "b": torch.zeros((d_out,), device=gen.device)}


def mlp_params(gen: torch.Generator, dims: Sequence[int]) -> dict:
    """``{"w": [...], "b": [...]}`` of the layers ``dims[i] ->
    dims[i+1]``."""
    layers = [dense_params(gen, a, b) for a, b in zip(dims[:-1], dims[1:])]
    return {"w": [p["w"] for p in layers], "b": [p["b"] for p in layers]}


def mlp_apply(ws: list, bs: list, x: torch.Tensor, *,
              act: str = "relu", final_act: bool = False,
              scope: str = "mlp") -> torch.Tensor:
    """MLP with ACT-compressed matmuls and activations, every site resolved
    from the ambient ``ActContext`` at ``<scope>/fc<i>`` (and
    ``<scope>/relu<i>`` or ``<scope>/act<i>``). ReLU keeps its exact 1-bit
    mask; other activations (``core.act.NONLIN``) store quantized inputs
    under the site's policy."""
    n = len(ws)
    ctx = current_context()
    with ctx.scope(scope) if ctx is not None else contextlib.nullcontext():
        for i, w in enumerate(ws):
            x = act_dense(x, w, bs[i], scope=f"fc{i}")
            if i < n - 1 or final_act:
                if act == "relu":
                    x = act_relu(x, scope=f"relu{i}")
                else:
                    x = act_nonlin(x, fn=act, scope=f"act{i}")
    return x


def param_leaves(params: dict) -> list:
    """The parameter tensors in the reference's pytree leaf order: keys
    sorted, list entries in order (sums over them round as the reference's
    do)."""
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(v if isinstance(v, (list, tuple)) else [v])
    return out
