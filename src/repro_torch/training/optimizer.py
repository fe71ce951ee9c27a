"""The reference's optimizers (port of ``repro/training/optimizer.py``):
Adam / AdamW with fp32 moments, SGD with momentum, global-norm clipping,
coupled or decoupled weight decay, and learning-rate schedules.

Each step is written as the reference writes it, so one update rounds as
the reference's does: Adam's ``eps`` sits outside ``sqrt(v / bc2)``,
``p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)`` (``torch.optim.Adam``
places it differently and is not used). Unlike the reference's pure
functions, ``update`` works in place: it overwrites the parameters and the
moments (autograd off) and returns them. ``grads`` are given in
``param_leaves`` order.

Nothing syncs the host. A schedule is evaluated in fp32 on the host from
the step count (``sched(step)`` -> a 0-d fp32 CPU tensor), and the scalars
go to each device once a step, without waiting; the clipping factor
``min(1, clip_norm / (norm + 1e-9))`` is a device tensor.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.layers import param_leaves

__all__ = ["Optimizer", "adam", "adamw", "sgd", "global_norm",
           "cosine_warmup", "constant_lr"]

_F32 = dict(dtype=torch.float32)


class Optimizer(NamedTuple):
    init: Callable    # params -> state
    update: Callable  # (grads, state, params) -> (params, state)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ over the tensors of Σ x²), in fp32, on their device."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tensors))


def constant_lr(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, **_F32)


def cosine_warmup(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.0) -> Callable:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor`` at ``total``; fp32 as the reference's."""
    def sched(step):
        step = torch.tensor(float(step), **_F32)
        warm = torch.tensor(peak_lr, **_F32) * step / max(warmup, 1)
        prog = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = torch.tensor(floor, **_F32) + torch.tensor(
            peak_lr - floor, **_F32) * 0.5 * (
            1 + torch.cos(torch.tensor(math.pi, **_F32) * prog))
        return torch.where(step < warmup, warm, cos)
    return sched


def _as_sched(lr) -> Callable:
    return lr if callable(lr) else constant_lr(lr)


def _on_devices(params, scalars):
    """Each device's copy of the host fp32 ``scalars``, moved once and
    asynchronously: a blocking copy would wait for the card's queued work
    each time."""
    out = {}
    for p in params:
        if p.device not in out:
            out[p.device] = [c.to(p.device, non_blocking=True)
                             for c in scalars]
    return out


def _clip_factors(grads, clip_norm):
    """{device: min(1, clip_norm / (norm + 1e-9))} of the global norm of
    ``grads`` (taken in fp32 tensor by tensor), or None without
    clipping."""
    if clip_norm is None:
        return None
    norm = global_norm(grads)
    factor = torch.clamp(clip_norm / (norm + 1e-9), max=1.0)
    return {g.device: factor.to(g.device, non_blocking=True) for g in grads}


def adam(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, clip_norm: float | None = None,
         decoupled_wd: bool = False) -> Optimizer:
    """Adam / AdamW (``decoupled_wd=True``) with fp32 moments; ``lr`` a
    float or a schedule ``step -> lr``."""
    sched = _as_sched(lr)

    def init(params):
        return {"step": 0,
                "mu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in param_leaves(params)],
                "nu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in param_leaves(params)]}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        t = torch.tensor(float(step), **_F32)
        bc1 = 1 - torch.tensor(b1, **_F32) ** t
        bc2 = 1 - torch.tensor(b2, **_F32) ** t
        leaves = param_leaves(params)
        consts = _on_devices(leaves, (bc1, bc2, sched(step)))
        factor = _clip_factors(grads, clip_norm)
        for p, g, m, v in zip(leaves, grads, state["mu"], state["nu"]):
            c1, c2, lr_d = consts[p.device]
            # cast leaf by leaf: an fp32 copy of every gradient at once
            # would raise a bf16 model's peak in the update
            g = g.to(torch.float32)
            if factor is not None:
                g = g * factor[g.device]
            if weight_decay and not decoupled_wd:
                g = g + weight_decay * p.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and decoupled_wd:
                u = u + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr_d * u).to(p.dtype))
        return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}

    return Optimizer(init, update)


def adamw(lr, *, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, decoupled_wd=True, **kw)


def sgd(lr, *, momentum: float = 0.0, nesterov: bool = False,
        clip_norm: float | None = None) -> Optimizer:
    """SGD with (Nesterov) momentum in fp32; ``lr`` a float or a
    schedule."""
    sched = _as_sched(lr)

    def init(params):
        return {"step": 0,
                "mom": [torch.zeros_like(p, dtype=torch.float32)
                        for p in param_leaves(params)]}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        leaves = param_leaves(params)
        consts = _on_devices(leaves, (sched(step),))
        factor = _clip_factors(grads, clip_norm)
        for p, g, mom in zip(leaves, grads, state["mom"]):
            (lr_d,) = consts[p.device]
            g = g.to(torch.float32)
            if factor is not None:
                g = g * factor[g.device]
            mom.copy_(momentum * mom + g)
            eff = momentum * mom + g if nesterov else mom
            p.copy_((p.to(torch.float32) - lr_d * eff).to(p.dtype))
        return params, {"step": step, "mom": state["mom"]}

    return Optimizer(init, update)
