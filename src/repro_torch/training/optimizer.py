"""The reference's Adam (port of ``repro/training/optimizer.py:adam``).

fp32 moments, bias correction, and ``eps`` outside ``sqrt(v / bc2)``:
``p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)``, each step written as the
reference writes it, so one update rounds as the reference's does.
``torch.optim.Adam`` places ``eps`` differently and is not used.

Unlike the reference's pure function, ``update`` works in place: it
overwrites the parameters and the moments (autograd off) and returns them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models.layers import param_leaves

__all__ = ["Optimizer", "adam"]


class Optimizer(NamedTuple):
    init: Callable    # params -> state
    update: Callable  # (grads, state, params) -> (params, state)


def adam(lr: float, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam at a constant ``lr``. ``grads`` are given in ``param_leaves``
    order."""

    def init(params):
        return {"step": 0,
                "mu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in param_leaves(params)],
                "nu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in param_leaves(params)]}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        f32 = dict(dtype=torch.float32)
        t = torch.tensor(float(step), **f32)
        bc1 = 1 - torch.tensor(b1, **f32) ** t
        bc2 = 1 - torch.tensor(b2, **f32) ** t
        lr_t = torch.tensor(lr, **f32)
        # the three scalars go to each device once and asynchronously: a
        # blocking copy would wait for the card's queued work each time
        consts = {}
        for p, g, m, v in zip(param_leaves(params), grads, state["mu"],
                              state["nu"]):
            if p.device not in consts:
                consts[p.device] = [c.to(p.device, non_blocking=True)
                                    for c in (bc1, bc2, lr_t)]
            c1, c2, lr_d = consts[p.device]
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            p.copy_((p.to(torch.float32) - lr_d * u).to(p.dtype))
        return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}

    return Optimizer(init, update)
