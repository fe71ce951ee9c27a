"""The training step: one ``ModelStep`` per arch and the function that runs
it (port of ``repro/training/step.py:ModelStep, make_train_step``).

A ``ModelStep`` binds a model's loss to its config and data:

  * ``init(seed) -> params``: the parameter dict, leaves requiring grad;
  * ``loss(params, batch, *, ctx=None) -> scalar``: the objective, every ACT
    site resolved through the ``ActContext`` it runs in (``ctx`` is entered
    for the call; ``None`` leaves resolution to the caller's context);
  * ``batches() -> iterator``: the step's default data stream.

The registry (``repro_torch.models.registry``) builds them; the launcher,
the trainer and ``chip_smoke.py`` consume the same object.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator

import torch

from repro_torch.core.context import act_context
from repro_torch.kernels.backend import full_fp32
from repro_torch.models.layers import param_leaves

__all__ = ["ModelStep", "make_train_step", "trainable", "enter_or_null"]


@dataclasses.dataclass(frozen=True)
class ModelStep:
    arch: str                      # registry id ("kgat")
    family: str                    # kgnn
    cfg: Any                       # model config dataclass
    init: Callable                 # init(seed) -> params
    loss: Callable                 # loss(params, batch, *, ctx=None)
    batches: Callable[[], Iterator]
    lr: float = 1e-3               # launcher default learning rate
    data: dict = dataclasses.field(default_factory=dict)  # bound data refs


def enter_or_null(ctx) -> contextlib.AbstractContextManager:
    """``with enter_or_null(ctx):`` enters ``ctx`` when given, else nothing
    (the ``loss(..., ctx=None)`` contract)."""
    return ctx if ctx is not None else contextlib.nullcontext()


def trainable(params: dict) -> dict:
    """A copy of a parameter dict whose leaves require grad (training
    updates its parameters in place; the caller's stay as they were)."""
    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    return {k: [leaf(t) for t in v] if isinstance(v, list) else leaf(v)
            for k, v in params.items()}


def make_train_step(step: ModelStep, opt, *, schedule=None,
                    root_seed: int | None = None, seed_fn=None):
    """``train_step(state, batch, i) -> (state, metrics)`` with
    ``state = (params, opt_state)``.

    Each call enters a fresh ``act_context(schedule, root_seed, step=i,
    seed_fn=seed_fn)``, so every ACT site resolves its per-site policy and
    its scope-derived rounding seed (``seed_fn`` injects seeds instead).
    ``metrics`` holds the loss and ``act``, the activation-bytes report of
    the residuals this step saved. The forward and the backward run in full
    fp32 (``full_fp32``), whatever the caller's TF32 setting.
    """

    def train_step(state, batch, i):
        params, opt_state = state
        ctx = act_context(schedule, root_seed, step=i, seed_fn=seed_fn)
        with full_fp32():
            loss = step.loss(params, batch, ctx=ctx)
            grads = torch.autograd.grad(loss, param_leaves(params))
        params, opt_state = opt.update(grads, opt_state, params)
        return (params, opt_state), {"loss": loss.detach(),
                                     "act": ctx.report()}

    return train_step
