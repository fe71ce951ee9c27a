"""The ACT context: named scopes, per-site policies, recorded residuals
(port of ``repro/core/context.py``).

``ActContext`` gives every compressed op three things when the explicit
``seed=`` / ``policy=`` kwargs are omitted:

  * a **named scope**, a ``/``-joined path like ``"kgat/layer2/spmm"``
    built from ``ctx.scope(...)`` blocks plus the op's site name;
  * a **policy**, resolved from the context's ``PolicySchedule`` by
    ``(op_kind, scope, layer)``, first matching rule wins;
  * a **stochastic-rounding seed**: ``seed_fn(scope, step)`` when the
    context was given one (the parity tests inject the reference's seeds
    that way), else ``repro_torch.core.rng.scope_seed(root_seed, scope,
    step)``.

The context also **records every residual the ops save** (scope, op kind,
shape, bits, exact-mask flag) as they run, so the activation-memory report
(``repro_torch.core.memory``) prices what the real forward saved. PyTorch
runs eagerly: the records come from the step itself, not from a trace.

Usage::

    with act_context(schedule, root_seed=1, step=i) as ctx:
        loss = bpr_loss(params, g, batch, cfg)    # ops self-resolve
    ctx.report()

Scope dedup (``#k`` suffixes for repeated names) and the record list live on
the context, so use a **fresh context per step**.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, Sequence

from .policy import FP32, ACTPolicy, PolicySchedule, as_schedule
from .rng import scope_seed

__all__ = ["SavedResidual", "ActContext", "act_context", "current_context",
           "model_context"]


@dataclasses.dataclass(frozen=True)
class SavedResidual:
    """One residual the backward pass will hold.

    bits is the *storage* width (None = uncompressed fp32 baseline);
    exact_mask marks lossless 1-bit bool masks (ReLU), which carry no
    per-row scale/zero overhead.
    """

    scope: str
    op_kind: str
    shape: tuple[int, ...]
    bits: int | None
    exact_mask: bool = False


# Ambient context stack: contexts are entered and left by the thread that
# runs the model.
_ACTIVE: list["ActContext"] = []


def current_context() -> "ActContext | None":
    return _ACTIVE[-1] if _ACTIVE else None


class ActContext:
    """See module docstring. ``schedule`` accepts a bare ``ACTPolicy``."""

    def __init__(self, schedule: PolicySchedule | ACTPolicy | None = None,
                 root_seed: int | None = None, *, step: int = 0,
                 seed_fn: Callable[[str, int], int] | None = None):
        self.schedule = as_schedule(schedule) if schedule is not None else None
        self.root_seed = root_seed
        self.step = int(step)
        self.seed_fn = seed_fn
        self.records: list[SavedResidual] = []
        self._stack: list[str] = []
        self._seen: dict[str, int] = {}

    # -- ambient management -------------------------------------------------

    def __enter__(self) -> "ActContext":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        popped = _ACTIVE.pop()
        if popped is not self:
            raise RuntimeError("ActContext exited out of order")

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator["ActContext"]:
        """Push a scope path component for the ops run inside."""
        self._stack.append(name)
        try:
            yield self
        finally:
            self._stack.pop()

    # -- per-site resolution ------------------------------------------------

    def qualify(self, name: str) -> str:
        """Full scope path for a site name; repeats get ``#k`` suffixes, so a
        site hit twice draws distinct noise while every other site's path
        (hence seed) stays the same."""
        full = "/".join(self._stack + [name])
        n = self._seen.get(full, 0)
        self._seen[full] = n + 1
        return full if n == 0 else f"{full}#{n}"

    def policy_for(self, op_kind: str, scope: str) -> ACTPolicy | None:
        if self.schedule is None:
            return None
        return self.schedule.resolve(op_kind, scope)

    def key_for(self, scope: str) -> int | None:
        """The site's uint32 rounding seed, or None without a root seed."""
        if self.seed_fn is not None:
            return int(self.seed_fn(scope, self.step)) & 0xFFFFFFFF
        if self.root_seed is None:
            return None
        return scope_seed(self.root_seed, scope, self.step)

    # -- records ------------------------------------------------------------

    def record(self, scope: str, op_kind: str, shape: Sequence[int],
               bits: int | None, *, exact_mask: bool = False) -> None:
        self.records.append(SavedResidual(
            scope=scope, op_kind=op_kind, shape=tuple(shape), bits=bits,
            exact_mask=exact_mask))

    def report(self) -> dict:
        """Price the recorded residuals (``repro_torch.core.memory``)."""
        from .memory import activation_bytes_report

        return activation_bytes_report(self.records)

    # -- entry-point guard --------------------------------------------------

    def check_key(self, who: str) -> None:
        """Fail fast when SR randomness is needed but no seed source exists.

        A constant default seed would reuse identical rounding noise every
        step, breaking the unbiasedness-in-expectation argument
        (Proposition 1 averages over independent draws).
        """
        if self.root_seed is None and self.seed_fn is None \
                and self.schedule is not None and self.schedule.requires_key:
            raise ValueError(
                f"{who}: the active stochastic-rounding policy needs a seed; "
                "pass seed=, or enter act_context(..., root_seed=...). (A "
                "fixed default seed would replay identical rounding noise "
                "every step.)")


def act_context(schedule: PolicySchedule | ACTPolicy | None = None,
                root_seed: int | None = None, *, step: int = 0,
                seed_fn: Callable[[str, int], int] | None = None
                ) -> ActContext:
    """A fresh ``ActContext`` to be entered as the ambient context::

        with act_context(schedule, root_seed, step=step) as ctx:
            ...
    """
    return ActContext(schedule, root_seed, step=step, seed_fn=seed_fn)


def model_context() -> ActContext:
    """Context resolution for model entry points: the ambient context, or a
    fresh FP32 one when none is active."""
    amb = current_context()
    return amb if amb is not None else ActContext(FP32)
