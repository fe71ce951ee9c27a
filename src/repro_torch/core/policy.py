"""ACT (activation-compressed training) policies and schedules (port of
``repro/core/policy.py``; the grammar, the presets and the scope names are
the reference's, so one schedule string means the same in both packages).

``ACTPolicy`` is a frozen (hashable) dataclass describing ONE op site's
residual storage. ``PolicySchedule`` maps op *sites* to policies: an ordered
rule table over ``(op_kind, scope glob, layer)`` resolved per call by the ACT
context (``repro_torch.core.context``). A bare ``ACTPolicy`` is the
uniform-schedule fast path: every API that takes a schedule also accepts a
policy (via ``as_schedule``).

``kernel`` stays a field so that the reference's strings and presets parse
unchanged, but the port has one quantizer whatever it says: the counter-hash
stochastic rounding of the reference's ``kernel="pallas"`` path, routed by
device (the CUDA kernels for a tensor on the card, their plain versions for
one on the CPU). The reference's ``kernel="jnp"`` draws its rounding noise
from ``jax.random``, which no other framework reproduces.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re

__all__ = [
    "ACTPolicy", "FP32", "INT8", "INT4", "INT2", "INT1", "policy_for_bits",
    "ScheduleRule", "PolicySchedule", "as_schedule", "scope_layer",
    "parse_schedule", "schedule_from_cli", "schedule_label",
    "first_layer_int8_rest_int2", "SCHEDULE_PRESETS",
]


@dataclasses.dataclass(frozen=True)
class ACTPolicy:
    """How compressed-activation ops store their backward residuals.

    bits       : 1/2/4/8 quantized storage, or ``None`` for the exact FP32
                 baseline (paper Tables 2-5 column "FP32").
    stochastic : stochastic rounding (paper default) vs nearest rounding
                 (paper Table 6 ablation — diverges below INT8).
    enabled    : master switch; ``False`` behaves exactly like vanilla ops.
    kernel     : "jnp" or "pallas", kept for the reference's grammar; the
                 port routes by device whatever it says (module docstring).
    """

    bits: int | None = 2
    stochastic: bool = True
    enabled: bool = True
    kernel: str = "jnp"

    def __post_init__(self):
        if self.bits is not None and self.bits not in (1, 2, 4, 8):
            raise ValueError(f"bits must be in {{1,2,4,8}} or None, got {self.bits}")
        if self.kernel not in ("jnp", "pallas"):
            raise ValueError(f"kernel must be 'jnp' or 'pallas', got {self.kernel}")

    @property
    def active(self) -> bool:
        return self.enabled and self.bits is not None

    @property
    def requires_key(self) -> bool:
        """True when this policy's quantizer consumes SR randomness."""
        return self.active and self.stochastic

    def with_bits(self, bits: int | None) -> "ACTPolicy":
        return dataclasses.replace(self, bits=bits)


FP32 = ACTPolicy(bits=None)
INT8 = ACTPolicy(bits=8)
INT4 = ACTPolicy(bits=4)
INT2 = ACTPolicy(bits=2)
INT1 = ACTPolicy(bits=1)


def policy_for_bits(bits: int | None, *, stochastic: bool = True,
                    kernel: str = "jnp") -> ACTPolicy:
    return ACTPolicy(bits=bits, stochastic=stochastic, kernel=kernel)


# ---------------------------------------------------------------------------
# per-site policy schedules
# ---------------------------------------------------------------------------

# a scope path component "layer<N>" tags the layer index (naming convention,
# DESIGN.md §6); "#k" suffixes dedup scope names repeated within one context
# and are invisible to rule matching.
_LAYER_RE = re.compile(r"(?:^|/)layer(\d+)(?:/|$)")


def scope_layer(scope: str) -> int | None:
    """Layer index encoded in a scope path, or None."""
    m = _LAYER_RE.search(scope.split("#", 1)[0])
    return int(m.group(1)) if m else None


@dataclasses.dataclass(frozen=True)
class ScheduleRule:
    """One row of a ``PolicySchedule``; ``None`` fields match anything.

    op_kind : op class ("matmul" | "nonlin" | "rmsnorm" | "spmm" | "remat")
    scope   : fnmatch glob over the full scope path, e.g. ``"kgat/*/spmm"``
    layer   : matches the ``layer<N>`` component of the scope path
    """

    policy: ACTPolicy
    op_kind: str | None = None
    scope: str | None = None
    layer: int | None = None

    def matches(self, op_kind: str, scope: str) -> bool:
        if self.op_kind is not None and self.op_kind != op_kind:
            return False
        if self.scope is not None and not fnmatch.fnmatchcase(
                scope.split("#", 1)[0], self.scope):
            return False
        if self.layer is not None and self.layer != scope_layer(scope):
            return False
        return True


@dataclasses.dataclass(frozen=True)
class PolicySchedule:
    """Ordered ``(op_kind, scope glob, layer) -> ACTPolicy`` rule table.

    Resolution: first matching rule wins; no match falls through to
    ``default``. A uniform schedule is just ``PolicySchedule(default=pol)``
    (or pass the bare ``ACTPolicy`` — ``as_schedule`` wraps it).
    """

    rules: tuple[ScheduleRule, ...] = ()
    default: ACTPolicy = FP32

    def resolve(self, op_kind: str, scope: str) -> ACTPolicy:
        for rule in self.rules:
            if rule.matches(op_kind, scope):
                return rule.policy
        return self.default

    @classmethod
    def uniform(cls, policy: ACTPolicy) -> "PolicySchedule":
        return cls(rules=(), default=policy)

    @property
    def policies(self) -> tuple[ACTPolicy, ...]:
        return tuple(r.policy for r in self.rules) + (self.default,)

    @property
    def requires_key(self) -> bool:
        """Conservative: any reachable policy consumes SR randomness."""
        return any(p.requires_key for p in self.policies)


def as_schedule(policy_or_schedule) -> PolicySchedule:
    """Coerce an ``ACTPolicy`` (uniform fast path) to a ``PolicySchedule``."""
    if isinstance(policy_or_schedule, PolicySchedule):
        return policy_or_schedule
    if isinstance(policy_or_schedule, ACTPolicy):
        return PolicySchedule.uniform(policy_or_schedule)
    raise TypeError(
        f"expected ACTPolicy or PolicySchedule, got {policy_or_schedule!r}")


def first_layer_int8_rest_int2(*, stochastic: bool = True,
                               kernel: str = "jnp") -> PolicySchedule:
    """Tiered preset: sensitive first-layer sites at INT8, the rest INT2.

    First-layer SPMM residuals and transform inputs see the raw embedding
    scale and tolerate the least rounding noise; deeper sites sit behind
    contractive nonlinearities (the hot/cold tiering argument of the data-
    tiering line of work applied to ACT residuals).
    """
    mk = lambda b: ACTPolicy(bits=b, stochastic=stochastic, kernel=kernel)  # noqa: E731
    return PolicySchedule(rules=(ScheduleRule(policy=mk(8), layer=0),),
                          default=mk(2))


SCHEDULE_PRESETS = {
    "first_layer_int8_rest_int2": first_layer_int8_rest_int2,
}

_BITS_SPEC = {"fp32": None, "none": None, "int1": 1, "int2": 2, "int4": 4,
              "int8": 8, "1": 1, "2": 2, "4": 4, "8": 8}


def parse_schedule(spec: str, *, stochastic: bool = True,
                   kernel: str = "jnp") -> PolicySchedule:
    """Build a schedule from a CLI spec string.

    Accepted forms (see ``repro_torch.launch.train --schedule``):
      * a preset name          — ``first_layer_int8_rest_int2``
      * a uniform bit-width    — ``int2`` / ``8`` / ``fp32``
      * ordered rules          — comma-separated ``[kind:]glob=bits`` pairs,
        first match wins; a bare ``*=bits`` sets the default, and WITHOUT
        one unmatched sites stay FP32 (compress only what the spec names —
        no silent implicit bit-width). Example:
        ``spmm:*/layer0/*=8,*/layer0/*=4,*=2``.
    """
    spec = spec.strip()
    if spec in SCHEDULE_PRESETS:
        return SCHEDULE_PRESETS[spec](stochastic=stochastic, kernel=kernel)
    mk = lambda b: ACTPolicy(bits=b, stochastic=stochastic, kernel=kernel)  # noqa: E731
    if spec.lower() in _BITS_SPEC:
        return PolicySchedule.uniform(mk(_BITS_SPEC[spec.lower()]))
    rules: list[ScheduleRule] = []
    default = mk(None)
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            lhs, rhs = entry.split("=")
        except ValueError:
            raise ValueError(f"bad schedule entry {entry!r} in {spec!r} "
                             "(expected [kind:]glob=bits)") from None
        if rhs.lower() not in _BITS_SPEC:
            raise ValueError(f"bad bit-width {rhs!r} in {spec!r}")
        pol = mk(_BITS_SPEC[rhs.lower()])
        kind, glob = lhs.split(":", 1) if ":" in lhs else (None, lhs)
        if glob == "*" and kind is None:
            default = pol
        else:
            rules.append(ScheduleRule(policy=pol, op_kind=kind, scope=glob))
    return PolicySchedule(rules=tuple(rules), default=default)


def schedule_label(spec: str | None, bits: int | None) -> str:
    """The canonical CLI-level schedule string (logs and, once checkpoints
    are ported, their identity), derived the same way by every entry point."""
    return spec or ("fp32" if not bits else f"int{bits}")


def schedule_from_cli(spec: str | None, bits: int | None, *,
                      stochastic: bool = True,
                      kernel: str = "jnp") -> PolicySchedule:
    """The shared ``--schedule`` / ``--bits`` precedence for entry points:
    a spec string wins; otherwise a uniform schedule from ``bits``
    (0/None = FP32 baseline)."""
    if spec:
        return parse_schedule(spec, stochastic=stochastic, kernel=kernel)
    return PolicySchedule.uniform(policy_for_bits(
        bits if bits else None, stochastic=stochastic, kernel=kernel))
