"""Per-site seeds for stochastic rounding (port of ``repro/core/rng.py``).

Every compressed op site draws its rounding noise from one uint32 seed,
derived from the run's root seed, the site's named scope (e.g.
``"kgat/layer2/spmm"``) and the step:

    seed = fmix(fmix(fmix(root) ^ crc32(scope)) ^ step)

with ``fmix`` the murmur3 32-bit finalizer. As in the reference the scope
enters through its crc32, so the derivation is deterministic given the root
(a replayed step draws the same noise) and stable under program edits
(adding an op changes no other op's seed). The reference folds the same
three inputs into a threefry key with ``jax.random.fold_in``, which torch
cannot reproduce; the two packages therefore draw different noise from the
same root. A parity test gives an ``ActContext`` a ``seed_fn`` instead
(``repro_torch.core.context``), which returns, for each (scope, step), the
seed the reference's kernel path would use.
"""

from __future__ import annotations

import zlib

__all__ = ["scope_hash", "scope_seed"]

_M32 = 0xFFFFFFFF


def _fmix(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def scope_hash(scope: str) -> int:
    """Stable 32-bit hash of a scope path (crc32, not Python's ``hash``,
    which is salted per process)."""
    return zlib.crc32(scope.encode("utf-8")) & _M32


def scope_seed(root: int, scope: str, step: int = 0) -> int:
    """The uint32 seed of one op site at one step; see module docstring."""
    return _fmix(_fmix(_fmix(root) ^ scope_hash(scope)) ^ (int(step) & _M32))
