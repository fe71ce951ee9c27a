"""Shared pytest configuration for the tier-1 suite.

Two jobs:

1. **Optional-dependency guards.** Some test modules use extras (e.g.
   ``hypothesis`` for property-based sweeps) that are not part of the
   baked container image. Those modules guard their own imports with a
   module-level ``pytest.importorskip("<dep>")`` so collection succeeds
   everywhere (the module reports as skipped instead of erroring).

2. **Test tiers.** The full suite exercises Pallas kernels in interpret
   mode (the kernel body runs in Python), which makes the heaviest cases
   slow on CPU. Those carry ``@pytest.mark.slow``; the fast tier is

       PYTHONPATH=src python -m pytest -q -m "not slow"

   and finishes in well under two minutes. CI (.github/workflows/ci.yml)
   runs the fast tier on CPU; the slow tier is a local/pre-release gate.
   See DESIGN.md §5.
"""

from __future__ import annotations


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy interpret-mode/statistical cases; deselect with "
        '-m "not slow" for the fast tier')
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA Hopper GPU and nvcc; skipped without a card "
        "(the port's kernel tests, run on the card)")
