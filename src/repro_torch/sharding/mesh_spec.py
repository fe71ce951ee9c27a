"""One mesh-layout spec type for every consumer (port of
``repro/sharding/mesh_spec.py``).

The launcher's ``--mesh``, the rank start-up (``launch.mesh``) and the
data-parallel step (``training.data_parallel.make_dp_step``) all take this
one type, so a layout string means the same thing everywhere and a
malformed one fails with one named error (``MeshSpecError``). The accepted
strings and the messages are the reference's.

Grammar::

    SPEC  := ENTRY ("," ENTRY)*
    ENTRY := AXIS "=" N          # AXIS an identifier, N a positive int

``"data=8"`` is the 1D data-parallel layout; ``"data=4,model=2"`` the 2D
data x model mesh with row-sharded tables. Axis order is the rank-grid
order: rank ``r`` sits at the row-major coordinates of ``r`` in ``shape``.

Constructing, printing and validating a spec touches no process group;
``build_mesh`` (the reference's ``build_sim``) makes the ranks' subgroups
(``sharding.comm.TorchMesh``) once ``torch.distributed`` is initialized.
"""

from __future__ import annotations

import dataclasses
import math
import re

__all__ = ["MeshSpec", "MeshSpecError"]


class MeshSpecError(ValueError):
    """A malformed mesh layout spec (the one named parse error)."""


_AXIS_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """An ordered mesh layout: ``((axis_name, extent), ...)``.

    ``str(spec)`` round-trips through ``parse`` exactly, so checkpoint
    metadata stores the topology as a plain string and refusal messages
    name both sides literally.
    """

    axes: tuple  # ((name, extent), ...), order = rank-grid order

    @classmethod
    def parse(cls, spec: "str | MeshSpec") -> "MeshSpec":
        if isinstance(spec, MeshSpec):
            return spec

        def die(why: str):
            raise MeshSpecError(
                f"mesh spec must be comma-separated AXIS=N entries (e.g. "
                f"'data=8' or 'data=4,model=2'), got {spec!r}: {why}")

        if not isinstance(spec, str) or not spec.strip():
            die("empty spec")
        axes, seen = [], set()
        for ent in spec.split(","):
            name, eq, num = ent.strip().partition("=")
            name = name.strip()
            if not eq:
                die(f"entry {ent.strip()!r} has no '='")
            if not _AXIS_RE.match(name):
                die(f"bad axis name {name!r}")
            if name in seen:
                die(f"duplicate axis {name!r}")
            try:
                n = int(num.strip())
            except ValueError:
                die(f"extent {num.strip()!r} is not an integer")
            if n < 1:
                die(f"axis {name!r} extent must be >= 1, got {n}")
            seen.add(name)
            axes.append((name, n))
        return cls(tuple(axes))

    @classmethod
    def from_shape(cls, shape, names) -> "MeshSpec":
        """Pair per-axis extents with axis names."""
        shape, names = tuple(shape), tuple(names)
        if len(shape) != len(names):
            raise MeshSpecError(
                f"mesh shape {shape} must name {len(names)} extents for "
                f"axes {names} (got {len(shape)})")
        return cls(tuple((str(n), int(s)) for n, s in zip(names, shape)))

    def __str__(self) -> str:
        return ",".join(f"{n}={e}" for n, e in self.axes)

    @property
    def names(self) -> tuple:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> tuple:
        return tuple(e for _, e in self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def extent(self, name: str, default: int = 1) -> int:
        """Extent of ``name``, or ``default`` when the axis is absent, so a
        1D ``data=N`` spec answers ``extent("model") == 1``."""
        for n, e in self.axes:
            if n == name:
                return e
        return default

    def check_axes(self, allowed, required=()) -> "MeshSpec":
        """Refuse axis names outside ``allowed`` or missing ``required``
        with the same named error as a parse failure."""
        allowed, required = tuple(allowed), tuple(required)
        for n in self.names:
            if n not in allowed:
                raise MeshSpecError(
                    f"mesh spec {self} names axis {n!r}; this path "
                    f"supports axes {allowed}")
        for n in required:
            if n not in self.names:
                raise MeshSpecError(
                    f"mesh spec {self} is missing required axis {n!r}")
        return self

    def check_mesh(self, mesh) -> "MeshSpec":
        """Validate an already-built mesh (``TorchMesh``) against this
        spec."""
        got = {str(n): int(mesh.shape[n]) for n in mesh.axis_names}
        want = {n: e for n, e in self.axes}
        if got != want:
            raise ValueError(
                f"mesh spec {self} does not match the mesh's axes {got}")
        return self

    def build_mesh(self, device=None):
        """The ranks' mesh with this layout: every axis's subgroups made on
        the initialized default process group (``sharding.comm``)."""
        from repro_torch.sharding.comm import TorchMesh

        return TorchMesh.build(self, device=device)
