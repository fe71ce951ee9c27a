"""Gradient compression for the multi-rank all-reduce (port of
``repro/training/compress.py``).

TinyKG's stochastic-rounding quantizer is an unbiased compressor, so the
reference reuses it for the gradient all-reduce, and so does the port:

  1. agree on a per-leaf scale: ``pmax`` of |g| (one scalar a leaf);
  2. SR-quantize ``g / scale`` to int8 codes in [-127, 127] (unbiased);
  3. ``psum`` the int32-widened codes (exact: an integer sum, the same
     bits whatever the order);
  4. dequantize by ``scale / 127 / n``.

The reference draws the rounding noise with ``jax.random`` (threefry),
which no other framework reproduces. The port draws it from its counter
hash (``kernels.hashrng.hash_uniform``: element index, uint32 seed) with
the reference's keying: the root seed, the scope ``<arch>/dp_psum`` and the
step (``core.rng.scope_seed``), then per reduced axis the rank's index along
it, then (with a placement) the group's position, then the leaf's index.
So the noise is independent across ranks and leaves, as in the reference,
and a replayed step draws the same noise. The leaves' scales travel in one
``pmax`` and their codes in one ``psum`` (a group's leaves concatenated):
both are elementwise, so this is the per-leaf reduce of the reference.

Axis-awareness (the 2D data x model mesh): ``placement`` maps top-level
parameter names to the axis each is row-sharded over. A row-sharded
table's gradient is already its block's exact gradient (the backward of
``sharding.rowshard.fetch_rows`` is the reduce-scatter share), so it
reduces only over the remaining axes; replicated parameters reduce over
every axis.

``allreduce_byte_report`` is the reference's analytic count: one byte an
element plus a 4-byte scale a leaf for int8, four bytes an element for
fp32; the two packages' series agree on it. The port's transport sends the
codes widened to int32 (step 3), four bytes an element either way:
``allreduce_sent_bytes`` counts that.
"""

from __future__ import annotations

import torch

from repro_torch.core.rng import _fmix, scope_seed
from repro_torch.kernels.hashrng import hash_uniform
from repro_torch.models.layers import param_leaves
from repro_torch.sharding.comm import TorchMesh, pmax, psum

__all__ = ["all_reduce_grads", "compressed_psum_mean", "psum_mean",
           "allreduce_byte_report", "allreduce_sent_bytes", "psum_seed",
           "fold_in", "restructure"]


def _axes(axis_name) -> tuple:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return param_leaves(tree)
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [tree]


def _numel(x) -> int:
    return int(x.numel()) if isinstance(x, torch.Tensor) else int(x.size)


def _reduce_groups(grads, axes: tuple, placement: dict | None) -> dict:
    """``reduced-axes tuple -> top-level names``: the grouping
    ``all_reduce_grads`` reduces by (placement skips the sharded axis)."""
    if not placement:
        return {axes: sorted(grads) if isinstance(grads, dict) else None}
    groups: dict = {}
    for name in grads:
        r_axes = tuple(a for a in axes if a != placement.get(name))
        groups.setdefault(r_axes, []).append(name)
    return groups


def _byte_groups(grads, axis_name, placement: dict | None, who: str):
    """``(reduced axes, names, elements, leaves)`` per all-reduce group."""
    axes = _axes(axis_name)
    if placement and not isinstance(grads, dict):
        raise TypeError(
            f"{who} placement= requires a dict of "
            f"top-level param subtrees, got {type(grads).__name__}")
    for r_axes, names in sorted(_reduce_groups(grads, axes,
                                               placement).items()):
        sub = grads if names is None else {n: grads[n] for n in names}
        leaves = _leaves(sub)
        yield r_axes, names, sum(_numel(x) for x in leaves), len(leaves)


def allreduce_byte_report(grads, axis_name, *, placement: dict | None = None,
                          compressed: bool = True) -> list[dict]:
    """Analytic per-step payload of ``all_reduce_grads``, by group (the
    reference's rows: ``axes``, ``wire``, ``bytes``, ``params``). ``grads``
    may hold tensors or numpy arrays of the parameters' shapes."""
    wire = "int8" if compressed else "fp32"
    out = []
    for r_axes, names, n_elems, n_leaves in _byte_groups(
            grads, axis_name, placement, "allreduce_byte_report"):
        if not r_axes:
            nbytes = 0      # sharded over every reduced axis: no wire hop
        elif compressed:
            nbytes = n_elems + 4 * n_leaves
        else:
            nbytes = 4 * n_elems
        out.append({"axes": "+".join(r_axes) if r_axes else "none",
                    "wire": wire, "bytes": int(nbytes),
                    "params": names})
    return out


def allreduce_sent_bytes(grads, axis_name, *, placement: dict | None = None,
                         compressed: bool = True) -> list[dict]:
    """What this port hands its all-reduce calls a step, by group (rows as
    ``allreduce_byte_report``'s): int8 sends the codes widened to int32, 4
    bytes an element, plus each leaf's fp32 scale in the ``pmax``; fp32
    sends 4 bytes an element. So int8 sends slightly more than fp32 here,
    where the analytic report counts a quarter."""
    wire = "int8" if compressed else "fp32"
    return [{"axes": "+".join(r_axes) if r_axes else "none", "wire": wire,
             "bytes": 0 if not r_axes else
             4 * n_elems + (4 * n_leaves if compressed else 0),
             "params": names}
            for r_axes, names, n_elems, n_leaves in _byte_groups(
                grads, axis_name, placement, "allreduce_sent_bytes")]


def fold_in(seed: int, data: int) -> int:
    """A new uint32 seed from ``seed`` and an integer (``jax.random.fold_in``'s
    role)."""
    return _fmix(_fmix(seed) ^ (int(data) & 0xFFFFFFFF))


def psum_seed(root_seed: int, scope: str, step: int) -> int:
    """The all-reduce's seed at one step: ``scope_seed(root, f"{scope}/
    dp_psum", step)``, the reference's ``scope_key``."""
    return scope_seed(root_seed, f"{scope}/dp_psum", step)


def _sr_quantize_int8(g: torch.Tensor, scale: torch.Tensor, seed: int):
    gn = g / torch.clamp_min(scale, 1e-12) * 127.0
    floor = torch.floor(gn)
    u = hash_uniform(torch.arange(g.numel(), device=g.device), seed)
    q = floor + (u.reshape(g.shape) < (gn - floor)).to(torch.float32)
    return torch.clamp(q, -127.0, 127.0).to(torch.int32)


def restructure(tree, leaves: list):
    """``leaves`` (in ``param_leaves`` order) put back in ``tree``'s
    shape."""
    it = iter(leaves)
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            out[k] = ([next(it) for _ in v] if isinstance(v, (list, tuple))
                      else next(it))
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [next(it) for _ in tree]
    return next(it)


def compressed_psum_mean(grads, mesh: TorchMesh, axis_name, seed: int):
    """Mean-all-reduce each leaf through int8 stochastic rounding
    (unbiased) over the ranks of ``axis_name`` (one axis or a tuple);
    ``seed`` is the same on every rank and each rank folds in its index
    along every reduced axis, so the noise is independent across ranks."""
    axes = mesh.axes(_axes(axis_name))
    for ax in axes:
        seed = fold_in(seed, mesh.index(ax))
    leaves = _leaves(grads)
    n = mesh.size(axes)
    gf = [g.to(torch.float32) for g in leaves]
    scales = pmax(torch.stack([g.abs().max() for g in gf]), mesh, axes)
    codes = [_sr_quantize_int8(g, scales[i], fold_in(seed, i)).reshape(-1)
             for i, g in enumerate(gf)]
    total = psum(torch.cat(codes), mesh, axes).split(
        [c.numel() for c in codes])
    out = [(t.to(torch.float32) * scales[i] / 127.0 / n)
           .reshape(g.shape).to(g.dtype)
           for i, (t, g) in enumerate(zip(total, leaves))]
    return restructure(grads, out)


def psum_mean(grads, mesh: TorchMesh, axis_name):
    """The exact fp32 baseline: ``psum(g) / n`` for every leaf (one
    concatenated all-reduce)."""
    axes = mesh.axes(_axes(axis_name))
    leaves = _leaves(grads)
    n = mesh.size(axes)
    flat = psum(torch.cat([g.to(torch.float32).reshape(-1)
                           for g in leaves]), mesh, axes)
    out = [(t / n).reshape(g.shape).to(g.dtype) for t, g in
           zip(flat.split([g.numel() for g in leaves]), leaves)]
    return restructure(grads, out)


def all_reduce_grads(grads, mesh: TorchMesh, axis_name, *,
                     seed: int | None = None, compressed: bool = True,
                     placement: dict | None = None):
    """The one gradient all-reduce of the multi-rank step.

    ``compressed=False`` is the exact fp32 mean; ``compressed=True`` needs
    the step's seed (``psum_seed``: reusing one would replay the same
    rounding noise every step). ``placement`` maps top-level names of the
    ``grads`` dict to the axis each is row-sharded over; those reduce over
    the other axes only."""
    axes = _axes(axis_name)
    if compressed and seed is None:
        raise ValueError(
            "compressed grad all-reduce needs a per-step seed (pass "
            "compressed=False for the exact baseline)")
    if not placement:
        if not compressed:
            return psum_mean(grads, mesh, axes)
        return compressed_psum_mean(grads, mesh, axes, seed)
    if not isinstance(grads, dict):
        raise TypeError(
            "all_reduce_grads placement= requires a dict of top-level "
            f"param subtrees, got {type(grads).__name__}")
    unknown = sorted(set(placement) - set(grads))
    if unknown:
        raise ValueError(
            f"placement names parameters not in the gradient tree: "
            f"{unknown} (have {sorted(grads)})")
    groups = _reduce_groups(grads, axes, placement)
    out = {}
    for j, r_axes in enumerate(sorted(groups)):
        sub = {n: grads[n] for n in groups[r_axes]}
        if not r_axes:
            out.update(sub)  # sharded over every reduced axis: local
        elif not compressed:
            out.update(psum_mean(sub, mesh, r_axes))
        else:
            out.update(compressed_psum_mean(sub, mesh, r_axes,
                                            fold_in(seed, j)))
    return {name: out[name] for name in grads}
