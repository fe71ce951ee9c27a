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

``embedding_bag`` (port of ``repro/models/layers.py:85``) sums or averages
multi-hot bags of table rows. The reference builds it from ``jnp.take``
and ``jax.ops.segment_sum``; the port from ``core.act.lookup_rows`` and
``sum_rows`` over a ``BagPlan`` built on the host (``bag_plan``: the
lookups' table rows and their grouping by bag, ``data.csr``'s runs), so on
the card the bag sums and the table gradient are fixed-order segment sums
(``csrc/segment_sum.cu``), with no ``index_add_``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.act import act_dense, act_nonlin, act_relu, \
    lookup_rows, sum_rows
from repro_torch.core.context import current_context
from repro_torch.data.csr import LookupPlan, lookup_plan, segment_runs, \
    stable_argsort

__all__ = ["glorot", "lecun", "normal_init", "dense_params", "mlp_params",
           "mlp_apply", "param_leaves", "BagPlan", "bag_plan",
           "embedding_bag"]


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


@dataclasses.dataclass(frozen=True)
class BagPlan:
    """The host-built grouping of an ``embedding_bag`` call: ``lookup``
    the lookups' table rows (``data.csr.LookupPlan``), ``bag`` each
    lookup's bag id, ``runs`` one ``SegmentRuns`` level whose output row
    ``b`` sums bag ``b``'s lookups in lookup order, and ``counts`` each
    bag's lookups (fp32)."""

    lookup: LookupPlan
    bag: torch.Tensor      # (nnz,) int64
    runs: tuple
    counts: torch.Tensor   # (num_segments,) fp32


def bag_plan(idx, segment_ids, num_segments: int, n_rows: int,
             device="cpu") -> BagPlan:
    """The ``BagPlan`` of lookups ``idx`` (table rows in ``[0, n_rows)``)
    into bags ``segment_ids`` (in ``[0, num_segments)``), host arrays,
    moved to ``device`` without waiting."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    seg = np.asarray(segment_ids, np.int64).reshape(-1)
    if idx.shape != seg.shape:
        raise ValueError(f"{len(idx)} lookups against {len(seg)} bag ids")
    counts = np.bincount(seg, minlength=num_segments)
    end = np.cumsum(counts)
    runs = (segment_runs(stable_argsort(seg, num_segments), end - counts,
                         end, num_segments, len(seg), device),)
    return BagPlan(lookup_plan(idx, n_rows, device),
                   torch.from_numpy(seg).to(device, non_blocking=True), runs,
                   torch.from_numpy(counts.astype(np.float32)).to(
                       device, non_blocking=True))


def embedding_bag(table: torch.Tensor, idx, segment_ids, num_segments: int,
                  *, weights: torch.Tensor | None = None,
                  combiner: str = "sum",
                  plan: BagPlan | None = None) -> torch.Tensor:
    """(num_segments, dim): bag ``b`` is the sum (``combiner="sum"``) or
    the mean (``"mean"``; an empty bag gives 0) of the table rows
    ``idx[e]`` over the lookups ``e`` with ``segment_ids[e] == b``, each
    row scaled by ``weights[e]`` where given.

    table : (vocab, dim); idx, segment_ids : (nnz,) host ints (``plan``,
    from ``bag_plan``, replaces them: a caller that reuses a batch's
    grouping builds it once). Both sums run in a fixed order: the bags'
    through ``sum_rows``, the table gradient through ``lookup_rows``.
    """
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner}")
    if plan is None:
        plan = bag_plan(idx, segment_ids, num_segments, table.shape[0],
                        table.device)
    rows = lookup_rows(table, plan.lookup)
    if weights is not None:
        rows = rows * weights[:, None]
    out = sum_rows(rows, plan.bag, plan.runs)
    if combiner == "mean":
        out = out / torch.clamp_min(plan.counts, 1.0)[:, None]
    return out
