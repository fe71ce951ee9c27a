"""The training step: one ``ModelStep`` per arch and the function that runs
it (port of ``repro/training/step.py:ModelStep, make_train_step``).

A ``ModelStep`` binds a model's loss to its config and data:

  * ``init(seed) -> params``: the parameter dict, leaves requiring grad;
  * ``loss(params, batch, *, ctx=None) -> scalar``: the objective, every ACT
    site resolved through the ``ActContext`` it runs in (``ctx`` is entered
    for the call; ``None`` leaves resolution to the caller's context);
  * ``batches() -> iterator``: the step's default data stream;
  * ``dp_spec``: what the multi-rank path shards (``ShardSpec``: the edges
    over the ``data`` ranks, and per parameter its layout over the
    ``model`` ranks), or ``None`` with ``dp_unsupported`` naming why;
  * ``unread``: the top-level parameters the loss does not read (DLRM's
    ``linear`` and ``bias``); their gradient is zero, as ``jax.grad``
    gives it. Any other parameter without a path to the loss is an error.

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

__all__ = ["ShardSpec", "DPSpec", "ROW_SHARDED", "REPLICATED", "ModelStep",
           "step_metadata", "make_train_step", "trainable", "enter_or_null"]

# per-parameter placement kinds of ``ShardSpec.placement``; REPLICATED is
# the default for any parameter not listed
ROW_SHARDED = "rows"
REPLICATED = "replicated"


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """What a step shards and what it replicates on several ranks (port of
    ``repro/training/step.py:ShardSpec``).

    The data axis: ``graph`` is the host COO edge list to split by
    destination (``data.csr.partition_edges``; anything with ``src``,
    ``dst``, ``rel``, ``n_nodes`` and ``n_relations``); the batch splits
    evenly over the ``data`` ranks. ``sites`` lists the per-layer ACT sites
    ``(name, op_kind)``; they resolve through the ambient ``ActContext``
    under the same ``<scope>/layer<l>/<site>`` paths as the single-device
    step. ``shard_loss(params, view, batch) -> (local objective, local
    batch loss)`` and ``shard_reps(params, view) -> local readout rows``
    run the model on one shard's view.

    The model axis: ``placement`` gives, per top-level parameter name, its
    layout over the ``model`` ranks: ``(name, ROW_SHARDED)`` stores dim 0
    as row blocks; anything not listed is REPLICATED. On a 1D ``data=N``
    mesh the placement is inert.
    """

    graph: Any
    scope: str
    sites: tuple
    n_layers: int
    shard_loss: Callable = None
    shard_reps: Callable | None = None
    placement: tuple = ()

    def row_sharded(self) -> tuple:
        """Top-level parameter names row-sharded over the model axis."""
        return tuple(n for n, kind in self.placement if kind == ROW_SHARDED)

    def placement_str(self) -> str:
        """Stable string form for checkpoint metadata (``"entity=rows"``)."""
        return ",".join(f"{n}={kind}" for n, kind in self.placement)


# the reference's pre-2D name
DPSpec = ShardSpec


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
    dp_spec: ShardSpec | None = None
    dp_unsupported: str | None = None   # why dp_spec is None, for errors
    unread: tuple = ()             # parameters the loss does not read

    def metadata(self) -> dict:
        """Checkpoint-facing identity (see ``step_metadata``)."""
        return {"arch": self.arch, "family": self.family,
                "model": getattr(self.cfg, "model", self.family)}


def step_metadata(step: ModelStep, schedule_spec: str | None = None, *,
                  mesh_spec=None, placement: str | None = None) -> dict:
    """The identity a checkpoint carries, so that a restore cannot silently
    resume another run: the step's ``metadata()``, the CLI-level schedule
    string (``"int8"``, ``"first_layer_int8_rest_int2"``, ...) and, for a
    multi-rank run, the mesh (a ``MeshSpec`` or its string) and the table
    placement (``ShardSpec.placement_str()``).
    ``training.checkpoint.check_meta`` refuses a restore under another
    arch, model, schedule, mesh or placement (``--reshard-from`` is the
    way across meshes)."""
    meta = step.metadata()
    if schedule_spec is not None:
        meta["schedule"] = str(schedule_spec)
    if mesh_spec is not None:
        meta["mesh"] = str(mesh_spec)
    if placement is not None:
        meta["placement"] = str(placement)
    return meta


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
    fp32 (``full_fp32``), whatever the caller's TF32 setting. The
    parameters of ``step.unread`` get a zero gradient.
    """

    def train_step(state, batch, i):
        params, opt_state = state
        ctx = act_context(schedule, root_seed, step=i, seed_fn=seed_fn)
        leaves = param_leaves(params)
        unread = {id(t) for t in param_leaves(
            {k: params[k] for k in step.unread})}
        with full_fp32():
            loss = step.loss(params, batch, ctx=ctx)
            got = iter(torch.autograd.grad(
                loss, [p for p in leaves if id(p) not in unread]))
        grads = [torch.zeros_like(p) if id(p) in unread else next(got)
                 for p in leaves]
        params, opt_state = opt.update(grads, opt_state, params)
        return (params, opt_state), {"loss": loss.detach(),
                                     "act": ctx.report()}

    return train_step
