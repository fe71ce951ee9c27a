"""Compressed-gradient training on several ranks for every registered KG
step (port of ``repro/training/data_parallel.py`` on ``torch.distributed``).

The edges are split by destination shard once at launch
(``data.csr.partition_edges``), one shard a ``data`` rank. Each rank runs
the whole step on its shard: edge weights, edge softmax, the
activation-compressed SPMM and transforms, BPR and the backward, through
the step's own ``ShardSpec.shard_loss``, which is the same
``propagate_view`` layer code as the single-device step, on a
``models.kgnn.ShardGraphView``. Each shard's edges carry their own
blocked-CSR layout and relation grouping, so the shard's SPMM, SDDMMs,
quant-pack and dequant-matmul are the port's kernels on the card (the
reference runs its jnp backend here). Neighbour rows come in through the
all-gather and the shard's halo rows; gradients all-reduce through the
INT8 stochastic-rounding mean (``training.compress``) or the exact fp32
mean; Adam then runs on each rank on the same bits.

Two mesh layouts, one step (``model_axis`` selects):

  * 1D ``data=N``: parameters replicated, gradients mean-reduced over
    ``data``;
  * 2D ``data x model``: the parameters the ``ShardSpec.placement`` marks
    ROW_SHARDED (the entity table) live as row blocks, ``1/M`` of the
    table on each ``model`` rank; the view is a ``Shard2DGraphView``, whose
    ``local_rows`` fetches the shard's rows from the blocks
    (``sharding.rowshard.fetch_rows``). Row-sharded gradients reduce over
    ``data`` only, replicated ones over both axes. On a rank, such a
    parameter is its block (``block_rows``); ``pad_row_sharded`` and
    ``unpad_row_sharded`` move between the full logical table and the
    padded row space the blocks tile.

Exactness (the reference's contract, ``tests/test_torch_dp.py``): the edge
weights are computed once from the layer-0 embeddings; within a shard the
edges keep their original relative order and each destination row sums
them in that order, so with exact compression and ``compress_grads=False``
the sharded forward gives the single-device rows, and the loss and
gradients agree to fp32 reassociation. Under stochastic policies each
shard quantizes with its own per-row scales and the scope-keyed seeds of
the single-device step, so the step is not the single-device step's bits,
but every estimator stays unbiased.

Failures (``make_dp_step``): every rank reaches one agreement point a step,
after the loss and the gradient all-reduce and before Adam (which updates
in place). A rank whose own code raised up to there, or whose step was
handed an injected failure (``train_step(..., fail=err)``), sets its flag; the flags are all-reduced by
max, and if any is set every rank raises the same ``StepFailed``, naming
the rank, with its state untouched. The trainers then roll back together
(``training.checkpoint.RankCheckpoints`` agrees on the step). This holds
for an injected failure, which the step carries through all its
collectives, and for a rank's own exception raised before the step's first
collective. It does not hold for an exception raised after that: the
failing rank then calls the flags' all-reduce while the others are in one
of the step's own collectives, and since every collective takes the one
``allreduce`` route the two calls may pair, so what follows is undefined
(an error, a mismatched buffer, or a wait until gloo's timeout). A rank
that dies inside a collective leaves the others waiting in it until gloo's
timeout.

The per-site policies and seeds resolve through the ambient
``ActContext`` under the same ``<arch>/layer<l>/<site>`` scopes as the
single-device step (no pre-resolution is needed: the body is ordinary
Python on each rank).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.context import act_context
from repro_torch.data.csr import EdgePartition, partition_edges, \
    row_partition, shard_graph_arrays
from repro_torch.kernels.backend import full_fp32
from repro_torch.models.layers import param_leaves
from repro_torch.sharding.comm import TorchMesh, all_gather, digest, \
    gather_rows_of_ranks, pmax, psum
from repro_torch.sharding.mesh_spec import MeshSpec
from repro_torch.training.compress import all_reduce_grads, \
    allreduce_byte_report, allreduce_sent_bytes, psum_seed, restructure
from repro_torch.training.step import ModelStep, ShardSpec

__all__ = ["partition_graph", "dp_loss_and_grads", "make_dp_step",
           "dp_forward_reps", "pad_row_sharded", "unpad_row_sharded",
           "check_no_sampled_dp", "shard_view", "block_rows",
           "gather_row_blocks", "replica_check", "StepFailed",
           "agree_on_failure"]


def check_no_sampled_dp(batch_or_view, *, mesh_spec: str = "data=N") -> None:
    """Refuse sampled minibatches on the multi-rank path with the
    reference's named error: the edges are split once at launch, but a
    sampled batch carries a fresh edge set every hop and step."""
    from repro_torch.models.kgnn import SampledGraphView

    inner = getattr(batch_or_view, "view", None)  # unwrap a SampledItem
    if isinstance(batch_or_view, SampledGraphView) \
            or isinstance(inner, SampledGraphView) or (
            isinstance(batch_or_view, str) and batch_or_view):
        raise NotImplementedError(
            f"sampled minibatch training (--sample) cannot be combined "
            f"with data parallelism (--mesh {mesh_spec}): edges are "
            f"dst-partitioned once at launch, but sampled batches carry "
            f"a fresh per-hop edge set every step. Drop --mesh to train "
            f"sampled on one device, or drop --sample for full-graph "
            f"data parallelism.")


def partition_graph(g, mesh, *, axis: str = "data") -> EdgePartition:
    """``partition_edges`` sized to one mesh axis (edges by destination
    shard); ``g`` is a host COO graph (``src``, ``dst``, ``rel``,
    ``n_nodes``), ``mesh`` a ``TorchMesh`` or a ``MeshSpec``."""
    n = mesh.shape[axis] if isinstance(mesh, TorchMesh) \
        else mesh.extent(axis)
    return partition_edges(np.asarray(g.src), np.asarray(g.dst),
                           np.asarray(g.rel), n_nodes=g.n_nodes,
                           n_shards=int(n))


def _as_dp_spec(step: ModelStep | ShardSpec) -> ShardSpec:
    if isinstance(step, ShardSpec):
        return step
    if getattr(step, "dp_spec", None) is None:
        arch = getattr(step, "arch", "<unknown>")
        why = getattr(step, "dp_unsupported", None) or \
            "the step registered no ShardSpec"
        raise NotImplementedError(
            f"data parallelism is not implemented for arch {arch!r}: {why}")
    return step.dp_spec


def _check_contract(part: EdgePartition, mesh: TorchMesh, axis: str, batch,
                    root_seed, *, need_key: bool) -> None:
    n_shards = int(mesh.shape[axis])
    if part.n_shards != n_shards:
        raise ValueError(
            f"partition built for {part.n_shards} shards, mesh axis "
            f"{axis!r} has {n_shards}")
    if batch is not None:
        b = batch["user"].shape[0]
        if b % n_shards:
            raise ValueError(
                f"batch {b} not divisible by {n_shards} shards")
    if need_key and root_seed is None:
        raise ValueError("dp step needs a root seed (per-step SR + psum "
                         "compression seeds derive from it)")


# -- the 2D row-sharded placement ----------------------------------------------


def _spec_row_sharded(spec_or_names) -> tuple:
    if isinstance(spec_or_names, (list, tuple, set, frozenset)):
        return tuple(spec_or_names)
    return _as_dp_spec(spec_or_names).row_sharded()


def _row_geometry(part: EdgePartition, n_model: int):
    """The blocks' geometry on an ``n_model`` axis: the padded row space
    covers every data shard's destination rows (``n_nodes_padded``)."""
    return row_partition(part.n_nodes, n_model, pad_to=part.n_nodes_padded)


def _leaf_names(params: dict) -> list:
    """The top-level name of each leaf, in ``param_leaves`` order."""
    return [k for k in sorted(params)
            for _ in (params[k] if isinstance(params[k], list)
                      else [params[k]])]


def _map_rows(tree, names: set, fn):
    """``fn`` applied to every row-sharded leaf of a parameter dict, or of
    a ``(params, opt_state)`` pair (Adam's ``mu``/``nu`` lists follow the
    parameters' leaf order)."""
    if isinstance(tree, dict):
        return {k: (fn(k, v) if k in names and not isinstance(v, list)
                    else v) for k, v in tree.items()}
    params, opt_state = tree
    leaf_names = _leaf_names(params)
    out = dict(opt_state)
    for key in ("mu", "nu"):
        out[key] = [fn(n, v) if n in names else v
                    for n, v in zip(leaf_names, opt_state[key])]
    return (_map_rows(params, names, fn), out)


def pad_row_sharded(tree, spec_or_names, part: EdgePartition, n_model: int):
    """Zero-pad every row-sharded leaf (a parameter dict, or a ``(params,
    opt_state)`` pair) from ``part.n_nodes`` rows to the 2D mesh's padded
    row count (``n_model x rows_per_block``). Padded rows are zero and get
    no gradient (``fetch_rows`` drops their cotangents), so Adam keeps
    them at zero."""
    names = set(_spec_row_sharded(spec_or_names))
    if not names or n_model is None:
        return tree
    rp = _row_geometry(part, n_model)

    def fix(name, leaf):
        rows = leaf.shape[0]
        if rows == rp.n_rows_padded:
            return leaf
        if rows != part.n_nodes:
            raise ValueError(
                f"row-sharded leaf {name!r} has {rows} rows; expected "
                f"{part.n_nodes} (unpadded) or {rp.n_rows_padded} (already "
                f"padded for model={n_model})")
        pad = (rp.n_rows_padded - rows,) + tuple(leaf.shape[1:])
        if isinstance(leaf, np.ndarray):
            return np.concatenate([leaf, np.zeros(pad, leaf.dtype)])
        out = torch.cat([leaf.detach(), leaf.new_zeros(pad)])
        return out.requires_grad_(leaf.requires_grad)

    return _map_rows(tree, names, fix)


def unpad_row_sharded(tree, spec_or_names, n_rows: int):
    """Inverse of ``pad_row_sharded``: row-sharded leaves cut back to the
    real row count (checkpoints, parity tests)."""
    names = set(_spec_row_sharded(spec_or_names))
    if not names:
        return tree
    return _map_rows(tree, names, lambda _, leaf: leaf[:n_rows])


def block_rows(tree, spec_or_names, part: EdgePartition, mesh: TorchMesh,
               model_axis: str = "model"):
    """This rank's block of every row-sharded leaf of a padded tree (a
    fresh leaf, requiring grad where the padded one did)."""
    names = set(_spec_row_sharded(spec_or_names))
    rp = _row_geometry(part, mesh.shape[model_axis])
    i = mesh.index(model_axis)

    def cut(_, leaf):
        blk = leaf[i * rp.rows_per_shard:(i + 1) * rp.rows_per_shard]
        if isinstance(blk, np.ndarray):
            return blk.copy()
        return blk.detach().clone().requires_grad_(leaf.requires_grad)

    return _map_rows(tree, names, cut)


def gather_row_blocks(tree, spec_or_names, part: EdgePartition,
                      mesh: TorchMesh, model_axis: str = "model"):
    """Every rank's blocks of the row-sharded leaves put back together
    (the padded row space), on every rank; a collective over
    ``model_axis``."""
    names = set(_spec_row_sharded(spec_or_names))
    return _map_rows(tree, names, lambda _, leaf: all_gather(
        leaf.detach(), mesh, model_axis, dim=0))


# -- the shard's view -----------------------------------------------------------


def shard_view(spec: ShardSpec, part: EdgePartition, mesh: TorchMesh, *,
               axis: str = "data", model_axis: str | None = None,
               device=None):
    """This rank's ``ShardGraphView`` (``Shard2DGraphView`` with a
    ``model_axis``): its shard's edges and layout on ``device``, built on
    the host once."""
    from repro_torch.models.kgnn import Shard2DGraphView, ShardGraphView
    from repro_torch.sharding.rowshard import owned_runs

    dev = device if device is not None else mesh.device
    s = mesh.index(axis)
    arrays = shard_graph_arrays(part, s, spec.graph.n_relations, device=dev)
    common = dict(src=arrays["src"], dst=arrays["dst"], rel=arrays["rel"],
                  mask=arrays["mask"], layout=arrays["layout"],
                  rel_runs=arrays["rel_runs"], halo=arrays["halo"],
                  halo_count=arrays["halo_count"], mesh=mesh, axis=axis,
                  num_rows=part.rows_per_shard,
                  n_nodes_padded=part.n_nodes_padded)
    if model_axis is None:
        return ShardGraphView(**common)
    rp = _row_geometry(part, mesh.shape[model_axis])
    ids = np.arange(s * part.rows_per_shard, (s + 1) * part.rows_per_shard)
    return Shard2DGraphView(
        **common, model_axis=model_axis, table_rows=rp.rows_per_shard,
        n_valid_rows=part.n_nodes, row_sharded=spec.row_sharded(),
        local_runs=owned_runs(ids, mesh.index(model_axis), rp.rows_per_shard,
                              part.n_nodes, device=dev))


def _check_row_sharded(params, sharded, rp, model_axis: str) -> None:
    for name in sharded:
        if name not in params:
            raise ValueError(
                f"ShardSpec places {name!r} on the model axis but params "
                f"has no such top-level entry (have {sorted(params)})")
        leaf = params[name]
        if getattr(leaf, "ndim", 0) < 2:
            raise ValueError(
                f"row-sharded param {name!r} must be a (rows, d) array, "
                f"got ndim={getattr(leaf, 'ndim', None)}")
        if leaf.shape[0] != rp.rows_per_shard:
            raise ValueError(
                f"row-sharded param {name!r} has {leaf.shape[0]} rows; a "
                f"{model_axis}={rp.n_shards} mesh needs {rp.n_rows_padded} "
                f"({rp.n_shards}×{rp.rows_per_shard}) — pad the state with "
                f"pad_row_sharded() and take this rank's block_rows() "
                f"before building the step")


def _prepare(step, part, mesh, axis, model_axis, params, batch, root_seed,
             need_key):
    spec = _as_dp_spec(step)
    _check_contract(part, mesh, axis, batch, root_seed, need_key=need_key)
    sharded = spec.row_sharded() if model_axis is not None else ()
    if model_axis is not None:
        _check_row_sharded(params, sharded, _row_geometry(
            part, mesh.shape[model_axis]), model_axis)
    return spec, sharded


def _local_batch(batch: dict, mesh: TorchMesh, axis: str) -> dict:
    n, i = mesh.shape[axis], mesh.index(axis)
    b = batch["user"].shape[0] // n
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def dp_loss_and_grads(step: ModelStep | ShardSpec, params: dict,
                      part: EdgePartition, batch: dict, *, mesh: TorchMesh,
                      view=None, axis: str = "data",
                      model_axis: str | None = None, schedule=None,
                      root_seed: int | None = None, step_idx: int = 0,
                      compress_grads: bool = True):
    """One rank's sharded step core: ``(loss, grads, act)``.

    ``part`` split over ``axis``, ``batch`` the global batch (each rank
    takes its even share). ``params`` are this rank's: replicated, or, with
    ``model_axis``, the row-sharded leaves as this rank's blocks. ``grads``
    (a dict shaped like ``params``) come back already mean-reduced through
    the compressed (or exact) all-reduce; ``loss`` is the mean over the
    ``data`` ranks of the local objectives (the global objective), the
    same bits on every rank; ``act`` is the step's activation report.
    ``view`` reuses a ``shard_view`` (else one is built)."""
    spec, sharded = _prepare(step, part, mesh, axis, model_axis, params,
                             batch, root_seed, need_key=True)
    if view is None:
        view = shard_view(spec, part, mesh, axis=axis, model_axis=model_axis)
    ctx = act_context(schedule, root_seed, step=step_idx)
    with full_fp32(), ctx:
        total, _ = spec.shard_loss(params, view,
                                   _local_batch(batch, mesh, axis))
        grads = torch.autograd.grad(total, param_leaves(params))
    axes = (axis, model_axis) if model_axis is not None else axis
    placement = {n: model_axis for n in sharded} or None
    grads = all_reduce_grads(
        restructure(params, list(grads)), mesh, axes,
        seed=psum_seed(root_seed, spec.scope, step_idx),
        compressed=compress_grads, placement=placement)
    loss = psum(total.detach(), mesh, axis) / mesh.shape[axis]
    return loss, grads, ctx.report()


@torch.no_grad()
def dp_forward_reps(step: ModelStep | ShardSpec, params: dict,
                    part: EdgePartition, *, mesh: TorchMesh, view=None,
                    axis: str = "data", model_axis: str | None = None,
                    schedule=None, root_seed: int | None = None,
                    step_idx: int = 0) -> torch.Tensor:
    """The readout of every node from the sharded forward, on every rank:
    the ``(n_nodes, D)`` table (node-space padding dropped)."""
    spec, _ = _prepare(step, part, mesh, axis, model_axis, params, None,
                       root_seed, need_key=False)
    if spec.shard_reps is None:
        raise NotImplementedError(f"{spec.scope}: ShardSpec has no "
                                  f"shard_reps")
    if view is None:
        view = shard_view(spec, part, mesh, axis=axis, model_axis=model_axis)
    with full_fp32(), act_context(schedule, root_seed, step=step_idx):
        reps = spec.shard_reps(params, view)
    return all_gather(reps, mesh, axis, dim=0)[:part.n_nodes]


def replica_check(params: dict, mesh: TorchMesh, *,
                  row_sharded: tuple = (), axis: str = "data") -> list:
    """The leaves whose bits differ between ranks that must hold the same
    copy: replicated leaves across every rank, row-sharded blocks across
    the ``axis`` ranks (``[]`` when all agree). One gather of one 64-bit
    digest a leaf (``sharding.comm.digest``) per group."""
    names = _leaf_names(params)
    leaves = param_leaves(params)
    bad = []
    for grp, axes in (("replicated", mesh.spec.names), ("rows", (axis,))):
        idx = [i for i, n in enumerate(names)
               if (n in row_sharded) == (grp == "rows")]
        if not idx or mesh.size(axes) == 1:
            continue
        d = torch.stack([digest(leaves[i]) for i in idx])
        every = gather_rows_of_ranks(d, mesh, axes)
        differ = (every != every[:1]).any(dim=0).tolist()
        bad += [f"{names[i]}[{i}]" for i, b in zip(idx, differ) if b]
    return bad


class StepFailed(RuntimeError):
    """A step failed on some rank; every rank raises this same error."""


def agree_on_failure(err: BaseException | None, mesh: TorchMesh,
                     step_idx: int) -> None:
    """The ranks' agreement on one step: every rank calls this at the same
    point with its own failure (or None); a max all-reduce of the flags
    over the whole mesh, then, if any rank failed, every rank raises
    ``StepFailed`` naming the highest such rank (this rank's own error as
    its cause)."""
    flag = torch.tensor([0 if err is None else mesh.rank + 1],
                        dtype=torch.int64, device=mesh.device)
    worst = int(pmax(flag, mesh, mesh.spec.names).item())
    if worst:
        raise StepFailed(f"step {step_idx}: rank {worst - 1} failed; every "
                         f"rank rolls back") from err


def make_dp_step(step: ModelStep | ShardSpec, part: EdgePartition,
                 mesh: TorchMesh, opt, *, schedule=None, root_seed: int,
                 axis: str = "data", model_axis: str | None = None,
                 mesh_spec: "MeshSpec | str | None" = None,
                 compress_grads: bool = True, view=None):
    """``train_step(state, batch, i, fail=None) -> (state, metrics)`` for
    the ``Trainer`` on this rank, for any KG arch with a ``ShardSpec``.

    The sharded loss and backward, the gradient all-reduce, the ranks'
    agreement on failures (``agree_on_failure``: an exception this rank's
    step raised, or ``fail``, an injected failure, which the step runs
    through like any other so that every rank's collectives match), then
    Adam on
    this rank's state (replicated parameters update identically on every
    rank; a row-sharded table updates block by block, and its padded rows
    stay zero). ``mesh_spec`` (a ``MeshSpec`` or its string) is validated
    against ``mesh`` and picks the layout: a ``model`` axis selects the 2D
    path. After each step every replicated leaf (and each block across the
    ``data`` ranks) is held bitwise equal on the ranks that keep it
    (``replica_check``: one digest a leaf), and the step raises when not.
    ``metrics`` holds the loss and the activation report.

    The ``allreduce/bytes_per_step`` gauge and the ``allreduce/bytes``
    counter (``obs``, labelled ``count="analytic"``) carry the reference's
    analytic payload a step, counted on this rank's leaves (on a 2D mesh
    its entity block, the part of the table this rank's all-reduce moves;
    the reference counts the whole padded table there). The
    ``allreduce/sent_bytes_per_step`` gauge and ``allreduce/sent_bytes``
    counter carry what this rank hands its all-reduce calls
    (``compress.allreduce_sent_bytes``: int8 codes travel as int32)."""
    from repro_torch.obs import get_registry

    spec = _as_dp_spec(step)
    if mesh_spec is not None:
        ms = MeshSpec.parse(mesh_spec)
        ms.check_axes(("data", "model"), required=("data",))
        ms.check_mesh(mesh)
        axis = "data"
        model_axis = "model" if "model" in ms.names else None
    sharded = spec.row_sharded() if model_axis is not None else ()
    if view is None:
        view = shard_view(spec, part, mesh, axis=axis, model_axis=model_axis)
    meters: list = []

    def init_meters(params):
        axes = (axis, model_axis) if model_axis is not None else axis
        placement = {n: model_axis for n in sharded} or None
        reg = get_registry()
        for name, report, extra in (
                ("allreduce/bytes", allreduce_byte_report,
                 {"count": "analytic"}),
                ("allreduce/sent_bytes", allreduce_sent_bytes, {})):
            for row in report(params, axes, placement=placement,
                              compressed=compress_grads):
                labels = dict(arch=spec.scope, axes=row["axes"],
                              wire=row["wire"], **extra)
                reg.gauge(f"{name}_per_step", **labels) \
                    .set(float(row["bytes"]))
                meters.append((reg.counter(name, **labels), row["bytes"]))

    def train_step(state, batch, step_idx, fail=None):
        params, opt_state = state
        err = fail
        try:
            check_no_sampled_dp(batch)
            if not meters:
                init_meters(params)
            for ctr, nbytes in meters:
                ctr.inc(nbytes)
            loss, grads, act = dp_loss_and_grads(
                spec, params, part, batch, mesh=mesh, view=view, axis=axis,
                model_axis=model_axis, schedule=schedule,
                root_seed=root_seed, step_idx=step_idx,
                compress_grads=compress_grads)
        except Exception as e:  # noqa: BLE001 (recoverable only before
            # the step's first collective: see the module's note)
            err = e
        agree_on_failure(err, mesh, step_idx)
        params, opt_state = opt.update(param_leaves(grads), opt_state,
                                       params)
        bad = replica_check(params, mesh, row_sharded=sharded, axis=axis)
        if bad:
            raise RuntimeError(f"step {step_idx}: the ranks' copies of {bad} "
                               f"differ after the update")
        return (params, opt_state), {"loss": loss, "act": act}

    return train_step
