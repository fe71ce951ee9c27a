"""The port's side of ``tests/test_torch_dp.py``: what each of the 4 gloo
ranks computes (a module of its own, so the spawned ranks import it
without the test module's JAX imports)."""

from __future__ import annotations

import numpy as np
import torch

SCHEDULES = ("fp32", "int8")        # int8: nearest rounding
MESHES = ("data=4", "data=2,model=2")
ARCHS = ("kgat", "kgin")
ADAM_MESH = MESHES[0]               # the Adam runs against the JAX package
ADAM_STEPS = 3
RETRY_MESH = MESHES[1]              # the retry case: data=2 (x model=2)
RETRY_STEPS, RETRY_EVERY = 4, 2     # checkpoints at step 2 and the end
RETRY_FAIL = (1, 3)                 # rank 1 fails step 3: roll back to 2


def dataset():
    from repro_torch.data.synthetic import gen_kg_dataset

    return gen_kg_dataset(n_users=16, n_items=32, n_attrs=16, seed=0)


def step_of(arch: str, ds, device="cpu"):
    """The reduced step the JAX side builds (``build_step(arch, ds=ds,
    dim=8, n_layers=2, batch_size=32)``), on ``device``."""
    from repro_torch.models.kgnn import KGNNConfig
    from repro_torch.models.registry import build_step

    cfg = KGNNConfig(model=arch, n_users=ds.n_users,
                     n_entities=ds.n_entities, n_relations=ds.n_relations,
                     dim=8, n_layers=2,
                     readout="concat" if arch == "kgat" else "sum")
    return build_step(arch, ds=ds, cfg=cfg, batch_size=32, device=device)


def schedule(name: str):
    from repro_torch.core.policy import ACTPolicy

    return None if name == "fp32" else ACTPolicy(bits=8, stochastic=False)


def _np(tree):
    from repro_torch.models.layers import param_leaves

    return [t.detach().numpy().copy() for t in param_leaves(tree)]


def retry_job(ckpt_dir: str) -> dict:
    """The retry case's ``dp_job``: KGAT INT2 with the int8 all-reduce,
    ``RETRY_STEPS`` steps, one failure on rank ``RETRY_FAIL[0]`` at step
    ``RETRY_FAIL[1]``."""
    from repro_torch.core.policy import parse_schedule
    from repro_torch.launch.train import dp_job

    ds = dataset()
    return dp_job(step_of("kgat", ds).cfg, ds, parse_schedule("int2"),
                  RETRY_STEPS, batch=32, allreduce="int8",
                  ckpt_dir=ckpt_dir, ckpt_every=RETRY_EVERY,
                  schedule_spec="int2", log_every=1, verbose=False,
                  fail_at=RETRY_FAIL)


def unfailed_losses(rt, job: dict, skip: range) -> list:
    """The losses of ``job``'s run on ``rt``'s mesh with no failure, set up
    as ``train_rank`` sets it up, on the batches a run that failed once
    and rolled back took: the stream without its batches ``skip`` (those
    of the steps rolled back and of the failed attempt; the trainer does
    not rewind its data)."""
    from repro_torch.launch.train import ROOT_SEED, shard_setup
    from repro_torch.models.registry import arch_of, build_step
    from repro_torch.training import data_parallel as dp
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import trainable

    cfg, mesh = job["cfg"], rt.mesh
    step = build_step(arch_of(cfg.model), ds=job["ds"], cfg=cfg,
                      batch_size=job["batch"], device=rt.device,
                      device_graph=False)
    part, view, model_axis = shard_setup(step, mesh)
    opt = adam(step.lr)
    params = step.init(0)
    state = (params, opt.init(params))
    if model_axis:
        state = dp.block_rows(dp.pad_row_sharded(
            state, step.dp_spec, part, mesh.shape[model_axis]),
            step.dp_spec, part, mesh)
    state = (trainable(state[0]), state[1])
    train = dp.make_dp_step(step, part, mesh, opt, schedule=job["schedule"],
                            root_seed=ROOT_SEED, mesh_spec=mesh.spec,
                            compress_grads=job["allreduce"] == "int8",
                            view=view)
    batches = [b for i, (_, b) in enumerate(zip(
        range(job["steps"] + len(skip)), step.batches())) if i not in skip]
    losses = []
    for i, b in enumerate(batches[:job["steps"]]):
        state, m = train(state, b, i)
        losses.append(float(m["loss"]))
    return losses


def rank_job(rt, jax_params: dict, retry: dict) -> dict:
    """Every case of the parity test on this rank; rank 0 returns the
    arrays, every rank the digests of its parameters after each step of
    the compressed runs and its retry case (``retry``: a ``retry_job``)."""
    import dataclasses

    from repro_torch.launch.train import train_rank
    from repro_torch.core.context import act_context
    from repro_torch.core.policy import parse_schedule
    from repro_torch.models import kgnn
    from repro_torch.models.kgnn import params_from_jax
    from repro_torch.models.layers import param_leaves
    from repro_torch.sharding.comm import digest
    from repro_torch.sharding.mesh_spec import MeshSpec
    from repro_torch.training import data_parallel as dp
    from repro_torch.training.optimizer import adam
    from repro_torch.training.step import trainable

    ds = dataset()
    meshes = {MESHES[0]: rt.mesh,
              MESHES[1]: MeshSpec.parse(MESHES[1]).build_mesh(
                  device=rt.device)}
    out = {"cases": {}, "single": {}}
    for arch in ARCHS:
        step = step_of(arch, ds)
        spec = step.dp_spec
        params = trainable(params_from_jax(jax_params[arch], device="cpu"))
        batch = next(iter(step.batches()))
        out[f"{arch}/batch"] = {k: v.numpy() for k, v in batch.items()}
        # the port's own single-device rollout, loss and gradients
        reps1 = kgnn.propagate(params, step.data["graph"], step.cfg)
        with act_context(None, 7) as ctx:
            loss1 = step.loss(params, batch, ctx=ctx)
        g1 = torch.autograd.grad(loss1, param_leaves(params))
        out["single"][arch] = (reps1.numpy(), float(loss1),
                               [g.numpy() for g in g1])
        for ms, mesh in meshes.items():
            part = dp.partition_graph(ds, mesh)
            model_axis = "model" if "model" in mesh.spec.names else None
            p = params
            if model_axis:
                p = dp.block_rows(dp.pad_row_sharded(
                    params, spec, part, mesh.shape["model"]), spec, part,
                    mesh)
                back = dp.unpad_row_sharded(dp.gather_row_blocks(
                    p, spec, part, mesh), spec, ds.n_nodes)
                out[f"{arch}/{ms}/roundtrip"] = all(
                    torch.equal(a, b) for a, b in
                    zip(param_leaves(back), param_leaves(params)))
            view = dp.shard_view(spec, part, mesh, model_axis=model_axis)
            for sname in SCHEDULES:
                reps = dp.dp_forward_reps(step, p, part, mesh=mesh,
                                          view=view, model_axis=model_axis,
                                          schedule=schedule(sname))
                loss, grads, _ = dp.dp_loss_and_grads(
                    step, p, part, batch, mesh=mesh, view=view,
                    model_axis=model_axis, schedule=schedule(sname),
                    root_seed=7, compress_grads=False)
                if model_axis:
                    grads = dp.unpad_row_sharded(dp.gather_row_blocks(
                        grads, spec, part, mesh), spec, ds.n_nodes)
                out["cases"][f"{arch}/{ms}/{sname}"] = (
                    reps.numpy(), float(loss), _np(grads))

    # three Adam steps of KGAT on data=4, exact and int8 all-reduce, and
    # the first step's entity gradient through the int8 mean
    step = step_of("kgat", ds)
    mesh = meshes[ADAM_MESH]
    part = dp.partition_graph(ds, mesh)
    view = dp.shard_view(step.dp_spec, part, mesh)
    params = trainable(params_from_jax(jax_params["kgat"], device="cpu"))
    batches = [b for _, b in zip(range(ADAM_STEPS), step.batches())]
    opt = adam(step.lr)
    adam_out = {"batches": [b["user"].numpy() for b in batches]}
    for name in ("fp32", "int8"):
        train = dp.make_dp_step(step, part, mesh, opt, root_seed=7,
                                mesh_spec=ADAM_MESH, view=view,
                                compress_grads=name == "int8")
        state = (trainable(params_from_jax(jax_params["kgat"],
                                           device="cpu")), None)
        state = (state[0], opt.init(state[0]))
        losses = []
        for i, b in enumerate(batches):
            state, m = train(state, b, i)
            losses.append(float(m["loss"]))
        adam_out[name] = losses
    _, g, _ = dp.dp_loss_and_grads(step, params, part, batches[0],
                                   mesh=mesh, view=view, root_seed=7)
    adam_out["entity_grad"] = g["entity"].numpy()
    out["adam"] = adam_out

    # the compressed 2D step: replicas equal after every step (the step
    # raises if not), two runs the same bits, every rank's digests
    ds_step = step_of("kgat", ds)
    spec, mesh = ds_step.dp_spec, meshes[MESHES[1]]
    part = dp.partition_graph(ds, mesh)
    view = dp.shard_view(spec, part, mesh, model_axis="model")
    params = trainable(params_from_jax(jax_params["kgat"], device="cpu"))
    opt = adam(ds_step.lr)

    def run():
        state = dp.block_rows(dp.pad_row_sharded(
            (params, opt.init(params)), spec, part, 2), spec, part, mesh)
        state = (trainable(state[0]), state[1])
        train = dp.make_dp_step(ds_step, part, mesh, opt,
                                schedule=parse_schedule("int2"),
                                root_seed=1, mesh_spec=MESHES[1],
                                view=view)
        losses, digests = [], []
        for i, b in zip(range(2), ds_step.batches()):
            state, m = train(state, b, i)
            losses.append(float(m["loss"]))
            digests.append([int(digest(t)) for t in param_leaves(state[0])])
        return losses, digests

    out["compressed"] = (run(), run())

    # unbiasedness of the compressed all-reduce: 16 psum seeds against the
    # exact mean (FP32 sites, so only the all-reduce's noise varies)
    p = dp.block_rows(dp.pad_row_sharded(params, spec, part, 2), spec,
                      part, mesh)
    batch = next(iter(ds_step.batches()))

    def grads(seed, compress):
        _, g, _ = dp.dp_loss_and_grads(
            ds_step, p, part, batch, mesh=mesh, view=view,
            model_axis="model", root_seed=seed, compress_grads=compress)
        return np.concatenate([x.numpy().ravel()
                               for x in param_leaves(g)])

    exact = grads(0, False)
    draws = np.stack([grads(seed, True) for seed in range(16)])
    out["unbiased"] = (exact, draws)

    # one rank fails a step of a data=2 x model=2 run through the
    # launcher's train_rank: every rank rolls back and replays, and the run
    # ends with the losses of a run that never failed
    rt2 = dataclasses.replace(rt, mesh=meshes[RETRY_MESH])
    run = train_rank(rt2, retry)
    out["retry"] = {"losses": [h["loss"] for h in run["steps"]],
                    "log": run["log"],
                    "unfailed": unfailed_losses(rt2, retry, range(
                        RETRY_FAIL[1] // RETRY_EVERY * RETRY_EVERY,
                        RETRY_FAIL[1] + 1))}
    return out if rt.is_root else {"compressed": out["compressed"],
                                   "retry": out["retry"]}


def card_job(rt, arch: str) -> dict:
    """A reduced ``data=2`` step on the card, kernels on: the FP32 forward
    rows and the exact all-reduce step's loss and gradients (seed-0
    parameters, first batch), then two INT2 steps with the int8
    all-reduce (replicas checked after each), with the kernel launches of
    the whole job."""
    from repro_torch.core.policy import parse_schedule
    from repro_torch.kernels.backend import LAUNCH_COUNTS, reset_counts
    from repro_torch.models.layers import param_leaves
    from repro_torch.training import data_parallel as dp
    from repro_torch.training.optimizer import adam

    ds = dataset()
    step = step_of(arch, ds, device=rt.device)
    mesh = rt.mesh
    part = dp.partition_graph(ds, mesh)
    view = dp.shard_view(step.dp_spec, part, mesh)
    params = step.init(0)
    batch = next(iter(step.batches()))
    reset_counts()
    reps = dp.dp_forward_reps(step, params, part, mesh=mesh, view=view)
    loss, grads, _ = dp.dp_loss_and_grads(step, params, part, batch,
                                          mesh=mesh, view=view, root_seed=7,
                                          compress_grads=False)
    opt = adam(step.lr)
    state = (params, opt.init(params))
    train = dp.make_dp_step(step, part, mesh, opt,
                            schedule=parse_schedule("int2"), root_seed=1,
                            view=view)
    losses = []
    for i, b in zip(range(2), step.batches()):
        state, m = train(state, b, i)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return {"reps": reps.cpu().numpy(), "loss": float(loss),
            "grads": [g.cpu().numpy() for g in param_leaves(grads)],
            "losses": losses, "counts": dict(LAUNCH_COUNTS)}
