"""Port parity: the multi-rank step against the JAX package's sharded step.

The JAX side is one subprocess with 4 forced host devices
(``tests/_subproc.py:forced_device_run``; each call jitted, about 20 s),
at the reference's DP test size (the 16-user synthetic CKG, d 8, 2 layers,
batch 32): ``dp_forward_reps`` and ``dp_loss_and_grads``
(``compress_grads=False``) on ``data=4`` and ``data=2,model=2``, for KGAT
and KGIN, under FP32 and under nearest-rounding INT8 (the reference's
threefry stochastic rounding does not cross frameworks). The port's side
is one spawn of 4 gloo ranks on the CPU (``launch.mesh.run_ranks``,
``tests/_torch_dp_ranks.py``) computing the same from the same parameters
(the JAX package's, from ``PRNGKey(0)``) and batch, with the plain
versions; the two run at once.

Tolerances, relative to the reference's max |value|:
- readout rows: 1e-6 (another framework's summation order); the port's
  sharded rows are also held bit for bit to its own single-device rollout;
- loss: 1e-6 absolute;
- gradients: 1e-5 of max |grad| (the reference's own fp32 all-reduce
  contract), against the JAX package's sharded gradients and against the
  port's single-device step.
The same three Adam steps run on both sides with the exact and with the
int8 all-reduce (``test_adam_runs_follow_jax`` states its limits).
In the same spawn, one rank fails a step of a short ``data=2,model=2`` run
through the launcher's ``train_rank`` (``test_multi_rank_retry``): every
rank rolls back to the same checkpoint and replays. Also: the 2D INT2 step
with the int8 all-reduce keeps every
replicated leaf bitwise equal across the ranks after each step (the step
checks it and raises), two runs of it give the same bits on every rank,
the compressed mean over 16 seeds is unbiased (its rms error a quarter of
one draw's, asserted below 0.4), and the row blocks round-trip to the full
table.
"""

from __future__ import annotations

import concurrent.futures as cf
import textwrap

import numpy as np
import pytest

from _subproc import forced_device_run
from _torch_dp_ranks import ADAM_MESH, ADAM_STEPS, ARCHS, MESHES, \
    RETRY_EVERY, RETRY_FAIL, RETRY_STEPS, SCHEDULES, rank_job, retry_job

_JAX_SIDE = """
    import jax, numpy as np
    from repro.core import act
    from repro.core.policy import ACTPolicy
    from repro.data.synthetic import gen_kg_dataset
    from repro.models.registry import build_step
    from repro.sharding.mesh_spec import MeshSpec
    from repro.training import data_parallel as dp

    act._dummy_key()   # a concrete placeholder key before any trace
    ds = gen_kg_dataset(n_users=16, n_items=32, n_attrs=16, seed=0)
    res = {{}}
    for arch in {archs!r}:
        step = build_step(arch, ds=ds, dim=8, n_layers=2, batch_size=32)
        g, spec = step.data["graph"], step.dp_spec
        params = step.init(jax.random.PRNGKey(0))
        batch = next(iter(step.batches()))
        for k in ("user", "pos", "neg"):
            res[f"{{arch}}/batch/{{k}}"] = np.asarray(batch[k])
        for ms in {meshes!r}:
            spec_m = MeshSpec.parse(ms)
            mesh = spec_m.build_sim()
            part = dp.partition_graph(g, mesh, axis="data")
            model_axis = "model" if "model" in spec_m.names else None
            p = (dp.pad_row_sharded(params, spec, part, 2) if model_axis
                 else params)
            for sname in {schedules!r}:
                sched = (None if sname == "fp32"
                         else ACTPolicy(bits=8, stochastic=False))
                reps = jax.jit(lambda p_: dp.dp_forward_reps(
                    spec, p_, part, mesh=mesh, model_axis=model_axis,
                    schedule=sched))(p)
                loss, grads = jax.jit(lambda p_, b_: dp.dp_loss_and_grads(
                    spec, p_, part, b_, mesh=mesh, model_axis=model_axis,
                    schedule=sched, root_key=jax.random.PRNGKey(7),
                    compress_grads=False))(p, batch)
                if model_axis:
                    grads = dp.unpad_row_sharded(grads, spec, g.n_nodes)
                key = f"{{arch}}/{{ms}}/{{sname}}"
                res[key + "/reps"] = np.asarray(reps)
                res[key + "/loss"] = np.asarray(loss)
                for i, x in enumerate(jax.tree_util.tree_leaves(grads)):
                    res[key + f"/grad/{{i}}"] = np.asarray(x)
    # three Adam steps of KGAT on data=4 with the exact and with the int8
    # all-reduce, and the int8 mean of the first step's gradients
    from repro.training.optimizer import adam
    step = build_step("kgat", ds=ds, dim=8, n_layers=2, batch_size=32)
    params = step.init(jax.random.PRNGKey(0))
    mesh = MeshSpec.parse({adam_mesh!r}).build_sim()
    part = dp.partition_graph(step.data["graph"], mesh, axis="data")
    opt = adam(step.lr)
    batches = [b for _, b in zip(range({adam_steps}), step.batches())]
    for i, b in enumerate(batches):
        res[f"adam/batch/{{i}}"] = np.asarray(b["user"])
    for name in ("fp32", "int8"):
        train = dp.make_dp_step(step.dp_spec, part, mesh, opt,
                                root_key=jax.random.PRNGKey(7),
                                mesh_spec={adam_mesh!r},
                                compress_grads=name == "int8")
        state, losses = (params, opt.init(params)), []
        for i, b in enumerate(batches):
            state, m = train(state, b, i)
            losses.append(float(m["loss"]))
        res[f"adam/{{name}}/losses"] = np.asarray(losses)
    _, grads = jax.jit(lambda p_, b_: dp.dp_loss_and_grads(
        step.dp_spec, p_, part, b_, mesh=mesh,
        root_key=jax.random.PRNGKey(7)))(params, batches[0])
    res["adam/int8/entity_grad"] = np.asarray(grads["entity"])
    np.savez({out!r}, **res)
"""


ENTITY = 2   # KGAT's param_leaves order: att_basis, att_coef, entity, ...


def _rel(got, ref) -> float:
    got = np.concatenate([np.ravel(x) for x in got])
    ref = np.concatenate([np.ravel(x) for x in ref])
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    import jax

    from repro.data.synthetic import gen_kg_dataset as jgen
    from repro.models.registry import build_step as jbuild
    from repro_torch.launch.mesh import run_ranks

    out = str(tmp_path_factory.mktemp("dp") / "jax_side.npz")
    src = _JAX_SIDE.format(archs=ARCHS, meshes=MESHES, schedules=SCHEDULES,
                           adam_mesh=ADAM_MESH, adam_steps=ADAM_STEPS,
                           out=out)
    ds = jgen(n_users=16, n_items=32, n_attrs=16, seed=0)
    params = {a: jax.tree_util.tree_map(np.asarray, jbuild(
        a, ds=ds, dim=8, n_layers=2, batch_size=32).init(
        jax.random.PRNGKey(0))) for a in ARCHS}
    with cf.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(forced_device_run, textwrap.dedent(src),
                              n_devices=4, timeout=300)
        # the retry run's checkpoint directory, made before the ranks start
        retry = retry_job(str(tmp_path_factory.mktemp("retry_ckpt")))
        ranks = run_ranks(rank_job, MESHES[0], device="cpu",
                          args=(params, retry), timeout_s=300)
        jax_run.result()
    with np.load(out) as z:
        jres = dict(z)
    return jres, ranks


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(sides, arch, mesh, sched):
    """Readout rows, loss and gradients of the sharded step against the JAX
    package's on the same mesh, and against the port's single device."""
    jres, ranks = sides
    port = ranks[0]
    for k, v in port[f"{arch}/batch"].items():
        assert np.array_equal(v, jres[f"{arch}/batch/{k}"]), k
    reps, loss, grads = port["cases"][f"{arch}/{mesh}/{sched}"]
    key = f"{arch}/{mesh}/{sched}"
    jgrads = [jres[f"{key}/grad/{i}"] for i in range(len(grads))]
    assert f"{key}/grad/{len(grads)}" not in jres
    assert _rel([reps], [jres[f"{key}/reps"]]) <= 1e-6
    assert abs(loss - float(jres[f"{key}/loss"])) <= 1e-6
    assert _rel(grads, jgrads) <= 1e-5
    reps1, loss1, grads1 = port["single"][arch]
    if sched == "fp32":
        assert np.array_equal(reps, reps1)
        assert abs(loss - loss1) <= 1e-6
        assert _rel(grads, grads1) <= 1e-5
    if "model" in mesh:
        assert port[f"{arch}/{mesh}/roundtrip"]


def test_compressed_step_replicas_and_bits(sides):
    """Two runs of the 2D INT2 step with the int8 all-reduce give the same
    losses and parameter bits, and every rank's copy agrees with the other
    ranks that hold it (replicated leaves: all four; the entity block: the
    two ``data`` ranks of its ``model`` index)."""
    _, ranks = sides
    for r in ranks:
        (l1, d1), (l2, d2) = r["compressed"]
        assert l1 == l2 and d1 == d2
        assert np.isfinite(l1).all()
    losses = {tuple(r["compressed"][0][0]) for r in ranks}
    assert len(losses) == 1
    for step in range(2):
        digests = [r["compressed"][0][1][step] for r in ranks]
        for i in range(len(digests[0])):
            vals = [d[i] for d in digests]
            if i == ENTITY:
                # ranks (0, m) and (1, m) hold block m: ranks m and 2 + m
                assert vals[0] == vals[2] and vals[1] == vals[3]
                assert vals[0] != vals[1]
            else:
                assert len(set(vals)) == 1, i


def test_compressed_allreduce_unbiased(sides):
    """The mean of 16 compressed all-reduces (16 seeds) sits about 1/4 as
    far from the exact mean as one draw (rms over every gradient element),
    and one draw within 5e-3 of it (the reference's bound)."""
    _, ranks = sides
    exact, draws = ranks[0]["unbiased"]
    one = float(np.sqrt(np.mean((draws[0] - exact) ** 2)))
    mean = float(np.sqrt(np.mean((draws.mean(0) - exact) ** 2)))
    assert float(np.abs(draws - exact).max()) < 5e-3
    assert 0 < mean < 0.4 * one, (one, mean)


def _zero_share(compressed, exact) -> float:
    """The share of the gradient's nonzero elements whose int8 mean is
    zero: every rank's code rounded to 0 (or the codes cancelled)."""
    nz = exact != 0
    return float((compressed[nz] == 0).mean())


def test_adam_runs_follow_jax(sides):
    """Three Adam steps of KGAT on ``data=4`` from the same parameters and
    batches: with the exact all-reduce the port's losses follow the JAX
    package's within 1e-6; with the int8 all-reduce within 5e-4, about
    four times the spread of the JAX package's own int8 losses over 8
    root keys at this size (their sd about 1.3e-4 about the exact run's:
    the two draw different noise). The share of zero int8 means in the
    entity gradient (what slows the int8 run: Adam moves an element whose
    mean is zero not at all) agrees within 0.05 (a few binomial sds over
    the table's 512 elements). A wrong scale would pass these loss limits,
    since Adam is invariant to it; ``test_compressed_allreduce_unbiased``
    and ``chip_smoke.py`` hold the int8 mean itself."""
    jres, ranks = sides
    port = dict(ranks[0]["adam"], cases=ranks[0]["cases"])
    for i, users in enumerate(port["batches"]):
        assert np.array_equal(users, jres[f"adam/batch/{i}"])
    want = {w: jres[f"adam/{w}/losses"] for w in ("fp32", "int8")}
    got = {w: np.asarray(port[w]) for w in ("fp32", "int8")}
    print(f"\n[adam] data=4 KGAT losses: JAX exact {want['fp32'].tolist()} "
          f"int8 {want['int8'].tolist()}; port exact {got['fp32'].tolist()} "
          f"int8 {got['int8'].tolist()}")
    assert np.abs(got["fp32"] - want["fp32"]).max() <= 1e-6
    assert np.abs(got["int8"] - want["int8"]).max() <= 5e-4
    exact = f"kgat/{ADAM_MESH}/fp32/grad/{ENTITY}"   # the exact mean
    zj = _zero_share(jres["adam/int8/entity_grad"], jres[exact])
    zt = _zero_share(port["entity_grad"],
                     port["cases"][f"kgat/{ADAM_MESH}/fp32"][2][ENTITY])
    print(f"[adam] zero share of the int8 entity gradient: JAX {zj:.4f}, "
          f"port {zt:.4f}")
    assert abs(zj - zt) <= 0.05


def test_multi_rank_retry(sides):
    """Rank 1's injected failure at step 3 reaches every rank at the step's
    agreement point: each logs the same failure (1 of the trainer's default
    3 in a row), rolls back to the step-2 checkpoint and replays, and the
    run's losses equal, bit for bit, a run that never failed on the
    batches the failed run kept (those of the rolled-back step and of the
    failed attempt skipped: the trainer does not rewind its data)."""
    _, ranks = sides
    rank, step = RETRY_FAIL
    back = step // RETRY_EVERY * RETRY_EVERY
    for r in ranks:
        run = r["retry"]
        failed = [m for m in run["log"] if "failed" in m]
        assert failed == [f"[trainer] step {step} failed (1/3): StepFailed("
                          f"'step {step}: rank {rank} failed; every rank "
                          f"rolls back')"], run["log"]
        assert [m for m in run["log"] if "rolled back" in m] == \
            [f"[trainer] rolled back to step {back}"]
        assert len(run["losses"]) == RETRY_STEPS
        assert run["losses"] == run["unfailed"]
        assert run["losses"] == ranks[0]["retry"]["losses"]


def test_train_kgnn_dp_always_checkpoints(monkeypatch, tmp_path):
    """Without ``ckpt_dir`` the multi-rank launcher makes a temporary
    checkpoint directory before the ranks start, hands it to every rank in
    the job, and removes it after; ``train_rank`` refuses a job without
    one. (``test_multi_rank_retry`` holds its trainer to ``max_failures``
    3: a retried failure logs "(1/3)".)"""
    import os

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.train import dp_job, train_kgnn_dp, train_rank

    seen = {}

    def fake_run_ranks(fn, mesh, *, device, args):
        seen["fn"], seen["dir"] = fn, args[0]["ckpt_dir"]
        seen["exists"] = os.path.isdir(seen["dir"])
        return []

    monkeypatch.setattr(lmesh, "run_ranks", fake_run_ranks)
    assert train_kgnn_dp(None, None, None, 2, mesh="data=2",
                         device="cpu") == []
    assert seen["fn"] is train_rank and seen["exists"]
    assert not os.path.exists(seen["dir"])
    train_kgnn_dp(None, None, None, 2, mesh="data=2", device="cpu",
                  ckpt_dir=str(tmp_path))
    assert seen["dir"] == str(tmp_path) and os.path.isdir(tmp_path)
    with pytest.raises(ValueError, match="checkpoint directory"):
        train_rank(None, dp_job(None, None, None, 2))


def test_failing_once_hands_one_failure_to_the_step():
    """``dp_job(fail_at=...)``'s rank wraps its step so that the injected
    failure reaches the step itself (which carries it to the ranks'
    agreement point) at that step once, and ``None`` at every other call,
    the replay of the failed step included."""
    from repro_torch.launch.train import _failing_once

    calls = []

    def step(state, batch, i, fail=None):
        calls.append((i, None if fail is None else str(fail)))
        return state, {}

    run = _failing_once(step, 3)
    for i in (0, 1, 2, 3, 3, 4):
        run(None, None, i)
    assert calls == [(0, None), (1, None), (2, None),
                     (3, "injected failure at step 3"), (3, None), (4, None)]

