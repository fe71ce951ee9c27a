"""Port parity: KGAT training against the JAX package.

The reduced KGAT config trains from the JAX parameters carried across, on
the same BPR batches. The JAX side runs its counter-hash kernel path
(``kernel="pallas"``, interpret mode) under every INT schedule and the port
takes the JAX side's rounding seeds, ``key_to_seed(scope_key(root, scope,
step))``, through ``ActContext(seed_fn=...)``.

Tolerances, relative to the reference's max |value|:
- gradients of one step, FP32 and INT2: 1e-5 (fp32 reassociation; at this
  size no quantization input sits within a rounding of an SR threshold, so
  both sides keep the same codes);
- the FP32 loss over 10 Adam steps: 1e-5;
- the INT2 loss over 10 steps: 1e-4. Adam's first steps move every
  parameter by about lr whatever the gradient's size, so reassociation
  differences grow with the steps, and from the second step on a
  quantization input can cross an SR threshold on one side only.
"""

from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.smoke import reduced as jreduced
from repro.core import policy as jpol
from repro.core.context import act_context as jact_context
from repro.core.rng import scope_key
from repro.data.synthetic import bpr_batches as jbpr
from repro.data.synthetic import gen_kg_dataset as jgen
from repro.kernels.hashrng import key_to_seed
from repro.models import kgnn as jk
from repro.models.registry import build_step as jbuild
from repro.training import optimizer as jopt
from repro.training.step import make_train_step as jmake
from repro_torch.configs import get as tget
from repro_torch.configs.smoke import reduced as treduced
from repro_torch.core import policy as tpol
from repro_torch.core.context import act_context
from repro_torch.data.synthetic import bpr_batches as tbpr
from repro_torch.launch import train as tlaunch
from repro_torch.launch.serve import reduced_dataset
from repro_torch.models import kgnn as tk
from repro_torch.models.layers import param_leaves
from repro_torch.models.registry import build_step as tbuild
from repro_torch.training import optimizer as topt
from repro_torch.training.step import make_train_step as tmake
from repro_torch.training.step import trainable

BATCH, STEPS, ROOT = 64, 10, jax.random.PRNGKey(1)


@functools.lru_cache(maxsize=None)
def _seed(scope: str, step: int) -> int:
    return int(key_to_seed(scope_key(ROOT, scope, step)))


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def world():
    jcfg = jreduced(jget("kgat")).model_cfg
    tcfg = treduced(tget("kgat")).model_cfg
    ds = reduced_dataset(tcfg)
    jds = jgen(n_users=jcfg.n_users, n_items=jcfg.n_entities * 3 // 5,
               n_attrs=jcfg.n_entities - jcfg.n_entities * 3 // 5,
               n_relations=(jcfg.n_relations - 2) // 2, n_triples=400,
               inter_per_user=8, seed=0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        functools.partial(jk.init_params, cfg=jcfg))(jax.random.PRNGKey(0)))
    return jcfg, tcfg, ds, jds, params


def test_bpr_batches_equal(world):
    _, _, ds, jds, _ = world
    for a, b in itertools.islice(zip(tbpr(ds, BATCH, seed=2),
                                     jbpr(jds, BATCH, seed=2)), 4):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_adam_update_equal():
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "w": [rng.normal(size=(4,)).astype(np.float32) for _ in range(2)]}
    gs = [jax.tree_util.tree_map(
        lambda x: (rng.normal(size=x.shape) * 10.0 ** rng.integers(-4, 2))
        .astype(np.float32), p) for _ in range(3)]
    jo, to = jopt.adam(3e-3), topt.adam(3e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = {"a": torch.tensor(p["a"]), "w": [torch.tensor(w) for w in p["w"]]}
    js, ts = jo.init(jp), to.init(tp)
    for g in gs:
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = to.update([torch.tensor(x) for x in
                            jax.tree_util.tree_leaves(g)], ts, tp)
        for a, b in zip(param_leaves(tp), _leaves_np(jp)):
            np.testing.assert_array_equal(a.numpy(), b)


def _jax_step(world, bits):
    jcfg, _, _, jds, _ = world
    sched = jpol.schedule_from_cli(None, bits, kernel="pallas")
    step = jbuild("kgat", schedule=sched, ds=jds, cfg=jcfg,
                  batch_size=BATCH, data_seed=2)
    return step, sched


def _torch_step(world, bits):
    _, tcfg, ds, _, _ = world
    return (tbuild("kgat", ds=ds, cfg=tcfg, batch_size=BATCH, device="cpu"),
            tpol.schedule_from_cli(None, bits))


@pytest.mark.parametrize("bits", [0, 2])
def test_one_step_gradients_match(world, bits):
    params = world[4]
    jstep, jsched = _jax_step(world, bits)
    tstep, tsched = _torch_step(world, bits)
    batch = next(jstep.batches())
    ref = jax.jit(jax.grad(lambda p: jstep.loss(
        p, batch, ctx=jact_context(jsched, ROOT, step=0))))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = trainable(tk.params_from_jax(params, device="cpu"))
    ctx = act_context(tsched, step=0, seed_fn=_seed)
    loss = tstep.loss(tp, {k: torch.from_numpy(np.array(v))
                           for k, v in batch.items()}, ctx=ctx)
    got = torch.autograd.grad(loss, param_leaves(tp))
    assert len(ctx.records) == 5 * world[1].n_layers
    for a, b in zip(got, _leaves_np(ref)):
        assert _rel(a.numpy(), b) <= 1e-5


@pytest.mark.parametrize("bits,tol", [(0, 1e-5), (2, 1e-4)])
def test_loss_trajectory_matches(world, bits, tol):
    params = world[4]
    jstep, jsched = _jax_step(world, bits)
    tstep, tsched = _torch_step(world, bits)
    jo, to = jopt.adam(jstep.lr), topt.adam(tstep.lr)
    jtrain = jmake(jstep, jo, schedule=jsched, root_key=ROOT)
    ttrain = tmake(tstep, to, schedule=tsched, seed_fn=_seed)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = trainable(tk.params_from_jax(params, device="cpu"))
    js, ts = (jp, jo.init(jp)), (tp, to.init(tp))
    jl, tl = [], []
    for i, (jb, tb) in enumerate(itertools.islice(
            zip(jstep.batches(), tstep.batches()), STEPS)):
        js, jm = jtrain(js, jb, i)
        ts, tm = ttrain(ts, tb, i)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=tol, atol=0)
    assert jl[-1] < jl[0]


def test_launcher_cpu_runs_and_refuses_without_card(monkeypatch, capsys):
    tlaunch.main(["--arch", "kgat", "--steps", "3", "--bits", "2",
                  "--batch", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done; loss" in out and "x vs fp32" in out
    tlaunch.main(["--arch", "codeqwen1.5-7b", "--steps", "1", "--bits",
                  "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(1.0x vs fp32)" in out and "done; loss" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "kgat", "--steps", "1"])
