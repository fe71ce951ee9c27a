"""Port parity: the KGCN, KGIN and R-GCN layers against the JAX package.

The reduced configs (40 users, 80 entities, d 16, 2 layers; R-GCN is KGAT's
reduced config with ``model="rgcn"``, 4 bases, readout sum) train from the
same parameters (the JAX package's parameter tree, filled from a numpy seed
and carried across by ``params_from_jax``), on the same BPR batches. Under
INT2 the JAX side runs its counter-hash kernel path (``kernel="pallas"``,
interpret mode) and the port takes its rounding seeds,
``key_to_seed(scope_key(root, scope, step))``, through
``ActContext(seed_fn=...)``; FP32 runs the JAX package's ``segment_sum``
path.

Tolerances, relative to the reference's max |value|:
- FP32: the loss of 3 Adam steps and the first step's gradients, 1e-5
  (fp32 reassociation; R-GCN sums its messages basis by basis, the
  reference edge by edge);
- INT2: the first step's loss and gradients, 1e-4 (both sides keep the
  same codes; the sums reassociate, through the dequantized residuals too).
The ACT report of a step equals the reference's ``traced_activation_report``
of the same loss, scope by scope, bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.smoke import reduced as jreduced
from repro.core import memory as jmem
from repro.core import policy as jpol
from repro.core.context import act_context as jact_context
from repro.core.rng import scope_key
from repro.data.synthetic import gen_kg_dataset as jgen
from repro.kernels.hashrng import key_to_seed
from repro.models import kgnn as jk
from repro.models.registry import build_step as jbuild
from repro.training import optimizer as jopt
from repro_torch.configs import get as tget
from repro_torch.configs.smoke import reduced as treduced
from repro_torch.core import policy as tpol
from repro_torch.core.context import act_context
from repro_torch.launch.serve import reduced_dataset
from repro_torch.models import kgnn as tk
from repro_torch.models.layers import param_leaves
from repro_torch.models.registry import arch_of, model_config
from repro_torch.models.registry import build_step as tbuild
from repro_torch.training import optimizer as topt
from repro_torch.training.step import trainable

BATCH, STEPS, ROOT = 64, 3, jax.random.PRNGKey(1)
MODELS = ("kgcn", "kgin", "rgcn")


@functools.lru_cache(maxsize=None)
def _seed(scope: str, step: int) -> int:
    return int(key_to_seed(scope_key(ROOT, scope, step)))


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _cfgs(model: str):
    """The reduced configs of ``model`` in both packages (R-GCN's derived
    from KGAT's by the port's rule, on each side)."""
    return (model_config(model, lambda a: jreduced(jget(a))),
            model_config(model, lambda a: treduced(tget(a))))


@pytest.fixture(scope="module")
def data():
    tcfg = treduced(tget("kgat")).model_cfg
    jds = jgen(n_users=tcfg.n_users, n_items=tcfg.n_entities * 3 // 5,
               n_attrs=tcfg.n_entities - tcfg.n_entities * 3 // 5,
               n_relations=(tcfg.n_relations - 2) // 2, n_triples=400,
               inter_per_user=8, seed=0)
    return reduced_dataset(tcfg), jds


@pytest.mark.parametrize("model", ("kgat",) + MODELS)
def test_configs_and_sites_match_jax(model):
    jc, tc = _cfgs(model)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tk.model_sites(tc) == jk.model_sites(jc)
    if model != "rgcn":
        assert dataclasses.asdict(tget(model).model_cfg) == \
            dataclasses.asdict(jget(model).model_cfg)


@pytest.mark.parametrize("bits", [0, 2])
@pytest.mark.parametrize("model", MODELS)
def test_steps_match_jax(data, model, bits):
    """FP32: 3 Adam steps' losses and the first step's gradients; INT2: the
    first step's loss and gradients; both: the ACT report of the step."""
    ds, jds = data
    jc, tc = _cfgs(model)
    jsched = jpol.schedule_from_cli(None, bits,
                                    kernel="pallas" if bits else "jnp")
    tsched = tpol.schedule_from_cli(None, bits)
    jstep = jbuild(arch_of(model), schedule=jsched, ds=jds, cfg=jc,
                   batch_size=BATCH, data_seed=2)
    tstep = tbuild(arch_of(model), ds=ds, cfg=tc, batch_size=BATCH,
                   device="cpu")
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.2).astype(np.float32),
        jax.eval_shape(functools.partial(jk.init_params, cfg=jc),
                       jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(jax.numpy.asarray, params)
    tp = trainable(tk.params_from_jax(params, device="cpu"))
    assert [k for k in sorted(tp)] == sorted(params)

    @jax.jit
    def value_and_grad(p, batch, i):
        return jax.value_and_grad(lambda q: jstep.loss(
            q, batch, ctx=jact_context(jsched, ROOT, step=i)))(p)

    jo, to = jopt.adam(jstep.lr), topt.adam(tstep.lr)
    jupdate = jax.jit(jo.update)
    js, ts = jo.init(jp), to.init(tp)
    batches = zip(jstep.batches(), tstep.batches())
    steps = STEPS if bits == 0 else 1
    for i in range(steps):
        jb, tb = next(batches)
        jl, jg = value_and_grad(jp, jb, i)
        ctx = act_context(tsched, step=i, seed_fn=_seed)
        tl = tstep.loss(tp, tb, ctx=ctx)
        tg = torch.autograd.grad(tl, param_leaves(tp))
        tol = 1e-5 if bits == 0 else 1e-4
        assert abs(float(tl.detach()) - float(jl)) <= tol * abs(float(jl)), i
        if i == 0:
            jleaves = jax.tree_util.tree_leaves(jg)
            assert len(tg) == len(jleaves)
            for a, b in zip(tg, jleaves):
                assert _rel(a.numpy(), b) <= tol
            ref = jmem.traced_activation_report(
                lambda p: jk.bpr_loss(p, jstep.data["graph"], jb, jc), jp,
                schedule=jsched)
            assert len(ctx.records) == len(tk.model_sites(tc)) * tc.n_layers
            assert ctx.report() == pytest.approx(ref, rel=0, abs=0)
        if i + 1 < steps:
            jp, js = jupdate(jg, js, jp)
            tp, ts = to.update(tg, ts, tp)
