"""Port parity: ACT policies, schedules, ops and the activation-bytes report
against the JAX package.

Every op runs on the same numpy inputs on both sides, the JAX side through
its counter-hash kernel path (``ACTPolicy(kernel="pallas")``, interpret
mode) and the port with the same rounding seed injected, so both save the
same residual codes. Forwards of elementwise ops must be bit-identical;
matmul and SPMM forwards, and every gradient, agree to fp32 reassociation
(max |diff| <= 1e-5 of max |ref|).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.smoke import reduced as jreduced
from repro.core import act as jact
from repro.core import memory as jmem
from repro.core import policy as jpol
from repro.data import csr as jcsr
from repro.data.synthetic import gen_kg_dataset as jgen
from repro.kernels.hashrng import key_to_seed
from repro.models import kgnn as jk
from repro_torch.configs import get as tget
from repro_torch.configs.smoke import reduced as treduced
from repro_torch.core import act as tact
from repro_torch.core import policy as tpol
from repro_torch.core.context import act_context
from repro_torch.data import csr as tcsr
from repro_torch.launch.serve import reduced_dataset
from repro_torch.models import kgnn as tk

TOL = 1e-5
KEY = jax.random.PRNGKey(3)
SEED = int(key_to_seed(KEY))

SPECS = ("int2", "8", "fp32", "first_layer_int8_rest_int2",
         "spmm:*/layer0/*=8,*/layer0/*=4,*=2", "matmul:kgat/*=1,nonlin:*=4")
SCOPES = [f"kgat/layer{l}/{s}" for l in range(3)
          for s in ("spmm", "w1", "w2", "act1", "act2")] + ["other", "w1#1"]
KINDS = ("spmm", "matmul", "nonlin", "relu")


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_strings_resolve_alike(spec):
    js = jpol.parse_schedule(spec, kernel="pallas")
    ts = tpol.parse_schedule(spec, kernel="pallas")
    for kind in KINDS:
        for scope in SCOPES:
            a, b = js.resolve(kind, scope), ts.resolve(kind, scope)
            assert (a.bits, a.stochastic, a.enabled, a.kernel) == \
                (b.bits, b.stochastic, b.enabled, b.kernel), (kind, scope)
    assert js.requires_key == ts.requires_key
    for bits in (0, 2, 8):
        a = jpol.schedule_from_cli(None, bits).default
        b = tpol.schedule_from_cli(None, bits).default
        assert a.bits == b.bits
    assert jpol.schedule_label(spec, 2) == tpol.schedule_label(spec, 2)
    with pytest.raises(ValueError):
        tpol.parse_schedule("spmm=int3")


def _pols(bits):
    return (jpol.ACTPolicy(bits=bits, kernel="pallas"),
            tpol.ACTPolicy(bits=bits))


def _grads(jfn, tfn, args, ct):
    """Forward and gradients of sum(op(*args) * ct) on both sides."""
    jout, jvjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    jg = jvjp(jnp.asarray(ct))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*targs)
    tout.backward(torch.from_numpy(ct))
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jg], [t.grad.numpy() for t in targs])


RNG = np.random.default_rng(11)
X = RNG.normal(size=(50, 21)).astype(np.float32)


@pytest.mark.parametrize("bits", [None, 2, 8])
def test_act_matmul_parity(bits):
    w = RNG.normal(size=(21, 13)).astype(np.float32)
    ct = RNG.normal(size=(50, 13)).astype(np.float32)
    jp, tp = _pols(bits)
    jo, to, jg, tg = _grads(
        lambda x, w_: jact.act_dense(x, w_, None, key=KEY, policy=jp),
        lambda x, w_: tact.act_dense(x, w_, None, seed=SEED, policy=tp),
        (X, w), ct)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _close(a, b)


@pytest.mark.parametrize("fn", sorted(tact.NONLIN))
def test_act_nonlin_parity(fn):
    ct = RNG.normal(size=X.shape).astype(np.float32)
    jp, tp = _pols(4)
    jo, to, jg, tg = _grads(
        lambda x: jact.act_nonlin(x, fn=fn, key=KEY, policy=jp),
        lambda x: tact.act_nonlin(x, fn=fn, seed=SEED, policy=tp),
        (X,), ct)
    if fn == "leaky_relu":
        np.testing.assert_array_equal(to, jo)
    else:
        # transcendental: XLA's and torch's tanh/exp may differ by an ulp
        _close(to, jo, 1e-6)
    _close(tg[0], jg[0])


def test_act_relu_parity():
    ct = RNG.normal(size=X.shape).astype(np.float32)
    jo, to, jg, tg = _grads(jact.act_relu, tact.act_relu, (X,), ct)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tg[0], jg[0])


@pytest.mark.parametrize("bits", [None, 2, 4])
def test_act_spmm_parity(bits):
    n, e, d = 40, 220, 19
    rng = np.random.default_rng(bits or 0)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ew = rng.uniform(0.1, 1.0, e).astype(np.float32)
    ct = rng.normal(size=(n, d)).astype(np.float32)
    kw = dict(n_dst=n, block_e=16, block_rows=8)
    lay_j = jcsr.build_spmm_layout(src, dst, **kw)
    lay_t = tcsr.build_spmm_layout(src, dst, device="cpu", **kw)
    jp, tp = _pols(bits)
    jo, to, jg, tg = _grads(
        lambda x_, w_: jact.act_spmm(x_, jnp.asarray(src), jnp.asarray(dst),
                                     w_, num_nodes=n, key=KEY, policy=jp,
                                     layout=lay_j),
        lambda x_, w_: tact.act_spmm(x_, w_, lay_t, seed=SEED, policy=tp),
        (x, ew), ct)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _close(a, b)


def test_stochastic_site_without_seed_raises():
    with pytest.raises(ValueError, match="needs a seed"):
        tact.act_matmul(torch.ones((2, 3)), torch.ones((3, 2)),
                        policy=tpol.ACTPolicy(bits=2))
    with act_context(tpol.INT2) as ctx, pytest.raises(ValueError):
        ctx.check_key("propagate")


@pytest.mark.parametrize("spec", ["int2", "spmm:*/layer0/*=8,*/layer0/*=4"])
def test_activation_bytes_report_equal_per_scope(spec):
    jcfg = jreduced(jget("kgat")).model_cfg
    tcfg = treduced(tget("kgat")).model_cfg
    ds = reduced_dataset(tcfg)
    jds = jgen(n_users=jcfg.n_users, n_items=jcfg.n_entities * 3 // 5,
               n_attrs=jcfg.n_entities - jcfg.n_entities * 3 // 5,
               n_relations=(jcfg.n_relations - 2) // 2, n_triples=400,
               inter_per_user=8, seed=0)
    g_j = jax.tree_util.tree_map(jnp.asarray, jds.graph)
    params = jk.init_params(jax.random.PRNGKey(0), jcfg)
    batch = {k: jnp.asarray(ds.train_pos[:8, i] if k != "neg"
                            else ds.train_pos[8:16, 1])
             for i, k in ((0, "user"), (1, "pos"), (1, "neg"))}
    ref = jmem.traced_activation_report(
        lambda p: jk.bpr_loss(p, g_j, batch, jcfg), params,
        schedule=jpol.parse_schedule(spec))
    tparams = tk.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    with act_context(tpol.parse_schedule(spec), root_seed=1) as ctx:
        tk.bpr_loss(tparams, ds.graph("cpu"),
                    {k: torch.from_numpy(np.array(v))
                     for k, v in batch.items()}, tcfg)
    got = ctx.report()
    assert len(ctx.records) == 5 * tcfg.n_layers
    assert got == pytest.approx(ref, rel=0, abs=0)
