"""The port's optimizers (``repro_torch.training.optimizer``) against the
reference's (``repro.training.optimizer``) on the same numpy parameters
and gradients: three updates each, within 1e-6 relative; the schedule at
every step from 0 to total + 5; the constant-lr Adam the training steps
use unchanged bit for bit."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jopt
from repro_torch.models.layers import param_leaves
from repro_torch.training import optimizer as topt

REL = 1e-6
SHAPES = {"emb": (7, 3), "w": [(3, 5), (5,)]}
STEPS = 3


def _draw(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: [(rng.standard_normal(s) * scale).astype(np.float32)
                for s in v] if isinstance(v, list)
            else (rng.standard_normal(v) * scale).astype(np.float32)
            for k, v in SHAPES.items()}


def _torch(tree: dict) -> dict:
    return {k: [torch.tensor(a) for a in v] if isinstance(v, list)
            else torch.tensor(v) for k, v in tree.items()}


def _close(got: list, want: list) -> None:
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= REL * max(np.abs(w).max(), 1e-30), err


def _run_both(jmake, tmake):
    """Three updates of each optimizer from the same parameters on the same
    gradients (the third step's gradients large enough to clip)."""
    params = _draw(0)
    grads = [_draw(10 + i, scale=10.0 ** i) for i in range(STEPS)]
    jo, to = jmake(), tmake()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init(jp)
    tp = _torch(params)
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = to.update(param_leaves(_torch(g)), ts, tp)
    _close(param_leaves(tp), jax.tree_util.tree_leaves(jp))
    return ts, js


@pytest.mark.parametrize("warmup,total,floor", [(3, 10, 0.0), (0, 4, 1e-4),
                                                (5, 5, 0.0)])
def test_cosine_warmup_every_step(warmup, total, floor):
    js = jopt.cosine_warmup(3e-3, warmup, total, floor)
    ts = topt.cosine_warmup(3e-3, warmup, total, floor)
    for step in range(total + 6):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = float(ts(step))
        assert abs(got - want) <= REL * 3e-3, (step, got, want)
    assert float(topt.constant_lr(0.25)(7)) == 0.25


def test_global_norm():
    tree = _draw(3)
    want = float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = float(topt.global_norm(param_leaves(_torch(tree))))
    assert abs(got - want) <= REL * want


@pytest.mark.parametrize("case", [
    "clipped_cosine", "coupled_wd", "decoupled_wd", "adamw_clipped"])
def test_adam_variants_match_reference(case):
    kw = {"clipped_cosine": dict(clip_norm=1.0),
          "coupled_wd": dict(weight_decay=0.05),
          "decoupled_wd": dict(weight_decay=0.05, decoupled_wd=True),
          "adamw_clipped": dict(clip_norm=1.0)}[case]
    if case == "clipped_cosine":
        def lr(mod):
            return mod.cosine_warmup(3e-3, 2, 5)
    else:
        def lr(mod):
            return 1e-2
    if case == "adamw_clipped":
        ts, js = _run_both(lambda: jopt.adamw(1e-3, **kw),
                           lambda: topt.adamw(1e-3, **kw))
    else:
        ts, js = _run_both(lambda: jopt.adam(lr(jopt), **kw),
                           lambda: topt.adam(lr(topt), **kw))
    assert ts["step"] == int(js["step"]) == STEPS
    _close(ts["mu"], jax.tree_util.tree_leaves(js["mu"]))
    _close(ts["nu"], jax.tree_util.tree_leaves(js["nu"]))


@pytest.mark.parametrize("nesterov,clip", [(False, None), (True, 1.0)])
def test_sgd_matches_reference(nesterov, clip):
    kw = dict(momentum=0.9, nesterov=nesterov, clip_norm=clip)
    ts, js = _run_both(lambda: jopt.sgd(0.05, **kw),
                       lambda: topt.sgd(0.05, **kw))
    _close(ts["mom"], jax.tree_util.tree_leaves(js["mom"]))


def _seed_adam_update(lr, grads, state, params, b1=0.9, b2=0.999,
                      eps=1e-8):
    """The port's constant-lr Adam before the extras, step for step."""
    step = state["step"] + 1
    f32 = dict(dtype=torch.float32)
    t = torch.tensor(float(step), **f32)
    bc1 = 1 - torch.tensor(b1, **f32) ** t
    bc2 = 1 - torch.tensor(b2, **f32) ** t
    lr_t = torch.tensor(lr, **f32)
    with torch.no_grad():
        for p, g, m, v in zip(param_leaves(params), grads, state["mu"],
                              state["nu"]):
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.copy_((p.to(torch.float32) - lr_t * u).to(p.dtype))
    return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}


def test_constant_adam_unchanged_bit_for_bit():
    opt = topt.adam(3e-3)
    a, b = _torch(_draw(0)), _torch(_draw(0))
    sa, sb = opt.init(a), opt.init(b)
    for i in range(STEPS):
        g = param_leaves(_torch(_draw(20 + i)))
        a, sa = opt.update(g, sa, a)
        b, sb = _seed_adam_update(3e-3, g, sb, b)
    for x, y in zip(param_leaves(a) + sa["mu"] + sa["nu"],
                    param_leaves(b) + sb["mu"] + sb["nu"]):
        assert torch.equal(x, y)
