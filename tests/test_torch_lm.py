"""Port parity: the LM families (dense GQA and MoE transformers) against the
JAX package.

The same numpy inputs go through the reference's ``repro.models``
(``transformer``, ``attention``, ``moe``) and the port's
``repro_torch.models`` on the CPU, reduced configs on both sides, with the
parameters drawn by the port's ``init_params`` and carried across as numpy
(``params_from_jax`` takes the reference's stacked tree). Three archs:
``stablelm-12b`` (GQA, reduced to 4 heads over 1 KV head),
``codeqwen1.5-7b`` (MHA) and ``moonshot-v1-16b-a3b`` (MoE, reduced to 8
experts, top-2); the other two reduce to the same shapes. FP32 runs the
reference's jnp path; INT2 runs its counter-hash kernel path
(``kernel="pallas"``, interpret mode) and the port takes its rounding
seeds through ``ActContext(seed_fn=...)``: the site's
``key_to_seed(scope_key(root, scope, step))``, and for the transformer's
per-layer seeds (the port's ``<lm>/layer<i>``) the reference's
``fold_in(scope_key(root, "lm", step), i)``.

Tolerances: ``rope``, the chunked and the decode attention within 1e-5
relative (of the reference's max |value|); ``lm_batches`` and the
layer-0 residual's codes, scale and zero bit-identical; ``act_rmsnorm``
and ``act_remat`` values and gradients within 1e-5 of each max |value|;
``moe_ffn`` the same expert choices (with the smallest gap between the
k-th and the (k+1)-th probability above 1e-5, so that a flip would fail as
a tie, not as a port fault), outputs and aux loss within 1e-5 relative;
the registry step's ``lm_loss`` within 1e-5 relative and every gradient
within 1e-5 of its max |value|, then three Adam steps' losses within rtol
1e-5, FP32 and INT2, dense and MoE; prefill and eight teacher-forced
decode steps' logits within 1e-5 relative, fp32 and int8 caches; the
``_q8`` codes, scale and zero equal.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.smoke import reduced as jreduced
from repro.core import act as jact
from repro.core import policy as jpol
from repro.core.context import act_context as jact_context
from repro.core.rng import scope_key
from repro.data.synthetic import lm_batches as jlm_batches
from repro.kernels import ops as kops
from repro.kernels.hashrng import key_to_seed
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.registry import build_step as jbuild
from repro.training import optimizer as jopt
from repro_torch.configs import get as tget
from repro_torch.configs.smoke import reduced as treduced
from repro_torch.core import act as tact
from repro_torch.core import policy as tpol
from repro_torch.core.context import act_context
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import LM_DP_UNSUPPORTED, NOT_PORTED, \
    build_step, path_kernels
from repro_torch.training import optimizer as topt
from repro_torch.training.step import make_train_step, trainable

ROOT = jax.random.PRNGKey(1)
TOL = 1e-5
TRAIN_ARCHS = ("stablelm-12b", "moonshot-v1-16b-a3b")
ALL_ARCHS = ("mistral-large-123b", "codeqwen1.5-7b", "stablelm-12b",
             "moonshot-v1-16b-a3b", "grok-1-314b")
B, S = 2, 40                  # seq 40 over chunks of 16: the padding path


@functools.lru_cache(maxsize=None)
def _seed(scope: str, step: int) -> int:
    m = re.fullmatch(r"(.*)/layer(\d+)", scope)
    if m:
        key = jax.random.fold_in(scope_key(ROOT, m.group(1), step),
                                 int(m.group(2)))
    else:
        key = scope_key(ROOT, scope, step)
    return int(key_to_seed(key))


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


def _close_leaves(got: dict, ref: dict, what: str):
    """Every tensor of ``got`` (the port's parameter names) within TOL of
    its max |value| against the reference's tree ``ref``."""
    flat = _as_reference_tree(got)
    for (path, g), (_, r) in zip(
            jax.tree_util.tree_leaves_with_path(flat),
            jax.tree_util.tree_leaves_with_path(ref), strict=True):
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(np.asarray(g) - r).max())
        assert err <= TOL * scale, (what, jax.tree_util.keystr(path), err,
                                    scale)


def _as_reference_tree(params: dict) -> dict:
    """The port's parameters as the reference's numpy tree (stacked
    ``blocks`` leaves, the MoE's nested): the inverse of
    ``params_from_jax``."""
    def a(t):
        return t.detach().numpy() if isinstance(t, torch.Tensor) else t

    out = {k: a(params[k]) for k in ("emb", "head", "ln_f")}
    blocks = {}
    for k, v in params.items():
        if not k.startswith("blocks/"):
            continue
        stacked = np.stack([a(t) for t in v])
        name = k[len("blocks/"):]
        if name.startswith("moe/"):
            blocks.setdefault("moe", {})[name[4:]] = stacked
        else:
            blocks[name] = stacked
    out["blocks"] = blocks
    return out


@functools.lru_cache(maxsize=None)
def _world(arch):
    """(jax config, port config, seed-0 parameters as the reference's numpy
    tree, a (B, S + 1) token batch)."""
    jcfg = jreduced(jget(arch)).model_cfg
    tcfg = treduced(tget(arch)).model_cfg
    params = _as_reference_tree(ttf.init_params(tcfg, seed=0, device="cpu"))
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(jax.eval_shape(
            lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg)))
    toks = next(lm_batches(vocab=tcfg.vocab, batch=B, seq=S, seed=5))
    return jcfg, tcfg, params, toks["tokens"]


def _sched(bits):
    return (jpol.schedule_from_cli(None, bits,
                                   kernel="pallas" if bits else "jnp"),
            tpol.schedule_from_cli(None, bits))


def test_configs_match_reference():
    for arch in ALL_ARCHS:
        j, t = jget(arch), tget(arch)
        assert (j.family, j.source) == (t.family, t.source)
        assert dataclasses.asdict(j.model_cfg) == \
            dataclasses.asdict(t.model_cfg)
        assert dataclasses.asdict(jreduced(j).model_cfg) == \
            dataclasses.asdict(treduced(t).model_cfg)
        assert [(s.name, s.kind, s.params) for s in j.shapes] == \
            [(s.name, s.kind, s.params) for s in t.shapes]
        for cfg_j, cfg_t in ((j.model_cfg, t.model_cfg),
                             (jreduced(j).model_cfg,
                              treduced(t).model_cfg)):
            assert cfg_j.n_params == cfg_t.n_params
            assert cfg_j.n_active_params == cfg_t.n_active_params
    assert NOT_PORTED == {}
    assert path_kernels("lm", False) == ("segment_sum",)
    assert path_kernels("moe_lm", True) == ("segment_sum", "quant_pack")


@pytest.mark.parametrize("kw", [
    dict(vocab=512, batch=3, seq=17, seed=0),
    dict(vocab=100352, batch=2, seq=9, seed=7, noise=0.3),
])
def test_lm_batches_bit_identical(kw):
    for a, b in itertools.islice(zip(lm_batches(**kw), jlm_batches(**kw)),
                                 2):
        assert a["tokens"].dtype == b["tokens"].dtype
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("heads", [(4, 1), (4, 4), (8, 2)])
def test_rope_and_attention(heads):
    """``rope``, ``chunked_causal_attention`` at seq 40 over chunks 16/16
    (the padding path) and ``decode_attention`` over a part-filled
    cache."""
    H, Kh = heads
    D = 16
    rng = np.random.default_rng(H * 10 + Kh)
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32)
               for h in (H, Kh, Kh))
    pos = np.arange(S)

    @jax.jit
    def reference(q, k, v):
        qr, kr = jattn.rope(q, pos, 1e6), jattn.rope(k, pos, 1e6)
        out = jattn.chunked_causal_attention(qr, kr, v, q_chunk=16,
                                             kv_chunk=16)
        dec = jattn.decode_attention(qr[:, -1:], kr, v, jnp.int32(29))
        return qr, out, dec

    jq, jo, jd = reference(q, k, v)
    tp = torch.from_numpy(pos)
    tq = tattn.rope(torch.from_numpy(q), tp, 1e6)
    tk = tattn.rope(torch.from_numpy(k), tp, 1e6)
    assert _rel(tq.numpy(), jq) <= TOL
    to = tattn.chunked_causal_attention(tq, tk, torch.from_numpy(v),
                                        q_chunk=16, kv_chunk=16)
    assert to.shape == (B, S, H, D)
    assert _rel(to.numpy(), jo) <= TOL
    td = tattn.decode_attention(tq[:, -1:], tk, torch.from_numpy(v), 29)
    assert _rel(td.numpy(), jd) <= TOL


def _jgrads(fn, args, cot):
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(cot)


@pytest.mark.parametrize("bits", [0, 2])
def test_act_rmsnorm_matches(bits):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(24, 48)).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=48)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jsched, tsched = _sched(bits)
    jpolicy, tpolicy = jsched.resolve("rmsnorm", "n"), \
        tsched.resolve("rmsnorm", "n")
    key = scope_key(ROOT, "n", 0)
    (out, (dx, dg)) = jax.jit(lambda x, g, c: _jgrads(
        lambda a, b: jact.act_rmsnorm(a, b, key=key, policy=jpolicy,
                                      eps=1e-5), (x, g), c))(x, gamma, cot)
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = torch.from_numpy(gamma).requires_grad_(True)
    got = tact.act_rmsnorm(tx, tg, seed=int(key_to_seed(key)),
                           policy=tpolicy, eps=1e-5)
    assert _rel(got.detach().numpy(), out) <= TOL
    gx, gg = torch.autograd.grad(got, (tx, tg), torch.from_numpy(cot))
    assert _rel(gx.numpy(), dx) <= TOL and _rel(gg.numpy(), dg) <= TOL


def _remat_nodes(y):
    """The ``act_remat`` backward nodes of ``y``'s graph, the output's
    first (the last layer's)."""
    seen, out, todo = set(), [], [y.grad_fn]
    while todo:
        n = todo.pop(0)
        if n is None or n in seen:
            continue
        seen.add(n)
        if type(n).__name__ == "_ActRematBackward":
            out.append(n)
        todo.extend(f for f, _ in n.next_functions)
    return out


def _jblock(p, x, c):
    return x + jnp.tanh(x @ p["w1"]) @ p["w2"] * c


def _tblock(p, x, c):
    return x + torch.tanh(x @ p["w1"]) @ p["w2"] * c


@pytest.mark.parametrize("bits", [0, 2])
def test_act_remat_matches(bits):
    """A two-layer residual MLP through ``act_remat`` (``repeat=2``, one
    seed a layer, a constant): the output and the gradients of the input
    and of every parameter; at INT2 the layer-0 residual's codes, scale
    and zero bit for bit against the reference kernel's on the same input
    and seed. (The transformer's blocks run through it in
    ``test_training_matches_reference``.)"""
    rng = np.random.default_rng(4)
    d = 48
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    blocks = {k: rng.normal(size=(2, d, d)).astype(np.float32) / d ** 0.5
              for k in ("w1", "w2")}
    jp = jpol.ACTPolicy(bits=bits or None, kernel="pallas")
    key = scope_key(ROOT, "lm", 0)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(2))

    def jforward(blocks, x):
        block = jact.act_remat(_jblock, jp, scope="lm/block", repeat=2)

        def body(x, layer):
            return block(layer[0], x, layer[1], 0.5), None

        return jax.lax.scan(body, x, (blocks, keys))[0]

    out, (dblocks, dx) = jax.jit(lambda b, x, c: _jgrads(
        jforward, (b, x), c))(blocks, x, cot)

    layers = [{k: torch.from_numpy(v[i]).requires_grad_(True)
               for k, v in blocks.items()} for i in range(2)]
    tx = torch.from_numpy(x).requires_grad_(True)
    block = tact.act_remat(_tblock, tpol.ACTPolicy(bits=bits or None),
                           scope="lm/block", repeat=2)
    seeds = [_seed(f"lm/layer{i}", 0) for i in range(2)]
    with act_context(_sched(bits)[1], step=0, seed_fn=_seed) as ctx:
        got = block(layers, tx, seeds, consts=0.5)
    assert [r.scope for r in ctx.records] == ["lm/block", "lm/block[1]"]
    assert _rel(got.detach().numpy(), out) <= TOL
    leaves = [layer[k] for k in ("w1", "w2") for layer in layers]
    grads = torch.autograd.grad(got, [tx] + leaves, torch.from_numpy(cot))
    refs = [dx] + [np.asarray(dblocks[k])[i] for k in ("w1", "w2")
                   for i in range(2)]
    for g, r in zip(grads, refs, strict=True):
        assert float(np.abs(g.numpy() - r).max()) <= \
            TOL * float(np.abs(r).max())
    nodes = _remat_nodes(got)
    assert len(nodes) == (2 if bits else 0)
    if bits:
        q = nodes[-1].q                       # layer 0: the deepest node
        ref = kops.quantize(jnp.asarray(x), keys[0], bits=2,
                            stochastic=True)
        for a in ("packed", "scale", "zero"):
            got_a = getattr(q, a).numpy()
            np.testing.assert_array_equal(
                got_a, np.asarray(getattr(ref, a)).reshape(got_a.shape))


def test_moe_ffn_matches():
    """The reduced moonshot MoE on 80 tokens (capacity 25: some choices are
    dropped): the same expert choices, no near-tie at the k-th choice,
    then the output and the aux loss."""
    jcfg, tcfg, params, _ = _world("moonshot-v1-16b-a3b")
    moe = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B * S, tcfg.d_model)).astype(np.float32)

    @jax.jit
    def reference(p, x):
        probs = jax.nn.softmax(x @ p["router"], axis=-1)
        top, idx = jax.lax.top_k(probs, jcfg.moe.top_k + 1)
        return jmoe.moe_ffn(p, x, jcfg.moe), idx[:, :-1], top

    (jy, jaux), jidx, jtop = reference(moe, x)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in moe.items()}
    tx = torch.from_numpy(x)
    probs = torch.softmax(tx @ tp["router"], dim=-1)
    tidx = torch.topk(probs, tcfg.moe.top_k, dim=-1).indices
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    k = tcfg.moe.top_k
    gap = float(np.min(np.asarray(jtop)[:, k - 1] - np.asarray(jtop)[:, k]))
    assert gap > 1e-5, f"near-tie at the k-th expert: gap {gap}"
    ty, taux = tmoe.moe_ffn(tp, tx, tcfg.moe)
    assert _rel(ty.numpy(), jy) <= TOL
    assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))


@pytest.mark.parametrize("bits", [0, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_training_matches_reference(arch, bits):
    """``build_step(arch, device="cpu")`` (reduced config, batch 8, seq 64,
    ``lm_batches(seed=0)``) against the reference's step: the first
    batch's ``lm_loss`` and every gradient, and the residual report (the
    whole stack one site, ``lm/block`` and ``lm/block[1]``); then 3 Adam
    steps' losses (``make_train_step``) against the reference's gradients
    and optimiser."""
    params = _world(arch)[2]
    jsched, tsched = _sched(bits)
    jstep = jbuild(jget(arch), schedule=jsched)
    tstep = build_step(arch, device="cpu")
    cfg = tstep.cfg
    assert tstep.lr == jstep.lr == 1e-3
    assert tstep.dp_spec is None
    assert tstep.dp_unsupported == jstep.dp_unsupported == LM_DP_UNSUPPORTED
    assert tstep.metadata()["model"] == tstep.family

    @jax.jit
    def jgrad(p, batch, i):
        def loss(p):
            return jstep.loss(p, batch,
                              ctx=jact_context(jsched, ROOT, step=i))
        return jax.value_and_grad(loss)(p)

    jo = jopt.adam(jstep.lr)
    jupdate = jax.jit(jo.update)
    ttrain = make_train_step(tstep, topt.adam(tstep.lr), schedule=tsched,
                             seed_fn=_seed)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = trainable(ttf.params_from_jax(params, device="cpu"))
    jstate = jo.init(jp)
    ts = (tp, topt.adam(tstep.lr).init(tp))
    jl, tl = [], []
    for i, (jb, tb) in enumerate(itertools.islice(
            zip(jstep.batches(), tstep.batches()), 3)):
        assert tb["tokens"].shape == (8, 65)
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
        loss, grads = jgrad(jp, jb, i)
        if i == 0:
            with act_context(tsched, step=0, seed_fn=_seed) as ctx:
                t0 = tstep.loss(tp, tb)
            assert abs(float(t0.detach()) - float(loss)) <= \
                TOL * abs(float(loss))
            names = sorted(tp)
            got = iter(torch.autograd.grad(t0, [t for k in names for t in (
                tp[k] if isinstance(tp[k], list) else [tp[k]])]))
            _close_leaves({k: ([next(got) for _ in tp[k]]
                               if isinstance(tp[k], list) else next(got))
                           for k in names}, grads, f"{arch} bits {bits}")
            rep = ctx.report()
            rows = 8 * 64
            assert set(rep) - {"total_bytes", "total_fp32_bytes",
                               "compression_ratio"} == \
                {"lm/block", "lm/block[1]"}
            assert rep["total_fp32_bytes"] == 2 * rows * cfg.d_model * 4
            assert rep["total_bytes"] == (
                2 * rows * (cfg.d_model // 4 + 8) if bits
                else rep["total_fp32_bytes"])
        jp, jstate = jupdate(grads, jstate, jp)
        ts, tm = ttrain(ts, tb, i)
        jl.append(float(loss))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=0)


def test_q8_matches_reference():
    x = np.random.default_rng(8).normal(size=(3, 7, 2, 16)).astype(
        np.float32)
    ref = jax.jit(jtf._q8)(jnp.asarray(x))
    got = ttf._q8(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("arch,kv_bits", [("stablelm-12b", None),
                                          ("moonshot-v1-16b-a3b", 8)])
def test_serving_matches_reference(arch, kv_bits):
    """``prefill`` of a (2, 16) prompt, then 8 ``decode_step``s fed the
    reference's greedy tokens (teacher forcing): each step's logits."""
    jcfg, tcfg, params, toks = _world(arch)
    jcfg = dataclasses.replace(jcfg, kv_cache_bits=kv_bits)
    tcfg = dataclasses.replace(tcfg, kv_cache_bits=kv_bits)
    prompt, steps = toks[:, :16], 8
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    prefill = jax.jit(jtf.prefill, static_argnames="cfg")
    decode = jax.jit(jtf.decode_step, static_argnames="cfg")
    jcache = jtf.init_cache(jcfg, B, 16 + steps)
    jlog, jcache = prefill(jp, jnp.asarray(prompt), cfg=jcfg, cache=jcache)
    tp = ttf.params_from_jax(params, device="cpu")
    tcache = ttf.init_cache(tcfg, B, 16 + steps, "cpu")
    tlog, tcache = ttf.prefill(tp, torch.from_numpy(prompt), tcfg, tcache)
    assert _rel(tlog.numpy(), jlog) <= TOL
    for _ in range(steps):
        fed = jnp.argmax(jlog, -1)[:, None]
        jlog, jcache = decode(jp, jcache, fed, jcfg)
        tlog, tcache = ttf.decode_step(tp, tcache,
                                       torch.from_numpy(np.array(fed)),
                                       tcfg)
        assert _rel(tlog.numpy(), jlog) <= TOL
    assert tcache["len"] == int(jcache["len"]) == 16 + steps
    if kv_bits == 8:
        np.testing.assert_array_equal(tcache["k"].numpy(),
                                      np.asarray(jcache["k"]))


def test_launchers_cpu(capsys):
    tlaunch.main(["--arch", "stablelm-12b", "--steps", "2", "--device",
                  "cpu"])
    out = capsys.readouterr().out
    assert "x vs fp32" in out and "done; loss" in out
    tserve.main(["--arch", "moonshot-v1-16b-a3b", "--tokens", "4",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "3 decode steps" in out and "ms/tok/batch" in out
    for flag in (["--mesh", "data=2"], ["--sample", "fanout=2"]):
        with pytest.raises(SystemExit):
            tlaunch.main(["--arch", "codeqwen1.5-7b", "--steps", "1",
                          "--device", "cpu"] + flag)
