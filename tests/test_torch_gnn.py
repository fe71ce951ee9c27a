"""Port parity: the GCN (gcn-cora) against the JAX package.

The same numpy inputs go through the reference's ``repro.models.gnn`` and
the port's ``repro_torch.models.gnn`` (plain versions of the kernels, on
the CPU), with the JAX parameters carried across. The JAX side runs its jnp
path at FP32; at INT2 it runs its counter-hash kernel path
(``kernel="pallas"``, interpret mode) and the port takes its rounding
seeds, ``key_to_seed(scope_key(root, scope, step))``, through
``ActContext(seed_fn=...)``.

Tolerances: logits within 1e-5 of max |logits| (fp32 reassociation:
segment sums against the SPMM's slot order); each gradient within 1e-5 of
its max |value| (at INT2 too: at 60 nodes no quantization input sits
within a rounding of an SR threshold, so both sides keep the same codes);
the residual report equal to the reference's ``traced_activation_report``;
the FP32 loss over 3 Adam steps within 1e-5 relative.
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
from repro.core.memory import traced_activation_report
from repro.core.rng import scope_key
from repro.data import sampler as jsampler
from repro.data.synthetic import cora_like as jcora
from repro.kernels.hashrng import key_to_seed
from repro.models import gnn as jgnn
from repro.models.registry import build_step as jbuild
from repro.training import optimizer as jopt
from repro.training.step import make_train_step as jmake
from repro_torch.configs import get as tget
from repro_torch.configs.smoke import reduced as treduced
from repro_torch.core import policy as tpol
from repro_torch.core.act import act_spmm
from repro_torch.core.context import act_context
from repro_torch.data import sampler as tsampler
from repro_torch.data.csr import build_spmm_layout
from repro_torch.data.synthetic import cora_like, cora_like_avg_deg, \
    molecule_batch
from repro_torch.launch import train as tlaunch
from repro_torch.models import gnn as tgnn
from repro_torch.models.registry import GNN_DP_UNSUPPORTED, build_step, \
    gnn_config
from repro_torch.training import optimizer as topt
from repro_torch.training.step import make_train_step, trainable

ROOT = jax.random.PRNGKey(1)
TOL = 1e-5
N = 60


@functools.lru_cache(maxsize=None)
def _seed(scope: str, step: int) -> int:
    return int(key_to_seed(scope_key(ROOT, scope, step)))


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def world():
    jcfg = jreduced(jget("gcn-cora")).model_cfg
    tcfg = treduced(tget("gcn-cora")).model_cfg
    params = jax.tree_util.tree_map(np.asarray, jgnn.init_params(
        jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, params


def _grads_close(got, ref):
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= TOL


@pytest.mark.parametrize("kw", [
    dict(n_nodes=60, d_feat=32),
    dict(n_nodes=300, d_feat=32, n_classes=7, avg_deg=4, seed=0),
    dict(n_nodes=500, d_feat=20, n_classes=47, avg_deg=36, seed=3),
])
def test_cora_like_bit_identical(kw):
    for a, b in zip(cora_like(**kw), jcora(**kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cora_like_avg_deg_nearest_shape():
    """The chosen degree's graph is nearer the shape's edge count than its
    neighbours' (Cora's count drawn for real; the shapes' counts held to
    1% of the expected one)."""
    got = [len(cora_like(n_nodes=2708, d_feat=1, avg_deg=a)[1])
           for a in (2, 3, 4)]
    assert cora_like_avg_deg(2708, 10556, 7) == 3
    assert abs(got[1] - 10556) < min(abs(got[0] - 10556),
                                     abs(got[2] - 10556))
    for n, e, c in ((2449029, 61859140, 47), (232965, 114615892, 41)):
        a = cora_like_avg_deg(n, e, c)
        share = 1 / c + 0.15 * (1 - 1 / c)
        assert abs(2 * min(1, 4 * share) * (n * a // 2) + n - e) < 0.01 * e


def test_sampler_bit_identical():
    feats, src, dst, _ = cora_like(n_nodes=200, d_feat=8)
    t_csr = tsampler.build_csr(src, dst, 200)
    j_csr = jsampler.build_csr(np.asarray(src), np.asarray(dst), 200)
    for a, b in zip(t_csr, j_csr):
        np.testing.assert_array_equal(a, b)
    for seed in (0, 5):
        tr, jr = np.random.default_rng(seed), np.random.default_rng(seed)
        seeds = tr.integers(0, 200, 16)
        np.testing.assert_array_equal(seeds, jr.integers(0, 200, 16))
        tb, ti = tsampler.sample_blocks(*t_csr, seeds, [5, 3], rng=tr)
        jb, ji = jsampler.sample_blocks(*j_csr, seeds, [5, 3], rng=jr)
        np.testing.assert_array_equal(ti, ji)
        assert len(tb) == len(jb) == 2
        for a, b in zip(tb, jb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _graph(n=N):
    feats, src, dst, labels = cora_like(n_nodes=n, d_feat=32, n_classes=7)
    return feats, src, dst, labels


def _jax_forward(jcfg, params, x, src, dst, n, sched):
    def f(p):
        with jact_context(sched, ROOT, step=0):
            return jgnn.gcn_forward(p, jnp.asarray(x), jnp.asarray(src),
                                    jnp.asarray(dst), n_nodes=n, cfg=jcfg)
    return f


@pytest.mark.parametrize("bits", [0, 2])
def test_gcn_forward_matches(world, bits):
    jcfg, tcfg, params = world
    x, src, dst, _ = _graph()
    jsched = jpol.schedule_from_cli(None, bits,
                                    kernel="pallas" if bits else "jnp")
    f = _jax_forward(jcfg, params, x, src, dst, N, jsched)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = f(jp)
    ref_g = jax.grad(lambda p: jnp.sum(f(p) * jnp.cos(f(p))))(jp)
    report = traced_activation_report(
        lambda p: jgnn.gcn_forward(p, jnp.asarray(x), jnp.asarray(src),
                                   jnp.asarray(dst), n_nodes=N, cfg=jcfg),
        jp, schedule=jsched, key=ROOT)

    layout = build_spmm_layout(src, dst, n_dst=N, device="cpu")
    tp = trainable(tgnn.params_from_jax(params, device="cpu"))
    ctx = act_context(tpol.schedule_from_cli(None, bits), step=0,
                      seed_fn=_seed)
    with ctx:
        out = tgnn.gcn_forward(tp, torch.from_numpy(x), layout, cfg=tcfg)
    assert _rel(out.detach().numpy(), ref) <= TOL
    got = torch.autograd.grad(torch.sum(out * torch.cos(out)), tp["w"])
    _grads_close(got, ref_g["w"])
    assert ctx.report() == report
    assert set(report) >= {"gcn/layer0/dense", "gcn/layer0/relu",
                           "gcn/layer1/dense"}


def test_unweighted_spmm_keeps_only_the_layout():
    """``act_spmm(x, None, layout)`` saves no tensor for its backward (the
    reference's index-only residuals) and its gradient is the transpose
    aggregation; both sides against a dense adjacency, within 1e-5."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 30, 200)
    layout = build_spmm_layout(src, dst, n_dst=30, n_src=40, device="cpu")
    x = torch.from_numpy(rng.standard_normal((40, 7), np.float32))
    g = torch.from_numpy(rng.standard_normal((30, 7), np.float32))
    x.requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = act_spmm(x, None, layout)
    y.backward(g)
    a = np.zeros((30, 40), np.float32)
    np.add.at(a, (dst, src), 1.0)
    assert saved == []
    assert _rel(y.detach().numpy(), a @ x.detach().numpy()) <= TOL
    assert _rel(x.grad.numpy(), a.T @ g.numpy()) <= TOL


def test_gcn_forward_blocks_matches(world):
    jcfg, tcfg, params = world
    feats, src, dst, _ = cora_like(n_nodes=200, d_feat=32)
    indptr, indices = tsampler.build_csr(src, dst, 200)
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 200, 16)
    blocks, inp = tsampler.sample_blocks(indptr, indices, seeds, [5, 3],
                                         rng=rng)
    x = feats[inp]
    jb = [{"src": jnp.asarray(b["src"]), "dst": jnp.asarray(b["dst"]),
           "n_src": b["n_src"], "n_dst": b["n_dst"]} for b in blocks]

    def f(p):
        return jgnn.gcn_forward_blocks(p, jnp.asarray(x), jb, cfg=jcfg,
                                       policy=jpol.FP32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = f(jp)
    ref_g = jax.grad(lambda p: jnp.sum(f(p) ** 2))(jp)

    tp = trainable(tgnn.params_from_jax(params, device="cpu"))
    out = tgnn.gcn_forward_blocks(tp, torch.from_numpy(x),
                                  tsampler.block_layouts(blocks, "cpu"),
                                  cfg=tcfg)
    assert out.shape == (16, tcfg.n_classes)
    assert _rel(out.detach().numpy(), ref) <= TOL
    _grads_close(torch.autograd.grad(torch.sum(out ** 2), tp["w"]),
                 ref_g["w"])


def test_gcn_forward_batched_matches(world):
    jcfg, tcfg, params = world
    x, src, dst, gid, _ = molecule_batch(n_graphs=8, d_feat=32)
    n = len(gid)

    def f(p):
        return jgnn.gcn_forward_batched(
            p, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(gid), n_graphs=8, n_nodes=n, cfg=jcfg,
            policy=jpol.FP32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = f(jp)
    ref_g = jax.grad(lambda p: jnp.sum(f(p) ** 2))(jp)

    tp = trainable(tgnn.params_from_jax(params, device="cpu"))
    layout = build_spmm_layout(src, dst, n_dst=n, device="cpu")
    out = tgnn.gcn_forward_batched(
        tp, torch.from_numpy(x), layout, torch.from_numpy(gid),
        tgnn.readout_runs(gid, 8, "cpu"), cfg=tcfg)
    assert out.shape == (8, tcfg.n_classes)
    assert _rel(out.detach().numpy(), ref) <= TOL
    _grads_close(torch.autograd.grad(torch.sum(out ** 2), tp["w"]),
                 ref_g["w"])


def test_training_matches_reference(world):
    """``build_step("gcn-cora", device="cpu")`` (reduced config,
    ``cora_like(n_nodes=300)``) for 3 Adam steps against the reference's
    ``_gnn_step`` and its optimiser, at FP32."""
    params = world[2]
    jstep = jbuild("gcn-cora", schedule=jpol.FP32)
    tstep = build_step("gcn-cora", device="cpu")
    assert tstep.lr == jstep.lr == 1e-2
    assert tstep.dp_spec is None
    assert tstep.dp_unsupported == jstep.dp_unsupported == GNN_DP_UNSUPPORTED
    np.testing.assert_array_equal(tstep.data["features"].numpy(),
                                  np.asarray(jstep.data["features"]))
    jtrain = jmake(jstep, jopt.adam(jstep.lr), schedule=jpol.FP32,
                   root_key=ROOT)
    ttrain = make_train_step(tstep, topt.adam(tstep.lr),
                             schedule=tpol.FP32, seed_fn=_seed)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = trainable(tgnn.params_from_jax(params, device="cpu"))
    js = (jp, jopt.adam(jstep.lr).init(jp))
    ts = (tp, topt.adam(tstep.lr).init(tp))
    jl, tl = [], []
    for i, (jb, tb) in enumerate(itertools.islice(
            zip(jstep.batches(), tstep.batches()), 3)):
        js, jm = jtrain(js, jb, i)
        ts, tm = ttrain(ts, tb, i)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=0)
    assert tl[-1] < tl[0]


def test_shape_configs():
    """The configs of the four shapes: Cora's at full width, ogbn-products'
    features and classes, and the reference's sharded cells' widths."""
    got = {s: (gnn_config(s).d_in, gnn_config(s).n_classes) for s in
           ("full_graph_sm", "ogb_products", "minibatch_lg", "molecule")}
    assert got == {"full_graph_sm": (1433, 7), "ogb_products": (100, 47),
                   "minibatch_lg": (602, 41), "molecule": (32, 2)}
    assert tget("gcn-cora").model_cfg == tgnn.GCNConfig()
    assert [s.params for s in tget("gcn-cora").shapes] == \
        [s.params for s in jget("gcn-cora").shapes]


def test_launcher_cpu(capsys):
    tlaunch.main(["--arch", "gcn-cora", "--steps", "2", "--bits", "2",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done; loss" in out and "x vs fp32" in out
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--arch", "gcn-cora", "--mesh", "data=2",
                      "--device", "cpu"])
    assert jbuild("gcn-cora").dp_unsupported in str(exc.value)
    assert "--arch gcn-cora (gnn)" in str(exc.value)
    with pytest.raises(SystemExit, match="Train it full-batch instead"):
        tlaunch.main(["--arch", "gcn-cora", "--sample", "fanout=3,2",
                      "--device", "cpu"])
