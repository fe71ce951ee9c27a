"""Port parity: the recsys family (FM, Wide&Deep, DLRM, xDeepFM) against
the JAX package.

The same numpy inputs go through the reference's ``repro.models.recsys``
and the port's ``repro_torch.models.recsys`` (plain versions of the
kernels, on the CPU), reduced configs on both sides, with the JAX
parameters carried across (``params_from_jax``). The JAX side runs its jnp
path at FP32; at INT2 it runs its counter-hash kernel path
(``kernel="pallas"``, interpret mode) and the port takes its rounding
seeds, ``key_to_seed(scope_key(root, scope, step))``, through
``ActContext(seed_fn=...)``.

Tolerances: logits within 1e-5 of max |logits| and each gradient within
1e-5 of its max |value|, FP32 and INT2 (fp32 reassociation; at batch 16 no
quantization input sits within a rounding of an SR threshold, so both
sides keep the same codes); the residual report equal to the reference's
``traced_activation_report``; ``criteo_batches`` bit-identical; ``auc``
within 1e-6 on data full of ties; the retrieval head and towers within
1e-6 relative; the registry step's loss over 3 Adam steps within 1e-5
relative, FP32.
"""

from __future__ import annotations

import dataclasses
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
from repro.data.synthetic import criteo_batches as jcriteo
from repro.kernels.hashrng import key_to_seed
from repro.models import recsys as jrec
from repro.models.registry import build_step as jbuild
from repro.training import optimizer as jopt
from repro.training.metrics import auc as jauc
from repro.training.step import make_train_step as jmake
from repro_torch.configs import get as tget
from repro_torch.configs.smoke import reduced as treduced
from repro_torch.core import policy as tpol
from repro_torch.core.context import act_context
from repro_torch.data.synthetic import criteo_batches
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import recsys as trec
from repro_torch.models.registry import RECSYS_DP_UNSUPPORTED, build_step, \
    check_fits, path_kernels, recsys_config
from repro_torch.training import optimizer as topt
from repro_torch.training.metrics import auc
from repro_torch.training.step import make_train_step, trainable

ROOT = jax.random.PRNGKey(1)
TOL = 1e-5
ARCHS = ("fm", "wide-deep", "dlrm-mlperf", "xdeepfm")


@functools.lru_cache(maxsize=None)
def _seed(scope: str, step: int) -> int:
    return int(key_to_seed(scope_key(ROOT, scope, step)))


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _as_reference_tree(params: dict) -> dict:
    """The port's parameters as the reference's numpy tree (each MLP a list
    of ``{w, b}``): the inverse of ``params_from_jax``."""
    out = {}
    for k, v in params.items():
        name, _, part = k.rpartition("_")
        if name in trec.MLPS:
            layers = out.setdefault(name, [{} for _ in v])
            for layer, t in zip(layers, v):
                layer[part] = t.numpy()
        else:
            out[k] = ([t.numpy() for t in v] if isinstance(v, list)
                      else v.numpy())
    return out


@functools.lru_cache(maxsize=None)
def _world(arch):
    """(jax config, port config, seed-0 parameters as the reference's numpy
    tree, one batch of 16). The parameters are drawn by the port's
    ``init_params`` (drawing them with ``jax.random`` would compile a
    dozen small programs)."""
    jcfg = jreduced(jget(arch)).model_cfg
    tcfg = treduced(tget(arch)).model_cfg
    params = _as_reference_tree(trec.init_params(tcfg, seed=0, device="cpu"))
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(jax.eval_shape(
            lambda: jrec.init_params(jax.random.PRNGKey(0), jcfg)))
    batch = next(criteo_batches(batch=16, n_dense=max(tcfg.n_dense, 1),
                                vocab_sizes=tcfg.vocab_sizes, seed=5))
    return jcfg, tcfg, params, batch


def test_configs_match_reference():
    for arch in ARCHS:
        j, t = jget(arch), tget(arch)
        assert (j.family, j.source) == (t.family, t.source) == \
            ("recsys", j.source)
        assert dataclasses.asdict(j.model_cfg) == \
            dataclasses.asdict(t.model_cfg)
        assert dataclasses.asdict(jreduced(j).model_cfg) == \
            dataclasses.asdict(treduced(t).model_cfg)
        assert [s.params for s in j.shapes] == [s.params for s in t.shapes]
    assert recsys_config("dlrm-mlperf", row_cap=2097152).total_vocab == \
        13693440
    red = treduced(tget("dlrm-mlperf")).model_cfg
    assert red.bot_mlp[-1] == red.embed_dim


@pytest.mark.parametrize("kw", [
    dict(batch=32, n_dense=13, vocab_sizes=(1000, 3, 40, 7), seed=3),
    dict(batch=7, n_dense=1, vocab_sizes=(10_000_000, 128, 5), seed=0,
         zipf_a=1.1),
])
def test_criteo_batches_bit_identical(kw):
    for a, b in itertools.islice(zip(criteo_batches(**kw), jcriteo(**kw)),
                                 3):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


_JAUC = jax.jit(jauc)


@pytest.mark.parametrize("case", ["ties", "all_equal", "random"])
def test_auc_matches_reference(case):
    rng = np.random.default_rng(7)
    logits = {"ties": rng.integers(0, 5, 300).astype(np.float32),
              "all_equal": np.ones(300, np.float32),
              "random": rng.normal(size=300).astype(np.float32)}[case]
    labels = (rng.random(len(logits)) < 0.4).astype(np.float32)
    got = auc(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = float(_JAUC(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(got - ref) <= 1e-6
    if case == "all_equal":
        assert got == 0.5


@pytest.mark.parametrize("bits", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_grads_match(arch, bits):
    """Logits, every gradient (the vector-Jacobian product with one fixed
    random cotangent) and the residual report of one forward and backward
    against the reference's."""
    jcfg, tcfg, params, batch = _world(arch)
    jsched = jpol.schedule_from_cli(None, bits,
                                    kernel="pallas" if bits else "jnp")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p):
        with jact_context(jsched, ROOT, step=0):
            return jrec.forward(p, jb, jcfg)

    cot = np.random.default_rng(1).normal(size=16).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    def value_and_vjp(p):
        out, vjp = jax.vjp(f, p)
        return out, vjp(jnp.asarray(cot))[0]

    # FP32 compiles faster as one program; the interpret-mode kernels of
    # INT2 run faster op by op
    ref, ref_g = jax.jit(value_and_vjp)(jp)
    report = traced_activation_report(lambda p: jrec.forward(p, jb, jcfg),
                                      jp, schedule=jsched, key=ROOT)

    tp = trainable(trec.params_from_jax(params, device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["lookup"] = trec.lookup_plan(batch["sparse"], tcfg, "cpu")
    ctx = act_context(tpol.schedule_from_cli(None, bits), step=0,
                      seed_fn=_seed)
    with ctx:
        out = trec.forward(tp, tb, tcfg)
    assert out.shape == (16,)
    assert _rel(out.detach().numpy(), ref) <= TOL
    flat = [(n, i, t) for n in sorted(tp) for i, t in enumerate(
        tp[n] if isinstance(tp[n], list) else [tp[n]])]
    got = torch.autograd.grad(out, [t for _, _, t in flat],
                              torch.from_numpy(cot), allow_unused=True)
    refs = {}
    for k, v in ref_g.items():
        if k in trec.MLPS:
            refs.update({f"{k}_w": [layer["w"] for layer in v],
                         f"{k}_b": [layer["b"] for layer in v]})
        else:
            refs[k] = v if isinstance(v, list) else [v]
    assert len(flat) == sum(len(v) for v in refs.values())
    for (name, i, _), g in zip(flat, got):
        r = np.asarray(refs[name][i])
        if g is None:            # DLRM's logit reads no linear term, bias
            assert arch == "dlrm-mlperf" and name in ("linear", "bias")
            assert not np.any(r)
            continue
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g.numpy() - r).max()) <= TOL * scale, (name, i)
    assert ctx.report() == report
    sites = {"fm": set(),
             "wide-deep": {"wide_deep/deep/fc0", "wide_deep/deep/relu0"},
             "dlrm-mlperf": {"dlrm/bot/fc0", "dlrm/top/fc0",
                             "dlrm/bot/relu2"},
             "xdeepfm": {"xdeepfm/cin0", "xdeepfm/cin2", "xdeepfm/cin_out",
                         "xdeepfm/deep/fc2"}}[arch]
    assert set(report) >= sites


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_matches(arch):
    """``retrieval_scores`` and ``retrieval_towers`` within 1e-6 relative;
    the towers' dot equals the scores."""
    jcfg, tcfg, params, batch = _world(arch)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = trec.params_from_jax(params, device="cpu")
    field = 2
    cand = np.arange(min(tcfg.vocab_sizes[field], 300), dtype=np.int32)
    q = batch["sparse"][:4]

    @jax.jit
    def reference(p, q, cand):
        return (jrec.retrieval_scores(p, {"sparse": q[0]}, cand, jcfg,
                                      item_field=field),
                jrec.retrieval_towers(p, q, cand, jcfg, item_field=field))

    ref, (ju, jc) = reference(jp, jnp.asarray(q), jnp.asarray(cand))
    got = trec.retrieval_scores(tp, {"sparse": torch.from_numpy(q[0])},
                                torch.from_numpy(cand), tcfg,
                                item_field=field)
    assert _rel(got.numpy(), ref) <= 1e-6
    tu, tc = trec.retrieval_towers(tp, torch.from_numpy(q),
                                   torch.from_numpy(cand), tcfg,
                                   item_field=field)
    assert tu.shape == (4, tcfg.embed_dim + 1)
    assert tc.shape == (len(cand), tcfg.embed_dim + 1)
    assert _rel(tu.numpy(), ju) <= 1e-6 and _rel(tc.numpy(), jc) <= 1e-6
    assert _rel((tc @ tu[0]).numpy(), ref) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_training_matches_reference(arch):
    """``build_step(arch, device="cpu")`` (reduced config, batch 256,
    ``criteo_batches(seed=3)``) for 3 Adam steps against the reference's
    step and optimiser, FP32, from the reference's parameters."""
    params = _world(arch)[2]
    jstep = jbuild(arch, schedule=jpol.FP32)
    tstep = build_step(arch, device="cpu")
    assert tstep.lr == jstep.lr == 1e-3
    assert tstep.dp_spec is None
    assert tstep.dp_unsupported == jstep.dp_unsupported == \
        RECSYS_DP_UNSUPPORTED
    jtrain = jmake(jstep, jopt.adam(jstep.lr), schedule=jpol.FP32,
                   root_key=ROOT)
    ttrain = make_train_step(tstep, topt.adam(tstep.lr),
                             schedule=tpol.FP32, seed_fn=_seed)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = trainable(trec.params_from_jax(params, device="cpu"))
    js = (jp, jopt.adam(jstep.lr).init(jp))
    ts = (tp, topt.adam(tstep.lr).init(tp))
    jl, tl = [], []
    for i, (jb, tb) in enumerate(itertools.islice(
            zip(jstep.batches(), tstep.batches()), 3)):
        assert tb["sparse"].shape == (256, tstep.cfg.n_sparse)
        np.testing.assert_array_equal(tb["sparse"].numpy(),
                                      np.asarray(jb["sparse"]))
        js, jm = jtrain(js, jb, i)
        ts, tm = ttrain(ts, tb, i)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=0)


def test_table_gradient_sums_each_row_in_order():
    """The lookups' backward: each distinct row's gradient is the sum of
    its positions' gradients (here against ``index_add_`` in float64), the
    rows no id reaches zero, and only the distinct rows' runs are built."""
    cfg = treduced(tget("fm")).model_cfg
    sparse = np.random.default_rng(0).integers(0, 3, (50, cfg.n_sparse))
    plan = trec.lookup_plan(sparse, cfg, "cpu")
    flat = (sparse + np.asarray(cfg.field_offsets)[None, :]).reshape(-1)
    assert torch.equal(plan.ids, torch.from_numpy(flat))
    assert torch.equal(plan.rows, torch.from_numpy(np.unique(flat)))
    assert plan.runs[0].n_out == len(np.unique(flat))
    table = torch.randn((cfg.total_vocab, cfg.embed_dim), dtype=torch.float64,
                        requires_grad=True)
    g = torch.randn((flat.size, cfg.embed_dim), dtype=torch.float64)
    from repro_torch.core.act import gather_rows

    out = gather_rows(table, plan.ids, plan.runs, rows=plan.rows)
    (got,) = torch.autograd.grad(out, table, g)
    ref = torch.zeros_like(table).index_add_(0, plan.ids, g)
    assert torch.allclose(got, ref, rtol=1e-12, atol=1e-12)
    # a forward that trains the tables without the batch's plan is refused
    # (index_select's backward would scatter with atomics)
    with pytest.raises(ValueError, match="LookupPlan"):
        trec.forward(trainable(trec.init_params(cfg, device="cpu")),
                     {"sparse": torch.from_numpy(sparse)}, cfg)


def test_only_unread_parameters_get_zero_gradient():
    """DLRM's step lists ``linear`` and ``bias`` as unread: a step gives
    them zero gradient, so Adam leaves them as they were; the same step
    without that list raises, as for any parameter the loss does not
    reach."""
    step = build_step("dlrm-mlperf", device="cpu", batch_size=16)
    assert step.unread == ("linear", "bias")
    assert build_step("xdeepfm", device="cpu", batch_size=16).unread == ()
    opt = topt.adam(step.lr)
    p = step.init(0)
    lin, bias = p["linear"].detach().clone(), p["bias"].detach().clone()
    batch = next(step.batches())
    train = make_train_step(step, opt, schedule=tpol.FP32, root_seed=0)
    (p, o), m = train((p, opt.init(p)), batch, 0)
    assert np.isfinite(float(m["loss"]))
    assert torch.equal(p["linear"], lin) and torch.equal(p["bias"], bias)
    bad = make_train_step(dataclasses.replace(step, unread=()), opt,
                          schedule=tpol.FP32, root_seed=0)
    with pytest.raises(RuntimeError, match="not have been used"):
        bad((p, o), batch, 1)


def test_path_kernels():
    assert path_kernels("fm", True) == ("segment_sum",)
    for model in ("wide_deep", "dlrm", "xdeepfm"):
        assert path_kernels(model, False) == ("segment_sum",)
        assert set(path_kernels(model, True)) == {
            "segment_sum", "quant_pack", "dequant_matmul"}


def test_full_dlrm_refused_before_allocating(monkeypatch):
    """On an 80 GB card, DLRM's full table (96.1 GB, four copies to train)
    is refused up front, naming its bytes; the capped table (7.0 GB) is
    not."""
    class Props:
        total_memory = 85_520_809_984           # an H100 80GB

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    dev = torch.device("cuda", 0)
    with pytest.raises(ValueError, match=r"187,767,399 rows x 128 x 4 B = "
                                         r"96\.1 GB"):
        check_fits(recsys_config("dlrm-mlperf"), dev)
    check_fits(recsys_config("dlrm-mlperf", row_cap=2097152), dev)
    check_fits(recsys_config("xdeepfm"), dev)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_cpu(capsys, arch):
    bits = "0" if arch == "fm" else "2"
    tlaunch.main(["--arch", arch, "--steps", "2", "--bits", bits,
                  "--batch", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done; loss" in out and "x vs fp32" in out


def test_train_launcher_refusals():
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--arch", "xdeepfm", "--mesh", "data=2",
                      "--device", "cpu"])
    assert RECSYS_DP_UNSUPPORTED in str(exc.value)
    assert "--arch xdeepfm (recsys)" in str(exc.value)
    with pytest.raises(SystemExit, match="Train it full-batch instead"):
        tlaunch.main(["--arch", "fm", "--sample", "fanout=3,2",
                      "--device", "cpu"])


def test_serve_launcher_cpu(capsys):
    tserve.main(["--arch", "dlrm-mlperf", "--batch", "8", "--requests",
                 "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dlrm-mlperf: batch=8 p50=" in out
    tserve.main(["--arch", "xdeepfm", "--retrieval", "500", "--k", "8",
                 "--requests", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "retrieval: 500 candidates" in out and "re-rank" in out
    assert "recall@8" in out
