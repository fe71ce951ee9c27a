"""Port parity: neighbour-sampled minibatch training and the hot/cold tier
store against the JAX package.

One small zipf world (30 users, 50 items, 20 attributes, 300 triples; d 8,
2 layers, fanouts (3, 2), batch 4) feeds both packages the same numpy
inputs. Arrays from the numpy pipeline (dataset, block caps, layouts,
sampled blocks, batches, the tier store's tables and counters) must be
identical. The sampled loss and its gradients (dense and entity rows) are
held to the reference's within 1e-5 of its max |value| at FP32 and at INT2
(the JAX side on its counter-hash kernel path in interpret mode, the port
taking its rounding seeds through ``ActContext(seed_fn=...)``; at this
size both keep the same codes), and the ACT report of a sampled step
equals the reference's traced report, bit for bit. ``run_sampled_training``
follows the reference's loss trajectory within 1e-5 over 4 KGCN steps
(FP32).

Port-internal contracts: a take-all fanout gives the full-graph
representations and loss; the overlapped prefetch-and-patch schedule
equals the sequential one bit for bit; ``hot_frac`` 0 and 1; the fanout
parser's errors; the launcher's ``--sample`` path in-process.
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

from repro.core import memory as jmem
from repro.core import policy as jpol
from repro.core.context import act_context as jact_context
from repro.core.rng import scope_key
from repro.data import csr as jcsr
from repro.data import minibatch as jmb
from repro.data.synthetic import gen_zipf_kg_dataset as jzipf
from repro.kernels.hashrng import key_to_seed
from repro.models import kgnn as jk
from repro.models.registry import build_step as jbuild
from repro.training import tiering as jtier
from repro_torch.core import policy as tpol
from repro_torch.core.context import act_context
from repro_torch.data import csr as tcsr
from repro_torch.data import minibatch as tmb
from repro_torch.data.synthetic import gen_zipf_kg_dataset as tzipf
from repro_torch.launch import train as tlaunch
from repro_torch.models import kgnn as tk
from repro_torch.models.layers import param_leaves
from repro_torch.models.registry import build_step as tbuild
from repro_torch.training import tiering as ttier
from repro_torch.training.step import trainable

ZIPF = dict(n_users=30, n_items=50, n_attrs=20, n_triples=300,
            inter_per_user=6, seed=0)
FANOUTS, BATCH, DIM, ROOT = (3, 2), 4, 8, jax.random.PRNGKey(1)
MODELS = ("kgat", "kgcn", "kgin", "rgcn")


@functools.lru_cache(maxsize=None)
def _seed(scope: str, step: int) -> int:
    return int(key_to_seed(scope_key(ROOT, scope, step)))


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _cfg(pkg, ds, model, **kw):
    return pkg.KGNNConfig(
        model=model, n_users=ds.n_users, n_entities=ds.n_entities,
        n_relations=ds.n_relations, dim=DIM, n_layers=len(FANOUTS),
        readout="concat" if model == "kgat" else "sum", **kw)


@pytest.fixture(scope="module")
def world():
    jds, tds = jzipf(**ZIPF), tzipf(**ZIPF)
    jitems = list(itertools.islice(jmb.sampled_items(
        jds, FANOUTS, batch_size=BATCH, seed=0, build_layouts=True), 3))
    titems = list(itertools.islice(tmb.sampled_items(
        tds, FANOUTS, batch_size=BATCH, seed=0), 3))
    return jds, tds, jitems, titems


def _params(cfg, seed=0):
    """A numpy parameter tree of the reference's shapes."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.2).astype(np.float32),
        jax.eval_shape(functools.partial(jk.init_params, cfg=cfg),
                       jax.random.PRNGKey(0)))


def test_zipf_dataset_identical(world):
    jds, tds, _, _ = world
    g = jds.graph
    for a, b in ((tds.src, g.src), (tds.dst, g.dst), (tds.rel, g.rel),
                 (tds.train_pos, jds.train_pos),
                 (tds.test_pos, jds.test_pos)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (tds.n_nodes, tds.n_users, tds.n_items, tds.n_entities,
            tds.n_relations) == (g.n_nodes, jds.n_users, jds.n_items,
                                 jds.n_entities, jds.n_relations)


def test_static_caps_and_padded_layout_identical(world):
    for e, n_out in ((0, 1), (255, 256), (256, 257), (11520, 768),
                     (675840, 135168)):
        assert tcsr.static_block_caps(e, n_out, block_e=64, block_rows=32) \
            == jcsr.static_block_caps(e, n_out, block_e=64, block_rows=32)
    _, _, jitems, titems = world
    for jb, tb in zip(jitems[0].view.blocks, titems[0].view.blocks):
        tl = tcsr.build_spmm_layout(
            np.asarray(jb.src), np.asarray(jb.dst), n_dst=jb.n_dst,
            n_src=jb.n_src, block_e=8, block_rows=4, pad_static=True,
            device="cpu")
        jl = jcsr.build_spmm_layout(
            np.asarray(jb.src), np.asarray(jb.dst), n_dst=jb.n_dst,
            n_src=jb.n_src, block_e=8, block_rows=4, pad_static=True)
        assert dataclasses.asdict(tl.meta) == dataclasses.asdict(jl.meta)
        assert tl.meta.n_blocks == jcsr.static_block_caps(
            len(jb.src), jb.n_dst, block_e=8, block_rows=4)
        for name in ("src_blk", "dstg_blk", "ldst_blk", "perm_blk",
                     "tile_of_blk", "t_src_blk", "t_ldst_blk", "t_perm_blk",
                     "t_tile_of_blk"):
            np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                          np.asarray(getattr(jl, name)))
        # the runs cover every real slot once and no pad slot
        for tr in (False, True):
            dr = tl.direction(tr)
            perm = dr.perm_blk.reshape(-1).numpy()
            covered = np.concatenate([np.arange(a, b) for a, b in zip(
                dr.row_start.numpy(), dr.row_end.numpy())])
            assert (perm[covered] < tl.meta.n_edges).all()
            np.testing.assert_array_equal(np.sort(perm[covered]),
                                          np.arange(tl.meta.n_edges))
        # the block's own layout (the sampler's block sizes) too
        np.testing.assert_array_equal(tb.layout.perm_blk.numpy(),
                                      np.asarray(jb.layout.perm_blk))


def test_sampled_items_identical(world):
    _, _, jitems, titems = world
    for ji, ti in zip(jitems, titems):
        assert ti.index == ji.index and ti.view.n_seeds == ji.view.n_seeds
        np.testing.assert_array_equal(ti.input_nodes, ji.input_nodes)
        np.testing.assert_array_equal(ti.requests, ji.requests)
        for k in ji.batch:
            np.testing.assert_array_equal(ti.batch[k], ji.batch[k])
        assert len(ti.view.blocks) == len(ji.view.blocks) == len(FANOUTS)
        for tb, jb in zip(ti.view.blocks, ji.view.blocks):
            assert (tb.n_src, tb.n_dst) == (jb.n_src, jb.n_dst)
            for k in ("src", "dst", "rel", "mask"):
                np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                              np.asarray(getattr(jb, k)))


@pytest.mark.parametrize("bits", [0, 2])
@pytest.mark.parametrize("model", MODELS)
def test_sampled_loss_and_gradients_match_jax(world, model, bits):
    """The first item's loss and gradients (dense and entity rows) and the
    step's ACT report."""
    jds, tds, jitems, titems = world
    jc, tc = _cfg(jk, jds, model), _cfg(tk, tds, model)
    jsched = jpol.schedule_from_cli(None, bits,
                                    kernel="pallas" if bits else "jnp")
    tsched = tpol.schedule_from_cli(None, bits)
    params = _params(jc)
    params["entity"] = params["entity"][titems[0].input_nodes]
    jview = jitems[0].view

    def jloss(p):
        return jk.sampled_bpr_loss(p, jview, jc)

    def jctx_loss(p):
        with jact_context(jsched, ROOT, step=0):
            return jloss(p)

    jl, jg = jax.jit(jax.value_and_grad(jctx_loss))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = trainable(tk.params_from_jax(params, device="cpu"))
    ctx = act_context(tsched, step=0, seed_fn=_seed)
    with ctx:
        tl = tk.sampled_bpr_loss(tp, titems[0].view, tc)
    tg = torch.autograd.grad(tl, param_leaves(tp))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jleaves)
    for a, b in zip(tg, jleaves):
        assert _rel(a.numpy(), b) <= 1e-5
    ref = jmem.traced_activation_report(
        jloss, jax.tree_util.tree_map(jnp.asarray, params), schedule=jsched)
    assert ctx.report() == pytest.approx(ref, rel=0, abs=0)


def _store_ops(mod, tab, freq, pkg_args, to_dev):
    """A fixed sequence of gathers, scatter-backs, a patch and a refresh."""
    store = mod.TieredEmbeddingStore(tab, freq, hot_frac=0.25,
                                     refresh_every=2, **pkg_args)
    rng = np.random.default_rng(5)
    outs = []
    for _ in range(2):
        rows = rng.integers(0, len(tab), 40)
        nxt = rng.integers(0, len(tab), 30)
        outs.append(np.asarray(store.gather(rows, np.concatenate(
            [rows, rows[:7]]))))
        pre = store.gather(nxt)
        grads = rng.normal(size=(len(rows), tab.shape[1])).astype(np.float32)
        upd = store.apply_grads(rows, to_dev(grads), lr=0.1)
        outs.append(np.asarray(store.patch(pre, nxt, upd)))
    store.refresh()
    return store, outs


def test_tier_store_matches_jax():
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(64, 5)).astype(np.float32)
    freq = rng.random(64)
    js, jouts = _store_ops(jtier, tab, freq, {}, jnp.asarray)
    ts, touts = _store_ops(ttier, tab, freq, {"device": "cpu"},
                           torch.from_numpy)
    for a, b in zip(touts, jouts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.flush(), js.flush())
    np.testing.assert_array_equal(ts._hot_ids, js._hot_ids)
    assert ts.stats == js.stats
    assert ts.stats["rows_transferred"] > ts.stats["cold_rows"] > 0
    assert (ts.hit_rate, ts.rows_transferred_per_step, ts.device_bytes,
            ts.table_bytes) == (js.hit_rate, js.rows_transferred_per_step,
                                js.device_bytes, js.table_bytes)


def test_run_sampled_training_matches_jax(world):
    jds, tds, _, _ = world
    jc, tc = _cfg(jk, jds, "kgcn"), _cfg(tk, tds, "kgcn")
    key = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray, jk.init_params(key, jc))
    kw = dict(fanouts=FANOUTS, steps=4, batch_size=BATCH, hot_frac=0.1,
              seed=0)
    jrep, _, jstore = jtier.run_sampled_training(
        jbuild("kgcn", ds=jds, cfg=jc, device_graph=False), init_key=key,
        **kw)
    trep, _, tstore = ttier.run_sampled_training(
        tbuild("kgcn", ds=tds, cfg=tc, device="cpu", device_graph=False),
        params=tk.params_from_jax(params, device="cpu"), **kw)
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-5, atol=0)
    assert trep.stats == jrep.stats
    assert _rel(tstore.flush(), jstore.flush()) <= 1e-5


@pytest.mark.parametrize("model", MODELS)
def test_take_all_fanout_gives_the_full_graph(world, model):
    """fanout >= the largest in-degree keeps every edge: the seed rows'
    representations and the BPR loss (L2 off: it covers other rows) are the
    full graph's."""
    _, tds, _, _ = world
    cfg = _cfg(tk, tds, model, l2=0.0)
    adj = tmb.build_kg_csr(tds.src, tds.dst, tds.rel, tds.n_nodes,
                           tds.n_relations)
    f = adj.max_in_degree
    batch = next(tmb.sampled_items(tds, (f, f), batch_size=BATCH, seed=1))
    view, inp = batch.view, batch.input_nodes
    params = tk.init_params(cfg, seed=2, device="cpu")
    full = tk.forward_reps(params, tds.graph("cpu"), cfg)
    seeds = np.concatenate([batch.batch["user"],
                            tds.n_users + batch.batch["pos"],
                            tds.n_users + batch.batch["neg"]])
    ps = {**params, "entity": params["entity"][torch.from_numpy(inp)]}
    samp = tk.sampled_reps(ps, view, cfg)
    np.testing.assert_allclose(samp.numpy(), full[seeds].numpy(),
                               rtol=0, atol=1e-6)
    loss = tk.bpr_loss(params, tds.graph("cpu"), {
        k: torch.from_numpy(v) for k, v in batch.batch.items()}, cfg)
    assert abs(float(tk.sampled_bpr_loss(ps, view, cfg)) - float(loss)) \
        <= 1e-6


def test_prefetch_patch_equals_sequential(world):
    _, tds, _, _ = world
    step = tbuild("kgcn", ds=tds, cfg=_cfg(tk, tds, "kgcn"), device="cpu",
                  device_graph=False)
    sched = tpol.schedule_from_cli(None, 2)
    runs = [ttier.run_sampled_training(
        step, fanouts=FANOUTS, steps=4, batch_size=BATCH, hot_frac=0.2,
        refresh_every=3, schedule=sched, root_seed=1, seed=3,
        overlap=overlap) for overlap in (True, False)]
    (r1, d1, s1), (r2, d2, s2) = runs
    assert r1.losses == r2.losses
    np.testing.assert_array_equal(s1.flush(), s2.flush())
    for a, b in zip(param_leaves(d1), param_leaves(d2)):
        assert torch.equal(a, b)
    assert r1.stats["patch_rows"] > 0 and r2.stats["patch_rows"] == 0
    assert r1.stats["refreshes"] == r2.stats["refreshes"] > 0
    assert all(len(r1.phase_ms[p]) == 4 for p in ttier.PHASES)


@pytest.mark.parametrize("hot_frac", [0.0, 1.0])
def test_hot_frac_zero_and_one(hot_frac):
    rng = np.random.default_rng(2)
    tab = rng.normal(size=(16, 3)).astype(np.float32)
    rows = np.array([0, 7, 15, 7])
    store = ttier.TieredEmbeddingStore(tab, None, hot_frac=hot_frac,
                                       device="cpu")
    np.testing.assert_array_equal(store.gather(rows).numpy(), tab[rows])
    assert store.stats["hot_hits"] == (len(rows) if hot_frac else 0)
    assert store.stats["cold_rows"] == (0 if hot_frac else 3)
    assert store.device_bytes == (tab.nbytes if hot_frac else 0)
    store.apply_grads(rows, torch.ones((4, 3)), lr=0.5)
    exp = tab.copy()
    np.add.at(exp, rows, -0.5)
    np.testing.assert_array_equal(store.flush(), exp)


@pytest.mark.parametrize("spec", ["fanout=", "fanout=3,0", "3,x", "-1"])
def test_parse_fanouts_errors(spec):
    with pytest.raises(ValueError, match="fanout=F1,F2"):
        tmb.parse_fanouts(spec)
    assert tmb.parse_fanouts("fanout=15,10,5") == (15, 10, 5)
    assert tmb.parse_fanouts("3,2") == jmb.parse_fanouts("3,2")


def test_launcher_sample_path_in_process(capsys, tmp_path, monkeypatch):
    tlaunch.main(["--arch", "kgat", "--sample", "fanout=3,2", "--steps", "3",
                  "--batch", "16", "--device", "cpu",
                  "--metrics-out", str(tmp_path),
                  "--trace", str(tmp_path / "trace.json")])
    out = capsys.readouterr().out
    assert "[train] done; loss" in out and "hit-rate" in out \
        and "rows/step" in out and "MiB table" in out
    trace = (tmp_path / "trace.json").read_text()
    assert all(f"train/step/{p}" in trace for p in ttier.PHASES)
    assert "train/step_ms" in (tmp_path / "summary.json").read_text()
    with pytest.raises(SystemExit, match="fanout=F1,F2"):
        tlaunch.main(["--arch", "kgat", "--sample", "fanout=3,0",
                      "--device", "cpu"])
    with pytest.raises(ValueError, match="one fanout per layer"):
        ttier.run_sampled_training(
            tbuild("kgat", device="cpu", device_graph=False), fanouts=(3,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "kgat", "--sample", "fanout=3,2"])
