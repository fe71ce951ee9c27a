"""Port parity: synthetic data and the KGAT rollout against the JAX package.

``gen_kg_dataset`` arrays must be equal; ``propagate`` on the reduced config,
from the JAX parameters carried across, within 1e-5 of the JAX ``propagate``
(COO ``segment_sum`` path, no layout).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.smoke import reduced as jreduced
from repro.data.synthetic import gen_kg_dataset as jgen
from repro.models import kgnn as jk
from repro_torch.configs import get as tget
from repro_torch.configs.smoke import reduced as treduced
from repro_torch.data.synthetic import gen_kg_dataset as tgen
from repro_torch.launch.serve import reduced_dataset
from repro_torch.models import kgnn as tk


@pytest.mark.parametrize("kw", [
    dict(n_users=30, n_items=40, n_attrs=20, n_relations=3, n_triples=200,
         inter_per_user=6, seed=3),
    # past 4M user*item pairs: the chunked candidate-sampling branch
    dict(n_users=2100, n_items=2000, n_attrs=300, n_relations=4,
         n_triples=500, inter_per_user=3, seed=1),
])
def test_gen_kg_dataset_arrays_equal(kw):
    ref, got = jgen(**kw), tgen(**kw)
    for name in ("src", "dst", "rel"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref.graph, name)))
    np.testing.assert_array_equal(got.train_pos, ref.train_pos)
    np.testing.assert_array_equal(got.test_pos, ref.test_pos)
    assert (got.n_nodes, got.n_users, got.n_items, got.n_entities,
            got.n_relations) == (ref.graph.n_nodes, ref.n_users, ref.n_items,
                                 ref.n_entities, ref.n_relations)
    tr, te = got.interaction_matrices()
    jtr, jte = ref.interaction_matrices()
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(te, jte)


def test_configs_match_jax():
    for red in (False, True):
        j, t = jget("kgat"), tget("kgat")
        if red:
            j, t = jreduced(j), treduced(t)
        jc, tc = j.model_cfg, t.model_cfg
        for f in ("model", "n_users", "n_entities", "n_relations", "dim",
                  "n_layers", "n_bases", "readout"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert tc.n_nodes == jc.n_nodes and tc.dims == jc.dims


def _jax_params_np(jcfg, seed=0):
    p = jk.init_params(jax.random.PRNGKey(seed), jcfg)
    return jax.tree_util.tree_map(np.asarray, p)


def test_propagate_matches_jax():
    jcfg = jreduced(jget("kgat")).model_cfg
    tcfg = treduced(tget("kgat")).model_cfg
    ds = reduced_dataset(tcfg)
    jds = jgen(n_users=jcfg.n_users, n_items=jcfg.n_entities * 3 // 5,
               n_attrs=jcfg.n_entities - jcfg.n_entities * 3 // 5,
               n_relations=(jcfg.n_relations - 2) // 2, n_triples=400,
               inter_per_user=8, seed=0)
    g_j = jax.tree_util.tree_map(jnp.asarray, jds.graph)
    pnp = _jax_params_np(jcfg)
    ref = np.asarray(jk.propagate(jax.tree_util.tree_map(jnp.asarray, pnp),
                                  g_j, jcfg))
    got = tk.propagate(tk.params_from_jax(pnp, device="cpu"),
                       ds.graph("cpu"), tcfg).numpy()
    assert got.shape == ref.shape == (tcfg.n_nodes, tcfg.dim * 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    users, items = ds.train_pos[:9, 0], ds.train_pos[:9, 1]
    np.testing.assert_allclose(
        tk.score_pairs(torch.from_numpy(got), torch.from_numpy(users),
                       torch.from_numpy(items), tcfg.n_users).numpy(),
        np.asarray(jk.score_pairs(jnp.asarray(ref), users, items,
                                  jcfg.n_users)), rtol=0, atol=1e-5)
    # attention sums to one over each destination's edges
    g = ds.graph("cpu")
    att = tk._kgat_attention(tk.params_from_jax(pnp, device="cpu"),
                             torch.from_numpy(np.array(pnp["entity"])), g)
    sums = np.zeros(g.n_nodes)
    np.add.at(sums, ds.dst, att.numpy().astype(np.float64))
    np.testing.assert_allclose(sums, 1.0, atol=1e-6)


def test_init_params_shapes_and_seed():
    cfg = treduced(tget("kgat")).model_cfg
    p = tk.init_params(cfg, seed=4, device="cpu")
    q = tk.init_params(cfg, seed=4, device="cpu")
    jp = _jax_params_np(jreduced(jget("kgat")).model_cfg)
    for name in ("entity", "relation", "att_basis", "att_coef"):
        assert tuple(p[name].shape) == jp[name].shape
        assert torch.equal(p[name], q[name])
    for name in ("w1", "w2"):
        assert [tuple(w.shape) for w in p[name]] == \
            [w.shape for w in jp[name]]
    assert p["entity"].std().item() == pytest.approx(0.1, rel=0.2)
