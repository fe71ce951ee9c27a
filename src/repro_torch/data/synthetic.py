"""Synthetic KG recommendation datasets and BPR sampler, the GCN's
node-classification graphs, the LM token stream and the CTR batches of the
recsys models (port of ``repro/data/synthetic.py:31-197``, ``:201``
``lm_batches``, ``:217`` ``criteo_batches`` and ``:241`` ``cora_like``).

``gen_kg_dataset``, ``gen_zipf_kg_dataset`` and ``bpr_batches`` make the
same numpy calls in the same order as the JAX package's, so the same
arguments and seed give identical arrays. ``gen_kg_dataset`` is
latent-factor user/item affinities plus an item KG whose relations link
items to attributes that share latent directions. The CKG node space is
``[users | items | attrs]``; relation 0 is ``interact`` (both directions),
KG relations are shifted by 1 with distinct inverses, and self loops take
the last relation id.

``cora_like`` is the reference's homophilous graph with class-Gaussian
features, the same numpy calls in the same order; ``cora_like_avg_deg``
picks the ``avg_deg`` that brings its edge count nearest a shape's, and
``molecule_batch`` draws the batched small graphs of the ``molecule`` shape.
``criteo_batches`` is the reference's planted-logistic CTR stream and
``lm_batches`` its noisy affine-bigram token stream, the same numpy calls
in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["KGDataset", "gen_kg_dataset", "gen_zipf_kg_dataset",
           "bpr_batches", "criteo_batches", "lm_batches", "cora_like",
           "cora_like_avg_deg", "molecule_batch"]


@dataclasses.dataclass
class KGDataset:
    src: np.ndarray           # (E,) int32 CKG edge sources
    dst: np.ndarray           # (E,) int32 CKG edge destinations
    rel: np.ndarray           # (E,) int32 relation ids
    n_nodes: int
    n_users: int
    n_items: int
    n_entities: int           # items + attributes
    n_relations: int
    train_pos: np.ndarray     # (n_train, 2) user, item
    test_pos: np.ndarray      # (n_test, 2)

    def graph(self, device="cuda", **layout_kw):
        """The CKG as tensors on ``device``, with its blocked-CSR layout."""
        from repro_torch.models.kgnn import CKG

        return CKG.build(self.src, self.dst, self.rel, n_nodes=self.n_nodes,
                         n_relations=self.n_relations, device=device,
                         **layout_kw)

    def interaction_matrices(self, n_users: int | None = None):
        """Dense bool (U, I) train/test matrices for Recall/NDCG eval, over
        the first ``n_users`` users (all by default)."""
        u = self.n_users if n_users is None else n_users
        out = []
        for pos in (self.train_pos, self.test_pos):
            m = np.zeros((u, self.n_items), bool)
            pos = pos[pos[:, 0] < u]
            m[pos[:, 0], pos[:, 1]] = True
            out.append(m)
        return tuple(out)


def gen_kg_dataset(*, n_users=200, n_items=300, n_attrs=150, n_relations=6,
                   n_triples=2000, inter_per_user=20, d_latent=8,
                   test_frac=0.2, seed=0) -> KGDataset:
    """User-item interactions + item KG with shared latent structure."""
    rng = np.random.default_rng(seed)
    u_lat = rng.normal(size=(n_users, d_latent)).astype(np.float32)
    i_lat = rng.normal(size=(n_items, d_latent)).astype(np.float32)
    a_lat = rng.normal(size=(n_attrs, d_latent)).astype(np.float32)

    if n_users * n_items <= 4_000_000:
        # small graphs: exact per-user top items
        scores = u_lat @ i_lat.T \
            + 0.5 * rng.gumbel(size=(n_users, n_items)).astype(np.float32)
        items = np.argsort(-scores, axis=1)[:, :inter_per_user]
        inter = np.stack([
            np.repeat(np.arange(n_users), inter_per_user),
            items.reshape(-1)], axis=1).astype(np.int64)
    else:
        # large graphs: per-user top items among a candidate sample,
        # chunked (the dense users x items score matrix would not fit)
        n_cand = min(max(8 * inter_per_user, 64), n_items)
        chunk = max(1, min(n_users, (1 << 22) // n_cand))
        inter_u, inter_i = [], []
        for u0 in range(0, n_users, chunk):
            u1 = min(u0 + chunk, n_users)
            cand = rng.integers(0, n_items, (u1 - u0, n_cand))
            scores = np.einsum("ud,ucd->uc", u_lat[u0:u1], i_lat[cand]) \
                + 0.5 * rng.gumbel(
                    size=(u1 - u0, n_cand)).astype(np.float32)
            top = np.argpartition(-scores, inter_per_user - 1,
                                  axis=1)[:, :inter_per_user]
            inter_u.append(np.repeat(np.arange(u0, u1), inter_per_user))
            inter_i.append(np.take_along_axis(cand, top, axis=1).reshape(-1))
        inter = np.stack([np.concatenate(inter_u),
                          np.concatenate(inter_i)], axis=1).astype(np.int64)
        inter = np.unique(inter, axis=0)  # candidate sampling can repeat
    rng.shuffle(inter)
    n_test = int(len(inter) * test_frac)
    test_pos, train_pos = inter[:n_test], inter[n_test:]

    # KG triples: relation r links item->attr when their latents align on
    # a relation-specific direction (so relations carry signal)
    rel_dirs = rng.normal(size=(n_relations, d_latent))
    heads = rng.integers(0, n_items, n_triples)
    rels = rng.integers(0, n_relations, n_triples)
    cand = rng.integers(0, n_attrs, (n_triples, 8))
    align = np.einsum("td,tcd->tc", i_lat[heads] * rel_dirs[rels],
                      a_lat[cand])
    tails = cand[np.arange(n_triples), np.argmax(align, 1)]

    # CKG node space: [users | items | attrs]
    n_entities = n_items + n_attrs
    src_list, dst_list, rel_list = [], [], []
    u_nodes = train_pos[:, 0]
    i_nodes = n_users + train_pos[:, 1]
    src_list += [u_nodes, i_nodes]
    dst_list += [i_nodes, u_nodes]
    rel_list += [np.zeros(len(train_pos), np.int64)] * 2
    h_nodes = n_users + heads
    t_nodes = n_users + n_items + tails
    src_list += [h_nodes, t_nodes]
    dst_list += [t_nodes, h_nodes]
    rel_list += [rels + 1, rels + 1 + n_relations]  # inverse rels distinct
    n_nodes = n_users + n_entities
    loops = np.arange(n_nodes)
    src_list.append(loops)
    dst_list.append(loops)
    rel_list.append(np.full(n_nodes, 2 * n_relations + 1, np.int64))

    return KGDataset(
        src=np.concatenate(src_list).astype(np.int32),
        dst=np.concatenate(dst_list).astype(np.int32),
        rel=np.concatenate(rel_list).astype(np.int32),
        n_nodes=n_nodes, n_users=n_users, n_items=n_items,
        n_entities=n_entities, n_relations=2 * n_relations + 2,
        train_pos=train_pos, test_pos=test_pos)


def gen_zipf_kg_dataset(*, n_users=300, n_items=500, n_attrs=200,
                        n_relations=6, n_triples=6000, inter_per_user=20,
                        zipf_a=1.1, test_frac=0.2, seed=0) -> KGDataset:
    """KG with Zipf-skewed in-degree, the data-tiering setting: item and
    attribute popularity follow ``p(rank) ∝ rank^-a``, so a small share of
    the entity rows receives most neighbour-sample requests (the hot/cold
    tier store's graph). Same node space and relation layout as
    ``gen_kg_dataset``."""
    rng = np.random.default_rng(seed)

    def zipf_choice(n, size):
        p = 1.0 / np.arange(1, n + 1) ** zipf_a
        return rng.choice(n, size=size, p=p / p.sum())

    inter = np.stack([
        np.repeat(np.arange(n_users), inter_per_user),
        zipf_choice(n_items, n_users * inter_per_user)], axis=1)
    inter = np.unique(inter.astype(np.int64), axis=0)
    rng.shuffle(inter)
    n_test = int(len(inter) * test_frac)
    test_pos, train_pos = inter[:n_test], inter[n_test:]

    heads = zipf_choice(n_items, n_triples).astype(np.int64)
    rels = rng.integers(0, n_relations, n_triples)
    tails = zipf_choice(n_attrs, n_triples).astype(np.int64)

    n_entities = n_items + n_attrs
    n_nodes = n_users + n_entities
    u_nodes, i_nodes = train_pos[:, 0], n_users + train_pos[:, 1]
    h_nodes, t_nodes = n_users + heads, n_users + n_items + tails
    loops = np.arange(n_nodes)
    return KGDataset(
        src=np.concatenate([u_nodes, i_nodes, h_nodes, t_nodes,
                            loops]).astype(np.int32),
        dst=np.concatenate([i_nodes, u_nodes, t_nodes, h_nodes,
                            loops]).astype(np.int32),
        rel=np.concatenate([
            np.zeros(2 * len(train_pos), np.int64), rels + 1,
            rels + 1 + n_relations,
            np.full(n_nodes, 2 * n_relations + 1)]).astype(np.int32),
        n_nodes=n_nodes, n_users=n_users, n_items=n_items,
        n_entities=n_entities, n_relations=2 * n_relations + 2,
        train_pos=train_pos, test_pos=test_pos)


def bpr_batches(ds: KGDataset, batch_size: int, *, seed=0):
    """Infinite (user, pos, neg) sampler with rejection on train positives;
    numpy int32 arrays."""
    rng = np.random.default_rng(seed)
    pos_set = set(map(tuple, ds.train_pos))
    n = len(ds.train_pos)
    while True:
        idx = rng.integers(0, n, batch_size)
        users = ds.train_pos[idx, 0]
        pos = ds.train_pos[idx, 1]
        neg = rng.integers(0, ds.n_items, batch_size)
        for i in range(batch_size):  # cheap rejection (sparse interactions)
            while (users[i], neg[i]) in pos_set:
                neg[i] = rng.integers(0, ds.n_items)
        yield {"user": users.astype(np.int32), "pos": pos.astype(np.int32),
               "neg": neg.astype(np.int32)}


def criteo_batches(*, batch: int, n_dense: int, vocab_sizes, seed=0,
                   zipf_a: float = 1.2):
    """Planted-logistic CTR batches with Zipf-distributed categorical ids:
    dicts of ``sparse`` (batch, F) int32, ``dense`` (batch, n_dense)
    float32 and ``label`` (batch,) float32."""
    rng = np.random.default_rng(seed)
    vocab_sizes = np.asarray(vocab_sizes)
    F = len(vocab_sizes)
    w_dense = rng.normal(size=n_dense) * 0.5
    # planted per-field hash weights (cheap stand-in for per-id weights)
    w_field = rng.normal(size=(F, 64)) * 0.6
    while True:
        dense = rng.lognormal(0.0, 1.0, (batch, n_dense)).astype(np.float32)
        dense = np.log1p(dense)
        sparse = np.empty((batch, F), np.int64)
        for f, v in enumerate(vocab_sizes):
            z = rng.zipf(zipf_a, batch)
            sparse[:, f] = np.minimum(z - 1, v - 1)
        logit = dense @ w_dense + sum(
            w_field[f, sparse[:, f] % 64] for f in range(F))
        prob = 1 / (1 + np.exp(-(logit - logit.mean())))
        labels = (rng.random(batch) < prob).astype(np.float32)
        yield {"sparse": sparse.astype(np.int32), "dense": dense,
               "label": labels}


def cora_like(*, n_nodes=500, d_feat=64, n_classes=7, avg_deg=4, seed=0):
    """Homophilous graph with class-Gaussian features (+ self loops):
    ``(feats (n, d_feat) float32, src, dst (E,) int32, labels (n,)
    int32)``, every undirected edge in both directions."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    centers = rng.normal(size=(n_classes, d_feat)) * 2.0
    feats = centers[labels] + rng.normal(size=(n_nodes, d_feat))
    n_edges = n_nodes * avg_deg // 2
    src = rng.integers(0, n_nodes, 4 * n_edges)
    dst = rng.integers(0, n_nodes, 4 * n_edges)
    same = labels[src] == labels[dst]
    keep = same | (rng.random(4 * n_edges) < 0.15)  # mostly homophilous
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    src_all = np.concatenate([src, dst, np.arange(n_nodes)])
    dst_all = np.concatenate([dst, src, np.arange(n_nodes)])
    return (feats.astype(np.float32), src_all.astype(np.int32),
            dst_all.astype(np.int32), labels.astype(np.int32))


def cora_like_avg_deg(n_nodes: int, n_edges: int, n_classes: int) -> int:
    """The ``avg_deg`` whose expected ``cora_like`` edge count, self loops
    included, comes nearest ``n_edges``. Of the ``4 * n_nodes * avg_deg //
    2`` candidate pairs a share ``1 / C + 0.15 (1 - 1 / C)`` survives (C
    classes), at most ``n_nodes * avg_deg // 2`` are kept, and each kept
    pair gives two edges."""
    share = 1.0 / n_classes + 0.15 * (1.0 - 1.0 / n_classes)

    def expected(avg):
        cap = n_nodes * avg // 2
        return 2 * min(cap, 4 * cap * share) + n_nodes

    guess = max(1, round((n_edges - n_nodes) / (n_nodes * min(1.0,
                                                              4 * share))))
    return min(range(max(1, guess - 2), guess + 3),
               key=lambda a: abs(expected(a) - n_edges))


def molecule_batch(*, n_graphs=128, n_nodes=30, n_edges=64, d_feat=32,
                   n_classes=2, seed=0):
    """``n_graphs`` small graphs of ``n_nodes`` nodes, each with
    ``n_edges`` random directed edges and a self loop a node, laid out
    block-diagonally: ``(feats (B*n, d_feat) float32, src, dst
    (B*(e+n),) int32, graph_ids (B*n,) int32, labels (B,) int32)``. The
    edge draws are the reference's batched-graph test's
    (``tests/test_arch_smoke.py``); the self loops make the ``molecule``
    cell's ``B * (e + n)`` edges."""
    rng = np.random.default_rng(seed)
    B, n, e = n_graphs, n_nodes, n_edges
    src = np.concatenate([rng.integers(0, n, e) + i * n for i in range(B)])
    dst = np.concatenate([rng.integers(0, n, e) + i * n for i in range(B)])
    loops = np.arange(B * n)
    feats = rng.normal(size=(B * n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, B)
    return (feats, np.concatenate([src, loops]).astype(np.int32),
            np.concatenate([dst, loops]).astype(np.int32),
            np.repeat(np.arange(B), n).astype(np.int32),
            labels.astype(np.int32))


def lm_batches(*, vocab: int, batch: int, seq: int, seed=0,
               noise: float = 0.1):
    """Noisy affine-bigram token stream (port of the reference's):
    ``next = (a·prev + c) mod V`` with probability 1-ε, else uniform; each
    batch ``{"tokens": (batch, seq + 1) int32}``."""
    rng = np.random.default_rng(seed)
    a, c = 31, 7
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        for t in range(1, seq + 1):
            nxt = (a * toks[:, t - 1] + c) % vocab
            flip = rng.random(batch) < noise
            nxt = np.where(flip, rng.integers(0, vocab, batch), nxt)
            toks[:, t] = nxt
        yield {"tokens": toks}
