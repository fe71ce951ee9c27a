"""Decoder-only LM (dense and MoE): GQA, RoPE, RMSNorm, SwiGLU (port of
``repro/models/transformer.py``).

Training: the whole stack is one ACT site, ``lm/block`` wrapped in
``core.act.act_remat`` with ``repeat=n_layers`` (the reference scans one
block over stacked layers): each block keeps only a b-bit copy of its
input, and the backward recomputes the block from the dequantized copy
(TinyKG's mechanism applied block-wise). Under FP32 it is a plain
checkpoint that recomputes from the fp32 input, the reference's baseline.
Each layer draws its rounding noise from its own seed, derived from the
``lm`` site's (``ctx.key_for("<lm>/layer<i>")``; the reference folds the
layer index into the site's key). Attention is the chunked online-softmax
form (``models.attention``).

The token embedding's gradient sums each row's positions in a fixed order
(``core.act.lookup_rows`` over the batch's ``data.csr.lookup_plan``,
the ``segment_sum`` kernel on the card), never ``index_add_``'s atomics;
a forward without a plan must not train the embedding.

Serving: ``init_cache``, ``prefill`` and ``decode_step`` with the cache
laid out (L, B, Smax, Kh, Dh); ``kv_cache_bits=8`` stores it as per-(token,
head) int8 codes with fp32 scale and zero over d_head (``_q8``, nearest
rounding), and each decode step dequantizes a layer's whole cache
(``_dq8``) before attending, as the reference does. The cache is updated
in place; ``len`` is a Python int.

Parameters: one flat dict (``models.layers.param_leaves`` order is the
reference's leaf order): ``emb`` (V, d), ``head`` (d, V), ``ln_f`` (d,)
and, per block parameter ``k`` (``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``,
``wo``, and ``w_gate``, ``w_up``, ``w_down`` or ``moe/router``,
``moe/w_gate``, ``moe/w_up``, ``moe/w_down``), ``blocks/<k>``: a list of
``n_layers`` tensors. ``init_params`` draws them from a seeded
``torch.Generator``; ``params_from_jax`` carries the reference's stacked
tree across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.act import act_remat, lookup_rows
from repro_torch.core.context import current_context
from repro_torch.core.policy import ACTPolicy, PolicySchedule
from repro_torch.core.rng import scope_seed
from repro_torch.kernels.backend import resolve_device

from .attention import chunked_causal_attention, decode_attention, rope
from .moe import PARAMS as MOE_PARAMS
from .moe import MoEConfig, moe_ffn, moe_params

__all__ = ["TransformerConfig", "init_params", "params_from_jax",
           "layer_params", "forward", "lm_loss",
           "init_cache", "cache_bytes", "prefill", "decode_step"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    rope_theta: float = 1e6
    moe: MoEConfig | None = None
    dtype: str = "float32"          # "float32" | "bfloat16"
    q_chunk: int = 512
    kv_chunk: int = 1024
    norm_eps: float = 1e-5
    # int8 KV cache: per-(token, head) row quantization over d_head,
    # nearest rounding
    kv_cache_bits: int | None = None

    @property
    def model(self) -> str:
        """The family's name, for checkpoints and ``PATH_KERNELS``."""
        return "moe_lm" if self.moe is not None else "lm"

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def _attn(self) -> int:
        d = self.d_model
        return d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d

    @property
    def n_params(self) -> int:
        """Total parameter count."""
        d, L = self.d_model, self.n_layers
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_ff \
                + d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        return L * (self._attn() + ffn + 2 * d) + 2 * self.vocab * d + d

    @property
    def n_active_params(self) -> int:
        """Active parameters a token (MoE: the top-k experts only)."""
        if self.moe is None:
            return self.n_params
        d, L = self.d_model, self.n_layers
        ffn = self.moe.top_k * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        return L * (self._attn() + ffn + 2 * d) + 2 * self.vocab * d + d


# -- parameters ---------------------------------------------------------------


def _block_params(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt, dev = cfg.tdtype, gen.device

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    s = d ** -0.5
    p = {"ln1": torch.ones((d,), dtype=dt, device=dev),
         "ln2": torch.ones((d,), dtype=dt, device=dev),
         "wq": normal((d, h * dh), s), "wk": normal((d, kh * dh), s),
         "wv": normal((d, kh * dh), s),
         "wo": normal((h * dh, d), (h * dh) ** -0.5)}
    if cfg.moe is not None:
        p.update({f"moe/{k}": v for k, v in
                  moe_params(gen, d, cfg.moe, dt).items()})
    else:
        p["w_gate"] = normal((d, cfg.d_ff), s)
        p["w_up"] = normal((d, cfg.d_ff), s)
        p["w_down"] = normal((cfg.d_ff, d), cfg.d_ff ** -0.5)
    return p


def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device="cuda") -> dict:
    """The reference's shapes and initializers (embedding N(0, 0.02²),
    projections N(0, 1/fan_in), norms 1), drawn on ``device`` from a
    generator seeded with ``seed``, in ``cfg.dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, dt = cfg.d_model, cfg.tdtype
    emb = (torch.randn((cfg.vocab, d), generator=gen, device=dev)
           * 0.02).to(dt)
    head = (torch.randn((d, cfg.vocab), generator=gen, device=dev)
            * d ** -0.5).to(dt)
    layers = [_block_params(gen, cfg) for _ in range(cfg.n_layers)]
    p = {"emb": emb, "head": head,
         "ln_f": torch.ones((d,), dtype=dt, device=dev)}
    for k in layers[0]:
        p[f"blocks/{k}"] = [layer[k] for layer in layers]
    return p


def params_from_jax(params_np: dict, device="cuda") -> dict:
    """Carry the reference's parameter tree, given as numpy arrays, across:
    ``emb``, ``head``, ``ln_f`` as they are, each stacked ``(L, ...)`` leaf
    of ``blocks`` (the MoE's nested ``moe`` dict too) as its
    ``blocks/<name>`` list of L tensors."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    p = {k: t(params_np[k]) for k in ("emb", "head", "ln_f")}
    for k, v in params_np["blocks"].items():
        items = ({f"moe/{n}": w for n, w in v.items()}
                 if isinstance(v, dict) else {k: v})
        for name, w in items.items():
            p[f"blocks/{name}"] = [t(w[i]) for i in range(len(w))]
    return p


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters by their short names (``wq``,
    ``moe/router``, ...)."""
    return {k[len("blocks/"):]: v[i] for k, v in params.items()
            if k.startswith("blocks/")}


# -- forward ------------------------------------------------------------------


def _rmsnorm(x, gamma, eps):
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * gamma


def _ffn(p: dict, y: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The block's FFN on (B, S, d): the MoE's or the SwiGLU."""
    B, S, d = y.shape
    if cfg.moe is not None:
        out, _aux = moe_ffn({n: p[f"moe/{n}"] for n in MOE_PARAMS},
                            y.reshape(B * S, d), cfg.moe)
        return out.reshape(B, S, d)
    silu = torch.nn.functional.silu
    return (silu(y @ p["w_gate"]) * (y @ p["w_up"])) @ p["w_down"]


def _qkv(p: dict, y, positions, cfg: TransformerConfig):
    B, S, _ = y.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = rope((y @ p["wq"]).reshape(B, S, h, dh), positions, cfg.rope_theta)
    k = rope((y @ p["wk"]).reshape(B, S, kh, dh), positions, cfg.rope_theta)
    v = (y @ p["wv"]).reshape(B, S, kh, dh)
    return q, k, v


def _block_fwd(cfg: TransformerConfig):
    """``fn(params_l, x, positions) -> y``, one block."""
    def fn(p, x, positions):
        B, S, _ = x.shape
        q, k, v = _qkv(p, _rmsnorm(x, p["ln1"], cfg.norm_eps), positions,
                       cfg)
        attn = chunked_causal_attention(q, k, v, q_chunk=cfg.q_chunk,
                                        kv_chunk=cfg.kv_chunk)
        x = x + attn.reshape(B, S, -1) @ p["wo"]
        return x + _ffn(p, _rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)

    return fn


def _layer_seeds(cfg: TransformerConfig, policy, seed):
    """The per-layer rounding seeds: from ``seed``, else from the ambient
    context's ``lm`` site (one seed a layer: ``<lm>/layer<i>``)."""
    L = cfg.n_layers
    if seed is not None:
        return [scope_seed(seed, f"layer{i}") for i in range(L)]
    ctx = current_context()
    if ctx is not None and (ctx.root_seed is not None
                            or ctx.seed_fn is not None):
        lm = ctx.qualify("lm")
        return [ctx.key_for(f"{lm}/layer{i}") for i in range(L)]
    if ctx is not None:
        ctx.check_key("transformer.forward")
    if policy is not None and policy.requires_key:
        raise ValueError(
            "transformer.forward: stochastic rounding under an active "
            "policy needs a seed; pass seed=, or run inside "
            "act_context(..., root_seed=...)")
    return [0] * L


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            policy: ACTPolicy | PolicySchedule | None = None,
            seed: int | None = None, lookup=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab). ``policy``/``seed`` omitted
    resolve from the ambient ``ActContext`` (the block policy at the site
    ``.../lm/block``; the per-layer seeds from the site ``.../lm``).
    ``lookup``: the flat tokens' ``data.csr.lookup_plan`` (needed to train
    ``emb``)."""
    B, S = tokens.shape
    if isinstance(policy, PolicySchedule):
        policy = policy.resolve("remat", "lm/block")
    seeds = _layer_seeds(cfg, policy, seed)
    x = lookup_rows(params["emb"], lookup, tokens.reshape(-1).long())
    x = x.reshape(B, S, cfg.d_model)
    positions = torch.arange(S, device=x.device)
    block = act_remat(_block_fwd(cfg), policy, scope="lm/block",
                      repeat=cfg.n_layers)
    layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    x = block(layers, x, seeds, consts=positions)
    x = _rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["head"]


def lm_loss(params: dict, batch: dict, cfg: TransformerConfig, *,
            policy: ACTPolicy | PolicySchedule | None = None,
            seed: int | None = None) -> torch.Tensor:
    """Next-token cross entropy in fp32. batch: ``tokens`` (B, S + 1), and
    ``lookup``, the plan of ``tokens[:, :-1]``, to train the embedding."""
    tokens = batch["tokens"]
    logits = forward(params, tokens[:, :-1], cfg, policy=policy, seed=seed,
                     lookup=batch.get("lookup"))
    targets = tokens[:, 1:].long()
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold)


# -- serving ------------------------------------------------------------------

_R255 = float(torch.tensor(1.0) / torch.tensor(255.0))  # fl32(1 / 255)


def _q8(x: torch.Tensor):
    """Per-row (last axis) int8 quantization, nearest rounding (half to
    even): (codes uint8, scale, zero), fp32 row stats. ``scale`` is the
    reference's ``(hi - lo) / 255`` as XLA compiles it, a multiply by
    fl32(1/255)."""
    xf = x.to(torch.float32)
    lo = xf.amin(dim=-1, keepdim=True)
    hi = xf.amax(dim=-1, keepdim=True)
    scale = (hi - lo) * _R255
    codes = torch.round((xf - lo) / torch.clamp_min(hi - lo, 1e-12) * 255.0)
    return codes.to(torch.uint8), scale, lo


def _dq8(codes, scale, zero, dtype):
    return (codes.to(torch.float32) * scale + zero).to(dtype)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """An empty cache: ``k``, ``v`` (L, B, max_len, Kh, Dh) in
    ``cfg.dtype``, or with ``kv_cache_bits=8`` uint8 codes beside fp32
    ``k_s``, ``k_z``, ``v_s``, ``v_z`` (L, B, max_len, Kh, 1); ``len`` 0."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    if cfg.kv_cache_bits == 8:
        stat = shape[:-1] + (1,)
        out = {k: torch.zeros(shape, dtype=torch.uint8, device=dev)
               for k in ("k", "v")}
        out.update({k: torch.zeros(stat, dtype=torch.float32, device=dev)
                    for k in ("k_s", "k_z", "v_s", "v_z")})
    else:
        out = {k: torch.zeros(shape, dtype=cfg.tdtype, device=dev)
               for k in ("k", "v")}
    out["len"] = 0
    return out


def cache_bytes(cache: dict) -> int:
    """The bytes a cache's tensors hold."""
    return sum(t.numel() * t.element_size() for t in cache.values()
               if isinstance(t, torch.Tensor))


def _store(cache: dict, i: int, at: slice, k, v, q8: bool) -> None:
    """Write a layer's new keys and values at positions ``at``."""
    if q8:
        for name, t in (("k", k), ("v", v)):
            codes, s, z = _q8(t)
            cache[name][i, :, at] = codes
            cache[f"{name}_s"][i, :, at] = s
            cache[f"{name}_z"][i, :, at] = z
    else:
        cache["k"][i, :, at] = k
        cache["v"][i, :, at] = v


@torch.no_grad()
def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: dict):
    """Prompt ingestion: the training forward (no ACT) while filling the
    cache's first S positions. tokens (B, S) -> (logits of the last
    position (B, vocab), cache)."""
    B, S = tokens.shape
    q8 = cfg.kv_cache_bits == 8
    x = lookup_rows(params["emb"], None, tokens.reshape(-1).long())
    x = x.reshape(B, S, cfg.d_model)
    positions = torch.arange(S, device=x.device)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        q, k, v = _qkv(p, _rmsnorm(x, p["ln1"], cfg.norm_eps), positions,
                       cfg)
        _store(cache, i, slice(0, S), k, v, q8)
        attn = chunked_causal_attention(q, k, v, q_chunk=cfg.q_chunk,
                                        kv_chunk=cfg.kv_chunk)
        x = x + attn.reshape(B, S, -1) @ p["wo"]
        x = x + _ffn(p, _rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
    # the last position's logits only (the reference slices them from the
    # whole (B, S, V) product)
    x = _rmsnorm(x[:, -1], params["ln_f"], cfg.norm_eps)
    cache["len"] = S
    return x @ params["head"], cache


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: TransformerConfig):
    """One decode step. tokens (B, 1) -> (logits (B, vocab), cache), the
    cache written at position ``len`` and ``len`` advanced."""
    B = tokens.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q8 = cfg.kv_cache_bits == 8
    n = cache["len"]
    x = lookup_rows(params["emb"], None, tokens.reshape(-1).long())
    x = x.reshape(B, 1, cfg.d_model)
    pos = torch.tensor([n], device=x.device)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        q, k, v = _qkv(p, _rmsnorm(x, p["ln1"], cfg.norm_eps), pos, cfg)
        _store(cache, i, slice(n, n + 1), k, v, q8)
        if q8:
            k_use = _dq8(cache["k"][i], cache["k_s"][i], cache["k_z"][i],
                         cfg.tdtype)
            v_use = _dq8(cache["v"][i], cache["v_s"][i], cache["v_z"][i],
                         cfg.tdtype)
        else:
            k_use, v_use = cache["k"][i], cache["v"][i]
        attn = decode_attention(q, k_use, v_use, n + 1)
        x = x + attn.reshape(B, 1, h * dh) @ p["wo"]
        x = x + _ffn(p, _rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
    x = _rmsnorm(x, params["ln_f"], cfg.norm_eps)
    cache["len"] = n + 1
    return (x @ params["head"])[:, 0], cache
