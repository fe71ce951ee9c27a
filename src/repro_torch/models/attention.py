"""Attention: chunked-causal (training and prefill) and cached decode, GQA
and RoPE (port of ``repro/models/attention.py``).

Plain PyTorch, as the reference's is plain jnp: no TPU kernel computes
attention there, and this port keeps the reference's algorithm rather
than a library's, so that parity holds and later tuning starts from a
measured baseline:

  * ``chunked_causal_attention`` pads the sequence to the lcm of the two
    chunk lengths, loops over query chunks and runs, for each, only its
    triangle of key/value chunks (fully masked blocks never run), with the
    online-softmax carry (running max, sum, accumulator) in fp32 and the
    probabilities in bf16 for bf16 inputs;
  * GQA repeats each key/value head to its group of query heads inside a
    chunk (``expand``, whose backward is a sum; ``repeat_interleave`` would
    gather, and its backward would scatter with atomics);
  * the reference's dots take ``preferred_element_type=float32``: a bf16
    product accumulated and returned in fp32. Here both operands are
    upcast to fp32 first (bf16 products are exact in fp32), which is the
    same function.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rope", "chunked_causal_attention", "decode_attention"]

_NEG = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D), positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), -ar / half)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _heads(t: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Kh, D) -> (B, S, Kh·g, D), each head repeated g times in
    place (``jnp.repeat(t, g, axis=2)``)."""
    if g == 1:
        return t
    B, S, Kh, D = t.shape
    return t[:, :, :, None, :].expand(B, S, Kh, g, D).reshape(B, S, Kh * g, D)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, q_chunk: int = 512,
                             kv_chunk: int = 512) -> torch.Tensor:
    """Causal attention. q: (B,S,H,D); k,v: (B,S,Kh,D); returns (B,S,H,D)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    scale = D ** -0.5
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, S)
    # pad S up to a chunk multiple; padded keys sit at positions past every
    # real query, so the causal mask hides them; padded query rows are
    # sliced off
    lcm = math.lcm(q_chunk, kv_chunk)
    S_pad = -(-S // lcm) * lcm
    if S_pad != S:
        pad = (0, 0, 0, 0, 0, S_pad - S)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    nq, nk = S_pad // q_chunk, S_pad // kv_chunk
    p_dt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    f32 = torch.float32
    dev = q.device
    kpos_all = torch.arange(S_pad, device=dev)
    outs = []
    for qi in range(nq):
        qb = q[:, qi * q_chunk:(qi + 1) * q_chunk].to(f32)
        qpos = kpos_all[qi * q_chunk:(qi + 1) * q_chunk]
        nk_i = min(((qi + 1) * q_chunk - 1) // kv_chunk + 1, nk)
        m = torch.full((B, H, q_chunk), _NEG, dtype=f32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=f32, device=dev)
        acc = torch.zeros((B, H, q_chunk, D), dtype=f32, device=dev)
        for kj in range(nk_i):
            sl = slice(kj * kv_chunk, (kj + 1) * kv_chunk)
            kb, vb = _heads(k[:, sl], G), _heads(v[:, sl], G)
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb.to(f32)) * scale
            mask = qpos[:, None] >= kpos_all[sl][None, :]
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            0.0).to(p_dt)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, dtype=f32)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(f32), vb.to(p_dt).to(f32))
            m = m_new
        out_i = acc / torch.clamp_min(l, 1e-30)[..., None]    # (B,H,qc,D)
        outs.append(out_i.transpose(1, 2))                    # (B,qc,H,D)
    return torch.cat(outs, dim=1).to(q.dtype)[:, :S]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """One-token decode. q: (B,1,H,D); caches: (B,Smax,Kh,D); positions
    ``>= cache_len`` are masked."""
    B, _, H, D = q.shape
    Smax, Kh = k_cache.shape[1], k_cache.shape[2]
    G = H // Kh
    f32 = torch.float32
    qg = q.reshape(B, Kh, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg.to(f32),
                     k_cache.to(f32)) * (D ** -0.5)
    mask = torch.arange(Smax, device=q.device)[None, None, None, :] \
        < cache_len
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).to(f32),
                       v_cache.to(f32))
    return out.reshape(B, 1, H, D).to(q.dtype)
