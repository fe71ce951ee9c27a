"""Mixture-of-Experts FFN: top-k token choice with grouped, sort-based
dispatch (port of ``repro/models/moe.py``).

GShard-style grouped dispatch, as the reference's: tokens split into
``n_groups`` groups, each group routed on its own:

  1. top-k gates a token (renormalised to sum 1);
  2. a stable argsort of the group's expert choices; a choice's position
     in its expert is its rank less the expert's first rank;
  3. choices past the capacity ``C = max(int(Tg·k·cf / E), 1)`` are
     dropped (their gate counts 0);
  4. the kept choices fill an (E, C, d) buffer, the experts' SwiGLU runs
     batched, and each token sums its k slots' outputs, gate-weighted.

The load-balancing auxiliary loss is the Switch/GShard one, over all
groups.

Every gather of the dispatch and the combine is a partial bijection
(``_route``): a buffer slot is filled by at most one choice and a choice
fills at most one slot, so both directions of autograd are gathers and
nothing is summed by atomics. The reference's ``xg[st]`` gather (a token
read k times) becomes ``expand`` over the k choices, whose backward is a
sum over them, and its ``.at[st].add`` combine a sum over each token's k
slots in choice order: the same bits every run, on the card too.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["MoEConfig", "moe_params", "moe_ffn", "PARAMS"]

# a layer's MoE parameters, in the reference's (sorted) order
PARAMS = ("router", "w_down", "w_gate", "w_up")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    n_groups: int = 1        # bound to the data-shard count by the launcher


def moe_params(gen: torch.Generator, d_model: int, cfg: MoEConfig,
               dtype=torch.float32) -> dict:
    """The reference's shapes and scales (router and up-projections
    N(0, 1/d), down N(0, 1/F)), drawn from ``gen`` on its device."""
    E, F = cfg.n_experts, cfg.d_ff

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * std).to(dtype)

    s_in, s_ff = d_model ** -0.5, F ** -0.5
    return {"router": normal((d_model, E), s_in),
            "w_gate": normal((E, d_model, F), s_in),
            "w_up": normal((E, d_model, F), s_in),
            "w_down": normal((E, F, d_model), s_ff)}


class _Route(torch.autograd.Function):
    """``out = cat([x, 0]).index_select(0, fwd)``, for a partial bijection:
    every row of ``x`` is read by at most one output row, the rest read the
    zero row ``n``. The backward is the inverse gather ``bwd`` (the output
    row that read each input row, or the zero row), no accumulation."""

    @staticmethod
    def forward(fctx, x, fwd, bwd):
        fctx.save_for_backward(bwd)
        return torch.cat([x, x.new_zeros((1,) + x.shape[1:])]) \
            .index_select(0, fwd)

    @staticmethod
    def backward(fctx, g):
        (bwd,) = fctx.saved_tensors
        gz = torch.cat([g, g.new_zeros((1,) + g.shape[1:])])
        return gz.index_select(0, bwd), None, None


def _routing(idx: torch.Tensor, E: int, C: int):
    """One group's routing from its (Tg, k) expert choices: ``slot_src``
    (E·C,), the choice (row ``t·k + s`` of the expanded tokens) filling
    each buffer slot or ``Tg·k`` where it stays empty, and ``choice_slot``
    (Tg·k,), the slot each choice fills or ``E·C`` where it is dropped."""
    n = idx.numel()
    dev = idx.device
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(n, device=dev) - starts[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)    # E·C: dropped
    choice_slot = torch.empty_like(slot).scatter_(0, order, slot)
    slot_src = torch.full((E * C + 1,), n, dtype=order.dtype, device=dev)
    slot_src.scatter_(0, slot, order)                # only E·C collides
    return slot_src[:E * C], choice_slot


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x: (T, d) token-major. Returns (y (T, d), aux_loss fp32 scalar)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = cfg.n_groups if T % cfg.n_groups == 0 else 1
    Tg = T // G
    C = max(int(Tg * k * cfg.capacity_factor / E), 1)

    xg = x.reshape(G, Tg, d)
    logits = xg @ params["router"].to(x.dtype)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)              # (G, Tg, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # load-balancing auxiliary loss (Switch/GShard), global over groups
    density = torch.nn.functional.one_hot(idx[..., 0], E).to(
        torch.float32).mean(dim=(0, 1))
    density_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(density * density_prob)

    w_gate = params["w_gate"].to(x.dtype)
    w_up = params["w_up"].to(x.dtype)
    w_down = params["w_down"].to(x.dtype)
    ys = []
    for gi in range(G):
        slot_src, choice_slot = _routing(idx[gi], E, C)
        keep = (choice_slot < E * C).reshape(Tg, k)
        xk = xg[gi][:, None, :].expand(Tg, k, d).reshape(Tg * k, d)
        buf = _Route.apply(xk, slot_src, choice_slot).reshape(E, C, d)
        # batched expert SwiGLU
        g = torch.bmm(buf, w_gate)
        u = torch.bmm(buf, w_up)
        out = torch.bmm(torch.nn.functional.silu(g) * u, w_down)
        back = _Route.apply(out.reshape(E * C, d), choice_slot, slot_src)
        # dropped choices read the zero row and count 0
        gate = (gates[gi] * keep).to(x.dtype)
        ys.append((back.reshape(Tg, k, d) * gate[..., None]).sum(dim=1))
    y = torch.stack(ys) if G > 1 else ys[0][None]
    return y.reshape(T, d), aux.to(torch.float32)
