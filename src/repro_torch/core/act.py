"""Activation-compressed ops (port of ``repro/core/act.py``, the paper's core
mechanism, section 3.3).

Each op computes an EXACT full-precision forward; what differs from vanilla
autograd is the *residual* it saves for the backward pass:

  vanilla:  save x (fp32)                  -> O(N*d*4) bytes
  TinyKG:   save Quant(x) (b-bit packed)   -> O(N*d*b/8) bytes (+2 fp32/row)

Under an active policy each ``torch.autograd.Function`` below saves the
packed ``QTensor`` and never the fp32 input; under FP32 it saves the input,
as vanilla autograd would. The backward computes full-precision gradients
from the dequantized residual, unbiased because the quantizer is
(Proposition 1). The port has the reference's layout path only: the SPMM's
backward runs the SPMM kernel on the transpose arrays for ∇x and the SDDMM
(fp32 or packed residual) for ∇ew; ``act_matmul``'s ∇W is the fused
dequant-matmul kernel. ``act_rmsnorm`` saves its input (quantized) and
recomputes the rstd in the backward; ``act_remat`` wraps a whole block
(the transformer's): the forward saves only Quant(x) and references to the
block's parameters, and the backward dequantizes x and recomputes the
block under autograd (gradient checkpointing whose checkpoint is b-bit
compressed); under an inactive policy it is a plain checkpoint that
recomputes from the fp32 input (``torch.utils.checkpoint``), the
reference's ``jax.checkpoint`` baseline.

``gather_rows`` (and ``lookup_rows``, an embedding lookup through it) is no
ACT site: it is ``index_select`` with a backward that sums each table row's
gradient in a fixed order (``ops.segment_sum`` over a precomputed grouping
of the edges), where ``index_select``'s own backward, ``index_add_``, adds
with atomics on the card and so changes the last bits from run to run.
``sum_rows`` is its transpose: that fixed-order sum forward, the gather
backward.

Site resolution follows the reference: explicit ``seed=`` / ``policy=``
kwargs first, then the ambient ``ActContext`` at the site named ``scope``;
with neither, the policy is FP32. Every resolved site records its residual
(shape, bits) on the context for the activation-memory report.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops

from .context import current_context
from .policy import FP32, ACTPolicy
from .quant import QTensor, dequantize

__all__ = ["act_matmul", "act_dense", "act_relu", "act_nonlin", "act_spmm",
           "act_rmsnorm", "act_remat", "weighted_spmm", "gather_rows",
           "lookup_rows", "sum_rows", "NONLIN"]


def _resolve_site(op_kind: str, scope: str | None, seed,
                  policy: ACTPolicy | None):
    """(scope, policy, seed, ctx) for one op call; see module docstring."""
    ctx = current_context()
    name = None
    if ctx is not None:
        name = ctx.qualify(scope or op_kind)
        if policy is None:
            policy = ctx.policy_for(op_kind, name)
        if seed is None:
            seed = ctx.key_for(name)
    if policy is None:
        policy = FP32
    if seed is None:
        if policy.requires_key:
            raise ValueError(
                f"act op {name or scope or op_kind!r}: stochastic rounding "
                "under an active policy needs a seed; pass seed=, or run "
                "inside act_context(..., root_seed=...). (A fixed default "
                "seed would replay identical rounding noise.)")
        seed = 0
    return name, policy, seed, ctx


def _record(ctx, name, op_kind, shape, policy: ACTPolicy) -> None:
    # bits=None prices the uncompressed fp32 residual: what vanilla
    # autograd keeps when the policy is inactive
    if ctx is not None and name is not None:
        ctx.record(name, op_kind, shape,
                   policy.bits if policy.active else None)


def _save(fctx, x: torch.Tensor, seed: int, policy: ACTPolicy, *rest):
    """Save ``x`` as the op's residual (quantized under an active policy)
    plus the tensors ``rest``."""
    if policy.active:
        fctx.q = ops.quantize(x.detach().reshape(-1, x.shape[-1]), seed,
                              bits=policy.bits, stochastic=policy.stochastic)
        fctx.save_for_backward(*rest)
    else:
        fctx.q = None
        fctx.save_for_backward(x, *rest)
    fctx.x_shape = x.shape


def _load(fctx):
    """(residual, rest): a 2-D ``QTensor`` or the saved fp32 input."""
    saved = fctx.saved_tensors
    if fctx.q is not None:
        return fctx.q, saved
    return saved[0], saved[1:]


def _xhat(res, shape) -> torch.Tensor:
    return dequantize(res).reshape(shape) if isinstance(res, QTensor) else res


# -- matmul / dense -----------------------------------------------------------


class _ActMatmul(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, w, policy, seed):
        _save(fctx, x, seed, policy, w)
        return x @ w

    @staticmethod
    def backward(fctx, g):
        res, (w,) = _load(fctx)
        dx = dw = None
        if fctx.needs_input_grad[0]:
            dx = g @ w.T
        if fctx.needs_input_grad[1]:
            g2 = g.reshape(-1, g.shape[-1])
            if isinstance(res, QTensor):
                dw = ops.dequant_matmul(res, g2)    # x_hat never formed
            else:
                dw = res.reshape(-1, res.shape[-1]).T @ g2
        return dx, dw, None, None


def act_matmul(x, w, *, seed=None, policy: ACTPolicy | None = None,
               scope: str | None = None):
    """``x @ w`` with b-bit residual storage of ``x``; ∇W runs the fused
    dequant-matmul kernel under an active policy, ∇x is ``g @ wᵀ``."""
    name, policy, seed, ctx = _resolve_site("matmul", scope, seed, policy)
    _record(ctx, name, "matmul", x.shape, policy)
    return _ActMatmul.apply(x, w, policy, seed)


def act_dense(x, w, b, *, seed=None, policy: ACTPolicy | None = None,
              scope: str | None = None):
    """Affine layer; the bias gradient needs no activation."""
    out = act_matmul(x, w, seed=seed, policy=policy, scope=scope)
    return out if b is None else out + b


# -- elementwise nonlinearities -----------------------------------------------


class _ActRelu(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x):
        mask = x > 0
        fctx.save_for_backward(mask)       # bool mask: 1 bit/elt in principle
        return torch.where(mask, x, 0.0)

    @staticmethod
    def backward(fctx, g):
        (mask,) = fctx.saved_tensors
        return torch.where(mask, g, 0.0)


def act_relu(x, *, scope: str | None = None):
    """ReLU with a 1-bit exact mask residual (paper section 4.1.4): lossless
    at any policy; under a context the mask is still recorded."""
    ctx = current_context()
    if ctx is not None:
        ctx.record(ctx.qualify(scope or "relu"), "relu", x.shape, 1,
                   exact_mask=True)
    return _ActRelu.apply(x)


# tanh-approximate gelu; the constant rounded to fp32 as the reference's
# jnp.sqrt(2 / jnp.pi) is
_GELU_C = float(torch.sqrt(torch.tensor(2 / math.pi, dtype=torch.float32)))


def _gelu(x):
    return 0.5 * x * (1 + torch.tanh(_GELU_C * (x + 0.044715 * (x * x * x))))


def _d_gelu(x):
    t = torch.tanh(_GELU_C * (x + 0.044715 * (x * x * x)))
    dt = (1 - t * t) * _GELU_C * (1 + 3 * 0.044715 * (x * x))
    return 0.5 * (1 + t) + 0.5 * x * dt


def _d_silu(x):
    s = torch.sigmoid(x)
    return s * (1 + x * (1 - s))


def _d_sigmoid(x):
    s = torch.sigmoid(x)
    return s * (1 - s)


def _d_tanh(x):
    t = torch.tanh(x)
    return 1 - t * t


NONLIN = {
    "silu": (torch.nn.functional.silu, _d_silu),
    "gelu": (_gelu, _d_gelu),
    "tanh": (torch.tanh, _d_tanh),
    "sigmoid": (torch.sigmoid, _d_sigmoid),
    "leaky_relu": (lambda x: torch.where(x > 0, x, 0.01 * x),
                   lambda x: torch.where(x > 0, 1.0, 0.01).to(x.dtype)),
}


class _ActNonlin(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, fn, policy, seed):
        _save(fctx, x, seed, policy)
        fctx.fn = fn
        return NONLIN[fn][0](x)

    @staticmethod
    def backward(fctx, g):
        res, _ = _load(fctx)
        dfn = NONLIN[fctx.fn][1]
        return g * dfn(_xhat(res, fctx.x_shape)), None, None, None


def act_nonlin(x, *, fn: str, seed=None, policy: ACTPolicy | None = None,
               scope: str | None = None):
    """Elementwise nonlinearity (``NONLIN``) saving a quantized copy of its
    input; the backward evaluates the derivative at the dequantized input."""
    name, policy, seed, ctx = _resolve_site("nonlin", scope or fn, seed,
                                            policy)
    _record(ctx, name, "nonlin", x.shape, policy)
    return _ActNonlin.apply(x, fn, policy, seed)


# -- RMSNorm --------------------------------------------------------------------


class _ActRmsnorm(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, gamma, eps, policy, seed):
        _save(fctx, x, seed, policy, gamma)
        fctx.eps = eps
        r = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        return x * r * gamma

    @staticmethod
    def backward(fctx, g):
        res, (gamma,) = _load(fctx)
        xhat = _xhat(res, fctx.x_shape).to(torch.float32)
        gf = g.to(torch.float32)
        d = xhat.shape[-1]
        r = torch.rsqrt(torch.mean(xhat * xhat, dim=-1, keepdim=True)
                        + fctx.eps)
        gg = gf * gamma.to(torch.float32)
        dot = torch.sum(gg * xhat, dim=-1, keepdim=True)
        dx = r * gg - (r ** 3 / d) * dot * xhat
        dgamma = torch.sum(gf * xhat * r, dim=tuple(range(g.ndim - 1)))
        return dx.to(g.dtype), dgamma.to(gamma.dtype), None, None, None


def act_rmsnorm(x, gamma, *, seed=None, policy: ACTPolicy | None = None,
                scope: str | None = None, eps: float = 1e-6):
    """RMSNorm storing its input quantized; the backward recomputes the rstd
    from the dequantized input (the reference's formulas)."""
    name, policy, seed, ctx = _resolve_site("rmsnorm", scope, seed, policy)
    _record(ctx, name, "rmsnorm", x.shape, policy)
    if not policy.enabled:
        r = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        return x * r * gamma
    return _ActRmsnorm.apply(x, gamma, eps, policy, seed)


# -- compressed checkpoint of a whole block -------------------------------------


class _ActRemat(torch.autograd.Function):
    @staticmethod
    def forward(fctx, fn, keys, consts, policy, seed, x, *leaves):
        _save(fctx, x, seed, policy, *leaves)
        fctx.fn, fctx.keys, fctx.consts = fn, keys, consts
        return fn(dict(zip(keys, leaves)), x, consts)

    @staticmethod
    def backward(fctx, g):
        res, leaves = _load(fctx)
        need = fctx.needs_input_grad[6:]
        xhat = _xhat(res, fctx.x_shape).detach().requires_grad_(True)
        ps = [t.detach().requires_grad_(n) for t, n in zip(leaves, need)]
        with torch.enable_grad():
            y = fctx.fn(dict(zip(fctx.keys, ps)), xhat, fctx.consts)
        wants = [xhat] + [t for t, n in zip(ps, need) if n]
        got = iter(torch.autograd.grad(y, wants, g))
        dx = next(got)
        return (None, None, None, None, None, dx,
                *[next(got) if n else None for n in need])


def act_remat(fn: Callable, policy: ACTPolicy | None = None, *,
              scope: str | None = None, repeat: int = 1):
    """Wrap ``fn(params, x, consts) -> y`` (``params`` a dict of tensors) to
    save only Quant(x) for the backward, which dequantizes x̂ and recomputes
    ``fn`` under autograd: one wrapper ACT-ifies a whole block with
    O(N·d·b/8) residual bytes. Returns ``apply(params, x, seed=None,
    consts=None)``; under an inactive policy it is a plain checkpoint
    (recompute from the fp32 input). ``policy=None`` resolves from the
    ambient context at call time (site ``scope`` / ``"remat"``).

    ``repeat`` is the reference's scan over stacked layers: ``apply`` then
    takes a list of ``repeat`` parameter dicts and runs the layers in
    order, one residual recorded a layer (``name``, ``name[1]``, ...), the
    site resolved once; ``seed`` is then a list of per-layer seeds (None:
    the site's one seed for every layer, as the reference's scan reuses a
    resolved key).
    """

    def one(p: dict, x, pol, seed, consts):
        keys = tuple(p)
        leaves = [p[k] for k in keys]
        if not pol.active:
            return torch.utils.checkpoint.checkpoint(
                lambda xx, *ls: fn(dict(zip(keys, ls)), xx, consts), x,
                *leaves, use_reentrant=False)
        return _ActRemat.apply(fn, keys, consts, pol, seed, x, *leaves)

    def apply(params, x, seed=None, consts=None):
        layer_seeds = seed if repeat > 1 else None
        if repeat > 1 and seed is not None:
            seed = 0          # the per-layer seeds are given: resolve none
        name, pol, seed0, ctx = _resolve_site("remat", scope, seed, policy)
        _record(ctx, name, "remat", x.shape, pol)
        for i in range(1, repeat):
            _record(ctx, None if name is None else f"{name}[{i}]", "remat",
                    x.shape, pol)
        if repeat == 1:
            return one(params, x, pol, seed0, consts)
        if layer_seeds is None:
            layer_seeds = [seed0] * repeat
        for p, s in zip(params, layer_seeds, strict=True):
            x = one(p, x, pol, s, consts)
        return x

    return apply


# -- SPMM (KG message passing, paper Eq. 2) -----------------------------------


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ew, layout, policy, seed):
        fctx.layout = layout
        fctx.weighted = ew is not None
        if fctx.weighted:        # x is read by ∇ew only
            _save(fctx, x, seed, policy, ew)
        return ops.spmm(x, ew, layout)

    @staticmethod
    def backward(fctx, g):
        if not fctx.weighted:    # linear in x: index-only residuals
            return (ops.spmm(g, None, fctx.layout, transpose=True), None,
                    None, None, None)
        res, (ew,) = _load(fctx)
        dx = dew = None
        if fctx.needs_input_grad[0]:
            # ∇x: the same kernel on the layout's src-sorted direction
            dx = ops.spmm(g, ew, fctx.layout, transpose=True)
        if fctx.needs_input_grad[1]:
            # ∇ew: the SDDMM, reading a packed residual directly
            dew = ops.spmm_grad_ew(res, g, fctx.layout)
        return dx, dew, None, None, None


def weighted_spmm(x, ew, layout):
    """Differentiable SPMM with an fp32 residual that is no ACT site and
    records nothing (the edge-softmax denominators; the reference's
    ``segment_sum``)."""
    return _Spmm.apply(x, ew, layout, FP32, 0)


def act_spmm(x, ew, layout, *, seed=None, policy: ACTPolicy | None = None,
             scope: str | None = None):
    """Weighted aggregation ``H[v] = Σ_{(u,r,v)} w_e · x[u]`` over the
    blocked-CSR ``layout`` of the graph. ``x`` is needed only for ∇ew, so it
    is what the site saves (quantized under an active policy). With
    ``ew=None`` the op is linear with index-only residuals: nothing to
    compress and nothing recorded."""
    if ew is None:
        return weighted_spmm(x, None, layout)
    name, policy, seed, ctx = _resolve_site("spmm", scope, seed, policy)
    _record(ctx, name, "spmm", x.shape, policy)
    return _Spmm.apply(x, ew, layout, policy, seed)


# -- gathers with a deterministic backward ------------------------------------


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(fctx, table, idx, runs, rows):
        fctx.runs = runs
        fctx.rows = rows
        fctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(fctx, g):
        out = ops.segment_sum(g, fctx.runs)
        if fctx.rows is not None:
            # distinct rows: each written once, no accumulation
            full = out.new_zeros((fctx.n_rows,) + out.shape[1:])
            return full.index_copy_(0, fctx.rows, out), None, None, None
        extra = fctx.n_rows - out.shape[0]
        if extra:
            out = torch.cat([out, out.new_zeros((extra,) + out.shape[1:])])
        return out, None, None, None


def gather_rows(table, idx, runs, *, rows=None):
    """``table.index_select(0, idx)`` whose backward is
    ``grad_table[v] = Σ grad_out[e]`` over the edges ``e`` with
    ``idx[e] == v``, summed in the order ``runs`` gives them
    (``data.csr.SegmentRuns`` levels, which must group exactly the edges of
    ``idx``): the same bits every run, on the card too. Output row ``r`` of
    the runs is table row ``r``, or, given ``rows`` (distinct table rows,
    one a run), table row ``rows[r]``; the rows no run reaches get zero
    gradient (a sampled block gathers from a prefix of a wider table,
    ``models.kgnn.BlockView``; a recsys batch touches a few of the table's
    rows, ``data.csr.lookup_plan``)."""
    return _GatherRows.apply(table, idx, runs, rows)


def lookup_rows(table, plan=None, ids=None):
    """An embedding lookup: with the batch's ``data.csr.LookupPlan``, the
    rows ``plan.ids`` through ``gather_rows`` (the table's deterministic
    backward); without one, ``table.index_select(0, ids)``, whose backward
    would scatter with atomics, so the table must not need a gradient
    then."""
    if plan is not None:
        return gather_rows(table, plan.ids, plan.runs, rows=plan.rows)
    if torch.is_grad_enabled() and table.requires_grad:
        raise ValueError("training an embedding table needs the batch's "
                         "LookupPlan (data.csr.lookup_plan)")
    return table.index_select(0, ids)


class _SumRows(torch.autograd.Function):
    @staticmethod
    def forward(fctx, y, idx, runs):
        fctx.save_for_backward(idx)
        return ops.segment_sum(y, runs)

    @staticmethod
    def backward(fctx, g):
        (idx,) = fctx.saved_tensors
        return g.index_select(0, idx), None, None


def sum_rows(y, idx, runs):
    """The transpose of ``gather_rows``: ``out[v] = Σ y[e]`` over the rows
    ``e`` with ``idx[e] == v``, summed in the order ``runs`` gives them
    (which must group exactly the rows of ``idx``; ``ops.segment_sum``),
    the same bits every run; the backward is the gather ``grad_out[idx]``.
    Never ``index_add_`` or ``scatter_add``, whose atomics reorder the sum
    on the card."""
    return _SumRows.apply(y, idx, runs)
