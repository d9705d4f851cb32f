"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch. Port
of ``repro.models.moe``'s portable path.

``moe_block`` sorts the (token, slot) choices by expert, scatters the
tokens into an (E, C, d) buffer (C the capacity), runs the experts' SwiGLU
as batched products over the E axis, and gathers the results back,
weighted by the gates. Choices past an expert's capacity are dropped, as
in the reference: ``torch.argsort(..., stable=True)`` is ``jnp.argsort``
(stable), so the same tokens are kept.

Protected, the three expert products are checked per expert on the eager
ABFT path (:func:`repro_torch.core.abft.gemm.ft_matmul_batched`, what the
reference's ``jax.vmap(abft.ft_matmul)`` computes: "the fused kernel takes
one weight"); they take no fault site. The SwiGLUs take ``jax.nn.silu``'s
operations one by one (``ssm.silu``), so that a bfloat16 activation rounds
as the reference's does: the router that reads it is discontinuous. The
shared expert (DeepSeek) runs
densely on every token through ``layers.swiglu``, so its products are
protected sites on the GEMM plan. The expert-parallel path
(``moe_block_ep``) comes with LM parallelism and raises.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.abft import gemm as abft_gemm

from . import layers
from .layers import dense_init
from .ssm import silu

__all__ = ["make_moe_params", "moe_block", "moe_block_ep",
           "aux_load_balance_loss"]

EP_ITEM = ("the expert-parallel MoE path (moe_block_ep) is not ported yet: "
           "it comes with LM parallelism, ROADMAP queue 1 item 12")


def _ft_expert_matmul(buf, w, threshold, correct):
    """Per-expert checked GEMMs: buf (e, c, d) @ w (e, d, f) -> ((e, c, f),
    stats with (e,) leaves), one batched product over the expert axis."""
    return abft_gemm.ft_matmul_batched(buf, w, threshold=threshold,
                                       with_correction=correct)


def _merge_expert_stats(*stats_dicts):
    """Sum the count leaves / max the score across the three expert GEMMs
    (leaves stay (e,) vectors; FTContext.summary reduces them)."""
    out = {}
    for k in stats_dicts[0]:
        vals = [s[k] for s in stats_dicts]
        out[k] = (functools.reduce(torch.maximum, vals) if k == "score"
                  else sum(vals))
    return out


def make_moe_params(gen, cfg, dtype=torch.float32, device="cuda") -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    kw = dict(dtype=dtype, device=device)
    # the reference's fan-in is each leaf's leading axis: E for the experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, device=device),
        "wi_gate": dense_init(gen, (e, d, f), **kw),
        "wi_up": dense_init(gen, (e, d, f), **kw),
        "wo": dense_init(gen, (e, f, d), **kw),
    }
    if cfg.num_shared_experts:
        p["shared"] = layers.make_mlp_params(
            gen, d, cfg.moe_d_ff * cfg.num_shared_experts, "swiglu", dtype,
            device=device)
    return p


def _route(router_w, xf, k):
    """Router: float32 softmax over the experts, its top k (descending),
    and the gates renormalised over them. xf: (T, d) -> probs (T, e),
    gate_vals (T, k), gate_idx (T, k)."""
    logits = torch.einsum("td,de->te", xf.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def _slots(gate_idx, cap, e):
    """The sort-based capacity dispatch of the (T, k) choices: ``order``
    (the stable sort by expert), and in that order ``keep`` (within the
    expert's first ``cap``), ``dest`` (the buffer row ``expert * cap +
    position``; ``e * cap``, the drop slot, where not kept) and
    ``src_token``. Expert ids outside [0, e) go to the drop bucket."""
    t, k = gate_idx.shape
    dev = gate_idx.device
    flat = gate_idx.reshape(-1).long()
    flat_e = flat.clamp(0, e)                            # e == drop bucket
    flat_e = torch.where(flat == flat_e, flat_e, e)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(e, device=dev),
                               right=False)
    pos_in_e = (torch.arange(t * k, device=dev)
                - first[sorted_e.clamp(0, e - 1)])
    keep = (pos_in_e < cap) & (sorted_e < e)
    dest = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)
    return order, keep, dest, order // k


def _dispatch_compute(xf, gate_vals, gate_idx, wg, wu, wo, cap, e, *,
                      dtype, ft_args=None):
    """Sort-based capacity dispatch + expert FFN + combine.

    xf: (T, d); gate_idx/vals: (T, k); wg/wu: (e, d, f); wo: (e, f, d).

    ``ft_args = (threshold, correct)`` routes the three expert GEMMs
    through the two-side ABFT; returns ``(y, stats)`` with stats ``None``
    when unprotected. Unprotected, each expert weight is cast to ``dtype``
    for its product alone, so that one cast copy is alive at a time.
    """
    t, d = xf.shape
    k = gate_idx.shape[-1]
    order, keep, dest, src_token = _slots(gate_idx, cap, e)

    # many dropped rows land in the extra last row, which is cut off
    buf = xf.new_zeros((e * cap + 1, d), dtype=dtype)
    buf[dest] = xf.to(dtype)[src_token]
    buf = buf[:-1].reshape(e, cap, d)

    if ft_args is not None:
        threshold, correct = ft_args
        gate, s1 = _ft_expert_matmul(buf, wg, threshold, correct)
        up, s2 = _ft_expert_matmul(buf, wu, threshold, correct)
        act = silu(gate) * up
        out_buf, s3 = _ft_expert_matmul(act, wo, threshold, correct)
        stats = _merge_expert_stats(s1, s2, s3)
    else:
        gate = torch.bmm(buf, wg.to(dtype))
        up = torch.bmm(buf, wu.to(dtype))
        act = silu(gate) * up
        out_buf = torch.bmm(act, wo.to(dtype))
        stats = None

    out_flat = out_buf.reshape(e * cap, d)
    gathered = torch.where(keep[:, None],
                           out_flat[dest.clamp(0, e * cap - 1)], 0.0)
    unsort = torch.argsort(order, stable=True)
    contrib = gathered[unsort].reshape(t, k, d)
    return torch.einsum("tkd,tk->td", contrib, gate_vals.to(dtype)), stats


def moe_block_ep(*args, **kwargs):
    raise NotImplementedError(EP_ITEM)


def moe_block(params, x, cfg, *, ft=None):
    """x: (B, T, D) -> (y, aux) with capacity-based top-k dispatch. The
    port runs on one card: the portable path (the reference takes its EP
    path only under a mesh with a ``model`` axis)."""
    return _moe_block_portable(params, x, cfg, ft=ft)


def _moe_block_portable(params, x, cfg, *, ft=None):
    """x: (B, T, D) -> (y, aux) with capacity-based top-k dispatch."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    tokens = b * t
    cap = max(math.ceil(tokens * k / e * cfg.capacity_factor), 8)

    xf = x.reshape(tokens, d)
    probs, gate_vals, gate_idx = _route(params["router"], xf, k)
    ft_args = ((ft.policy.threshold, True)
               if ft is not None and ft.enabled else None)
    y, stats = _dispatch_compute(xf, gate_vals, gate_idx, params["wi_gate"],
                                 params["wi_up"], params["wo"], cap, e,
                                 dtype=x.dtype, ft_args=ft_args)
    if stats is not None:
        ft.record(stats)

    if "shared" in params:
        y = y + layers.swiglu(params["shared"], xf, ft=ft, silu=silu)

    aux = aux_load_balance_loss(probs, gate_idx, e)
    return y.reshape(b, t, d), aux


def aux_load_balance_loss(probs, gate_idx, e):
    """Switch-style load-balance auxiliary loss."""
    idx = gate_idx.reshape(-1)
    density = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    density.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float32,
                                          device=probs.device))
    density = density / torch.clamp(density.sum(), min=1.0)
    router_prob = probs.mean(0)
    return e * torch.sum(density * router_prob)
