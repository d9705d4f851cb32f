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
protected sites on the GEMM plan.

Under a mesh (``parallel.sharding.use_mesh``) ``moe_block`` takes the
reference's mesh branch. A rank passes its own activations: its shard of
the batch over the dp axes (or the whole batch when the batch is
replicated). With a ``model`` axis that divides the experts and at least
1024 tokens a rank it runs ``moe_block_ep``: each rank routes its tokens
over all experts, runs its E/|model| experts on them, and one all-reduce
of the (T_local, d) outputs over ``model`` combines the shards. Else it
runs the portable path on the whole batch, as the reference's partitioner
does: the tokens are all-gathered over dp and each rank keeps its rows.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from repro_torch.core.abft import gemm as abft_gemm
from repro_torch.parallel import sharding

from . import layers
from .layers import dense_init
from .ssm import silu

__all__ = ["make_moe_params", "moe_block", "moe_block_ep",
           "aux_load_balance_loss", "takes_ep", "EP_MIN_TOKENS"]

EP_MIN_TOKENS = 1024     # tokens a rank from which the mesh branch runs EP


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


class _SumGradOver(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``:
    each model rank's experts give a part of the gradient of the tokens
    and gates they read."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Combine(torch.autograd.Function):
    """Forward: the sum over ``group`` (the expert shards' outputs). The
    backward passes the gradient through once: every model rank holds the
    same upstream gradient of the replicated sum, which is its part's
    (``dist.nn``'s all-reduce would sum it, |model| times too much)."""

    @staticmethod
    def forward(ctx, y, group):
        out = y.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    """Forward: the mean over the mesh ``axes``; the backward passes the
    gradient through once (each rank's loss holds the mean as its own
    term: the train step's mean over dp then counts each rank's term
    once)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, n):
        out = x.clone()
        sharding.all_reduce_over(out, mesh, axes)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherRows(torch.autograd.Function):
    """Forward: the rows of every rank along the mesh ``axes``, in rank
    order (an all-gather a dim); the backward sums the gradient over them
    and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return sharding.gather_leaf(x, (axes,), mesh)

    @staticmethod
    def backward(ctx, g):
        g = sharding.all_reduce_over(g.contiguous().clone(), ctx.mesh,
                                     ctx.axes)
        return sharding.shard_leaf(g, (ctx.axes,), ctx.mesh), None, None


def _dp_of(mesh):
    """The dp axes the batch is split over and their size (none when the
    batch is replicated)."""
    if sharding.batch_replicated():
        return (), 1
    dp = sharding.dp_axes(mesh)
    sizes = sharding.mesh_shape(mesh)
    return dp, math.prod(sizes[a] for a in dp)


def takes_ep(cfg, mesh, tokens_local: int) -> bool:
    """Whether ``moe_block`` takes the expert-parallel path: a mesh with a
    ``model`` axis that divides the experts, and at least
    ``EP_MIN_TOKENS`` tokens a rank (the reference's rule; below it the
    replicated routing and the combine cost more than they save)."""
    sizes = sharding.mesh_shape(mesh)
    return ("model" in sizes and cfg.num_experts % sizes["model"] == 0
            and tokens_local >= EP_MIN_TOKENS)


def moe_block_ep(params, x, cfg, mesh, *, ft=None):
    """Expert-parallel MoE over the ``model`` axis of ``mesh``.

    ``x`` (B, T, d) is this rank's batch: its dp shard, the same on every
    rank along ``model``. Routing runs replicated (float32 softmax, top
    k); the expert ids are rebased to this rank's ``E / |model|`` experts,
    the others going to the drop bucket; the capacity comes from the
    tokens a rank. ``params``' routed experts are all E (this rank's range
    is taken) or this rank's ``E / |model|``. The outputs are combined by
    one all-reduce of (T_local, d) over ``model``; ``aux`` is the mean
    over the dp ranks. Protected, the routed experts' flagged and
    corrected counts are summed over ``model`` (a rank's counts then cover
    its own tokens, as its dense products' do) and the score is maxed
    over every rank. The shared expert runs on this rank's tokens, with
    ``ft``.

    The backward gives each rank the gradient the reference's global
    program gives it: the combine passes the gradient through once, and
    the parts of the tokens' and gates' gradients from each rank's experts
    are summed over ``model``; routing and aux are differentiated once.
    """
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    sizes = sharding.mesh_shape(mesh)
    m_size = sizes["model"]
    e_local = e // m_size
    dp, n_dp = _dp_of(mesh)
    tokens_local = b * t
    cap = max(math.ceil(tokens_local * k / e * cfg.capacity_factor), 8)
    m_idx = mesh.get_local_rank("model")
    group = mesh.get_group("model")
    experts = []
    for name in ("wi_gate", "wi_up", "wo"):
        w = params[name]
        if w.shape[0] not in (e, e_local):
            raise ValueError(f"moe_block_ep: {name} holds {w.shape[0]} "
                             f"experts, not {e} or this rank's {e_local}")
        if w.shape[0] != e_local:
            w = w[m_idx * e_local:(m_idx + 1) * e_local]
        experts.append(w)

    ft_on = ft is not None and ft.enabled
    xf = x.reshape(tokens_local, d)
    probs, gate_vals, gate_idx = _route(params["router"], xf, k)
    # rebase expert ids to this shard's local range
    local_idx = gate_idx - m_idx * e_local
    local_idx = torch.where((local_idx >= 0) & (local_idx < e_local),
                            local_idx, e_local)          # -> drop bucket
    xs, gs = xf, gate_vals
    if m_size > 1:
        xs = _SumGradOver.apply(xf, group)
        gs = _SumGradOver.apply(gate_vals, group)
    y, stats = _dispatch_compute(
        xs, gs, local_idx, *experts, cap, e_local, dtype=x.dtype,
        ft_args=(ft.policy.threshold, True) if ft_on else None)
    if m_size > 1:
        y = _Combine.apply(y, group)
    aux = aux_load_balance_loss(probs, gate_idx, e)
    if dp:
        aux = _MeanOver.apply(aux, mesh, dp, n_dp)
    if stats is not None:
        counts = torch.stack([stats["flagged"].sum(),
                              stats["corrected"].sum()]).float()
        score = stats["score"].max().reshape(1).float()
        sharding.all_reduce_over(counts, mesh, ("model",))
        sharding.all_reduce_over(score, mesh, ("model",) + dp,
                                 op=dist.ReduceOp.MAX)
        ft.record({"flagged": counts[0], "corrected": counts[1],
                   "score": score[0]})
    if "shared" in params:
        y = y + layers.swiglu(params["shared"], xf, ft=ft, silu=silu)
    return y.reshape(b, t, d), aux


def moe_block(params, x, cfg, *, ft=None):
    """x: (B, T, D) -> (y, aux) with capacity-based top-k dispatch.

    Off a mesh: the portable path. Under a mesh (``use_mesh``), ``x`` is
    this rank's batch: the expert-parallel path when :func:`takes_ep`,
    else the portable path on the whole batch (gathered over dp when it is
    split there), as the reference's partitioner runs it.
    """
    mesh = sharding.current_mesh()
    if mesh is None:
        return _moe_block_portable(params, x, cfg, ft=ft)
    b, t, _ = x.shape
    if takes_ep(cfg, mesh, b * t):
        return moe_block_ep(params, x, cfg, mesh, ft=ft)
    dp, n = _dp_of(mesh)
    if n == 1:
        return _moe_block_portable(params, x, cfg, ft=ft)
    return _moe_block_gathered(params, x, cfg, mesh, dp, ft=ft)


def _routed(params, xf, cfg, ft):
    """The routed experts on ``xf`` (T, d): ``(y, stats, probs,
    gate_idx)``, the capacity from all T tokens."""
    e, k = cfg.num_experts, cfg.top_k
    rows = params["wi_gate"].shape[0]
    if rows != e:
        raise ValueError(
            f"the portable MoE path needs all {e} routed experts, got "
            f"{rows}: the caller kept an expert-parallel slice where "
            f"moe_block took no expert-parallel path (takes_ep)")
    cap = max(math.ceil(xf.shape[0] * k / e * cfg.capacity_factor), 8)
    probs, gate_vals, gate_idx = _route(params["router"], xf, k)
    ft_args = ((ft.policy.threshold, True)
               if ft is not None and ft.enabled else None)
    y, stats = _dispatch_compute(xf, gate_vals, gate_idx, params["wi_gate"],
                                 params["wi_up"], params["wo"], cap, e,
                                 dtype=xf.dtype, ft_args=ft_args)
    return y, stats, probs, gate_idx


def _moe_block_gathered(params, x, cfg, mesh, dp, *, ft=None):
    """The portable path on the whole batch of a dp-split mesh: the routed
    experts on every dp rank's tokens (capacity and aux the whole batch's,
    as the reference's global program has them), this rank's rows kept;
    the shared expert on this rank's tokens. The routed experts' counts
    are recorded on the first dp rank only (each dp rank computes all of
    them; the train step sums counts over dp)."""
    b, t, d = x.shape
    xg = _GatherRows.apply(x.reshape(b * t, d), mesh, dp)
    y, stats, probs, gate_idx = _routed(params, xg, cfg, ft)
    if stats is not None:
        if any(mesh.get_local_rank(a) for a in dp):
            stats = dict(stats, flagged=stats["flagged"] * 0,
                         corrected=stats["corrected"] * 0)
        ft.record(stats)
    y = sharding.shard_leaf(y, (dp,), mesh)
    xf = x.reshape(b * t, d)
    if "shared" in params:
        y = y + layers.swiglu(params["shared"], xf, ft=ft, silu=silu)
    aux = aux_load_balance_loss(probs, gate_idx, cfg.num_experts)
    return y.reshape(b, t, d), aux


def _moe_block_portable(params, x, cfg, *, ft=None):
    """x: (B, T, D) -> (y, aux) with capacity-based top-k dispatch."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    y, stats, probs, gate_idx = _routed(params, xf, cfg, ft)
    if stats is not None:
        ft.record(stats)

    if "shared" in params:
        y = y + layers.swiglu(params["shared"], xf, ft=ft, silu=silu)

    aux = aux_load_balance_loss(probs, gate_idx, cfg.num_experts)
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
