"""Train, eval, serve and prefill step factories. Port of
``repro.train.loop``.

``make_train_step`` returns a ``(params, opt_state, batch, step) ->
(params, opt_state, metrics)`` function: float32 CE loss with z-loss, the
MoE aux loss, remat, micro-batched gradient accumulation, fault-aware
update skipping and the ABFT telemetry of the forward in its metrics
(the reference's names: ``loss``, ``ce``, ``lr``, ``grad_norm``,
``skipped_updates``, ``moe_aux``, ``ft_flagged``, ``ft_corrected``,
``ft_max_score``). Params are the port's param tree; the step sets
``requires_grad`` on its leaves for the forward and backward only, takes
the gradients with ``torch.autograd.grad`` and updates params and moments
in place
(``optim.apply_updates``), so the trees it returns are the ones it was
given. A protected linear checks its forward product (``ft_matmul`` on
the card) and its backward is the plain product's gradient, as the
reference's autodiff gives (``core.gemm.api._FusedLinear``).

Every architecture of ``configs`` trains: the dense decoder family, the
recurrent models (``models.ssm``: autograd runs through the doubling scan
and the sequential mLSTM and sLSTM loops, which write nothing in place
without a decode state), the MoE models (``models.moe`` and MLA: the routed
experts' checked products are eager batched products, differentiated
through their in-place correction as the reference's ``jax.grad`` runs
through its ``vmap(abft.ft_matmul)``; the capacity is computed per call,
so per micro-batch, as in the reference's scan), the VLM (InternVL2: a
batch may carry ``patch_embeds``, and the loss takes the text tail of the
logits) and the encoder-decoder (Whisper: a batch carries ``frames``).

``make_train_step(model, run, mesh)`` is the step over a ``data x model``
mesh (``launch.mesh.make_host_mesh``), FSDP/ZeRO-3 storage: params and
AdamW moments are each rank's shards by ``parallel.param_specs(...,
fsdp=run.parallel.fsdp)`` (``parallel.shard_tree`` makes them), gathered
on use. A step (1) takes the rank's shard of the batch by
``batch_specs``, (2) all-gathers every param leaf (under expert
parallelism the routed experts over the dp axes only: their ``model``
shard stays local), (3) runs the forward and backward under
``use_mesh``, (4) all-reduces the gradients as a mean over the dp axes,
(5) clips by the norm of the whole mean gradient and (6) updates each
rank's shards with its slice of it. Ranks along ``model`` compute the
dense products redundantly. The metrics are the same on every rank:
``loss``, ``ce`` and ``moe_aux`` means over dp, the ``ft_*`` counters
sums over dp (``ft_max_score`` a max). The reference's int8 compressed
all-reduce (``parallel.compress_allreduce_mean``) is not wired into the
step, as in the reference, where ``ParallelConfig.compress_grads`` only
names it.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.configs.base import RunConfig
from repro_torch.models import Model, moe
from repro_torch.parallel import sharding
from repro_torch.tree import leaves, leaves_with_path, unflatten

__all__ = ["make_train_step", "make_eval_step", "make_serve_step",
           "make_prefill_step", "cross_entropy", "param_layout"]

_AUX = ("moe_aux", "ft_flagged", "ft_corrected", "ft_max_score")


def cross_entropy(logits, labels, *, z_loss: float = 1e-4):
    """Token-mean CE in float32 with logit z-regularization. Returns
    ``(ce + z_loss * mean(lse^2), ce)``. The label's logit is picked with
    a gather (the reference's iota match adds zeros to it: the same
    value)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = torch.mean(lse - ll)
    zl = z_loss * torch.mean(lse ** 2)
    return ce + zl, ce


def _loss_fn(model: Model, params, batch, *, block_q, remat, moe_coef=0.01,
             inject=None):
    logits, aux = model.apply(params, batch, block_q=block_q, remat=remat,
                              inject=inject)
    labels = batch["labels"]
    logits = logits[:, -labels.shape[1]:]  # vlm: text-tail loss
    total, ce = cross_entropy(logits, labels)
    total = total + moe_coef * aux["moe_aux"]
    return total, (ce, aux)


def _value_and_grad(model: Model, params, batch, *, block_q, remat,
                    inject=None):
    """``((total, (ce, aux)), grads)`` of :func:`_loss_fn` at ``params``:
    ``jax.value_and_grad(..., has_aux=True)``'s result, the gradients a
    tree of float32 tensors shaped as ``params`` (zeros where a leaf takes
    no part). The param leaves take ``requires_grad`` for the call only:
    each leaves with the flag it came with, so a later forward (a decode
    step) builds no graph."""
    ps = leaves(params)
    was = [p.requires_grad for p in ps]
    try:
        with torch.enable_grad():
            for p in ps:
                p.requires_grad_(True)
            total, (ce, aux) = _loss_fn(model, params, batch,
                                        block_q=block_q, remat=remat,
                                        inject=inject)
            grads = torch.autograd.grad(total, ps, allow_unused=True)
    finally:
        for p, flag in zip(ps, was):
            p.requires_grad_(flag)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return ((total.detach(), (ce.detach(), aux)), unflatten(params, grads))


def _accumulate(grad, micro: int, params, batch):
    """``((total, (ce, aux)), grads)`` over ``micro`` micro-batches: the
    batch split along its first axis, gradients, losses and aux summed,
    then gradients and losses divided by their count, as the reference's
    scan does."""
    if micro <= 1:
        return grad(params, batch)
    parts = {k: v.reshape((micro, v.shape[0] // micro) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    grads = None
    for i in range(micro):
        (t, (c, a)), g = grad(params, {k: v[i] for k, v in parts.items()})
        if grads is None:
            grads, total, ce, aux = g, t, c, a
            continue
        for acc, gi in zip(leaves(grads), leaves(g)):
            acc.add_(gi)
        total, ce = total + t, ce + c
        aux = {k: aux[k] + a[k] for k in _AUX}
    for g in leaves(grads):
        g.div_(micro)
    return (total / micro, (ce / micro, aux)), grads


def make_train_step(model: Model, run: RunConfig, mesh=None) -> Callable:
    """The train step ``(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``. ``batch`` holds ``tokens`` and ``labels``
    tensors on the params' device (and ``frames`` or ``patch_embeds``
    for the encoder-decoder or the VLM). With ``microbatch`` > 1 the batch is
    split along its first axis and the gradients, losses and aux are
    summed over the micro-batches, then gradients and losses divided by
    their count, as the reference's scan does.

    With a ``mesh``, the step of the module docstring: ``params`` and
    ``opt_state`` are this rank's shards, ``batch`` the whole batch (the
    same on every rank)."""
    par = run.parallel
    micro = par.microbatch
    grad = functools.partial(_value_and_grad, model,
                             block_q=par.attn_block_q, remat=par.remat)
    if mesh is not None:
        return _sharded_step(model, run, mesh, grad)

    def train_step(params, opt_state, batch, step):
        dev = batch["tokens"].device
        lr = optim.cosine_schedule(
            step, base_lr=run.learning_rate, warmup_steps=run.warmup_steps,
            total_steps=run.total_steps, device=dev)
        (total, (ce, aux)), grads = _accumulate(grad, micro, params, batch)
        params, opt_state, info = optim.apply_updates(
            params, grads, opt_state, lr=lr,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip,
            skip_nonfinite=model.cfg.ft.skip_nonfinite_updates)
        metrics = {
            "loss": total, "ce": ce, "lr": lr,
            "grad_norm": info["grad_norm"],
            "skipped_updates": info["skipped"],
            "moe_aux": aux["moe_aux"],
            "ft_flagged": aux["ft_flagged"],
            "ft_corrected": aux["ft_corrected"],
            "ft_max_score": aux["ft_max_score"],
        }
        return params, opt_state, metrics

    return train_step


def param_layout(model: Model, run: RunConfig, mesh) -> list:
    """``(path, spec)`` of every param leaf, in tree order, by
    ``param_specs(..., fsdp=run.parallel.fsdp)`` on the model's ``meta``
    params."""
    return sharding.flat_specs(sharding.param_specs(
        model.init(None, device="meta"), mesh, fsdp=run.parallel.fsdp))


def _sharded_step(model: Model, run: RunConfig, mesh, grad) -> Callable:
    """The train step over ``mesh`` (module docstring)."""
    micro = run.parallel.microbatch
    specs = dict(param_layout(model, run, mesh))
    sizes = sharding.mesh_shape(mesh)
    dp = sharding.dp_axes(mesh)
    n_dp = math.prod(sizes[a] for a in dp)

    def train_step(params, opt_state, batch, step):
        dev = batch["tokens"].device
        lr = optim.cosine_schedule(
            step, base_lr=run.learning_rate, warmup_steps=run.warmup_steps,
            total_steps=run.total_steps, device=dev)
        bspecs = sharding.batch_specs(batch, mesh)
        local = {k: sharding.shard_leaf(v, bspecs[k], mesh)
                 for k, v in batch.items()}
        replicated = n_dp > 1 and bspecs["tokens"][0] is None
        b, t = local["tokens"].shape[:2]
        # the rule moe_block applies to the tokens it sees; where it takes
        # the portable path on experts kept sliced here, it raises
        ep = bool(model.cfg.num_experts) and moe.takes_ep(
            model.cfg, mesh, b // max(micro, 1) * t)
        paths = [path for path, _ in leaves_with_path(params)]
        place = [(specs[path], ("model",) if ep and
                  sharding.ROUTED_EXPERTS.search("/".join(path)) else ())
                 for path in paths]
        full = unflatten(params, [
            sharding.gather_leaf(p, sp, mesh, keep=kp)
            for p, (sp, kp) in zip(leaves(params), place)])
        with sharding.use_mesh(mesh, replicated_batch=replicated):
            (total, (ce, aux)), grads = _accumulate(grad, micro, full, local)
        del full
        mean_dp = n_dp > 1 and not replicated
        gl = leaves(grads)
        if mean_dp:
            for g in gl:
                sharding.all_reduce_over(g, mesh, dp).div_(n_dp)
        # the norm of the whole mean gradient, ``optim.global_norm``'s sums
        # in its order: under EP a rank holds its experts' part of their
        # leaves only, summed over model
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in gl])
        kept = [i for i, (_, kp) in enumerate(place) if kp]
        if kept:
            part = sharding.all_reduce_over(sq[kept], mesh, ("model",))
            sq[kept] = part
        gnorm = torch.sqrt(_from_first(sq, mesh, "model").sum())
        shards = unflatten(params, [
            sharding.shard_leaf(g, sp, mesh, keep=kp)
            for g, (sp, kp) in zip(gl, place)])
        params, opt_state, info = optim.apply_updates(
            params, shards, opt_state, lr=lr,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip,
            skip_nonfinite=model.cfg.ft.skip_nonfinite_updates,
            grad_norm=gnorm)
        sums = torch.stack([total, ce, aux["moe_aux"], aux["ft_flagged"],
                            aux["ft_corrected"]]).float()
        score = aux["ft_max_score"].reshape(1).float()
        if mean_dp:
            sharding.all_reduce_over(sums, mesh, dp)
            sums[:3] /= n_dp
            sharding.all_reduce_over(score, mesh, dp,
                                     op=dist.ReduceOp.MAX)
        _from_first(sums, mesh, "model")
        _from_first(score, mesh, "model")
        metrics = {
            "loss": sums[0], "ce": sums[1], "lr": lr,
            "grad_norm": info["grad_norm"],
            "skipped_updates": info["skipped"],
            "moe_aux": sums[2], "ft_flagged": sums[3],
            "ft_corrected": sums[4], "ft_max_score": score[0],
        }
        return params, opt_state, metrics

    return train_step


def _from_first(t: torch.Tensor, mesh, axis: str):
    """``t`` made the value of the first rank along ``axis`` (in place):
    ranks along ``model`` compute the same numbers redundantly, and they
    must agree to the bit."""
    if sharding.mesh_shape(mesh)[axis] > 1:
        group = mesh.get_group(axis)
        dist.broadcast(t, group=group, src=dist.get_global_rank(group, 0))
    return t


def make_eval_step(model: Model, run: RunConfig) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            total, (ce, aux) = _loss_fn(model, params, batch,
                                        block_q=run.parallel.attn_block_q,
                                        remat=False)
        return {"loss": total, "ce": ce}
    return eval_step


def make_serve_step(model: Model, run: RunConfig) -> Callable:
    """One batched greedy decode step: (params, cache, tokens, pos) ->
    (next_tokens, cache, aux)."""

    def serve_step(params, cache, tokens, pos, inject=None):
        logits, cache, aux = model.decode_step(params, cache, tokens, pos,
                                               block_q=0, inject=inject)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], cache, aux

    return serve_step


def make_prefill_step(model: Model, run: RunConfig) -> Callable:
    """Full-sequence forward for inference-prefill shapes (logits only)."""

    def prefill_step(params, batch):
        logits, aux = model.apply(params, batch,
                                  block_q=run.parallel.attn_block_q)
        return logits[:, -1], aux

    return prefill_step
