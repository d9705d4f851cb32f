"""AdamW with a cosine schedule, global-norm clipping and fault-aware
update skipping (non-finite grads are dropped and counted: the
fail-continue half of the paper's fault model applied to training). Port
of ``repro.optim.adamw``.

Param, gradient and moment trees are nested dicts of tensors (the port's
param tree). The moments are float32 on the params' device. Unlike the
reference, which returns new trees, :func:`apply_updates` writes params,
moments and step in place (under ``torch.no_grad``): a 1B-parameter model
keeps one copy of each on the card. Whether the step is finite is decided
on the host before any tensor is written, so a skipped step leaves every
tensor as it was.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWState", "init_state", "apply_updates", "cosine_schedule",
           "global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: dict
    nu: dict


def _zeros_like(tree):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                          device=t.device), tree)


def init_state(params) -> AdamWState:
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=_zeros_like(params), nu=_zeros_like(params))


def cosine_schedule(step, *, base_lr, warmup_steps, total_steps,
                    min_ratio=0.1, device=None):
    """Linear warm-up then cosine decay to ``min_ratio * base_lr``, as a
    0-d float32 tensor (the reference's float32 arithmetic) on
    ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    s = torch.as_tensor(step, **f32)
    warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    sq = [torch.sum(torch.square(t.float())) for t in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def apply_updates(
    params,
    grads,
    state: AdamWState,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    skip_nonfinite: bool = True,
    grad_norm: torch.Tensor | None = None,
):
    """One AdamW step, in place. Returns ``(params, state, info)``: the same
    trees (written), the state with its step advanced, and ``grad_norm``,
    ``lr`` and ``skipped`` (1.0 when a non-finite norm dropped the step).
    ``grad_norm`` is the norm to clip by when ``grads`` are shards of the
    gradient (the sharded train step passes the whole gradient's); else
    ``global_norm(grads)``."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    finite = bool(torch.isfinite(gnorm))      # one host read a step
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    info = {"grad_norm": gnorm, "lr": lr,
            "skipped": torch.tensor(0.0 if finite else 1.0,
                                    device=gnorm.device)}
    if skip_nonfinite and not finite:
        return params, state, info
    scale = (torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
             if grad_clip > 0 else torch.ones_like(gnorm))
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    # each leaf's operations in the reference's order, their temporaries
    # written in place: a leaf's update holds two leaf-sized float32
    # temporaries at a time, not four (the peak of a step whose largest
    # leaf is a 4 GB embedding)
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state.mu), leaves(state.nu)):
        gf = g.float() * scale
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_(((1 - b2) * gf).mul_(gf))
        del gf
        delta = m / c1
        delta.div_((v / c2).sqrt_().add_(eps))
        if p.dim() >= 2:             # decoupled decay on matrices only
            delta.add_(weight_decay * p.float())
        p.copy_(p.float() - delta.mul_(lr))
    state.step.copy_(step)
    return params, state, info
