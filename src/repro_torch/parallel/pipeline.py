"""GPipe-style pipeline parallelism over a ``stage`` mesh dimension. Port of
``repro.parallel.pipeline``.

Each rank along ``stage`` runs one contiguous stage of a layer stack;
microbatches stream through with one hop to the right neighbour a tick.

The hop is a ``dist.all_to_all_single`` over the stage group in which a
rank sends its whole activation to its right neighbour and receives its
left neighbour's (one non-zero split each way): gloo's point-to-point
``send``/``recv`` need not take CUDA tensors, its all-to-all does (as the
sharded FFT's exchange found), and NCCL takes both.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .sharding import mesh_shape

__all__ = ["pipeline_apply", "ring_hop"]


def ring_hop(y: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``y`` of the left neighbour along ``axis`` (the reference's
    ``ppermute`` with pairs ``(i, i + 1 mod S)``)."""
    s = mesh_shape(mesh)[axis]
    if s == 1:
        return y.clone()
    i = mesh.get_local_rank(axis)
    n = y.numel()
    send = [0] * s
    recv = [0] * s
    send[(i + 1) % s] = n
    recv[(i - 1) % s] = n
    out = torch.empty_like(y).reshape(-1)
    dist.all_to_all_single(out, y.contiguous().reshape(-1), recv, send,
                           group=mesh.get_group(axis))
    return out.reshape(y.shape)


def pipeline_apply(fn_stage: Callable, stage_params, x: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``fn_stage(stage_params, x) -> x`` as an S-stage GPipe pipeline
    over microbatches.

    ``stage_params`` is this rank's stage (its slice ``[stage]`` of the
    reference's stacked leaves); ``x`` (M, micro_batch, ...) is the same
    on every rank, ``x[m]`` microbatch m. The schedule runs S + M - 1
    ticks: each tick every stage processes one slot and passes it right;
    stage 0 ingests microbatch t (zeros once they run out), and the last
    stage emits microbatch t - S + 1. Returns the last stage's stacked
    outputs, on every rank of the stage group.
    """
    s = mesh_shape(mesh)[axis]
    m = x.shape[0]
    stage = mesh.get_local_rank(axis)
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(s + m - 1):
        if stage == 0:
            cur = x[t] if t < m else torch.zeros_like(buf)
        else:
            cur = buf
        y = fn_stage(stage_params, cur)
        if stage == s - 1 and t >= s - 1:
            outs[t - s + 1] = y
        buf = ring_hop(y, mesh, axis)
    group = mesh.get_group(axis)
    dist.broadcast(outs, group=group,
                   src=dist.get_global_rank(group, s - 1))
    return outs
