"""Distributed-optimization collectives. Port of
``repro.parallel.collectives``.

int8 error-feedback gradient compression: quantize each leaf to int8 with
one scale a leaf before the DP all-reduce, and carry the quantization
residual to the next step. Each rank passes its own local leaves (the
reference's leading replica axis is how ``shard_map`` hands a device its
part; here a rank holds its part).

The wire. The reference sums the int8 values in int16 (2 B an element
against float32's 4). Neither gloo nor NCCL reduces int16, and int8 would
overflow, so the port sums them in int32: 4 B an element, float32's cost,
twice the reference's. The integer sum is exact, so the mean is what the
reference computes.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, unflatten

from .sharding import all_reduce_over, mesh_shape

__all__ = ["compress_allreduce_mean", "quantize_int8", "dequantize_int8"]

_SLICE = 1 << 24          # elements a float64 residual slice (128 MB)


def quantize_int8(x: torch.Tensor):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor):
    return q.float() * scale


def compress_allreduce_mean(grads: Any, residual: Any, mesh,
                            axes: tuple[str, ...]):
    """int8-quantized gradient mean over the DP ``axes`` with error feedback.

    Protocol, per leaf: (1) a MAX all-reduce of |g + r| gives one scale,
    (2) quantize locally to int8 (round half to even, clip to +-127),
    (3) sum the quantized payload (in int32, the module docstring),
    (4) dequantize and divide by the rank count; the residual carries the
    quantization error to the next step. Returns ``(mean, new_residual)``:
    the mean is the same on every rank of the group.
    """
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_shape(mesh)
    n_ranks = 1
    for a in names:
        n_ranks *= sizes[a]
    if n_ranks > 256:
        raise ValueError(f"int16 accumulation bounds the reduction to 256 "
                         f"ranks, got {n_ranks} over axes {axes}")

    def one(g, r):
        gl = g.float() + r
        gmax = torch.max(torch.abs(gl)).reshape(1)
        all_reduce_over(gmax, mesh, names, op=dist.ReduceOp.MAX)
        scale = gmax[0] / 127.0 + 1e-12
        q = torch.clamp(torch.round(gl / scale), -127, 127)
        # the residual rounded once, as a fused multiply-add gives it (the
        # reference's compiled product-difference): the float32 product
        # is exact in float64. In slices, so that a large leaf's float64
        # temporaries stay small
        new_r = torch.empty_like(gl)
        s64 = scale.double()
        for a, b, out in zip(gl.view(-1).split(_SLICE), q.view(-1).split(
                _SLICE), new_r.view(-1).split(_SLICE)):
            out.copy_(a.double() - b.double() * s64)
        summed = all_reduce_over(q.to(torch.int32), mesh, names)
        mean = summed.float() * scale / n_ranks
        return mean.to(g.dtype), new_r

    out = [one(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
