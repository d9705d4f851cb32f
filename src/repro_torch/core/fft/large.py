"""Large-N FFT: the paper's kernel-level N1 x N2 (x N3) decomposition.

Each kernel-level factor is one global-memory round trip: a batched block
FFT along one axis of the tiled signal cube, a twiddle multiply (table
precomputed on host), and a transpose. This module is the eager oracle and
materializes the transposes with torch. The kernel path
(``kernels.ops._fft_multipass``) folds them and the twiddle into the block
kernel's access pattern instead: each pass is one launch in the layout
``plan.pass_layouts`` gives it, reading its signals strided, applying the
pass twiddle on the way out and (the last pass) writing the output
transposed, with the same index maps as here.
"""
from __future__ import annotations

import math

import torch

from . import factors
from .plan import Plan, make_plan
from .stockham import block_fft_stages

__all__ = ["fft_large"]


def _twiddle_table(n1: int, n2: int, like: torch.Tensor,
                   inverse: bool) -> torch.Tensor:
    """(n1, n2) table T[k1, n2] = exp(-+2*pi*i*k1*n2/(n1*n2)) built on host."""
    t = factors.stage_twiddle(n1, n2, inverse=inverse)
    return torch.as_tensor(t).to(dtype=like.dtype, device=like.device)


def _fft_factors(x: torch.Tensor, facs: tuple[int, ...],
                 inverse: bool) -> torch.Tensor:
    """FFT over the last axis of ``x`` with len == prod(facs), recursively."""
    n = x.shape[-1]
    if len(facs) == 1:
        return block_fft_stages(x, inverse=inverse)
    f1, rest = facs[0], facs[1:]
    f2 = math.prod(rest)
    if f1 * f2 != n:
        raise ValueError(f"factors {facs} do not multiply to {n}")
    lead = tuple(x.shape[:-1])
    # pass 1: FFT along the f1 axis (stride f2): X[n1, n2] = x[f2*n1 + n2]
    z = x.reshape(lead + (f1, f2)).transpose(-1, -2)   # (..., f2, f1)
    z = block_fft_stages(z, inverse=inverse)           # FFT over f1
    z = z.transpose(-1, -2)                            # (..., f1, f2)
    z = z * _twiddle_table(f1, f2, x, inverse)
    # pass 2..: FFT along the f2 axis — recurse over remaining factors
    if len(rest) == 1:
        z = block_fft_stages(z, inverse=inverse)
    else:
        z = _fft_factors(z.reshape(-1, f2), rest, inverse).reshape(z.shape)
    # output ordering k = k1 + f1*k2 -> view as (f2, f1) row-major
    return z.transpose(-1, -2).reshape(lead + (n,))


def fft_large(x: torch.Tensor, plan: Plan | None = None) -> torch.Tensor:
    """Multi-pass FFT over the last axis; the inverse is scaled once by 1/N."""
    n = x.shape[-1]
    if plan is None:
        plan = make_plan(n)
    if plan.n != n:
        raise ValueError(f"plan is for n={plan.n}, input has n={n}")
    y = _fft_factors(x, plan.kernel_factors, plan.inverse)
    if plan.inverse:
        y = y / n
    return y
