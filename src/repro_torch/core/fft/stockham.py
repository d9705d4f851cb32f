"""Mixed-radix Stockham FFT in torch ops (the eager reference path).

Each stage is a contraction with a small DFT factor matrix followed by a
twiddle multiply. Complex data is native ``complex64``/``complex128``.

Index convention (see ``factors.stage_twiddle``): for N = r*m,

    n = m*n1 + n2          (input:  reshape to (r, m), row-major)
    k = k1 + r*k2          (output: transpose (r, m) -> (m, r), flatten)

    Y[k1,k2] = sum_{n2} T[k1,n2] * (sum_{n1} Wr[k1,n1] X[n1,n2]) * Wm[n2,k2]
"""
from __future__ import annotations

import torch

from . import factors
from .plan import Plan, StagePlan, make_plan

__all__ = ["fft", "ifft", "fft_with_plan", "block_fft_stages", "fft_stages",
           "naive_dft", "radix2_fft"]


def _as_complex(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    if not x.is_complex():
        x = x.to(torch.complex64)
    return x


def _factor_const(r: int, like: torch.Tensor, inverse: bool) -> torch.Tensor:
    return torch.as_tensor(factors.dft_matrix(r, inverse=inverse)).to(
        dtype=like.dtype, device=like.device)


def _twiddle_const(r: int, m: int, like: torch.Tensor,
                   inverse: bool) -> torch.Tensor:
    return torch.as_tensor(factors.stage_twiddle(r, m, inverse=inverse)).to(
        dtype=like.dtype, device=like.device)


def fft_stages(x: torch.Tensor, stages, *, inverse: bool = False
               ) -> torch.Tensor:
    """Run ``stages`` over the last axis of ``x`` (unnormalized)."""
    return _fft_recursive(x, list(stages), inverse)


def block_fft_stages(x: torch.Tensor, *, inverse: bool = False
                     ) -> torch.Tensor:
    """Single-pass mixed-radix FFT over the last axis of ``x`` (batched,
    unnormalized), following ``make_plan(n).stages[0]``."""
    n = x.shape[-1]
    if n == 1:
        return x
    return _fft_recursive(x, list(make_plan(n).stages[0]), inverse)


def _fft_recursive(x: torch.Tensor, stages, inverse: bool) -> torch.Tensor:
    n = x.shape[-1]
    if len(stages) == 0 or n == 1:
        return x
    st = stages[0]
    r, m = st.radix, st.m
    if r * m != n:
        raise ValueError(f"stage {st} does not fit length {n}")
    lead = tuple(x.shape[:-1])
    z = x.reshape(lead + (r, m))
    # a broadcast matmul computes each signal alike whatever the batch
    # (einsum's path, and so its rounding, changes with the batch size)
    z = torch.matmul(_factor_const(r, x, inverse), z)
    if m > 1:
        z = z * _twiddle_const(r, m, x, inverse)
        z = _fft_recursive(z, stages[1:], inverse)  # FFT along last axis (m)
    # k = k1 + r*k2  ->  output viewed as (m, r) row-major is Y^T
    return z.transpose(-1, -2).reshape(lead + (n,))


def fft_with_plan(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Single-pass FFT following ``plan.stages[0]`` (1/N on the inverse)."""
    if plan.num_passes != 1:
        raise ValueError(f"fft_with_plan is single-pass, got "
                         f"num_passes={plan.num_passes} — use "
                         f"large.fft_large for multi-pass plans")
    y = _fft_recursive(x, list(plan.stages[0]), plan.inverse)
    if plan.inverse:
        y = y / plan.n
    return y


def _fft(x: torch.Tensor, *, inverse: bool) -> torch.Tensor:
    plan = make_plan(x.shape[-1], inverse=inverse)
    if plan.num_passes == 1:
        return fft_with_plan(x, plan)
    from . import large  # local import to avoid cycle

    return large.fft_large(x, plan)


def fft(x) -> torch.Tensor:
    """Forward FFT over the last axis. Matches ``torch.fft.fft``."""
    return _fft(_as_complex(x), inverse=False)


def ifft(x) -> torch.Tensor:
    """Inverse FFT over the last axis (normalized by 1/N)."""
    return _fft(_as_complex(x), inverse=True)


def naive_dft(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """O(N^2) direct DFT — the paper's conceptual v0 lower bound."""
    n = x.shape[-1]
    w = _factor_const(n, x, inverse)
    y = torch.einsum("kn,...n->...k", w, x)
    return y / n if inverse else y


def radix2_fft(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Pure radix-2 Stockham (the paper's TurboFFT-v0: log2(N) stages)."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("power of two required")
    stages = []
    m = n
    while m > 1:
        m //= 2
        stages.append(StagePlan(radix=2, m=m))
    y = _fft_recursive(x, stages, inverse)
    return y / n if inverse else y
