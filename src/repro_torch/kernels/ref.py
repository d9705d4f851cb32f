"""Test oracles for the kernels: the platform library (``torch.fft``, the
cuFFT analogue on a card; ``torch.matmul``). Never on the main path."""
from __future__ import annotations

import torch

__all__ = ["fft_ref", "fft_ri_ref", "matmul_ref", "abft_matmul_ref"]


def fft_ref(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Complex oracle: ``torch.fft`` over the last axis."""
    y = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
    return y.to(x.dtype)


def fft_ri_ref(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool = False):
    """Split real/imag form of :func:`fft_ref`, for comparing with the
    reference's split-layout kernels. (B, N) -> (B, N)."""
    y = fft_ref(torch.complex(xr, xi), inverse=inverse)
    return y.real.to(xr.dtype), y.imag.to(xi.dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in float32, returned in ``a.dtype``."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def abft_matmul_ref(a: torch.Tensor, b: torch.Tensor):
    """Oracle for the ABFT GEMM kernel: float32 product + exact checksum
    rows/cols ``(c, e^T C, C e)``."""
    c = torch.matmul(a.float(), b.float())
    return c, c.sum(0), c.sum(1)
