"""Test oracles for the kernels: the platform library (``torch.fft``, the
cuFFT analogue on a card). Never on the main path."""
from __future__ import annotations

import torch

__all__ = ["fft_ref", "fft_ri_ref"]


def fft_ref(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Complex oracle: ``torch.fft`` over the last axis."""
    y = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
    return y.to(x.dtype)


def fft_ri_ref(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool = False):
    """Split real/imag form of :func:`fft_ref`, for comparing with the
    reference's split-layout kernels. (B, N) -> (B, N)."""
    y = fft_ref(torch.complex(xr, xi), inverse=inverse)
    return y.real.to(xr.dtype), y.imag.to(xi.dtype)
