"""ABFT encoding vectors and their precomputed DFT-side images.

Left-side checksum (paper §2.2.2): compare ``(e1^T W) x`` with ``e1^T y``.
``e1^T W`` is precomputed once — and since ``(e1^T W)[n] = DFT(e1)[n]``, the
precompute is itself just one FFT of the encoding vector.

Right-side checksums (paper §4.1): ``e2 = 1`` (correction value) and
``e3 = (1, 2, ..., B)`` (location encoding) combine a *batch* of signals.

Host-side numpy, bitwise equal to ``repro.core.abft.encoding``.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.fft import factors

__all__ = ["left_encoding", "left_encoding_image", "EPS"]

EPS = 1e-30


def left_encoding(n: int, kind: str = "wang") -> np.ndarray:
    """The left encoding vector e1 of length n (applied to outputs)."""
    if kind == "ones":
        return factors.ones_encoding(n)
    if kind == "wang":
        return factors.wang_encoding(n)
    raise ValueError(f"unknown encoding kind {kind!r}")


@functools.lru_cache(maxsize=None)
def left_encoding_image(n: int, kind: str = "wang",
                        inverse: bool = False) -> np.ndarray:
    """``e1^T W`` (applied to inputs): one host-side FFT of e1.

    For the inverse transform W is the (unnormalized) inverse DFT kernel, so
    the image is ifft(e1) * n.
    """
    e1 = left_encoding(n, kind)
    if inverse:
        return np.fft.ifft(e1) * n
    return np.fft.fft(e1)
