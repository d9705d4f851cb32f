"""DFT factor matrices and twiddle tables.

The paper precomputes twiddle factors into tables to avoid in-kernel
trigonometry (critical for FP64 on GPU). All tables here are built on host
with numpy in float64 and cast once, so kernel inputs are pure data. This is
a copy of ``repro.core.fft.factors``: the tables must stay bitwise equal to
the reference's, which the port's tests check.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "dft_matrix",
    "dft_matrix_ri",
    "stage_twiddle",
    "stage_twiddle_ri",
    "pass_twiddle",
    "wang_encoding",
    "ones_encoding",
    "location_encoding",
]


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int, *, inverse: bool = False) -> np.ndarray:
    """The (n, n) DFT matrix W with W[j, k] = exp(-2*pi*i*j*k / n).

    Forward sign convention matches ``numpy.fft.fft``. ``inverse=True``
    returns the *unnormalized* inverse kernel exp(+2*pi*i*j*k/n); the 1/n
    normalization is applied by the caller once per full transform.
    """
    sign = 1.0 if inverse else -1.0
    j = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    # Use exact angle reduction mod n to keep fp64 twiddles accurate for
    # large n (j*k can exceed 2**53 only for n > ~94M, far beyond our sizes).
    ang = sign * 2.0 * np.pi * ((j * k) % n) / n
    return np.cos(ang) + 1j * np.sin(ang)


def dft_matrix_ri(n: int, dtype=np.float32, *, inverse: bool = False):
    """DFT matrix as a (real, imag) pair of real arrays."""
    w = dft_matrix(n, inverse=inverse)
    return w.real.astype(dtype), w.imag.astype(dtype)


@functools.lru_cache(maxsize=None)
def stage_twiddle(r: int, m: int, *, inverse: bool = False) -> np.ndarray:
    """Stage twiddle table T[k1, n2] = exp(-2*pi*i*k1*n2/(r*m)), shape (r, m).

    For the Cooley-Tukey split N = r*m with input index n = m*n1 + n2 and
    output index k = k1 + r*k2 the stage computes::

        Y[k1, k2] = sum_n2 ( T[k1, n2] * sum_n1 W_r[k1, n1] X[n1, n2] ) W_m[n2, k2]
    """
    n = r * m
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(r)[:, None]
    n2 = np.arange(m)[None, :]
    ang = sign * 2.0 * np.pi * ((k1 * n2) % n) / n
    return np.cos(ang) + 1j * np.sin(ang)


def stage_twiddle_ri(r: int, m: int, dtype=np.float32, *, inverse: bool = False):
    t = stage_twiddle(r, m, inverse=inverse)
    return t.real.astype(dtype), t.imag.astype(dtype)


@functools.lru_cache(maxsize=None)
def pass_twiddle(m: int, *, inverse: bool = False) -> tuple[np.ndarray, int]:
    """The pass twiddle w_M^e, e < M, as two short tables with the exponent
    split into low and high halves: ``(table, log_l)`` with ``table`` =
    ``lo`` (L = 2^log_l entries, ``lo[j] = w_M^j``) then ``hi`` (M / L
    entries, ``hi[j] = w_M^(j*L)``), so that ``w_M^e = lo[e % L] *
    hi[e // L]``. L = 2^ceil(log2(M) / 2): about 2 sqrt(M) entries in all,
    built in float64 with the angle reduced exactly mod M.
    """
    if m <= 0 or m & (m - 1):
        raise ValueError(f"M must be a power of two, got {m}")
    log_m = m.bit_length() - 1
    log_l = (log_m + 1) // 2
    sign = 1.0 if inverse else -1.0
    lo = np.arange(1 << log_l)
    hi = (np.arange(m >> log_l) << log_l) % m
    ang = sign * 2.0 * np.pi * np.concatenate([lo, hi]) / m
    return np.cos(ang) + 1j * np.sin(ang), log_l


# ---------------------------------------------------------------------------
# ABFT encoding vectors (paper §2.2.2 / §4.1)
# ---------------------------------------------------------------------------

def ones_encoding(n: int, dtype=np.complex128) -> np.ndarray:
    """The all-ones vector e2. Misses opposite-sign error pairs (x+eps, x-eps)
    when used alone (paper §2.2.2) — used as the *correction-value* checksum.
    """
    return np.ones(n, dtype=dtype)


@functools.lru_cache(maxsize=None)
def wang_encoding(n: int) -> np.ndarray:
    """Wang's encoding e_Wang[k] = omega_3^k (omega_3 = exp(-2*pi*i/3)).

    Keeps the input unchanged (unlike Jou's variant) while avoiding the
    +/- eps cancellation blind spot of the ones vector [Wang & Jha 1994].
    """
    ang = -2.0 * np.pi * (np.arange(n) % 3) / 3.0
    return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex128)


def location_encoding(n: int, offset: int = 0, dtype=np.complex128) -> np.ndarray:
    """The location vector e3 = (1+o, 2+o, ..., n+o) (paper §4.1): the ratio of
    the e3-checksum divergence to the e2-checksum divergence recovers the
    (1-based, offset) index of the corrupted signal.
    """
    return (np.arange(n, dtype=np.float64) + 1.0 + offset).astype(dtype)
