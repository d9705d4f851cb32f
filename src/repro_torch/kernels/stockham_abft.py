"""Kernel 2: the block FFT with fused two-sided ABFT (``csrc/abft_fft.cu``).

Replaces ``repro.kernels.stockham_abft.abft_fft_pallas``. A batch of
B = G * T * bs signals forms G checksum groups of T transactions of bs
signals. :func:`abft_fft` returns ``(y, delta, cs)``:

* ``y`` — (B, N) the forward FFT, with the simulated SEU added,
* ``delta`` — (B,) per-signal left-checksum divergence
  ``|(e1^T W) x_b - e1^T y_b| / (|(e1^T W) x_b| + EPS)`` (zeros when
  ``per_signal=False``),
* ``cs`` — (4, G, N) complex right-side checksums per group
  ``[X.e2, X.e3, Y.e2, Y.e3]`` with e2 = ones and e3 the 1-based global
  signal id (the reference packs the same sums as (G, 8, N) split re/im).

``inject`` is the 6-field SEU ``[tile, row, col, enabled, eps_r, eps_i]``
(integer fields truncated), added to ``y[tile*bs + row, col]`` before any
output checksum. Forward only, as the reference: ``inverse=True`` raises.
A CUDA tensor runs the kernel, a CPU tensor the plain torch version
:func:`abft_fft_plain`; any other device raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.abft.encoding import (EPS, left_encoding,
                                            left_encoding_image)
from repro_torch.core.fft.plan import MAX_BLOCK_N, StagePlan

from . import _build
from .stockham import (_check_tables, block_fft_plain, device_key,
                       pack_radices, stage_tables)

__all__ = ["abft_fft", "abft_fft_plain", "encoding_vectors"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    f"abft_fft_{s}": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                      _I, _I, _I, ctypes.c_ulonglong, _I, _P)
    for s in ("c64", "c128")
}
_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


@functools.lru_cache(maxsize=None)
def _encoding_vectors(n: int, encoding: str, dtype: torch.dtype,
                      device: str):
    np_dtype = np.complex64 if dtype == torch.complex64 else np.complex128
    ew = torch.from_numpy(left_encoding_image(n, encoding).astype(np_dtype))
    e1 = torch.from_numpy(left_encoding(n, encoding).astype(np_dtype))
    return ew.to(device), e1.to(device)


def encoding_vectors(n: int, encoding: str, dtype: torch.dtype, device):
    """``(e1^T W, e1)`` as complex (N,) tensors on ``device``, built once."""
    return _encoding_vectors(n, encoding, dtype, device_key(device))


def _geometry(x: torch.Tensor, bs: int, transactions: int,
              inverse: bool) -> int:
    if inverse:
        raise NotImplementedError(
            "ABFT protection covers the forward transform (paper scope); "
            "protect ifft by conjugation: ifft(x) = conj(fft(conj(x)))/n")
    b = x.shape[0]
    if bs <= 0 or b % bs != 0:
        raise ValueError(f"batch {b} is not divisible by tile size bs={bs}")
    tiles = b // bs
    if transactions <= 0 or tiles % transactions != 0:
        raise ValueError(f"tiles={tiles} (batch {b} / bs={bs}) is not "
                         f"divisible by transactions={transactions}")
    return tiles // transactions


def abft_fft_plain(x: torch.Tensor, stages: Sequence[StagePlan], *, bs: int,
                   transactions: int = 1, per_signal: bool = True,
                   encoding: str = "wang", inject=None,
                   inverse: bool = False):
    """Plain torch version of the kernel: the same ``(y, delta, cs)``."""
    b, n = x.shape
    groups = _geometry(x, bs, transactions, inverse)
    rdt = _REAL[x.dtype]
    y = block_fft_plain(x, stages)
    if inject is not None:
        inj = torch.as_tensor(inject).to(device=x.device, dtype=rdt)
        sig = torch.arange(b, device=x.device)
        col = torch.arange(n, device=x.device)
        hit = ((inj[3] > 0) & (sig // bs == inj[0].to(torch.int32))[:, None]
               & (sig % bs == inj[1].to(torch.int32))[:, None]
               & (col == inj[2].to(torch.int32))[None, :])
        y = y + torch.where(hit, torch.complex(inj[4], inj[5]),
                            torch.zeros((), dtype=x.dtype, device=x.device))
    if per_signal:
        ew, e1 = encoding_vectors(n, encoding, x.dtype, x.device)
        s_in = x @ ew
        s_out = y @ e1
        delta = (s_in - s_out).abs() / (s_in.abs() + EPS)
    else:
        delta = torch.zeros(b, dtype=rdt, device=x.device)
    gid = torch.arange(1, b + 1, device=x.device).to(rdt)
    gid = gid.reshape(groups, transactions * bs, 1)
    xg = x.reshape(groups, transactions * bs, n)
    yg = y.reshape(groups, transactions * bs, n)
    cs = torch.stack([xg.sum(1), (gid * xg).sum(1),
                      yg.sum(1), (gid * yg).sum(1)])
    return y, delta, cs


def abft_fft(x: torch.Tensor, stages: Sequence[StagePlan], *, bs: int,
             transactions: int = 1, per_signal: bool = True,
             encoding: str = "wang", inject=None, inverse: bool = False,
             tables: torch.Tensor | None = None):
    """Fused FT-FFT of a contiguous (B, N) complex tensor: ``(y, delta,
    cs)`` as documented in the module. CUDA tensor: the kernel; CPU tensor:
    the plain version. ``tables`` is the forward :func:`stage_tables` of
    ``stages`` as an FFT plan keeps them (looked up when omitted)."""
    if x.device.type == "cpu":
        return abft_fft_plain(x, stages, bs=bs, transactions=transactions,
                              per_signal=per_signal, encoding=encoding,
                              inject=inject, inverse=inverse)
    if x.device.type != "cuda":
        raise ValueError(f"abft_fft runs on cuda (kernel) or cpu (plain "
                         f"version), got a {x.device.type} tensor")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"abft_fft takes complex64/complex128, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"abft_fft takes a contiguous (B, N) tensor, got "
                         f"shape {tuple(x.shape)}")
    b, n = x.shape
    if n > MAX_BLOCK_N or n & (n - 1) \
            or math.prod(st.radix for st in stages) != n:
        raise ValueError(f"stages {[s.radix for s in stages]} do not run a "
                         f"single-pass N={n} (N <= {MAX_BLOCK_N}, power of "
                         f"two)")
    groups = _geometry(x, bs, transactions, inverse)
    rdt = _REAL[x.dtype]
    y = torch.empty_like(x)
    delta = torch.empty(b, dtype=rdt, device=x.device)
    cs = torch.empty((4, groups, n), dtype=x.dtype, device=x.device)
    if tables is None:
        tables = stage_tables(stages, x.dtype, device=x.device)
    _check_tables(tables, x)
    ew, e1 = encoding_vectors(n, encoding, x.dtype, x.device)
    inj = None
    if inject is not None:
        inj = torch.as_tensor(inject).to(device=x.device, dtype=rdt)
        if inj.numel() != 6:
            raise ValueError(f"inject is the 6-field SEU descriptor, got "
                             f"{inj.numel()} values")
        inj = inj.contiguous()
    lib = _build.load("abft_fft", _SIGNATURES)
    fn = getattr(lib, f"abft_fft_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), delta.data_ptr(),
                 cs.data_ptr(), tables.data_ptr(), ew.data_ptr(),
                 e1.data_ptr(), None if inj is None else inj.data_ptr(),
                 b, n.bit_length() - 1, bs, transactions, len(stages),
                 pack_radices(stages), int(per_signal), stream)
    if err != 0:
        raise RuntimeError(f"abft_fft launch failed: CUDA error {err}")
    abft_fft.launches += 1
    return y, delta, cs


abft_fft.launches = 0
