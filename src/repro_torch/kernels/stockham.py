"""Kernel 1: the batched single-pass block FFT (``csrc/block_fft.cu``).

Replaces ``repro.kernels.stockham.block_fft_pallas``. :func:`block_fft` runs
the CUDA kernel on a CUDA tensor and its plain torch version
:func:`block_fft_plain` on a CPU tensor; any other device raises. The stage
matrices and twiddles of a plan are packed once into one flat complex table
on the device (:func:`stage_tables`) and reused by every launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.fft import factors
from repro_torch.core.fft.plan import MAX_BLOCK_N, StagePlan
from repro_torch.core.fft.stockham import fft_stages

from . import _build

__all__ = ["block_fft", "block_fft_plain", "stage_tables", "pack_radices"]

_P = ctypes.c_void_p
_SIGNATURES = {
    f"block_fft_{s}": (_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_ulonglong, ctypes.c_double, _P)
    for s in ("c64", "c128")
}
_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}


@functools.lru_cache(maxsize=None)
def _host_tables(stages: tuple[StagePlan, ...], dtype: torch.dtype,
                 inverse: bool) -> torch.Tensor:
    parts = []
    for st in stages:
        parts.append(factors.dft_matrix(st.radix, inverse=inverse).ravel())
        if st.m > 1:
            parts.append(factors.stage_twiddle(st.radix, st.m,
                                               inverse=inverse).ravel())
    flat = np.concatenate(parts) if parts else np.zeros(1, np.complex128)
    np_dtype = np.complex64 if dtype == torch.complex64 else np.complex128
    return torch.from_numpy(flat.astype(np_dtype))


@functools.lru_cache(maxsize=None)
def _device_tables(stages, dtype, inverse, device: str) -> torch.Tensor:
    return _host_tables(stages, dtype, inverse).to(device)


def stage_tables(stages: Sequence[StagePlan], dtype: torch.dtype, *,
                 inverse: bool = False, device="cpu") -> torch.Tensor:
    """The kernel's flat stage table on ``device``: per stage W_r (r*r,
    row-major) then, when m > 1, the twiddle T (r*m, row-major). Built in
    float64 numpy from :mod:`factors`, cast once, uploaded once per
    (stages, dtype, direction, device)."""
    return _device_tables(tuple(stages), dtype, bool(inverse),
                          device_key(device))


def device_key(device) -> str:
    """Canonical cache key of a device: ``"cuda"`` resolves to its index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def pack_radices(stages: Sequence[StagePlan]) -> int:
    """The stage radices as 4-bit log2 fields of one 64-bit word."""
    if len(stages) > 16:
        raise ValueError(f"{len(stages)} stages do not fit the packed word")
    word = 0
    for i, st in enumerate(stages):
        r = st.radix
        if r < 2 or r > 128 or r & (r - 1):
            raise ValueError(f"the kernel takes power-of-two radices "
                             f"2..128, got {r}")
        word |= (r.bit_length() - 1) << (4 * i)
    return word


def block_fft_plain(x: torch.Tensor, stages: Sequence[StagePlan], *,
                    inverse: bool = False, scale: float = 1.0
                    ) -> torch.Tensor:
    """Plain torch version of the kernel: ``scale`` times the unnormalized
    transform of each row of ``x`` through ``stages``."""
    y = fft_stages(x, stages, inverse=inverse)
    return y if scale == 1.0 else y * scale


def _check(x: torch.Tensor, stages: Sequence[StagePlan]) -> int:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"block_fft takes complex64/complex128, got "
                        f"{x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"block_fft takes a contiguous (B, N) tensor, got "
                         f"shape {tuple(x.shape)}")
    n = x.shape[1]
    if n > MAX_BLOCK_N or n & (n - 1) \
            or math.prod(st.radix for st in stages) != n:
        raise ValueError(f"stages {[s.radix for s in stages]} do not run a "
                         f"single-pass N={n} (N <= {MAX_BLOCK_N}, power of "
                         f"two)")
    return n.bit_length() - 1


def _check_tables(tables: torch.Tensor, x: torch.Tensor) -> None:
    if tables.dtype != x.dtype or tables.device != x.device \
            or not tables.is_contiguous():
        raise ValueError(f"stage tables must be a contiguous {x.dtype} "
                         f"tensor on {x.device}, got {tables.dtype} on "
                         f"{tables.device}")


def block_fft(x: torch.Tensor, stages: Sequence[StagePlan], *,
              inverse: bool = False, scale: float = 1.0,
              tables: torch.Tensor | None = None) -> torch.Tensor:
    """Batched single-pass FFT of each row of a (B, N) complex tensor through
    ``stages``, times ``scale``. CUDA tensor: the kernel; CPU tensor: the
    plain version. ``tables`` is the :func:`stage_tables` of ``stages`` in
    this direction as an FFT plan keeps them (looked up when omitted)."""
    if x.device.type == "cpu":
        return block_fft_plain(x, stages, inverse=inverse, scale=scale)
    if x.device.type != "cuda":
        raise ValueError(f"block_fft runs on cuda (kernel) or cpu (plain "
                         f"version), got a {x.device.type} tensor")
    log_n = _check(x, stages)
    y = torch.empty_like(x)
    if tables is None:
        tables = stage_tables(stages, x.dtype, inverse=inverse,
                              device=x.device)
    _check_tables(tables, x)
    lib = _build.load("block_fft", _SIGNATURES)
    fn = getattr(lib, f"block_fft_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), tables.data_ptr(), x.shape[0],
                 log_n, len(stages), pack_radices(stages), float(scale),
                 stream)
    if err != 0:
        raise RuntimeError(f"block_fft launch failed: CUDA error {err}")
    block_fft.launches += 1
    return y


block_fft.launches = 0
