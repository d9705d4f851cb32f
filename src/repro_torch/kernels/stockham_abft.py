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

The kernel runs each checksum group on one thread-block cluster: the
group's signals in tiles of S whole signals, C CTAs taking tiles c, c + C,
..., each CTA owning N / C columns of the group's sums.
:func:`launch_geometry` picks S, C, the steps, threads and shared memory
(``csrc/abft_fft.cu`` gives the design).
"""
from __future__ import annotations

import ctypes
import dataclasses
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
                       launch_lock, pack_radices, stage_tables)

__all__ = ["abft_fft", "abft_fft_plain", "encoding_vectors",
           "launch_geometry", "max_active_clusters", "Geometry"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    **{f"abft_fft_{s}": (_P,) * 10 for s in ("c64", "c128")},
    **{f"abft_fft_clusters_{s}": (_P,) for s in ("c64", "c128")},
}
_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_ITEMSIZE = {torch.complex64: 8, torch.complex128: 16}

TILE_POINTS = MAX_BLOCK_N      # points of one CTA tile (S * N)
POINTS_PER_THREAD = 16         # each thread's points in every stage
MAX_CLUSTER = 8                # the portable thread-block cluster size
SMEM_PER_CTA = 232448          # H100: the shared memory a CTA can use
SMEM_PER_SM = 233472           # H100: an SM's, 1 KiB of it kept per CTA
_FAST_RADIX = 16               # the register codelets' largest radix


def _next_pow2(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The launch of one checksum-group shape (see ``csrc/abft_fft.cu``).

    A group's ``bs * transactions`` signals of ``n`` points (``dtype``, a
    torch dtype name) in ``tiles`` tiles of ``sigs`` signals; a cluster of
    ``cluster`` CTAs a group, CTA c taking tiles c, c + C, ... in ``steps``
    steps, each owning ``n // cluster`` columns of the sums; ``threads`` a
    CTA, ``smem`` bytes of dynamic shared memory a CTA; ``fast``: every
    radix <= 16 (register codelets), else the generic stages."""

    n: int
    dtype: str
    bs: int
    transactions: int
    sigs: int
    tiles: int
    cluster: int
    steps: int
    threads: int
    smem: int
    fast: bool

    @property
    def rows(self) -> int:
        """Signals a group."""
        return self.bs * self.transactions

    @property
    def accumulators(self) -> str:
        """Where an owner keeps its column sums between the steps:
        ``"registers"`` with one step (each is written to cs straight
        away), ``"shared"`` memory with more."""
        return "registers" if self.steps == 1 else "shared"

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM holds by shared memory alone."""
        return SMEM_PER_SM // (self.smem + 1024)

    def pack(self, batch: int, stages=(), per_signal: bool = False):
        """The kernel's 13 x int64 geometry (see abft_fft_c64)."""
        return (ctypes.c_longlong * 13)(
            batch, self.n.bit_length() - 1, len(stages),
            pack_radices(stages), self.bs, self.transactions, self.sigs,
            self.cluster, self.steps, int(per_signal), int(self.fast),
            self.smem, self.threads)


@functools.lru_cache(maxsize=None)
def _geometry_of(n: int, dtype: torch.dtype, bs: int, transactions: int,
                 fast: bool) -> Geometry:
    rows = bs * transactions
    sigs = min(TILE_POINTS // n, _next_pow2(rows))
    tiles = -(-rows // sigs)
    cluster = min(MAX_CLUSTER, n, _next_pow2(tiles))
    steps = -(-tiles // cluster)
    threads = max(32, sigs * n // POINTS_PER_THREAD)
    sums = 4 * n // cluster if steps > 1 else 0
    points = sigs * n + 2 * sigs + threads // 32 + sums
    return Geometry(n=n, dtype=str(dtype).removeprefix("torch."), bs=bs,
                    transactions=transactions, sigs=sigs, tiles=tiles,
                    cluster=cluster, steps=steps, threads=threads,
                    smem=points * _ITEMSIZE[dtype], fast=fast)


def launch_geometry(stages: Sequence[StagePlan], dtype: torch.dtype, bs: int,
                    transactions: int) -> Geometry:
    """The kernel's launch for groups of ``transactions`` x ``bs``
    signals of N = prod(radices) points through ``stages``: a tile of S =
    min(8192 / N, rows rounded up to a power of two) signals, a cluster of
    C = min(8, N, tiles rounded up to a power of two) CTAs, N / 16 * S
    threads (at least 32) and the shared memory of the tile, the
    per-signal checksums, the warps' partials and, with more than one
    step, the owners' running sums (4 N / C points)."""
    n = math.prod(st.radix for st in stages)
    if n > MAX_BLOCK_N or n & (n - 1):
        raise ValueError(f"stages {[s.radix for s in stages]} do not run a "
                         f"single-pass N={n} (N <= {MAX_BLOCK_N}, power of "
                         f"two)")
    if bs <= 0 or transactions <= 0:
        raise ValueError(f"bs={bs} and transactions={transactions} must be "
                         f"positive")
    return _geometry_of(n, dtype, int(bs), int(transactions),
                        all(st.radix <= _FAST_RADIX for st in stages))


@functools.lru_cache(maxsize=None)
def _clusters(geo: Geometry, device: str) -> int:
    lib = _build.load("abft_fft", _SIGNATURES)
    suffix = _SUFFIX[getattr(torch, geo.dtype)]
    packed = geo.pack(geo.rows)
    with torch.cuda.device(torch.device(device)):
        got = getattr(lib, f"abft_fft_clusters_{suffix}")(
            ctypes.addressof(packed))
    if got < 0:
        raise RuntimeError(f"abft_fft cluster query failed: CUDA error "
                           f"{-got}")
    return got


def max_active_clusters(geo: Geometry, device="cuda") -> int:
    """How many clusters of ``geo``'s launch the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: it cannot schedule one), asked
    once per geometry and device."""
    return _clusters(geo, device_key(device))


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
    ew, e1 = encoding_vectors(n, encoding, x.dtype, x.device)
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
    if x.dtype == torch.complex64 and (n < 2 or x.data_ptr() % 16):
        raise ValueError(f"abft_fft moves complex64 in 16-byte pairs: it "
                         f"takes N >= 2 and a 16-byte aligned x, got N={n} "
                         f"at address {x.data_ptr():#x}")
    groups = _geometry(x, bs, transactions, inverse)
    stages = tuple(stages)
    geo = launch_geometry(stages, x.dtype, bs, transactions)
    if groups and max_active_clusters(geo, x.device) < 1:
        raise RuntimeError(f"abft_fft: the card cannot schedule a cluster "
                           f"of {geo.cluster} CTAs with {geo.smem} bytes of "
                           f"shared memory each ({geo})")
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
    packed = geo.pack(b, stages, per_signal)
    lib = _build.load("abft_fft", _SIGNATURES)
    fn = getattr(lib, f"abft_fft_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), delta.data_ptr(),
                 cs.data_ptr(), tables.data_ptr(), ew.data_ptr(),
                 e1.data_ptr(), None if inj is None else inj.data_ptr(),
                 ctypes.addressof(packed), stream)
    if err != 0:
        raise RuntimeError(f"abft_fft launch failed: CUDA error {err}")
    with launch_lock:
        abft_fft.launches += 1
    return y, delta, cs


abft_fft.launches = 0
