"""Kernel 1: the batched block FFT, one launch a pass (``csrc/block_fft.cu``).

Replaces ``repro.kernels.stockham.block_fft_pallas``. :func:`block_fft` runs
the CUDA kernel on a CUDA tensor and its plain torch version
:func:`block_fft_plain` on a CPU tensor; any other device raises. The stage
matrices and twiddles of a plan are packed once into one flat complex table
on the device (:func:`stage_tables`) and reused by every launch; the pass
twiddle of a multi-pass transform is two short tables
(:func:`pass_twiddle_table`). A launch addresses its signals through a
:class:`~repro_torch.core.fft.plan.PassLayout`, so each pass of an
N1 x N2 (x N3) transform is one launch that reads and writes every point
once.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.fft import factors
from repro_torch.core.fft.plan import MAX_BLOCK_N, PassLayout, StagePlan
from repro_torch.core.fft.stockham import fft_stages

from . import _build

__all__ = ["block_fft", "block_fft_plain", "stage_tables",
           "pass_twiddle_table", "pack_radices"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    f"block_fft_{s}": (_P, _P, _P, _P, _P, _I, _I, ctypes.c_ulonglong, _I,
                       _I, _I, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_double, _P)
    for s in ("c64", "c128")
}
_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
# points of one CTA tile; the kernel's register codelets take radix <= 16
_TILE_POINTS = MAX_BLOCK_N
_FAST_RADIX = 16


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


@functools.lru_cache(maxsize=None)
def _device_pass_twiddle(m, dtype, inverse, device: str) -> torch.Tensor:
    table, _ = factors.pass_twiddle(m, inverse=inverse)
    np_dtype = np.complex64 if dtype == torch.complex64 else np.complex128
    return torch.from_numpy(table.astype(np_dtype)).to(device)


def pass_twiddle_table(m: int, dtype: torch.dtype, *, inverse: bool = False,
                       device="cpu") -> torch.Tensor:
    """The pass twiddle w_M^e as the kernel reads it on ``device``:
    :func:`factors.pass_twiddle`'s low table then its high table (about
    2 sqrt(M) entries), cast once, uploaded once per (M, dtype, direction,
    device)."""
    return _device_pass_twiddle(int(m), dtype, bool(inverse),
                                device_key(device))


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


def _tile_signals(n: int, layout: PassLayout) -> int:
    """Signals per CTA tile: as many whole signals as fit ``_TILE_POINTS``,
    taken along the fastest axis (a power of two that divides its count
    when there are slower axes, so a tile never straddles two of them: one
    signal a tile at an odd count), and no more than the launch has."""
    sigs = max(1, _TILE_POINTS // n)
    if len(layout.axes) > 1:
        fast = layout.fast_count
        sigs = min(sigs, fast & -fast)
    total = layout.signals
    return min(sigs, 1 << max(total - 1, 0).bit_length())


def _twiddle_split(m: int) -> tuple[int, int]:
    """(log2 M, log2 L) of the pass twiddle tables of ``m``."""
    log_m = m.bit_length() - 1
    return log_m, (log_m + 1) // 2


def _twiddle_m(n: int, layout: PassLayout, m: int | None) -> int:
    """The pass twiddle's M: ``m``, by default N times the fastest axis's
    count; a power of two either way."""
    m = n * layout.fast_count if m is None else int(m)
    if m <= 0 or m & (m - 1):
        raise ValueError(f"the pass twiddle's M must be a power of two, "
                         f"got {m}")
    return m


def _twiddle_index(layout: PassLayout, offset: int,
                   mid_step: int) -> torch.Tensor:
    """Each signal's pass twiddle index, over the layout's signal axes:
    ``offset`` + its index along the fastest axis + ``mid_step`` times its
    index along the axis before it."""
    counts = tuple(a[0] for a in layout.axes)
    idx = torch.arange(counts[-1]) + offset
    if mid_step and len(counts) > 1:
        idx = idx + mid_step * torch.arange(counts[-2])[:, None]
    return idx.expand(counts)


def block_fft_plain(x: torch.Tensor, stages: Sequence[StagePlan], *,
                    inverse: bool = False, scale: float = 1.0,
                    layout: PassLayout | None = None,
                    twiddle: torch.Tensor | None = None,
                    m: int | None = None, offset: int = 0,
                    mid_step: int = 0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the kernel: ``scale`` times the unnormalized
    transform of each row of ``x`` through ``stages``. With ``layout``, the
    signals are strided views of ``x``'s storage and the result is written
    through the output strides into ``out`` (a new tensor like ``x`` when
    omitted), each point k of a signal times the pass twiddle ``w_M^(k*i)``
    when ``twiddle`` is given: i is ``offset`` + the signal's index along
    the fastest axis + ``mid_step`` times its index along the axis before
    it, and M is ``m`` (by default N times the fastest axis's count)."""
    if layout is None:
        y = fft_stages(x, stages, inverse=inverse)
        y = y if scale == 1.0 else y * scale
        return y if out is None else out.copy_(y)
    n = math.prod(st.radix for st in stages)
    counts = tuple(a[0] for a in layout.axes)
    src = torch.as_strided(x, counts + (n,),
                           tuple(a[1] for a in layout.axes)
                           + (layout.point_in,))
    y = fft_stages(src, stages, inverse=inverse)
    if scale != 1.0:
        y = y * scale
    if twiddle is not None:
        log_m, log_l = _twiddle_split(_twiddle_m(n, layout, m))
        e = (_twiddle_index(layout, offset, mid_step)[..., None]
             * torch.arange(n)) & ((1 << log_m) - 1)
        e = e.to(twiddle.device)
        y = y * (twiddle[e & ((1 << log_l) - 1)]
                 * twiddle[(1 << log_l) + (e >> log_l)])
    if out is None:
        out = torch.empty_like(x)
    torch.as_strided(out, counts + (n,),
                     tuple(a[2] for a in layout.axes)
                     + (layout.point_out,)).copy_(y)
    return out


def _check_tables(tables: torch.Tensor, x: torch.Tensor) -> None:
    if tables.dtype != x.dtype or tables.device != x.device \
            or not tables.is_contiguous():
        raise ValueError(f"stage tables must be a contiguous {x.dtype} "
                         f"tensor on {x.device}, got {tables.dtype} on "
                         f"{tables.device}")


def _reach(layout: PassLayout, n: int, side: int) -> int:
    """One past the last element the layout addresses on ``side`` (1 in,
    2 out)."""
    point = layout.point_in if side == 1 else layout.point_out
    return 1 + (n - 1) * point + sum((a[0] - 1) * a[side]
                                     for a in layout.axes)


def _vec_ok(layout: PassLayout, n: int, sigs: int, side: int) -> bool:
    """Whether complex64 points can move as 16-byte pairs on ``side``: two
    points of a row (point stride 1), or the same point of two neighbouring
    signals (fastest axis of stride 1), every pair starting even."""
    point = layout.point_in if side == 1 else layout.point_out
    strides = [a[side] for a in layout.axes if a[0] > 1]
    if point == 1:
        return n >= 2 and all(st % 2 == 0 for st in strides)
    fast = layout.axes[-1][side] if layout.axes[-1][0] > 1 else None
    return (sigs >= 2 and fast == 1 and layout.signals % sigs == 0
            and point % 2 == 0
            and all(a[side] % 2 == 0 for a in layout.axes[:-1] if a[0] > 1))


@functools.lru_cache(maxsize=1024)
def _launch_desc(layout: PassLayout, n: int, vec_in: bool, vec_out: bool):
    """The kernel's 16 x int64 layout descriptor (see block_fft.cu) and the
    element counts the layout reaches on each side."""
    axes = ((1, 0, 0),) * (3 - len(layout.axes)) + tuple(layout.axes)
    sigs = _tile_signals(n, layout)
    vals = ([a[0] for a in axes] + [a[1] for a in axes]
            + [a[2] for a in axes]
            + [layout.point_in, layout.point_out, layout.signals, sigs,
               sigs.bit_length() - 1,
               int(vec_in and _vec_ok(layout, n, sigs, 1)),
               int(vec_out and _vec_ok(layout, n, sigs, 2))])
    return ((ctypes.c_longlong * 16)(*vals), _reach(layout, n, 1),
            _reach(layout, n, 2))


@functools.lru_cache(maxsize=None)
def _stage_args(stages: tuple[StagePlan, ...]) -> tuple[int, int, int, bool]:
    """(log2 N, stages, packed radices, every radix <= 16) of a launch;
    raises on stages the kernel does not run."""
    n = math.prod(st.radix for st in stages)
    if n > MAX_BLOCK_N or n & (n - 1):
        raise ValueError(f"stages {[s.radix for s in stages]} do not run a "
                         f"single-pass N={n} (N <= {MAX_BLOCK_N}, power of "
                         f"two)")
    return (n.bit_length() - 1, len(stages), pack_radices(stages),
            all(st.radix <= _FAST_RADIX for st in stages))


@functools.lru_cache(maxsize=256)
def _rows(batch: int, n: int) -> PassLayout:
    return PassLayout.rows(batch, n)


def _kernel(dtype: torch.dtype):
    """The C entry point of ``dtype`` (the library built at first use)."""
    fn = _KERNELS.get(dtype)
    if fn is None:
        lib = _build.load("block_fft", _SIGNATURES)
        fn = _KERNELS[dtype] = getattr(lib, f"block_fft_{_SUFFIX[dtype]}")
    return fn


_KERNELS: dict[torch.dtype, object] = {}


def block_fft(x: torch.Tensor, stages: Sequence[StagePlan], *,
              inverse: bool = False, scale: float = 1.0,
              tables: torch.Tensor | None = None,
              layout: PassLayout | None = None,
              twiddle: torch.Tensor | None = None,
              m: int | None = None, offset: int = 0, mid_step: int = 0,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the block FFT through ``stages``, times ``scale``.

    Without ``layout``: each row of a contiguous (B, N) tensor. With it:
    the signals the :class:`PassLayout` addresses in ``x``'s storage,
    written through its output strides into ``out`` (which may be ``x``
    itself when the layout reads and writes the same places; a new tensor
    like ``x`` when omitted), times the pass twiddle ``twiddle`` (a
    :func:`pass_twiddle_table` of M = ``m``, by default N * the fastest
    axis's count) when given: point k of a signal times ``w_M^(k*i)``, i =
    ``offset`` + the signal's fastest-axis index + ``mid_step`` * its index
    along the axis before that (a shard's pass over its columns of a
    larger transform). CUDA tensor: the kernel; CPU tensor: the plain
    version.
    ``tables`` is the :func:`stage_tables` of ``stages`` in this direction
    as an FFT plan keeps them (looked up when omitted)."""
    if x.device.type == "cpu":
        return block_fft_plain(x, stages, inverse=inverse, scale=scale,
                               layout=layout, twiddle=twiddle, m=m,
                               offset=offset, mid_step=mid_step, out=out)
    if x.device.type != "cuda":
        raise ValueError(f"block_fft runs on cuda (kernel) or cpu (plain "
                         f"version), got a {x.device.type} tensor")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"block_fft takes complex64/complex128, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"block_fft takes a contiguous tensor, got shape "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    stages = tuple(stages)
    log_n, nst, logr, fast = _stage_args(stages)
    n = 1 << log_n
    if layout is None:
        if x.dim() != 2 or x.shape[1] != n:
            raise ValueError(f"block_fft takes a contiguous (B, {n}) tensor "
                             f"without a layout, got shape {tuple(x.shape)}")
        layout = _rows(x.shape[0], n)
    if out is None:
        out = torch.empty_like(x)
    elif out.dtype != x.dtype or out.device != x.device \
            or not out.is_contiguous():
        raise ValueError("block_fft's out must be a contiguous tensor of "
                         "x's dtype on x's device")
    desc, reach_in, reach_out = _launch_desc(
        layout, n, x.data_ptr() % 16 == 0, out.data_ptr() % 16 == 0)
    if reach_in > x.numel() or reach_out > out.numel():
        raise ValueError(f"{layout} with N={n} reaches beyond x "
                         f"({x.numel()}) or out ({out.numel()})")
    if tables is None:
        tables = stage_tables(stages, x.dtype, inverse=inverse,
                              device=x.device)
    _check_tables(tables, x)
    tw_log_m, tw_ptr = 0, None
    if twiddle is not None:
        tw_log_m, log_l = _twiddle_split(_twiddle_m(n, layout, m))
        if twiddle.numel() != (1 << log_l) + (1 << (tw_log_m - log_l)):
            raise ValueError(f"the pass twiddle has {twiddle.numel()} "
                             f"entries, not those of M = 2^{tw_log_m}")
        _check_tables(twiddle, x)
        tw_ptr = twiddle.data_ptr()
    fn = _kernel(x.dtype)
    args = (x.data_ptr(), out.data_ptr(), tables.data_ptr(), tw_ptr,
            ctypes.addressof(desc), log_n, nst, logr, int(inverse),
            int(fast), tw_log_m, int(offset), int(mid_step), float(scale))
    index = x.device.index
    # the launch is on the current stream of x's device; switching devices
    # only when needed keeps the host's share of a launch small
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"block_fft launch failed: CUDA error {err}")
    with launch_lock:
        block_fft.launches += 1
    return out


block_fft.launches = 0
# the serving runtime's workers launch from several threads at once, and a
# bare ``+= 1`` on a launch count can lose one: counts change under this lock
launch_lock = threading.Lock()
