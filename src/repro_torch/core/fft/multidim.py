"""Local multi-dimensional FFTs: fftn over the last axes, the packed
real-input rfft2/irfft2, and 2-D convolution.

The local part of ``repro.core.fft.multidim``; its slab and pencil mesh
decompositions are ROADMAP queue 1 item 10.3 (``fft_convolve2(mesh=...)``
raises). Every transform axis is bound by the plan to an
:class:`~repro_torch.kernels.ops.AxisFFT` (its stage plan and device
tables), or to ``None`` when its length is not a power of two:

* a power-of-two axis runs :func:`repro_torch.kernels.ops._fft_axis` — the
  block-FFT kernel on the card, its plain version on the CPU. An axis that
  is not the last is one launch over strided columns, in place: no
  ``movedim`` and no transpose copy;
* any other length runs the O(n^2) direct DFT (``stockham.naive_dft``)
  through a ``movedim`` view, the reference's local fallback.

The first transform of a call writes a new tensor; the later ones work in
place in it, so the caller's operand is never written. Each inverse axis
carries its own 1/n inside its launch, so an inverse fftn is normalized by
1/prod(n) with no extra pass.

The Hermitian pack and unpack of the real transforms are plain torch
operations, as the reference computes them outside any kernel: the pack
``x[..., 0::2] + 1j*x[..., 1::2]`` is ``torch.view_as_complex`` (no copy),
the interleave of the inverse is ``torch.view_as_real``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .stockham import naive_dft

__all__ = ["fft_convolve2"]


def _is_pow2(n: int) -> bool:
    return n > 0 and not (n & (n - 1))


def _local_axis_fft(z: torch.Tensor, axis: int, ax, *, inverse: bool,
                    scale: float = 1.0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The UNNORMALIZED transform of ``z`` along ``axis`` times ``scale``,
    into ``out`` (which may be ``z``; new when omitted). ``ax`` is the
    axis's :class:`~repro_torch.kernels.ops.AxisFFT`, or ``None`` for the
    direct DFT of a length that is not a power of two."""
    if ax is not None:
        from repro_torch.kernels import ops  # lazy: ops imports core.fft
        return ops._fft_axis(z, axis, ax.plan, ax.tables[inverse],
                             ax.twiddles[inverse], inverse=inverse,
                             scale=scale, out=out)
    n = z.shape[axis]
    y = naive_dft(z.movedim(axis, -1), inverse=inverse)
    factor = scale * n if inverse else scale      # naive_dft's inverse is 1/n
    if factor != 1.0:
        y = y * factor
    y = y.movedim(-1, axis)
    if out is None:
        return y.contiguous()
    return out.copy_(y)


def _local_fftn(x: torch.Tensor, axes, *, inverse: bool) -> torch.Tensor:
    """Local n-D transform over the last ``len(axes)`` axes of ``x``
    (numpy conventions: the inverse is normalized by 1/prod(n)); ``axes``
    holds each transform axis's :class:`~repro_torch.kernels.ops.AxisFFT`
    (or ``None``), slowest first. The last axis goes first and writes a new
    tensor; every other axis then transforms it in place."""
    x = x.contiguous()
    y = None
    for i in range(len(axes) - 1, -1, -1):
        axis = i - len(axes)
        n = x.shape[axis]
        y = _local_axis_fft(x if y is None else y, axis, axes[i],
                            inverse=inverse,
                            scale=1.0 / n if inverse else 1.0, out=y)
    return y


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return (torch.complex128 if dtype in (torch.float64, torch.complex128)
            else torch.complex64)


def _real_of(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


@functools.lru_cache(maxsize=256)
def _hermitian_tables(cc: int, dtype: torch.dtype, inverse: bool,
                      device: str):
    """Index and weight tables of the Hermitian unpack (forward) or repack
    (inverse) for ``cc`` real points, built in float64 and cast once.

    Forward, k = 0..cc/2: ``X[k] = a[k] Z[k mod h] + b[k] conj(Z[(h - k)
    mod h])`` with ``a, b = 1/2 -+ i/2 w^k``, w = exp(-2 pi i / cc), h =
    cc/2 — the reference's ``0.5 (Z + Z*) - 0.5i w (Z - Z*)``. Inverse,
    k = 0..h-1: ``z[k] = a[k] Y[k] + b[k] conj(Y[h - k])`` with
    ``a, b = 1/2 +- i/2 w^-k`` — its ``e + i o``."""
    half = cc // 2
    if inverse:
        k = np.arange(half)
        iw = 0.5j * np.exp(2j * np.pi * k / cc)
        idx, ridx = k, half - k
        a, b = 0.5 + iw, 0.5 - iw
    else:
        k = np.arange(half + 1)
        iw = 0.5j * np.exp(-2j * np.pi * k / cc)
        idx, ridx = k % half, (half - k) % half
        a, b = 0.5 - iw, 0.5 + iw
    np_dtype = np.complex128 if dtype == torch.complex128 else np.complex64
    return tuple(torch.from_numpy(t).to(device) for t in (
        idx.astype(np.int64), ridx.astype(np.int64), a.astype(np_dtype),
        b.astype(np_dtype)))


def _combine(z: torch.Tensor, cc: int, *, inverse: bool) -> torch.Tensor:
    """``a * z[idx] + b * conj(z[ridx])`` along the last axis with the
    tables of :func:`_hermitian_tables`: five torch kernels (two gathers, a
    conjugation, a product and a fused multiply-add)."""
    idx, ridx, a, b = _hermitian_tables(cc, z.dtype, inverse, str(z.device))
    zc = z.index_select(-1, ridx).conj_physical_()
    return z.index_select(-1, idx).mul_(a).addcmul_(zc, b)


def _unpack_half(zf: torch.Tensor, cc: int) -> torch.Tensor:
    """Hermitian unpack of the packed half-length spectrum: (..., C/2)
    C2C bins of z = x_even + i*x_odd -> the (..., C/2+1) rfft bins."""
    return _combine(zf, cc, inverse=False)


def _pack(x: torch.Tensor) -> torch.Tensor:
    """``x[..., 0::2] + 1j*x[..., 1::2]`` of a real (..., C) tensor, C even,
    as a complex view of its storage (a copy only when ``x`` is not
    contiguous or starts at an odd element)."""
    x = x.contiguous()
    if x.storage_offset() % 2:
        x = x.clone()
    return torch.view_as_complex(x.view(x.shape[:-1] + (x.shape[-1] // 2, 2)))


def _rfft_cols(x: torch.Tensor, half) -> torch.Tensor:
    """Packed rfft over the (even-length) last axis: (..., C) real ->
    (..., C/2+1) half spectrum, via one half-length C2C transform (``half``
    its axis bundle)."""
    cc = x.shape[-1]
    zf = _local_axis_fft(_pack(x), -1, half, inverse=False)
    return _unpack_half(zf, cc)


def _irfft_cols(y: torch.Tensor, half) -> torch.Tensor:
    """Inverse of :func:`_rfft_cols` (normalized):
    (..., C/2+1) half spectrum -> (..., C) real, C = 2*(bins-1). Recovers
    the packed half-length time signal z = x_even + i*x_odd from the
    spectrum's even/odd split, inverts it in place, then interleaves its
    real and imaginary parts (a view)."""
    h = y.shape[-1] - 1
    z = _combine(y, 2 * h, inverse=True)
    z = _local_axis_fft(z, -1, half, inverse=True, scale=1.0 / h, out=z)
    return torch.view_as_real(z).reshape(z.shape[:-1] + (2 * h,))


def _irfft_odd(y: torch.Tensor, n: int) -> torch.Tensor:
    """Real inverse of odd length ``n`` from the first (n+1)/2 bins of
    ``y``: the full Hermitian spectrum (no Nyquist bin), then the direct
    inverse DFT."""
    yh = y[..., :(n + 1) // 2]
    full = torch.cat([yh, yh[..., 1:].flip(-1).conj()], dim=-1)
    return naive_dft(full, inverse=True).real


def _local_rfft2(x: torch.Tensor, rows, half) -> torch.Tensor:
    """Local rfft2 over the last two axes ((..., R, C) real ->
    (..., R, C/2+1)); ``rows`` and ``half`` bind the R-point and the
    C/2-point axes. Odd C runs the direct DFT and crops (the same fallback
    as the odd-n 1-D paths). The column transform of the (..., R, C/2+1)
    half spectrum works in place: one launch over C/2+1 strided columns."""
    cc = x.shape[-1]
    if cc % 2:
        z = _local_axis_fft(x.to(_complex_of(x.dtype)), -1, None,
                            inverse=False)[..., :cc // 2 + 1].contiguous()
    else:
        z = _rfft_cols(x, half)
    return _local_axis_fft(z, -2, rows, inverse=False, out=z)


def _local_irfft2(y: torch.Tensor, rows, half, *, cc: int) -> torch.Tensor:
    """Local irfft2: (..., R, cc//2 + 1) half spectrum -> (..., R, cc) real
    (odd ``cc`` reconstructs the full Hermitian spectrum and runs the
    direct inverse DFT)."""
    rr = y.shape[-2]
    z = _local_axis_fft(y.contiguous(), -2, rows, inverse=True,
                        scale=1.0 / rr)
    if cc % 2:
        return _irfft_odd(z, cc)
    return _irfft_cols(z, half)


def _crop2(full: torch.Tensor, sa: tuple[int, int], sv: tuple[int, int],
           mode: str) -> torch.Tensor:
    """numpy convolve mode cropping applied per transform axis."""
    from .spectral import _crop  # per-axis 1-D crop

    out = _crop(full, sa[1], sv[1], mode)
    out = out.transpose(-1, -2)
    out = _crop(out, sa[0], sv[0], mode)
    return out.transpose(-1, -2)


def _pad2(x: torch.Tensor, nr: int, nc: int) -> torch.Tensor:
    """Zero-pad the last two axes to (nr, nc)."""
    return F.pad(x, (0, nc - x.shape[-1], 0, nr - x.shape[-2]))


def _convolve2(a: torch.Tensor, v: torch.Tensor, *, mode: str, axes,
               real: bool) -> torch.Tensor:
    """The local 2-D convolution of :func:`fft_convolve2` on operands
    already on the plan's device in their compute dtype; ``axes`` binds the
    padded (nr, nc) grid (the nc/2 axis when ``real``)."""
    sa = (a.shape[-2], a.shape[-1])
    sv = (v.shape[-2], v.shape[-1])
    nr, nc = _conv2_shape(sa, sv)
    ap, vp = _pad2(a, nr, nc), _pad2(v, nr, nc)
    rows, cols = axes
    if real:
        fa = _rfft_cols(ap, cols)
        fa = _local_axis_fft(fa, -2, rows, inverse=False, out=fa)
        fv = _rfft_cols(vp, cols)
        fv = _local_axis_fft(fv, -2, rows, inverse=False, out=fv)
        prod = fa * fv
        prod = _local_axis_fft(prod, -2, rows, inverse=True, scale=1.0 / nr,
                               out=prod)
        full = _irfft_cols(prod, cols)
    else:
        full = _local_fftn(_local_fftn(ap, axes, inverse=False)
                           * _local_fftn(vp, axes, inverse=False), axes,
                           inverse=True)
    return _crop2(full[..., :sa[0] + sv[0] - 1, :sa[1] + sv[1] - 1],
                  sa, sv, mode)


def _conv2_shape(sa, sv) -> tuple[int, int]:
    """The padded grid of a 2-D linear convolution: each axis a power of
    two >= its linear size."""
    from .spectral import _next_pow2
    return (_next_pow2(sa[0] + sv[0] - 1), _next_pow2(sa[1] + sv[1] - 1))


def fft_convolve2(a, v, mesh=None, *, mode: str = "full",
                  device="cuda") -> torch.Tensor:
    """2-D linear convolution over the last two axes, ``jnp.convolve`` mode
    semantics (full/same/valid) applied per axis, batched over leading
    dims, on ``device``.

    ``v`` is one kernel ``(Kr, Kc)`` shared by the whole batch or a
    per-signal batch matching ``a``'s leading dims; real inputs give a real
    result. Each axis is padded to a power of two >= its linear size. When
    BOTH operands are real the round trip is the packed half-spectrum
    pipeline (a rank-2 real plan: rfft over the columns, one strided launch
    over the rows); otherwise the complex rank-2 plan. Sugar over
    ``plan(FFTSpec(..., rank=2)).convolve``. ``mesh`` is ROADMAP queue 1
    item 10.3 and raises.
    """
    from . import api
    from .distributed import _ITEM_10_3
    from .spectral import _result_dtypes

    if mesh is not None:
        raise NotImplementedError(f"fft_convolve2 on a mesh is not ported "
                                  f"yet: {_ITEM_10_3}")
    a = torch.as_tensor(a)
    v = torch.as_tensor(v)
    if a.dim() < 2 or v.dim() < 2:
        raise ValueError("fft_convolve2 needs 2-D operands")
    cdtype, real = _result_dtypes(a, v)
    nr, nc = _conv2_shape(a.shape[-2:], v.shape[-2:])
    spec = api.FFTSpec(shape=tuple(a.shape[:-2]) + (nr, nc),
                       dtype=cdtype, rank=2, mesh=mesh,
                       real=real and nc % 2 == 0, device=str(device))
    return api.plan(spec).convolve(a, v, mode=mode)

