"""FFT library extensions beyond the paper's C2C core: the real-input
transform, the 2-D transform, and the FT-protected inverse via conjugation.

The local part of ``repro.core.fft.extensions``. These compose the
validated building blocks (no new numerics):

  rfft:  real -> half spectrum via ONE C2C FFT of half length (the packing
         trick: z = x_even + i*x_odd, a view of the operand's storage),
  irfft: the packed half-length inverse (the same function as the
         reference's full-length inverse, at half the work),
  fft2:  sugar over a rank-2 plan (``core.fft.api``); with ``mesh`` the
         slab or pencil decomposition (``core.fft.multidim``),
  ft_ifft: ifft(x) = conj(fft(conj(x))) / N — it runs the *forward*
         protected kernel, so the two-sided ABFT covers the inverse too.

Every public function builds (or LRU-hits) the
:class:`~repro_torch.core.fft.api.FFTPlan` describing the call on
``device`` (``"cuda"`` by default: the block-FFT kernel) and runs its
executor. Odd lengths are outside the power-of-two planner and run the
O(n^2) direct DFT (``stockham.naive_dft``), as in the reference.

One deliberate difference: the reference's ``irfft(y, n)`` with an even
``n`` larger than ``2*(bins-1)`` returns ``2*(bins-1)`` samples, not ``n``.
Here that raises ``ValueError`` naming the largest ``n`` the spectrum
gives.
"""
from __future__ import annotations

import dataclasses

import torch

from .distributed import _AUTO, FFT_AXIS
from .multidim import _complex_of, _irfft_cols, _irfft_odd, _rfft_cols
from .stockham import naive_dft

__all__ = ["rfft", "irfft", "fft2", "ifft2", "rfft2", "irfft2", "ft_ifft"]


def _rfft(x: torch.Tensor, half) -> torch.Tensor:
    """The rank-1 real plan's forward executor: ``x`` real on the plan's
    device, ``half`` the bundle of its N/2-point axis."""
    n = x.shape[-1]
    if n % 2:
        # odd n: no even/odd split — direct DFT, cropped half spectrum
        return naive_dft(x.to(_complex_of(x.dtype)))[..., :n // 2 + 1]
    return _rfft_cols(x, half)


def _irfft(y: torch.Tensor, half, *, n: int) -> torch.Tensor:
    """The rank-1 real plan's inverse executor: the ``n//2 + 1`` bins of
    ``y`` -> ``n`` real samples."""
    if n % 2:
        return _irfft_odd(y, n)
    return _irfft_cols(y, half)


def rfft(x, *, mesh=None, axis: str = FFT_AXIS,
         data_axis: str | None = _AUTO, device="cuda") -> torch.Tensor:
    """Real-input FFT over the last axis -> (..., N/2+1) half spectrum, on
    ``device``: a rank-1 real plan (float64 keeps complex128). Odd lengths
    run the direct DFT and crop to the ``n//2 + 1`` bins.

    ``mesh`` (inferred from a DTensor operand when omitted) runs the
    packed half-length C2C transform on the pencil pipeline over its
    ``axis`` dimension, the batch over ``data_axis``; the Hermitian unpack
    stays local on the gathered rows. A (B, N) operand; the result is a
    DTensor replicated over ``axis``. Sizes the pencil cannot split run
    locally."""
    from . import api

    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if x.shape[-1] == 0:
        raise ValueError("rfft: empty signal axis (n=0) has no spectrum")
    return api.plan(api.spec_for(x, real=True, mesh=mesh, axis=axis,
                                 data_axis=data_axis,
                                 device=device)).rfft(x)


def irfft(y, n: int | None = None, *, mesh=None, axis: str = FFT_AXIS,
          data_axis: str | None = _AUTO, device="cuda") -> torch.Tensor:
    """Inverse of :func:`rfft`: (..., bins) half spectrum -> (..., n) real.

    Even ``n`` (default ``2*(bins-1)``) reconstructs the ``2*(bins-1)``-point
    signal and truncates it to ``n`` samples; an even ``n`` above
    ``2*(bins-1)`` raises. Odd ``n`` crops to the ``(n+1)//2`` bins an
    odd-length real signal has (numpy's convention) and inverts exactly by
    the direct DFT. ``mesh``, ``axis`` and ``data_axis`` as :func:`rfft`:
    the half-length inverse rides the pencil pipeline (odd ``n`` runs
    locally).
    """
    from . import api

    y = y if isinstance(y, torch.Tensor) else torch.as_tensor(y)
    if mesh is None:
        from repro_torch.parallel.fft_sharding import infer_fft_mesh
        mesh = infer_fft_mesh(y, axis)
    bins = y.shape[-1]
    if bins == 0:
        raise ValueError("irfft: empty spectrum (0 bins)")
    if n is None:
        if bins == 1:
            raise ValueError(
                "irfft: a single-bin spectrum has no default length "
                "(2*(bins-1) = 0) — pass n explicitly (n=1 or n=2)")
        n = 2 * (bins - 1)
    if n <= 0:
        raise ValueError(f"irfft: output length must be positive, got n={n}")
    dtype = (torch.complex128 if y.dtype in (torch.complex128, torch.float64)
             else torch.complex64)
    if n == 1:
        # one sample: the spectrum is just the (real) DC bin
        return y[..., :1].to(device=device, dtype=dtype).real
    if n % 2:
        mesh = None                    # the direct DFT runs locally
    if n % 2:
        full = n
        m = (n + 1) // 2   # bins of an odd-length real signal
        if bins < m:
            raise ValueError(f"irfft: spectrum has {bins} bins but odd "
                             f"n={n} needs at least {m}")
        y = y[..., :m]
    else:
        full = 2 * (bins - 1)
        if n > full:
            raise ValueError(
                f"irfft: {bins} bins reconstruct at most n={full} even "
                f"samples, got n={n} — pass n <= {full} or a longer "
                f"spectrum")
    spec = api.FFTSpec(shape=tuple(y.shape[:-1]) + (full,), dtype=dtype,
                       real=True, mesh=mesh, axis=axis, data_axis=data_axis,
                       device=str(device))
    out = api.plan(spec).irfft(y)
    return out if n == full else out[..., :n]


def fft2(x, *, mesh=None, axis: str = FFT_AXIS, natural_order: bool = True,
         decomp: str = "auto", data_axis: str | None = _AUTO,
         device="cuda") -> torch.Tensor:
    """2-D FFT over the last two axes on ``device``: sugar over a rank-2
    plan. Real inputs promote (float64 to complex128); odd and other
    non-power-of-two axes run the direct DFT. ``mesh`` (inferred from a
    DTensor operand when omitted) runs the slab or pencil decomposition
    (``decomp``; ``natural_order=False`` keeps a pencil result in the
    transposed digit order)."""
    return _fft2(x, False, mesh=mesh, axis=axis, natural_order=natural_order,
                 decomp=decomp, data_axis=data_axis, device=device)


def ifft2(x, *, mesh=None, axis: str = FFT_AXIS, natural_order: bool = True,
          decomp: str = "auto", data_axis: str | None = _AUTO,
          device="cuda") -> torch.Tensor:
    """Inverse of :func:`fft2` (normalized by 1/(R*C)); on a mesh with
    ``natural_order=False`` it consumes the pencil's transposed order."""
    return _fft2(x, True, mesh=mesh, axis=axis, natural_order=natural_order,
                 decomp=decomp, data_axis=data_axis, device=device)


def _fft2(x, inverse: bool, **kw) -> torch.Tensor:
    from . import api

    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if not x.is_complex():
        x = x.to(_complex_of(x.dtype))
    p = api.plan(api.spec_for(x, rank=2, **kw))
    return p.ifft(x) if inverse else p.fft(x)


def rfft2(x, *, mesh=None, axis: str = FFT_AXIS,
          data_axis: str | None = _AUTO, decomp: str = "auto",
          device="cuda") -> torch.Tensor:
    """2-D real-input FFT over the last two axes -> (..., R, C/2+1) half
    spectrum, on ``device``: sugar over a rank-2 *real* plan (the packed
    rfft over the columns, then one launch over the C/2+1 strided
    columns of the rows' axis). On ``mesh`` the real slab (about half the
    all-to-all bytes of :func:`fft2`), or the composed pencil path."""
    from . import api

    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if x.is_complex():
        raise ValueError(f"rfft2 takes a real input, got {x.dtype}")
    return api.plan(api.spec_for(x, rank=2, real=True, mesh=mesh, axis=axis,
                                 data_axis=data_axis, decomp=decomp,
                                 device=device)).rfft2(x)


def irfft2(y, *, mesh=None, axis: str = FFT_AXIS,
           data_axis: str | None = _AUTO, decomp: str = "auto",
           device="cuda") -> torch.Tensor:
    """Inverse of :func:`rfft2`: (..., R, C/2+1) half spectrum ->
    (..., R, C) real grid with ``C = 2*(bins-1)`` (even columns only)."""
    from . import api

    y = y if isinstance(y, torch.Tensor) else torch.as_tensor(y)
    if y.dim() < 2:
        raise ValueError(f"irfft2 needs a rank >= 2 spectrum, got "
                         f"{tuple(y.shape)}")
    if y.shape[-1] < 2:
        raise ValueError(
            "irfft2: a single-bin half spectrum has no default width — "
            "the columns' full length 2*(bins-1) would be 0")
    if mesh is None:
        from repro_torch.parallel.fft_sharding import infer_fft_mesh
        mesh = infer_fft_mesh(y, axis)
    cc = 2 * (y.shape[-1] - 1)
    dtype = (torch.complex128 if y.dtype in (torch.complex128, torch.float64)
             else torch.complex64)
    spec = api.FFTSpec(shape=tuple(y.shape[:-2]) + (y.shape[-2], cc),
                       dtype=dtype, rank=2, real=True, mesh=mesh, axis=axis,
                       data_axis=data_axis, decomp=decomp,
                       device=str(device))
    return api.plan(spec).irfft2(y)


def ft_ifft(x, **ft_kwargs):
    """Fault-tolerant inverse FFT via conjugation around the protected
    forward kernel: ifft(x) = conj(fft(conj(x))) / N. ``ft_kwargs`` are
    :func:`~repro_torch.kernels.ops.ft_fft`'s (``device`` included).
    Returns the same :class:`~repro_torch.kernels.ops.FTFFTResult`, with
    ``y`` already conjugated and normalized."""
    from repro_torch.kernels import ops

    x = torch.as_tensor(x)
    if not x.is_complex():
        x = x.to(_complex_of(x.dtype))
    n = x.shape[-1]
    # conj_physical: the kernel reads the storage, not a lazy conjugate view
    res = ops.ft_fft(torch.conj_physical(x), **ft_kwargs)
    return dataclasses.replace(res, y=res.y.conj() / n)
