"""Spectral consumers: convolution, correlation and the periodogram.

The local part of ``repro.core.fft.spectral``: forward transform ->
pointwise product -> inverse, each transform the plan's own executor (the
block-FFT kernel on the card). Two REAL operands take one packed transform:
``p = a + i*v`` gives ``ifft(fft(p)^2) = a(.)a - v(.)v + 2i (a(.)v)``, so the
circular convolution is ``imag(.) / 2`` of one self-product, with the kernel
riding the imaginary part. Correlation of real operands is the same trick
on the circularly reversed kernel.

The reference's mesh pipelines (transposed digit order, two all-to-alls)
are ROADMAP queue 1 item 10.3: ``mesh=`` raises there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .distributed import _ITEM_10_3

__all__ = ["fft_convolve", "correlate", "power_spectrum", "conv_spec"]


def _no_mesh(mesh, what: str) -> None:
    """The spectral consumers run locally: a ``mesh`` raises."""
    if mesh is not None:
        raise NotImplementedError(f"{what} on a mesh is not ported yet: "
                                  f"{_ITEM_10_3}")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _result_dtypes(a: torch.Tensor, v: torch.Tensor):
    """(compute complex dtype, whether the result should be real)."""
    wide = (a.dtype in (torch.float64, torch.complex128)
            or v.dtype in (torch.float64, torch.complex128))
    cdtype = torch.complex128 if wide else torch.complex64
    real = not (a.is_complex() or v.is_complex())
    return cdtype, real


def _crop(full: torch.Tensor, la: int, lv: int, mode: str) -> torch.Tensor:
    """numpy convolve/correlate mode cropping of the length la+lv-1 result
    (a view)."""
    lmin, lmax = min(la, lv), max(la, lv)
    if mode == "full":
        return full
    if mode == "same":
        start = (lmin - 1) // 2
        return full[..., start:start + lmax]
    if mode == "valid":
        return full[..., lmin - 1:lmax]
    raise ValueError(f"mode must be full|same|valid, got {mode!r}")


def _pad_tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis to length n."""
    pad = n - x.shape[-1]
    if pad <= 0:
        return x
    return F.pad(x, (0, pad))


def _spectral_pair(a: torch.Tensor, v: torch.Tensor, *, conj_kernel: bool,
                   out_len: int, fwd, inv) -> torch.Tensor:
    """The length ``out_len`` head of the circular product's inverse of two
    padded complex operands: ``inv(fwd(a) * fwd(v))``, ``fwd(v)``
    conjugated for a correlation. ``fwd``/``inv`` are the plan's
    executors (linear results need nfft >= la + lv - 1, which callers
    guarantee)."""
    fv = fwd(v)
    if conj_kernel:
        fv = fv.conj()
    return inv(fwd(a) * fv)[..., :out_len]


def _spectral_real(a: torch.Tensor, v: torch.Tensor, *, conj_kernel: bool,
                   out_len: int, fwd, inv) -> torch.Tensor:
    """Circular product of two padded REAL operands via ONE packed
    transform: ``imag(inv(fwd(a + i*v)^2)) / 2``. Correlation with a real
    kernel is convolution with the circularly reversed kernel
    ``w[k] = v[-k mod n]``, so the same path serves ``conj_kernel=True``
    and the caller's roll/crop logic applies unchanged."""
    if conj_kernel:
        v = v.flip(-1).roll(1, -1)
    p = torch.complex(a, v.expand_as(a))     # kernel rides the imaginary part
    fp = fwd(p)
    return inv(fp.mul_(fp)).imag[..., :out_len] * 0.5


def _conv_nfft(la: int, lv: int) -> int:
    """FFT length for a linear result: power of two >= la + lv - 1."""
    return _next_pow2(la + lv - 1)


def conv_spec(a, v, mesh=None, *, device="cuda"):
    """The :class:`~repro_torch.core.fft.api.FFTSpec` of the padded
    transform one convolution/correlation of ``a`` with ``v`` runs: last
    axis padded to :func:`_conv_nfft`, batch dims from ``a``, compute dtype
    promoted across both operands, ``real`` when both are real. Build it
    once and reuse ``plan(spec).convolve/correlate``."""
    from . import api

    _no_mesh(mesh, "conv_spec")
    a = torch.as_tensor(a)
    v = torch.as_tensor(v)
    cdtype, real = _result_dtypes(a, v)
    nfft = _conv_nfft(a.shape[-1], v.shape[-1])
    return api.FFTSpec(shape=tuple(a.shape[:-1]) + (nfft,), dtype=cdtype,
                       rank=1, mesh=mesh, real=real, device=str(device))


def fft_convolve(a, v, mesh=None, *, mode: str = "full",
                 device="cuda") -> torch.Tensor:
    """Linear convolution along the last axis on ``device``.

    Matches ``np.convolve`` (modes full/same/valid) batched over leading
    dims; ``v`` is one kernel ``(Lv,)`` shared by the whole batch or a
    per-signal batch matching ``a``'s leading dims. Real inputs give a real
    result through one packed transform pair. Sugar over
    ``plan(conv_spec(a, v)).convolve``; ``mesh`` is ROADMAP queue 1 item
    10.3 and raises."""
    from . import api

    return api.plan(conv_spec(a, v, mesh, device=device)).convolve(
        a, v, mode=mode)


def correlate(a, v, mesh=None, *, mode: str = "full",
              device="cuda") -> torch.Tensor:
    """Cross-correlation along the last axis: ``c[m] = sum_k a[m+k] *
    conj(v[k])``, ``np.correlate`` conventions (modes full/same/valid),
    batched over leading dims. Sugar over
    ``plan(conv_spec(...)).correlate``."""
    from . import api

    return api.plan(conv_spec(a, v, mesh, device=device)).correlate(
        a, v, mode=mode)


def power_spectrum(x, mesh=None, *, real: bool = False,
                   device="cuda") -> torch.Tensor:
    """Periodogram ``|X[k]|^2 / N`` along the last axis (real output), on
    ``device``, in natural bin order.

    ``real=True`` (opt-in: it changes the output SHAPE) takes a real input
    through the packed rfft and returns the one-sided ``N/2 + 1``-bin
    spectrum ``|X[k]|^2 / N`` for ``k <= N/2``."""
    from . import api

    _no_mesh(mesh, "power_spectrum")
    x = torch.as_tensor(x)
    if real and x.is_complex():
        raise ValueError(f"power_spectrum(real=True) takes a real input, "
                         f"got {x.dtype}")
    if real:
        dt = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    else:
        dt = x.dtype if x.is_complex() else torch.complex64
    spec = api.FFTSpec(shape=tuple(x.shape), dtype=dt, mesh=mesh, real=real,
                       device=str(device))
    return api.plan(spec).power_spectrum(x)
