"""Spectral consumers: convolution, correlation and the periodogram.

The local part of ``repro.core.fft.spectral``: forward transform ->
pointwise product -> inverse, each transform the plan's own executor (the
block-FFT kernel on the card). Two REAL operands take one packed transform:
``p = a + i*v`` gives ``ifft(fft(p)^2) = a(.)a - v(.)v + 2i (a(.)v)``, so the
circular convolution is ``imag(.) / 2`` of one self-product, with the kernel
riding the imaginary part. Correlation of real operands is the same trick
on the circularly reversed kernel.

On a mesh (a ``DeviceMesh`` with an ``fft`` dimension of more than one
rank) the round trip stays in the FFTW-MPI transposed digit order: the
forward's pass 1 of the signal rows and of the kernel's rows go into one
send buffer, ONE all-to-all, pass 2, the pointwise product on each rank's
k1 block, then the TRANSPOSED_IN inverse, whose ONE all-to-all splits the
batch: exactly two all-to-alls (``2 * chunks``) and no all-gather
(``distributed.spectral_volume``), each signal's result whole on one rank
(a ``DTensor``, ``Shard(0)`` over ``data`` then over ``fft``). The real
pair rides one packed operand there too, so no kernel rows are sent. The
mesh path takes (B, L) signals.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .distributed import _AUTO, FFT_AXIS, _resolve_mesh, mesh_size

__all__ = ["fft_convolve", "correlate", "power_spectrum", "conv_spec"]


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


def _on_mesh(a: torch.Tensor, v: torch.Tensor, p, m, *, conj_kernel: bool,
             real: bool, out_len: int, chunks: int):
    """The circular product of padded (B, N) ``a`` and (BK, N) ``v`` (BK 1
    or B; a 1-D ``v`` is one kernel) on this rank of the mesh ``m``, with
    ``p`` the N-point pencil: the length ``out_len`` head of this rank's
    rows of the natural-order result (the imaginary half of the packed
    self-product, halved, for two real operands), and a function that
    makes a DTensor of the global (B, L) value from this rank's rows cut
    to L."""
    from . import distributed

    if a.dim() != 2:
        raise ValueError(f"the spectral consumers on a mesh take (B, L) "
                         f"signals, got {tuple(a.shape)}")
    v = v.reshape(-1, v.shape[-1])
    b, bk = a.shape[0], v.shape[0]
    if real:
        if conj_kernel:
            v = v.flip(-1).roll(1, -1)
        pk = torch.complex(a, v.expand_as(a))   # the kernel rides imag
        rows, spec = distributed._spectral_round_trip(
            pk, None, p, m, conj_kernel=False, chunks=chunks)
        rows = rows.imag * 0.5
    else:
        if bk not in (1, b):
            raise ValueError(
                f"kernel batch must be 1 or match the signal batch ({b}), "
                f"got {bk}")
        rows, spec = distributed._spectral_round_trip(
            a, v, p, m, conj_kernel=conj_kernel, chunks=chunks)

    def like(local: torch.Tensor):
        shape = (b, local.shape[-1])
        return distributed._dtensor(local.contiguous(), spec, m, shape)

    return rows[..., :out_len], like


def _conv_nfft(la: int, lv: int, shards: int = 1) -> int:
    """FFT length for a linear result: power of two >= la + lv - 1, raised
    to the mesh's least pencil size (shards^2) on ``shards`` ranks."""
    return max(_next_pow2(la + lv - 1), shards * shards)


def _shards(mesh, axis: str) -> int:
    mesh = _resolve_mesh(mesh, axis)
    return mesh_size(mesh, axis) if mesh is not None else 1


def _device(device, mesh):
    """``device``, by default the mesh's device type, else the card."""
    if device is not None:
        return str(device)
    return getattr(mesh, "device_type", None) or "cuda"


def conv_spec(a, v, mesh=None, *, axis: str = FFT_AXIS,
              data_axis: str | None = _AUTO, chunks: int = 1, device=None):
    """The :class:`~repro_torch.core.fft.api.FFTSpec` of the padded
    transform one convolution/correlation of ``a`` with ``v`` runs: last
    axis padded to :func:`_conv_nfft` (at least shards^2 on a mesh),
    batch dims from ``a``, compute dtype promoted across both operands,
    ``real`` when both are real. Build it once and reuse
    ``plan(spec).convolve/correlate``. ``chunks`` splits the mesh round
    trip into that many transactions."""
    from . import api

    a = torch.as_tensor(a)
    v = torch.as_tensor(v)
    cdtype, real = _result_dtypes(a, v)
    nfft = _conv_nfft(a.shape[-1], v.shape[-1], _shards(mesh, axis))
    return api.FFTSpec(shape=tuple(a.shape[:-1]) + (nfft,), dtype=cdtype,
                       rank=1, mesh=mesh, axis=axis, data_axis=data_axis,
                       real=real, chunks=chunks,
                       device=_device(device, mesh))


def fft_convolve(a, v, mesh=None, *, mode: str = "full",
                 axis: str = FFT_AXIS, data_axis: str | None = _AUTO,
                 device=None) -> torch.Tensor:
    """Linear convolution along the last axis on ``device`` (by default
    the mesh's device type, else ``"cuda"``).

    Matches ``np.convolve`` (modes full/same/valid) batched over leading
    dims; ``v`` is one kernel ``(Lv,)`` shared by the whole batch or a
    per-signal batch matching ``a``'s leading dims. Real inputs give a real
    result through one packed transform pair. On a mesh (every rank
    calling it with the global operands) the whole op is two all-to-alls
    and no all-gather, and the result a DTensor of (B, L) signals whole on
    their ranks. Sugar over ``plan(conv_spec(a, v, mesh)).convolve``."""
    from . import api

    return api.plan(conv_spec(a, v, mesh, axis=axis, data_axis=data_axis,
                              device=device)).convolve(a, v, mode=mode)


def correlate(a, v, mesh=None, *, mode: str = "full", axis: str = FFT_AXIS,
              data_axis: str | None = _AUTO, device=None) -> torch.Tensor:
    """Cross-correlation along the last axis: ``c[m] = sum_k a[m+k] *
    conj(v[k])``, ``np.correlate`` conventions (modes full/same/valid),
    batched over leading dims; the same collectives as
    :func:`fft_convolve` on a mesh. Sugar over
    ``plan(conv_spec(...)).correlate``."""
    from . import api

    return api.plan(conv_spec(a, v, mesh, axis=axis, data_axis=data_axis,
                              device=device)).correlate(a, v, mode=mode)


def power_spectrum(x, mesh=None, *, axis: str = FFT_AXIS,
                   data_axis: str | None = _AUTO,
                   natural_order: bool | None = None, real: bool = False,
                   device=None) -> torch.Tensor:
    """Periodogram ``|X[k]|^2 / N`` along the last axis (real output), on
    ``device`` (by default the mesh's device type, else ``"cuda"``).

    On a mesh the bins stay in the transposed digit order by default
    (``natural_order=None`` -> False there): the ``|.|^2`` is
    elementwise, so the whole op is ONE all-to-all and no all-gather;
    ``natural_order=True`` pays the all-gather for numpy bin order. The
    local path is natural order.

    ``real=True`` (opt-in: it changes the output SHAPE) takes a real input
    through the packed rfft and returns the one-sided ``N/2 + 1``-bin
    spectrum ``|X[k]|^2 / N`` for ``k <= N/2`` (natural order only)."""
    from . import api

    x = torch.as_tensor(x)
    on_mesh = _shards(mesh, axis) > 1
    device = _device(device, mesh)
    if real:
        if x.is_complex():
            raise ValueError(f"power_spectrum(real=True) takes a real input, "
                             f"got {x.dtype}")
        if natural_order is False:
            raise ValueError(
                "the one-sided real spectrum is natural-order only — the "
                "Hermitian unpack indexes bins by k")
        spec = api.spec_for(x, rank=1, mesh=mesh, axis=axis,
                            data_axis=data_axis, real=True, device=device)
        return api.plan(spec).power_spectrum(x)
    if natural_order is None:
        natural_order = not on_mesh
    dt = x.dtype if x.is_complex() else torch.complex64
    spec = api.FFTSpec(shape=tuple(x.shape), dtype=dt, rank=1, mesh=mesh,
                       axis=axis, data_axis=data_axis,
                       natural_order=natural_order, device=device)
    return api.plan(spec).power_spectrum(x)
