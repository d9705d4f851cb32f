"""Multi-dimensional FFTs: fftn over the last axes, the packed real-input
rfft2/irfft2 and 2-D convolution, locally and on a ``torch.distributed``
mesh.

The port of ``repro.core.fft.multidim``. Every transform axis is bound by
the plan to an :class:`~repro_torch.kernels.ops.AxisFFT` (its stage plan
and device tables), or to ``None`` when its length is not a power of two:

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

**On a mesh** (the reference's slab and pencil decompositions; each rank
runs the pipeline on plain local tensors, its collectives the
``dist.all_to_all_single``/``all_gather_into_tensor``/``all_reduce`` of the
rank's :class:`~repro_torch.core.fft.distributed._Mesh`, and results come
back as ``DTensor`` s):

* **slab** — the first transform axis block-sharded over ``fft``: the
  local transform of every trailing axis, ONE all-to-all (split the last
  axis, gather the first), the transform of the first axis; the output is
  sharded over the last axis, natural order at no cost, and the inverse
  mirrors it. The batch shards over ``data`` when it divides. The
  all-to-all's send buffer is a torch relayout copy of the trailing
  passes' output; the first axis's launch reads the received blocks in
  place (one uniform point stride);
* **pencil** — the last axis runs the 1-D pencil digit split over ``fft``
  (:class:`~repro_torch.core.fft.distributed.Pencil`, its pass 1 one
  launch with the global-column twiddle), the second-to-last the same
  split over ``data``, leading axes stay local: one grid scales over the
  whole 2-D mesh. Transposed digit order out, the TRANSPOSED_IN inverse
  consumes it; natural order adds one all-gather a mesh dimension.
  ``chunks`` transactions ride the batch (or the first leading axis);
* **real slab** — the packed half-length row pass and the Hermitian
  unpack, padded to ``Cp = C/2 + D`` columns so the one all-to-all stays
  shard-divisible, then the FFT over R; about half the C2C bytes;
* **the 2-D grouped two-side ABFT** — per checksum group two checksum
  grids ride the slab transpose as extra batch rows (pass 1's second
  launch into the same buffer at a row offset), the left check guards
  both passes, and the verdict is the 1-D pipeline's
  (:func:`~repro_torch.core.fft.distributed._grouped_verdict`, one
  ``all_reduce``);
* **fft_convolve2** — both operands' forward in one all-to-all, the
  product in the slab's natural order, the mirrored inverse whose
  all-to-all sends each rank the rows of its block of the cropped result:
  two all-to-alls and no all-gather.

The feasibility rules, the volume model (:func:`collective_volume_nd`) and
the chooser (:func:`choose_decomp`) are the reference's arithmetic,
copied.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fft.plan import PassLayout, _merged, axis_layout

from . import distributed
from .distributed import (_AUTO, FFT_AXIS, DistFFTResult, Launch, Source,
                          _contiguous_strides, _group_sums, _grouped_verdict,
                          _left_delta, _msq, _resolve_data_axis,
                          _resolve_mesh, _rows_of, mesh_size)
from .spectral import _device
from .stockham import naive_dft

__all__ = [
    "DECOMP_SLAB", "DECOMP_PENCIL", "choose_decomp", "collective_volume_nd",
    "slab_feasible", "rslab_feasible", "pencil_feasible",
    "distributed_fft2", "distributed_ifft2", "distributed_fftn",
    "distributed_ifftn", "distributed_rfft2", "distributed_irfft2",
    "ft_distributed_fft2", "ft_distributed_rfft2", "fft_convolve2",
    "conv2_spec", "GridPencil"]

DECOMP_SLAB = "slab"
DECOMP_PENCIL = "pencil"
_DECOMPS = (DECOMP_SLAB, DECOMP_PENCIL)


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
    as a complex view of its storage (a rank's block of a global grid
    included; a copy only when its last axis is strided or an element
    pair would straddle a complex element)."""
    if x.stride(-1) != 1 or x.storage_offset() % 2 \
            or any(st % 2 for st in x.stride()[:-1]):
        x = x.contiguous()
        if x.storage_offset() % 2:
            x = x.clone()
    return torch.view_as_complex(x.unflatten(-1, (x.shape[-1] // 2, 2)))


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


def _conv2_shape(sa, sv, shards: int = 1) -> tuple[int, int]:
    """The padded grid of a 2-D linear convolution: each axis a power of
    two >= its linear size (and >= the ``fft`` ranks on a mesh, the slab's
    divisibility floor)."""
    from .spectral import _next_pow2
    return (max(_next_pow2(sa[0] + sv[0] - 1), shards),
            max(_next_pow2(sa[1] + sv[1] - 1), shards))


def fft_convolve2(a, v, mesh=None, *, mode: str = "full",
                  axis: str = FFT_AXIS, data_axis: str | None = _AUTO,
                  device=None) -> torch.Tensor:
    """2-D linear convolution over the last two axes, ``jnp.convolve`` mode
    semantics (full/same/valid) applied per axis, batched over leading
    dims, on ``device`` (the mesh's device type, else the card).

    ``v`` is one kernel ``(Kr, Kc)`` shared by the whole batch or a
    per-signal batch matching ``a``'s leading dims; real inputs give a real
    result. Each axis is padded to a power of two >= its linear size (and
    >= the ``fft`` ranks on a mesh). When BOTH operands are real the round
    trip is the packed half-spectrum pipeline (a rank-2 real plan);
    otherwise the complex rank-2 plan. Sugar over ``plan(FFTSpec(...,
    rank=2)).convolve``. On ``mesh`` (a batch of at most one leading
    dimension) the slab round trip: two all-to-alls, no all-gather, the
    result a DTensor sharded over its rows (:func:`conv2_local`).
    """
    from . import api

    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    v = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    spec = conv2_spec(a, v, mesh, axis=axis, data_axis=data_axis,
                      device=device)
    return api.plan(spec).convolve(a, v, mode=mode)


def conv2_spec(a, v, mesh=None, *, axis: str = FFT_AXIS,
               data_axis: str | None = _AUTO, device=None):
    """The rank-2 :class:`~repro_torch.core.fft.api.FFTSpec` that
    :func:`fft_convolve2` of ``a`` with ``v`` plans: each transform axis
    padded by :func:`_conv2_shape`, batch dims from ``a``, the compute
    dtype promoted across both operands, ``real`` when both are real (and
    the padded width is even). Its plan's ``launches["convolve"]`` and
    ``convolve`` are the function's."""
    from . import api
    from .spectral import _result_dtypes

    a = torch.as_tensor(a)
    v = torch.as_tensor(v)
    if a.dim() < 2 or v.dim() < 2:
        raise ValueError("fft_convolve2 needs 2-D operands")
    cdtype, real = _result_dtypes(a, v)
    mesh = _resolve_mesh(mesh, axis)
    shards = mesh_size(mesh, axis) if mesh is not None else 1
    nr, nc = _conv2_shape(a.shape[-2:], v.shape[-2:], shards)
    return api.FFTSpec(shape=tuple(a.shape[:-2]) + (nr, nc),
                       dtype=cdtype, rank=2, mesh=mesh, axis=axis,
                       data_axis=data_axis, real=real and nc % 2 == 0,
                       device=_device(device, mesh))


# ---------------------------------------------------------------------------
# decomposition choice + communication model (the reference's arithmetic)
# ---------------------------------------------------------------------------


def slab_feasible(shape: tuple[int, ...], fft_shards: int) -> bool:
    """Slab shards ``shape[0]`` and all-to-alls ``shape[-1]``: both must
    divide by the fft-axis size (power-of-two axes, like the 1-D stack)."""
    return (len(shape) >= 2 and all(_is_pow2(s) for s in shape)
            and shape[0] % fft_shards == 0 and shape[-1] % fft_shards == 0)


def rslab_feasible(shape: tuple[int, ...], fft_shards: int) -> bool:
    """Real-input slab feasibility: a 2-D power-of-two grid whose rows AND
    packed half width both tile over the fft axis — ``D | R`` for the input
    sharding and ``D | C/2`` so the padded half spectrum ``Cp = C/2 + D``
    stays shard-divisible through the inter-axis transpose (which needs
    ``C >= 2*D``). Rank-3 real grids are not supported."""
    return (len(shape) == 2 and all(_is_pow2(s) for s in shape)
            and shape[-1] >= 2 and shape[0] % fft_shards == 0
            and (shape[-1] // 2) % fft_shards == 0)


def pencil_feasible(shape: tuple[int, ...], fft_shards: int,
                    data_shards: int = 1) -> bool:
    """Pencil digit-splits the last axis over ``fft`` and the second-to-last
    over ``data``: each needs the 1-D DistPlan constraint N >= shards^2."""
    if len(shape) < 2 or not all(_is_pow2(s) for s in shape):
        return False
    if not _is_pow2(fft_shards) or not _is_pow2(data_shards):
        return False
    return (shape[-1] >= fft_shards * fft_shards
            and shape[-2] >= data_shards * data_shards)


def collective_volume_nd(shape: tuple[int, ...], batch: int, fft_shards: int,
                         *, decomp: str = DECOMP_SLAB, itemsize: int = 8,
                         ft: bool = False, groups: int = 1,
                         data_shards: int = 1, natural_order: bool = True,
                         real: bool = False, chunks: int = 1) -> dict:
    """Analytic per-device communication model of one distributed n-D
    transform over ``shape`` (the reference's, copied).

    **slab**: ONE all-to-all over the locally-resident block — ``rows *
    grid/D`` elements, ``rows = (batch + 2*groups if ft)/data_shards``.
    Natural order is free, zero all-gathers. The grouped verdict is
    ``3*groups/data_shards + 1`` scalars plus the stats broadcast, at ring
    factor 2 (``psum_hlo``); ``permute_hlo`` is a term of the reference's
    compiled program only.

    **pencil**: TWO all-to-alls (one per mesh axis; one when
    ``data_shards == 1``), each moving the full local block — ``batch *
    grid/(D*data)`` elements. ``natural_order=True`` adds the digit
    restore, one all-gather per mesh axis: ``full/data_shards`` (fft
    gathered first) then ``full`` bytes, ``full = batch * grid *
    itemsize``. ``ft=True`` raises here.

    **real** (slab only): the transpose moves the PADDED half spectrum,
    ``Cp = C/2 + D`` columns instead of C. ``chunks > 1`` (pencil only)
    splits each digit pass into that many all-to-alls, total volume
    unchanged.
    """
    if decomp not in _DECOMPS:
        raise ValueError(f"decomp must be {'|'.join(_DECOMPS)}, got {decomp!r}")
    chunks = max(1, int(chunks))
    if chunks > 1 and decomp != DECOMP_PENCIL:
        raise ValueError(
            "chunked (multi-transaction) execution rides the pencil digit "
            "passes; the slab inter-axis transpose is bulk-synchronous — "
            f"got decomp={decomp!r} with chunks={chunks}")
    if real and decomp != DECOMP_SLAB:
        raise ValueError(
            "the real-input model is slab-only (rfft2 rides the padded "
            "half-spectrum transpose); the pencil real path composes two "
            "1-D transforms — model each with collective_volume(real=True)")
    cols = shape[-1] // 2 + fft_shards if real else shape[-1]
    grid = int(np.prod(shape[:-1])) * cols
    d = fft_shards
    dd = data_shards
    if decomp == DECOMP_SLAB:
        if ft and groups % dd:
            raise ValueError(f"groups={groups} must divide over "
                             f"data_shards={dd}")
        rows = (batch + (2 * groups if ft else 0)) / dd
        a2a_hlo = rows * grid * itemsize / d
        a2a_wire = a2a_hlo * (d - 1) / d
        verdict = (3 * groups // dd + 1) * (itemsize // 2)
        stats = (5 * groups // dd * (itemsize // 2) if groups > 1
                 else 3 + (itemsize // 2) + 4)
        psum_hlo = 2.0 * (verdict + stats) if ft else 0.0
        psum_wire = psum_hlo * (d - 1) / d
        permute_hlo = (5 * groups // dd * (itemsize // 2)
                       if ft and dd > 1 else 0.0)
        gather_hlo = gather_wire = 0.0
        a2a_count, gather_count = 1, 0
        local_bytes = rows * grid * itemsize / d
    else:
        if ft:
            raise ValueError("grouped ABFT rides the slab inter-axis "
                             "transpose; decomp='pencil' has no ft model")
        local = batch * grid * itemsize / (d * dd)
        a2a_count = (2 if dd > 1 else 1) * chunks
        a2a_hlo = (2 if dd > 1 else 1) * local
        a2a_wire = local * (d - 1) / d
        if dd > 1:
            a2a_wire += local * (dd - 1) / dd
        psum_hlo = psum_wire = permute_hlo = 0.0
        full = float(batch * grid * itemsize)
        if natural_order:
            gather_hlo = full + (full / dd if dd > 1 else 0.0)
            gather_wire = full * (d - 1) / d if dd == 1 else (
                (full / dd) * (d - 1) / d + full * (dd - 1) / dd)
            gather_count = 2 if dd > 1 else 1
        else:
            gather_hlo = gather_wire = 0.0
            gather_count = 0
        local_bytes = local
    return {
        "decomp": decomp,
        "shape": tuple(shape),
        "shards": d,
        "data_shards": dd,
        "groups": groups,
        "real": real,
        "chunks": chunks,
        "exposed_fraction": 1.0 / chunks,
        "overlap_efficiency": 1.0 - 1.0 / chunks,
        "all_to_all_count": a2a_count,
        "all_gather_count": gather_count,
        "all_to_all_bytes": a2a_hlo,
        "all_to_all_wire": a2a_wire,
        "gather_hlo": gather_hlo,
        "gather_wire": gather_wire,
        "psum_hlo": psum_hlo,
        "psum_wire": psum_wire,
        "permute_hlo": permute_hlo,
        "total_wire": a2a_wire + gather_wire + psum_wire + permute_hlo,
        "hlo_bytes": a2a_hlo + gather_hlo + psum_hlo + permute_hlo,
        "local_bytes": local_bytes,
        "abft_overhead": 2.0 * groups / batch if (ft and batch) else 0.0,
    }


def choose_decomp(shape: tuple[int, ...], mesh, *, batch: int = 1,
                  ft: bool = False, natural_order: bool = True,
                  axis: str = FFT_AXIS,
                  data_axis: str | None = _AUTO) -> str:
    """Pick the decomposition for an n-D transform over ``shape`` on
    ``mesh`` — ``"slab"``, ``"pencil"``, or ``"local"``: among the
    feasible candidates the one moving fewer modelled bytes
    (:func:`collective_volume_nd`) wins, the per-device footprint breaking
    a tie. ABFT (``ft=True``) rides the slab transpose, so it forces
    slab."""
    shape = tuple(int(s) for s in shape)
    mesh = _resolve_mesh(mesh, axis)
    if mesh is None or mesh_size(mesh, axis) == 1:
        return "local"
    d = mesh_size(mesh, axis)
    daxis = _resolve_data_axis(mesh, data_axis)
    dd = mesh_size(mesh, daxis) if daxis else 1
    cands = []
    if slab_feasible(shape, d):
        # batch shards over data only when it divides
        bdd = dd if (dd > 1 and batch % dd == 0) else 1
        g = 1 if not ft else max(bdd, 1)
        cands.append((DECOMP_SLAB, collective_volume_nd(
            shape, batch, d, data_shards=bdd, ft=ft, groups=g,
            natural_order=natural_order)))
    if not ft and pencil_feasible(shape, d, dd):
        cands.append((DECOMP_PENCIL, collective_volume_nd(
            shape, batch, d, decomp=DECOMP_PENCIL, data_shards=dd,
            natural_order=natural_order)))
    if not cands:
        raise ValueError(
            f"no feasible decomposition for shape={shape} on a "
            f"{d}-way fft axis (data={dd}): slab needs fft | shape[0] and "
            f"fft | shape[-1]; pencil needs shape[-1] >= fft^2 and "
            f"shape[-2] >= data^2 (power-of-two axes throughout)")
    cands.sort(key=lambda c: (c[1]["hlo_bytes"], c[1]["local_bytes"]))
    return cands[0][0]


# ---------------------------------------------------------------------------
# the per-rank steps of the mesh pipelines (no collective but the _Mesh's)
# ---------------------------------------------------------------------------


def _launch(ax, layout: PassLayout, src: torch.Tensor, out: torch.Tensor, *,
            inverse: bool, scale: float) -> torch.Tensor:
    """ONE block-FFT launch of the single-pass axis ``ax`` through
    ``layout``, ``src`` and ``out`` flat contiguous views."""
    from repro_torch.kernels import stockham

    return stockham.block_fft(src, ax.plan.stages[0], inverse=inverse,
                              scale=scale, tables=ax.tables[inverse][0],
                              layout=layout, out=out)


def _flat_rows(xv: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(flat, row stride) of a view ``xv`` whose rows (its first dimension)
    each hold contiguous elements: ``flat`` a contiguous 1-D view of its
    storage from row 0's first element on."""
    rows, inner = xv.shape[0], xv[0].numel()
    span = (rows - 1) * xv.stride(0) + inner
    return (torch.as_strided(xv, (span,), (1,), xv.storage_offset()),
            xv.stride(0))


def _last_axis(xv: torch.Tensor, ax, out: torch.Tensor, *, inverse: bool,
               scale: float = 1.0) -> torch.Tensor:
    """The transform along the last axis of every row of ``xv`` (rows,
    ..., n) into the contiguous ``out`` of its shape: ONE launch reading
    the rows where they lie (a rank's block of the global operand, no
    copy) when the axis is single-pass; otherwise a copy and the local
    multi-pass transform."""
    n = xv.shape[-1]
    if xv.shape[0] and ax.plan.num_passes == 1 and xv[0].is_contiguous():
        per = xv[0].numel() // n
        flat, rs = _flat_rows(xv)
        layout = PassLayout(_merged(((xv.shape[0], rs, per * n),
                                     (per, n, n))), 1, 1)
        _launch(ax, layout, flat, out.view(-1), inverse=inverse, scale=scale)
        return out
    return _local_axis_fft(xv.contiguous(), -1, ax, inverse=inverse,
                           scale=scale, out=out)


def _block_axis(src: torch.Tensor, ax, rows: int, inner: int,
                out: torch.Tensor, *, into_blocks: bool, inverse: bool,
                scale: float = 1.0) -> torch.Tensor:
    """The transform of ``rows`` x ``inner`` signals along the axis of n
    points that a slab all-to-all exchanges. ``into_blocks`` False reads
    the received layout (n, rows, inner) — the axis's D blocks one after
    the other, point p at p * rows * inner: one uniform stride — and
    writes (rows, n, inner); True reads (rows, n, inner) and writes that
    layout, the send buffer whose blocks of n/D points are the ranks'
    chunks. ONE launch when the axis is single-pass, else a relayout copy
    and the local transform."""
    n = ax.plan.n
    if ax.plan.num_passes == 1:
        if into_blocks:
            axes, p_in, p_out = ((rows, n * inner, inner), (inner, 1, 1)), \
                inner, rows * inner
        else:
            axes, p_in, p_out = ((rows, inner, n * inner), (inner, 1, 1)), \
                rows * inner, inner
        _launch(ax, PassLayout(_merged(axes), p_in, p_out), src.view(-1),
                out.view(-1), inverse=inverse, scale=scale)
    elif into_blocks:
        y = _local_axis_fft(src.view(rows, n, inner), 1, ax, inverse=inverse,
                            scale=scale)
        out.view(n, rows, inner).copy_(y.transpose(0, 1))
    else:
        z = out.view(rows, n, inner)
        z.copy_(src.view(n, rows, inner).transpose(0, 1))
        _local_axis_fft(z, 1, ax, inverse=inverse, scale=scale, out=z)
    return out


def _to_blocks(z: torch.Tensor, d: int) -> torch.Tensor:
    """The slab all-to-all's send buffer of ``z`` (rows, s0l, ..., C): its
    D blocks of the last axis, (D, s0l, rows, ..., C/D) (a torch copy)."""
    rows, s0l, c = z.shape[0], z.shape[1], z.shape[-1]
    mid = z.shape[2:-1]
    zv = z.view((rows, s0l) + mid + (d, c // d))
    k = len(mid)
    perm = (2 + k, 1, 0) + tuple(range(2, 2 + k)) + (3 + k,)
    return zv.permute(perm).contiguous()


def _from_blocks(recv: torch.Tensor, rows: int, d: int) -> torch.Tensor:
    """The mirror of :func:`_to_blocks`: the received (D, s0l, rows, ...,
    C/D) blocks of the last axis as (rows, s0l, ..., C) (a torch copy)."""
    s0l, cl = recv.shape[1], recv.shape[-1]
    mid = tuple(recv.shape[3:-1])
    k = len(mid)
    perm = (2, 1) + tuple(range(3, 3 + k)) + (0, 3 + k)
    return recv.permute(perm).reshape(
        (rows, s0l) + mid + (d * cl,)).contiguous()


def _exchange(send: torch.Tensor, m) -> torch.Tensor:
    recv = torch.empty_like(send)
    m.all_to_all(recv, send)
    return recv


def _spec(m, fft_dim: int | None, data_dim: int | None) -> dict:
    """A placement spec of ``m``: ``Shard(fft_dim)`` over its ``fft``
    dimension and ``Shard(data_dim)`` over its data one (each None:
    replicated)."""
    from torch.distributed.tensor import Shard

    spec = {}
    if fft_dim is not None:
        spec[m.axis] = Shard(fft_dim)
    if data_dim is not None and m.daxis:
        spec[m.daxis] = Shard(data_dim)
    return spec


def _grid_rows(x, m, ndim: int, sdim: int):
    """This rank's rows of the grids ``x`` (a batch ``(B, *grid)`` or one
    grid) as the slab holds them: transform axis ``sdim`` block-sharded
    over ``fft``, the batch over ``data`` when it divides. Returns
    ``(view, b, bsharded)``, ``view`` (rows, *grid with axis ``sdim`` cut
    to this rank's block) — a view of the global operand, or the local
    tensor of a DTensor (redistributed first when its layout is
    another)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.fft_sharding import placements

    hasb = x.dim() == ndim + 1
    b = x.shape[0] if hasb else 1
    row0, rows, bsharded = _rows_of(b, m) if hasb else (0, 1, False)
    dim = x.dim() - ndim + sdim
    if isinstance(x, DTensor):
        if x.device_mesh != m.mesh:
            raise ValueError(f"the operand lives on {x.device_mesh}, the "
                             f"plan on {m.mesh}")
        want = placements(m.mesh, _spec(m, dim, 0 if bsharded else None))
        if list(x.placements) != want:
            x = x.redistribute(x.device_mesh, want)
        loc = x.to_local()
        return (loc if hasb else loc.unsqueeze(0)), b, bsharded
    xb = x if hasb else x.unsqueeze(0)
    n = xb.shape[1 + sdim] // m.shards
    return xb[row0:row0 + rows].narrow(1 + sdim, m.rank * n, n), b, bsharded


def _result(local: torch.Tensor, m, xdim: int, ndim: int, tdim: int,
            bsharded: bool, shape) -> tuple:
    """(local, spec, global shape) of a slab result whose transform axis
    ``tdim`` is sharded over ``fft`` (the batch over ``data`` when
    ``bsharded``): ``local`` (rows, ...) squeezed back to one grid when
    the operand had no batch dimension."""
    hasb = xdim == ndim + 1
    return ((local if hasb else local.squeeze(0)),
            _spec(m, xdim - ndim + tdim, 0 if bsharded else None),
            tuple(shape))


# -- slab ---------------------------------------------------------------


def _slab_exchange(z1: torch.Tensor, rows_ax, m):
    """The slab's transpose of the filled pass-1 buffer ``z1`` (rows,
    s0/D, *mid, W): the relayout into the send buffer, ONE all-to-all, the
    first axis's launch reading the received blocks in place. Returns
    ``(out, recv)``: ``out`` (rows, s0, *mid, W/D) in natural order,
    ``recv`` the received blocks (D, s0/D, rows, *mid, W/D) the launch
    read."""
    d = m.shards
    rows, s0 = z1.shape[0], z1.shape[1] * d
    recv = _exchange(_to_blocks(z1, d), m)
    out = torch.empty((rows, s0) + tuple(z1.shape[2:-1])
                      + (z1.shape[-1] // d,), dtype=z1.dtype,
                      device=z1.device)
    _block_axis(recv, rows_ax, rows, out[0, 0].numel(), out,
                into_blocks=False, inverse=False)
    return out, recv


def _slab_forward_rows(xv: torch.Tensor, axes, m) -> torch.Tensor:
    """The slab forward on this rank's rows ``xv`` (rows, s0/D, *mid, C)
    (a view whose rows are contiguous inside): the last axis's launch
    reading them in place, the middle axis in place, the relayout into
    the send buffer, ONE all-to-all, the first axis's launch reading the
    received blocks. Returns (rows, s0, *mid, C/D), natural order."""
    z = torch.empty(xv.shape, dtype=xv.dtype, device=xv.device)
    _last_axis(xv, axes[-1], z, inverse=False)
    for k in range(1, len(axes) - 1):
        _local_axis_fft(z, 1 + k, axes[k], inverse=False, out=z)
    return _slab_exchange(z, axes[0], m)[0]


def _slab_inverse_rows(yl: torch.Tensor, axes, m) -> torch.Tensor:
    """The mirror of :func:`_slab_forward_rows` on this rank's contiguous
    rows ``yl`` (rows, s0, *mid, C/D): the middle axis (into a new
    tensor), the first axis's launch writing the send buffer's blocks,
    ONE all-to-all, the relayout of the received blocks, the last axis in
    place. Returns (rows, s0/D, *mid, C), each axis normalized by its
    1/n."""
    d = m.shards
    rows, s0 = yl.shape[0], yl.shape[1]
    z = yl
    for k in range(len(axes) - 2, 0, -1):
        n = yl.shape[1 + k]
        z = _local_axis_fft(z, 1 + k, axes[k], inverse=True, scale=1.0 / n,
                            out=None if z is yl else z)
    send = torch.empty((s0, rows) + tuple(yl.shape[2:]), dtype=yl.dtype,
                       device=yl.device)
    _block_axis(z, axes[0], rows, yl[0, 0].numel(), send, into_blocks=True,
                inverse=True, scale=1.0 / s0)
    del z
    recv = _exchange(send.view((d, s0 // d, rows) + tuple(yl.shape[2:])), m)
    del send
    x = _from_blocks(recv, rows, d)
    c = x.shape[-1]
    return _local_axis_fft(x, -1, axes[-1], inverse=True, scale=1.0 / c,
                           out=x)


def slab_local(x, axes, m, *, inverse: bool):
    """One slab transform of ``x`` ((B, *grid) or one grid, the global
    value or a DTensor) on this rank: ``(local, spec, shape)``. Forward:
    the input's first transform axis sharded over ``fft``, the output's
    last; the inverse mirrors it."""
    ndim = len(axes)
    if inverse:
        yv, b, bsh = _grid_rows(x, m, ndim, ndim - 1)
        local = _slab_inverse_rows(yv.contiguous(), axes, m)
        return _result(local, m, x.dim(), ndim, 0, bsh, x.shape)
    xv, b, bsh = _grid_rows(x, m, ndim, 0)
    local = _slab_forward_rows(xv, axes, m)
    return _result(local, m, x.dim(), ndim, ndim - 1, bsh, x.shape)


# -- pencil -------------------------------------------------------------


class GridPencil:
    """The per-rank steps of the pencil n-D transform of grids ``tshape``
    (lead..., R, C) over ``shards`` ``fft`` ranks and ``dsize`` data ranks,
    with their stage and twiddle tables on ``device``.

    The last axis is the 1-D digit split over ``fft`` (``pc``, a
    :class:`~repro_torch.core.fft.distributed.Pencil`: C = c1 * c2), the
    second-to-last the same split over ``data`` (``pr``: R = r1 * r2; with
    one data rank ``rax``, the whole R axis, local), every leading axis a
    local :class:`~repro_torch.kernels.ops.AxisFFT` (``lead``). A rank
    holds, of (B, *lead, R, C), the fast digits c2 and r2 of its blocks
    going in, and the slow digits k1 of each axis coming out (the
    transposed digit order, contiguous blocks of R and C)."""

    def __init__(self, tshape: tuple[int, ...], shards: int, dsize: int,
                 dtype: torch.dtype, device: str):
        from repro_torch.kernels.ops import axis_fft

        self.tshape = tuple(tshape)
        self.shards, self.dsize = shards, dsize
        rr, cc = self.tshape[-2:]
        self.lead = tuple(axis_fft(n, dtype, device)
                          for n in self.tshape[:-2])
        self.pc = distributed.pencil(cc, shards, dtype, device)
        self.pr = distributed.pencil(rr, dsize, dtype, device) \
            if dsize > 1 else None
        self.rax = None if dsize > 1 else axis_fft(rr, dtype, device)
        self.r1, self.r2 = (self.pr.n1, self.pr.n2) if dsize > 1 \
            else (rr, 1)

    def launches(self, chunks: int, *, transposed_in: bool = False) -> int:
        """block_fft launches of one call: the leading axes' passes and, a
        transaction, pass 1 and the tail of each digit split (the R axis's
        passes with one data rank). The TRANSPOSED_IN inverse runs pass A
        and pass B of each split."""
        lead = sum(ax.plan.num_passes for ax in self.lead)
        if transposed_in:
            c = 2
            r = 2 if self.pr else self.rax.plan.num_passes
        else:
            c = 1 + self.pc.ax2.plan.num_passes
            r = 1 + self.pr.ax2.plan.num_passes if self.pr \
                else self.rax.plan.num_passes
        return lead + chunks * (c + r)

    def check_transposed_in(self) -> None:
        """The TRANSPOSED_IN inverse runs each split's tail as one launch
        (pass A): raise when a tail takes more."""
        for p in (self.pc, self.pr):
            if p is not None and p.ax2.plan.num_passes != 1:
                raise ValueError(
                    f"the pencil's TRANSPOSED_IN inverse takes the digit "
                    f"tail of {p.n} points in one local pass, got "
                    f"n2={p.n2} in {p.ax2.plan.num_passes}")


@functools.lru_cache(maxsize=64)
def grid_pencil(tshape: tuple[int, ...], shards: int, dsize: int,
                dtype: torch.dtype, device: str) -> GridPencil:
    """The :class:`GridPencil` of its arguments, built once."""
    return GridPencil(tshape, shards, dsize, dtype, device)


def _pencil_rows(gp: GridPencil, m, blc: int, zc: torch.Tensor,
                 out: torch.Tensor, *, inverse: bool) -> None:
    """The R-axis pass of one transaction: ``zc`` (blc, r1, r2/dd, C/D)
    after the C split, into ``out`` (blc, R/dd, C/D). With data ranks:
    pass 1 over r1 (one launch with the twiddle of the rank's global r2
    rows, the fastest signal axis) into the send buffer (dd, r1/dd, blc,
    r2/dd, C/D), ONE all-to-all over ``data``, the relayout of the
    received blocks (a torch copy) and the r2 tail in place; else the
    local transform of R."""
    rr = gp.tshape[-2]
    inner = gp.pc.n1l * gp.pc.n2
    if gp.pr is None:
        _local_axis_fft(zc.view(blc, rr, inner), 1, gp.rax, inverse=inverse,
                        scale=1.0 / rr if inverse else 1.0,
                        out=out.view(blc, rr, inner))
        return
    pr, dd = gp.pr, m.dsize
    r1l, r2, r2l = pr.n1l, pr.n2, pr.n2l
    layout = PassLayout(((blc, pr.n1 * r2l * inner, r2l * inner),
                         (inner, 1, 1), (r2l, inner, inner)),
                        r2l * inner, blc * r2l * inner)
    send = torch.empty((dd, r1l, blc, r2l, inner), dtype=zc.dtype,
                       device=zc.device)
    Launch(pr.stages1, pr.tables1[inverse], layout, inverse,
           1.0 / rr if inverse else 1.0, pr.twiddle[inverse], rr,
           m.drank * r2l)(zc.reshape(-1), send.view(-1))
    recv = torch.empty_like(send)
    m.data_all_to_all(recv, send)
    del send
    z4 = out.view(blc, r1l, dd, r2l, inner)
    z4.copy_(recv.permute(2, 1, 0, 3, 4))
    z4 = out.view(blc, r1l, r2, inner)
    _local_axis_fft(z4, 2, pr.ax2, inverse=inverse, scale=1.0, out=z4)


def _pencil_forward(flat: torch.Tensor, bl: int, gp: GridPencil, m, *,
                    inverse: bool, chunks: int) -> torch.Tensor:
    """The pencil forward (or natural-order inverse) on this rank: ``flat``
    the global (BL, R, C) grids (BL = B * prod(lead)) read in place, this
    rank's (BL, R/dd, C/D) block of the transposed digit order back.

    A transaction is a contiguous run of BL: pass 1 over c1 of its rows
    (one launch, global-column twiddle) into the send buffer, its
    all-to-all over ``fft`` (asynchronous, issued before the next
    transaction's pass 1), then — once it has arrived — the c2 tail and
    the R pass (:func:`_pencil_rows`). The leading axes last, in place,
    unchunked."""
    pc = gp.pc
    rr, cc = gp.tshape[-2:]
    r1, r2 = gp.r1, gp.r2
    r2l = r2 // m.dsize
    inner = pc.n1l * pc.n2
    ce = distributed.resolve_chunks(bl, chunks)
    blc = bl // ce
    sigs = blc * r1 * r2l
    dt, dev = flat.dtype, flat.device
    out = torch.empty((bl, rr // m.dsize, inner), dtype=dt, device=dev)
    pending = None
    for i in range(ce + 1):
        if i < ce:
            src = Source(flat, i * blc * rr * cc + m.drank * r2l * cc
                         + m.rank * pc.n2l, cc, pc.n2)
            send = torch.empty((m.shards, pc.n1l, sigs, pc.n2l), dtype=dt,
                               device=dev)
            pc.pass1(src, r2l, m.rank, inverse=inverse, send=send,
                     out_rows=sigs, blocks=(blc * r1, r2 * cc))
            recv = torch.empty_like(send)
            work = m.all_to_all(recv, send, async_op=True)
        if pending is not None:
            pw, precv, pi = pending
            pw.wait()
            zc = torch.empty((sigs, pc.n1l, pc.n2), dtype=dt, device=dev)
            pc.pass2(precv, sigs, inverse=inverse, out=zc)
            del precv
            _pencil_rows(gp, m, blc, zc, out[pi * blc:(pi + 1) * blc],
                         inverse=inverse)
            del zc
        pending = (work, recv, i) if i < ce else None
    _lead_axes(out, gp, bl, inverse=inverse)
    return out


def _lead_axes(z: torch.Tensor, gp: GridPencil, bl: int, *,
               inverse: bool) -> None:
    """Each leading transform axis of ``z`` (BL, ...), in place."""
    lead = gp.tshape[:-2]
    if not lead:
        return
    b = bl // math.prod(lead)
    zv = z.view((b,) + lead + (-1,))
    for k, ax in enumerate(gp.lead):
        n = lead[k]
        _local_axis_fft(zv, 1 + k, ax, inverse=inverse,
                        scale=1.0 / n if inverse else 1.0, out=zv)


def _pencil_natural(out: torch.Tensor, gp: GridPencil, m) -> torch.Tensor:
    """This rank's (BL, R/dd, C/D) transposed-order block to the whole
    (BL, R, C) in natural order: ONE all-gather over ``fft``, then (with
    data ranks) ONE over ``data``, and the digit restore (a torch copy)."""
    bl = out.shape[0]
    rr, cc = gp.tshape[-2:]
    g = torch.empty((m.shards,) + tuple(out.shape), dtype=out.dtype,
                    device=out.device)
    m.all_gather(g.view(-1), out.view(-1))
    if m.dsize > 1:
        g2 = torch.empty((m.dsize,) + tuple(g.shape), dtype=g.dtype,
                         device=g.device)
        m.data_gather(g2.view(-1), g.view(-1))
        g = g2
    pc = gp.pc
    g = g.view(m.dsize, m.shards, bl, gp.r1 // m.dsize, gp.r2, pc.n1l,
               pc.n2)
    return g.permute(2, 4, 0, 3, 6, 1, 5).reshape(bl, rr, cc)


def _pencil_inverse_t(loc: torch.Tensor, gp: GridPencil, m, *,
                      chunks: int) -> torch.Tensor:
    """The TRANSPOSED_IN inverse on this rank: ``loc`` its (BL, R/dd, C/D)
    block of the transposed digit order, (BL, r1, r2/dd, c1, c2/D) back —
    natural order, the fast digits sharded.

    A transaction: with data ranks, pass A over kr2 (one launch, the
    conjugate twiddle of the rank's global kr1 rows and 1/R) into the send
    buffer, ONE all-to-all over ``data``, the relayout and pass B over kr1
    in place (else the local inverse of R); then pass A over kc2 (1/C)
    into the send buffer, ONE all-to-all over ``fft`` (asynchronous,
    issued before the next transaction's R pass), the relayout and pass B
    over kc1 in place. The leading axes last."""
    pc, pr = gp.pc, gp.pr
    rr, cc = gp.tshape[-2:]
    bl = loc.shape[0]
    inner = pc.n1l * pc.n2
    r1, r2 = gp.r1, gp.r2
    r2l = r2 // m.dsize
    ce = distributed.resolve_chunks(bl, chunks)
    blc = bl // ce
    rows = blc * r1 * r2l
    dt, dev = loc.dtype, loc.device
    out = torch.empty((bl, r1, r2l, pc.n1, pc.n2l), dtype=dt, device=dev)
    pending = None
    for i in range(ce + 1):
        if i < ce:
            zin = loc[i * blc:(i + 1) * blc]
            if pr is None:
                zr = _local_axis_fft(zin.view(blc, rr, inner), 1, gp.rax,
                                     inverse=True, scale=1.0 / rr)
            else:
                r1l = pr.n1l
                layout = PassLayout(((blc, r1l * r2 * inner, r1l * inner),
                                     (inner, 1, 1), (r1l, r2 * inner, inner)),
                                    inner, blc * r1l * inner)
                send = torch.empty((r2, blc, r1l, inner), dtype=dt,
                                   device=dev)
                ax = pr.ax2
                Launch(ax.plan.stages[0], ax.tables[True][0], layout, True,
                       1.0 / rr, pr.twiddle[True], rr, m.drank * r1l)(
                           zin.reshape(-1), send.view(-1))
                recv = torch.empty_like(send)
                m.data_all_to_all(recv, send)
                del send
                zr = torch.empty((blc, r1, r2l, inner), dtype=dt, device=dev)
                zr.view(blc, m.dsize, r1l, r2l, inner).copy_(
                    recv.view(m.dsize, r2l, blc, r1l, inner).permute(
                        2, 0, 3, 1, 4))
                del recv
                Launch(pr.stages1, pr.tables1[True],
                       axis_layout(blc, r1, r2l * inner), True)(
                           zr.view(-1), zr.view(-1))
            ax = pc.ax2
            layout = PassLayout(((rows, pc.n1l * pc.n2, pc.n1l),
                                 (pc.n1l, pc.n2, 1)), 1, rows * pc.n1l)
            send = torch.empty((pc.n2, rows, pc.n1l), dtype=dt, device=dev)
            Launch(ax.plan.stages[0], ax.tables[True][0], layout, True,
                   1.0 / cc, pc.twiddle[True], cc, m.rank * pc.n1l)(
                       zr.reshape(-1), send.view(-1))
            del zr
            recv = torch.empty_like(send)
            work = m.all_to_all(recv, send, async_op=True)
        if pending is not None:
            pw, precv, pi = pending
            pw.wait()
            oc = out[pi * blc:(pi + 1) * blc]
            oc.view(rows, m.shards, pc.n1l, pc.n2l).copy_(
                precv.view(m.shards, pc.n2l, rows, pc.n1l).permute(
                    2, 0, 3, 1))
            del precv
            Launch(pc.stages1, pc.tables1[True],
                   axis_layout(rows, pc.n1, pc.n2l), True)(
                       oc.reshape(-1), oc.reshape(-1))
        pending = (work, recv, i) if i < ce else None
    _lead_axes(out, gp, bl, inverse=True)
    return out


def _pencil_global(x, m) -> torch.Tensor:
    """The global grids of ``x`` on this rank: a tensor as it is; a
    replicated DTensor's local tensor; a DTensor in the pencil's block
    layout (``shard_grid``: the last axis over ``fft``, the
    second-to-last over ``data``) gathered by ONE all-gather over each of
    those dimensions and a relayout (the ingest, which the volume model
    does not count); any other DTensor through ``full_tensor``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    nd = x.dim()
    pl = dict(zip(distributed.mesh_axes(x.device_mesh), x.placements))
    if all(p == Replicate() for p in pl.values()):
        return x.to_local()
    by_fft, by_data = pl.get(m.axis), pl.get(m.daxis) if m.daxis else None
    block = (by_fft in (Shard(nd - 1), Replicate())
             and by_data in (None, Shard(nd - 2), Replicate())
             and all(p == Replicate() for k, p in pl.items()
                     if k not in (m.axis, m.daxis))
             and x.shape[-1] % m.shards == 0
             and (by_data != Shard(nd - 2) or x.shape[-2] % m.dsize == 0))
    if not block:
        return x.full_tensor()
    loc = x.to_local()
    if by_fft == Shard(nd - 1):
        g = torch.empty((m.shards,) + tuple(loc.shape), dtype=loc.dtype,
                        device=loc.device)
        m.all_gather(g.view(-1), loc.contiguous().view(-1))
        loc = torch.movedim(g, 0, -2).reshape(loc.shape[:-1] + (-1,))
    if by_data == Shard(nd - 2):
        g = torch.empty((m.dsize,) + tuple(loc.shape), dtype=loc.dtype,
                        device=loc.device)
        m.data_gather(g.view(-1), loc.contiguous().view(-1))
        loc = torch.movedim(g, 0, -3).reshape(
            loc.shape[:-2] + (-1, loc.shape[-1]))
    return loc


def pencil_local(x, gp: GridPencil, m, *, inverse: bool,
                 natural_order: bool, chunks: int):
    """One pencil transform of ``x`` on this rank: ``(local, spec,
    shape)``. The forward takes the global grids (natural order) and
    gives this rank's transposed-order block (the last axis over ``fft``,
    the second-to-last over ``data``: shape ``x.shape``), or with
    ``natural_order`` the whole natural-order result (replicated). The
    natural-order inverse runs the forward's steps on the inverse tables.
    The TRANSPOSED_IN inverse (``inverse`` and not ``natural_order``)
    takes the forward's transposed-order output and gives the natural
    order with the fast digits sharded: the cube (B, *lead, r1, r2, c1,
    c2) of the grids, r2 over ``data`` and c2 over ``fft``
    (``fft_sharding.pencil_nd_specs``' input layout; ``full_tensor()
    .reshape(x.shape)`` is the natural-order result)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.fft_sharding import placements

    ndim = len(gp.tshape)
    hasb = x.dim() == ndim + 1
    bl = (x.shape[0] if hasb else 1) * math.prod(gp.tshape[:-2])
    rr, cc = gp.tshape[-2:]
    nd = x.dim()
    tspec = _spec(m, nd - 1, nd - 2 if m.dsize > 1 else None)
    if inverse and not natural_order:
        if isinstance(x, DTensor):
            want = placements(m.mesh, tspec)
            if list(x.placements) != want:
                x = x.redistribute(x.device_mesh, want)
            loc = x.to_local().contiguous()
        else:
            rl, cl = rr // m.dsize, cc // m.shards
            loc = x[..., m.drank * rl:(m.drank + 1) * rl,
                    m.rank * cl:(m.rank + 1) * cl].contiguous()
        local = _pencil_inverse_t(loc.view(bl, rr // m.dsize, -1), gp, m,
                                  chunks=chunks)
        lead = gp.tshape[:-2]
        b = x.shape[0] if hasb else 1
        cube = (b,) + lead + (gp.r1, gp.r2, gp.pc.n1, gp.pc.n2)
        nl = len(lead)
        local = local.view((b,) + lead + (gp.r1, gp.r2 // m.dsize, gp.pc.n1,
                                          gp.pc.n2l))
        return local, _spec(m, nl + 4, nl + 2 if m.dsize > 1 else None), \
            cube
    glob = _pencil_global(x, m).contiguous()
    out = _pencil_forward(glob.view(-1), bl, gp, m, inverse=inverse,
                          chunks=chunks)
    if natural_order:
        return _pencil_natural(out, gp, m).view(x.shape), {}, tuple(x.shape)
    return out.view(x.shape[:-2] + (rr // m.dsize, cc // m.shards)), tspec, \
        tuple(x.shape)


# -- the real slab --------------------------------------------------------


def _live(bins: int, d: int, rank: int) -> tuple[int, int]:
    """(first, count) of ``rank``'s live bins of ``bins`` split over ``d``
    ranks as ``torch.chunk`` splits them (DTensor's ``Shard``): blocks of
    ceil(bins/d). For the half spectrum (bins = C/2 + 1, D | C/2) a block
    is the Cp/D padded columns a rank holds after the real slab's
    transpose."""
    per = -(-bins // d)
    first = rank * per
    return first, max(0, min(per, bins - first))


def _half_rows(zv: torch.Tensor, half, cc: int, d: int) -> torch.Tensor:
    """The real slab's row pass of the packed rows ``zv`` (rows, R/D, C/2)
    (a complex view of real rows, read in place): the half-length FFT, the
    Hermitian unpack and the pad to Cp = C/2 + D columns (torch copies).
    Returns (rows, R/D, Cp)."""
    zf = torch.empty(zv.shape, dtype=zv.dtype, device=zv.device)
    _last_axis(zv, half, zf, inverse=False)
    return F.pad(_unpack_half(zf, cc), (0, d - 1))


def _rslab_forward_rows(xv: torch.Tensor, rows_ax, half, m) -> torch.Tensor:
    """The real slab forward on this rank's real rows ``xv`` (rows, R/D, C)
    (a view): the row pass (:func:`_half_rows`), the relayout into the
    send buffer, ONE all-to-all, the R axis's launch reading the received
    blocks. Returns the padded half spectrum's (rows, R, Cp/D)."""
    return _slab_exchange(_half_rows(_pack(xv), half, xv.shape[-1],
                                     m.shards), rows_ax, m)[0]


def _rslab_inverse_rows(yp: torch.Tensor, rows_ax, half, m,
                        cc: int) -> torch.Tensor:
    """The mirror on this rank's padded half-spectrum rows ``yp`` (rows, R,
    Cp/D): the inverse over R (1/R) writing the send buffer's blocks, ONE
    all-to-all, the relayout, the live bins' Hermitian inverse. Returns
    the real (rows, R/D, C)."""
    d = m.shards
    rows, rr, cpl = yp.shape
    send = torch.empty((rr, rows, cpl), dtype=yp.dtype, device=yp.device)
    _block_axis(yp, rows_ax, rows, cpl, send, into_blocks=True, inverse=True,
                scale=1.0 / rr)
    recv = _exchange(send.view(d, rr // d, rows, cpl), m)
    del send
    z = _from_blocks(recv, rows, d)[..., :cc // 2 + 1]
    return _irfft_cols(z, half)


def rslab_local(x, rows_ax, half, m, *, inverse: bool, cc: int):
    """One real slab transform on this rank: ``(local, spec, shape)``. The
    forward takes real grids ``x`` (B, R, C) (or one grid) with R over
    ``fft`` and gives the (B, R, C/2+1) half spectrum with the bins over
    ``fft`` in ``torch.chunk``'s blocks (each rank's Cp/D padded columns
    cut to its live ones); the inverse takes that and gives the real
    grids back."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.fft_sharding import placements

    d = m.shards
    bins = cc // 2 + 1
    first, count = _live(bins, d, m.rank)
    cpl = (cc // 2 + d) // d
    if not inverse:
        xv, b, bsh = _grid_rows(x, m, 2, 0)
        local = _rslab_forward_rows(xv, rows_ax, half, m)[..., :count]
        shape = tuple(x.shape[:-1]) + (bins,)
        return _result(local, m, x.dim(), 2, 1, bsh, shape)
    hasb = x.dim() == 3
    b = x.shape[0] if hasb else 1
    row0, rows, bsh = _rows_of(b, m) if hasb else (0, 1, False)
    if isinstance(x, DTensor):
        want = placements(m.mesh, _spec(m, x.dim() - 1, 0 if bsh else None))
        if list(x.placements) != want:
            x = x.redistribute(x.device_mesh, want)
        yl = x.to_local()
        yl = yl if hasb else yl.unsqueeze(0)
    else:
        yb = x if hasb else x.unsqueeze(0)
        yl = yb[row0:row0 + rows, :, first:first + count]
    yp = F.pad(yl, (0, cpl - count))
    local = _rslab_inverse_rows(yp, rows_ax, half, m, cc)
    shape = tuple(x.shape[:-1]) + (cc,)
    return _result(local, m, x.dim(), 2, 0, bsh, shape)


def _composed_rfft2(x, rows_ax, *, mesh, axis: str, device):
    """The pencil path's rfft2: the 1-D mesh rfft over the columns of
    every row (the packed half-length pencil pipeline), then the 1-D mesh
    transform over the rows of every bin (natural order; the local
    transform of R when it cannot pencil-split). Each piece is a rank-1
    sharded plan over ``fft`` with the batch replicated; the result is a
    DTensor replicated on ``mesh``."""
    from . import api
    from .extensions import rfft

    shape = tuple(x.shape)
    rr, cc = shape[-2:]
    glob = _replicated(x)
    y = rfft(glob.reshape(-1, cc), mesh=mesh, axis=axis, data_axis=None,
             device=device)
    y = _replicated(y).reshape(shape[:-1] + (cc // 2 + 1,))
    d = mesh_size(mesh, axis)
    if api._feasible_1d(rr, d):
        z = y.transpose(-1, -2).reshape(-1, rr)
        p = api.plan(api.spec_for(z, mesh=mesh, axis=axis, data_axis=None,
                                  device=device))
        y = _replicated(p.fft(z)).reshape(shape[:-2] + (cc // 2 + 1, rr)) \
            .transpose(-1, -2).contiguous()
    else:
        y = _local_axis_fft(y.contiguous(), -2, rows_ax, inverse=False)
    return _replicated_on(y, mesh)


def _composed_irfft2(y, rows_ax, *, cc: int, mesh, axis: str, device):
    """Inverse of :func:`_composed_rfft2`: the rows' inverse, then the 1-D
    mesh irfft over the columns (``cc`` points)."""
    from . import api
    from .extensions import irfft

    y = _replicated(y)
    shape = tuple(y.shape)
    rr, bins = shape[-2:]
    d = mesh_size(mesh, axis)
    if api._feasible_1d(rr, d):
        z = y.transpose(-1, -2).reshape(-1, rr)
        p = api.plan(api.spec_for(z, mesh=mesh, axis=axis, data_axis=None,
                                  device=device))
        y = _replicated(p.ifft(z)).reshape(shape[:-2] + (bins, rr)) \
            .transpose(-1, -2)
    else:
        y = _local_axis_fft(y.contiguous(), -2, rows_ax, inverse=True,
                            scale=1.0 / rr)
    out = irfft(y.reshape(-1, bins).contiguous(), n=cc, mesh=mesh, axis=axis,
                data_axis=None, device=device)
    return _replicated_on(_replicated(out).reshape(shape[:-1] + (cc,)), mesh)


def _replicated_on(y: torch.Tensor, mesh):
    """``y``, the same on every rank, as a DTensor replicated on
    ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(y, mesh, [Replicate()] * mesh.ndim,
                              run_check=False, shape=y.shape,
                              stride=y.stride())


def _replicated(x) -> torch.Tensor:
    """The global value of ``x`` on this rank (a DTensor's full tensor; a
    replicated one's local tensor)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    if all(p == Replicate() for p in x.placements):
        return x.to_local()
    return x.full_tensor()


# -- the 2-D grouped two-side ABFT ----------------------------------------


def _seu2(z1: torch.Tensor, inject: torch.Tensor, *, b: int, g: int,
          bl: int, gl: int, md: int, rank: int) -> None:
    """Add the SEUs of ``inject`` (F, 7) rows ``[fft_device, signal,
    local_r, col, enable, eps_re, eps_im]`` that fall on this rank and data
    shard to pass 1's output ``z1`` (bl + 2*gl, R/D, cols): ``local_r``
    one of the rank's R rows, ``col`` a global bin, ``signal`` in [0, B) a
    data grid, [B, B+G) / [B+G, B+2G) a group's cs2 / cs3 grid. One
    ``index_put_`` with ``accumulate`` on the device; an SEU elsewhere adds
    0."""
    nrow, rl, cols = z1.shape
    dev_, sig, row, col = (inject[:, i].long() for i in range(4))
    is_data = sig < b
    is_cs2 = (sig >= b) & (sig < b + g)
    gidx = torch.where(is_cs2, sig - b, sig - b - g)
    owner = torch.where(is_data, torch.div(sig, bl, rounding_mode="floor"),
                        torch.div(gidx, gl, rounding_mode="floor"))
    lrow = torch.where(is_data, sig - owner * bl,
                       bl + torch.where(is_cs2, 0, gl) + gidx - owner * gl)
    hit = ((owner == md) & (dev_ == rank) & (row >= 0) & (row < rl)
           & (col >= 0) & (col < cols) & (lrow >= 0) & (lrow < nrow))
    amp = inject[:, 4] * hit.to(inject.dtype)
    eps = torch.complex(inject[:, 5], inject[:, 6]).to(z1.dtype) * amp
    idx = torch.where(hit, (lrow * rl + row) * cols + col, 0)
    z1.view(-1).index_put_((idx,), eps, accumulate=True)


def ft_slab2_local(x, axes, m, *, groups: int, threshold: float,
                   correct: bool, inject: torch.Tensor | None,
                   recompute: bool, real: bool):
    """The grouped two-side ABFT on the slab forward of (B, R, C) grids on
    this rank: ``(res, spec, shape)``, ``res.y`` this rank's rows.

    Pass 1: the C transform (real: the packed half-length one) of the
    data rows straight from where they lie into rows [0, bl) of the pass-1
    buffer, then of the group sums cs2 = sum x and cs3 = sum id * x
    (torch; real rows for real grids) into rows [bl, bl + 2gl) of the same
    buffer — a second launch at that row offset; its left check (sum_k
    F[k] = n x[0]); (real) the unpack and the pad to Cp; the SEUs of
    ``inject``; the relayout and ONE all-to-all; pass 2 over R reading the
    received blocks, its left check; the output group sums, d2, d3 and
    the shared :func:`_grouped_verdict` with ``n = R * C`` (real: ``R *
    Cp``), ONE ``all_reduce``; the telemetry gathers. ``recompute`` reads
    the verdict back and reruns this data shard's uncorrectable groups on
    the plain slab."""
    rows_ax, last = axes
    d = m.shards
    xv, b, bsh = _grid_rows(x, m, 2, 0)
    bl, rl, cc = xv.shape
    rr = rl * d
    g = groups
    s = b // g
    dl = m.dsize if bsh else 1
    md = m.drank if bsh else 0
    gl = g // dl
    rdt = xv.real.dtype if xv.is_complex() else xv.dtype
    dev = xv.device
    ids = torch.arange(1, s + 1, dtype=rdt, device=dev).view(s, 1, 1)
    cs = torch.empty((2 * gl, rl, cc), dtype=xv.dtype, device=dev)
    _group_sums(xv.reshape(gl, s, rl, cc), ids, cs)
    zv, zcs = (_pack(xv), _pack(cs)) if real else (xv, cs)
    npts = zv.shape[-1]
    nrow = bl + 2 * gl
    zf = torch.empty((nrow, rl, npts), dtype=zv.dtype, device=dev)
    _last_axis(zv, last, zf[:bl], inverse=False)
    _last_axis(zcs, last, zf[bl:], inverse=False)
    f_sum = zf.sum(dim=-1)
    delta = torch.maximum(
        _left_delta(f_sum[:bl], zv[..., 0], _msq(zv, -1), npts),
        _left_delta(f_sum[bl:], zcs[..., 0], _msq(zcs, -1), npts))
    z1 = F.pad(_unpack_half(zf, cc), (0, d - 1)) if real else zf
    del zf, cs, zcs
    if inject is not None:
        _seu2(z1, inject, b=b, g=g, bl=bl, gl=gl, md=md, rank=m.rank)
    cw = z1.shape[-1]
    out, recv = _slab_exchange(z1, rows_ax, m)
    del z1
    cwl = cw // d
    rv = recv.view(rr, nrow, cwl)
    delta = torch.maximum(delta, _left_delta(out.sum(dim=1), rv[0],
                                             _msq(rv, 0), rr))
    del recv, rv
    ylg = out[:bl].view(gl, s, rr, cwl)
    cso = torch.empty((2 * gl, rr, cwl), dtype=out.dtype, device=dev)
    _group_sums(ylg, ids, cso)
    d2 = out[bl:bl + gl] - cso[:gl]
    d3 = out[bl + gl:] - cso[gl:]
    stats = _grouped_verdict(ylg, d2, d3, cso[:gl], all_reduce=m.all_reduce,
                             threshold=threshold, s=s, n=rr * cw, md=md,
                             bl=bl, gl=gl, correct=correct)
    y = out[:bl]
    res = distributed._ft_result(y, stats, delta, m, bsharded=bsh,
                                 correct=correct)
    if recompute:
        bad = res.uncorrectable.cpu()
        for gi in torch.nonzero(bad).flatten().tolist():
            lg = gi - md * gl
            if not 0 <= lg < gl:
                continue              # another data shard's group
            grp = xv[lg * s:(lg + 1) * s]
            y[lg * s:(lg + 1) * s] = (
                _rslab_forward_rows(grp, rows_ax, last, m) if real
                else _slab_forward_rows(grp, axes, m))
        res.recomputed = torch.tensor(int(bad.sum()), dtype=torch.int32,
                                      device=dev)
    shape = (b, rr, cc)
    if real:
        bins = cc // 2 + 1
        res.y = y[..., :_live(bins, d, m.rank)[1]]
        shape = (b, rr, bins)
    return res, _spec(m, 2, 0 if bsh else None), shape


# -- the 2-D convolution --------------------------------------------------


def _crop_range(la: int, lv: int, mode: str) -> tuple[int, int]:
    """(start, length) of ``spectral._crop``'s window of the la + lv - 1
    linear result."""
    lmin, lmax = min(la, lv), max(la, lv)
    if mode == "full":
        return 0, la + lv - 1
    if mode == "same":
        return (lmin - 1) // 2, lmax
    if mode == "valid":
        return lmin - 1, lmax - lmin + 1
    raise ValueError(f"mode must be full|same|valid, got {mode!r}")


def conv2_local(a: torch.Tensor, v: torch.Tensor, axes, m, *, sa, sv,
                mode: str, real: bool):
    """This rank's block of the 2-D linear convolution of the padded grids
    ``a`` (B, nr, nc) (or one grid) and ``v`` (BK, nr, nc), BK 1 or B, the
    global values in the compute dtype: ``(local, spec, shape)``.
    ``sa``/``sv`` are the operands' unpadded (rows, cols), ``axes`` the
    (nr, nc) axes (the nc/2 one when ``real``: both operands' packed
    half-spectrum round trip).

    Forward, both operands stacked: pass 1 of ``a``'s rows and of ``v``'s
    (two launches into one buffer at row offsets), the relayout, ONE
    all-to-all, the R axis; the product in the slab's natural order; the
    inverse over R writing the send buffer (all nr rows, one uniform
    stride), ONE all-to-all that sends each rank the rows of its
    ``torch.chunk`` block of the cropped rows (uneven splits: the rows the
    crop drops never move), the relayout, the inverse of the columns and
    their crop. The result is sharded over its rows."""
    rows_ax, last = axes
    d = m.shards
    hasb = a.dim() == 3
    b = a.shape[0] if hasb else 1
    row0, ba, bsh = _rows_of(b, m) if hasb else (0, 1, False)
    ab = a if hasb else a.unsqueeze(0)
    vb = v if v.dim() == 3 else v.unsqueeze(0)
    nr, nc = ab.shape[-2:]
    rl = nr // d
    av = ab[row0:row0 + ba].narrow(1, m.rank * rl, rl)
    vv = (vb[row0:row0 + ba] if vb.shape[0] == b and hasb and b > 1
          else vb[:1]).narrow(1, m.rank * rl, rl)
    bk = vv.shape[0]
    za, zv = (_pack(av), _pack(vv)) if real else (av, vv)
    zf = torch.empty((ba + bk, rl, za.shape[-1]), dtype=za.dtype,
                     device=za.device)
    _last_axis(za, last, zf[:ba], inverse=False)
    _last_axis(zv, last, zf[ba:], inverse=False)
    z1 = F.pad(_unpack_half(zf, nc), (0, d - 1)) if real else zf
    del zf
    cwl = z1.shape[-1] // d
    zr = _slab_exchange(z1, rows_ax, m)[0]
    del z1
    prod = zr[:ba] * zr[ba:]
    del zr
    send = torch.empty((nr, ba, cwl), dtype=prod.dtype, device=prod.device)
    _block_axis(prod, rows_ax, ba, cwl, send, into_blocks=True, inverse=True,
                scale=1.0 / nr)
    del prod
    r_lo, r_len = _crop_range(sa[0], sv[0], mode)
    c_lo, c_len = _crop_range(sa[1], sv[1], mode)
    counts = [_live(r_len, d, e)[1] for e in range(d)]
    mine = counts[m.rank]
    per_row = ba * cwl
    recv = torch.empty((d, mine, ba, cwl), dtype=send.dtype,
                       device=send.device)
    m.all_to_all(recv.view(-1), send[r_lo:r_lo + r_len].reshape(-1),
                 out_splits=[mine * per_row] * d,
                 in_splits=[c * per_row for c in counts])
    del send
    z = recv.permute(2, 1, 0, 3).reshape(ba, mine, d * cwl).contiguous()
    del recv
    if real:
        full = _irfft_cols(z[..., :nc // 2 + 1], last) if mine else \
            z.real.new_empty((ba, 0, nc))
    else:
        full = _local_axis_fft(z, -1, last, inverse=True, scale=1.0 / nc,
                               out=z) if mine else z
    local = full[..., c_lo:c_lo + c_len]
    shape = ((b,) if hasb else ()) + (r_len, c_len)
    return ((local if hasb else local.squeeze(0)),
            _spec(m, a.dim() - 2, 0 if bsh else None), shape)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def distributed_fftn(x, mesh=None, *, ndim: int | None = None,
                     decomp: str = "auto", inverse: bool = False,
                     natural_order: bool = True, axis: str = FFT_AXIS,
                     data_axis: str | None = _AUTO, chunks: int = 1,
                     device=None):
    """N-D FFT over the last ``ndim`` axes (default: all, capped at 3) of
    ``x``, a batch ``(B, *grid)`` or one grid, distributed over ``mesh``:
    the plan of ``FFTSpec(x.shape, rank=ndim, mesh=mesh, ...)`` and its
    executor. Matches ``torch.fft.fftn`` conventions.

    ``decomp`` picks the layout — ``"slab"``, ``"pencil"``, ``"auto"``
    (:func:`choose_decomp`) or ``"local"``. ``natural_order=False`` (pencil)
    keeps both distributed axes in the transposed digit order and, on the
    inverse, declares the input to be in it (TRANSPOSED_IN). ``chunks``
    (pencil) splits the batch, or the first leading axis of one rank-3
    grid, into overlapped transactions; results are bitwise the same for
    every count. Without a mesh (or on one ``fft`` rank) this is the local
    transform, on ``device`` (the mesh's device type, else the card)."""
    from repro_torch.kernels.ops import _as_complex

    from . import api

    x = _as_complex(x)
    if ndim is None:
        ndim = min(x.dim(), 3)
    if ndim < 2 or ndim > 3:
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    if x.dim() < ndim:
        raise ValueError(f"input rank {x.dim()} < ndim={ndim}")
    spec = api.spec_for(x, rank=ndim, mesh=mesh, axis=axis,
                        data_axis=data_axis, decomp=decomp,
                        natural_order=natural_order, chunks=int(chunks),
                        device=_device(device, mesh))
    p = api.plan(spec)
    return p.ifft(x) if inverse else p.fft(x)


def distributed_fft2(x, mesh=None, **kwargs):
    """2-D FFT over the last two axes (see :func:`distributed_fftn`)."""
    return distributed_fftn(x, mesh, ndim=2, **kwargs)


def distributed_ifft2(x, mesh=None, **kwargs):
    """Inverse 2-D FFT (normalized by 1/(R*C)); ``natural_order=False``
    consumes the forward's transposed-digit pencil output."""
    return distributed_fftn(x, mesh, ndim=2, inverse=True, **kwargs)


def distributed_ifftn(x, mesh=None, **kwargs):
    """Inverse of :func:`distributed_fftn` (normalized by 1/prod(shape))."""
    return distributed_fftn(x, mesh, inverse=True, **kwargs)


def _real_axes(tshape, dtype, device):
    """The (R, C/2) axes of a real rank-2 grid on ``device``."""
    from repro_torch.kernels.ops import axis_fft

    return (axis_fft(tshape[0], dtype, device),
            axis_fft(tshape[1] // 2, dtype, device)
            if tshape[1] % 2 == 0 else None)


def _as_dtensor(result, m):
    """A DTensor of a ``*_local`` function's ``(local, spec, shape)``."""
    local, spec, shape = result
    return distributed._dtensor(local, spec, m, shape)


def distributed_rfft2(x, mesh=None, *, axis: str = FFT_AXIS,
                      data_axis: str | None = _AUTO, device=None):
    """2-D real-input FFT over the last two axes -> the (..., R, C/2+1)
    half spectrum, distributed over ``mesh`` by the real slab (a DTensor,
    the bins over ``fft``). Matches ``torch.fft.rfft2``. Like the
    reference, a grid the mesh cannot split (:func:`rslab_feasible`), or no
    mesh, runs the local transform on every rank (a plain tensor on
    ``device``)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if x.is_complex():
        raise ValueError(f"rfft2 takes a real input, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"rfft2 needs a rank >= 2 input, got "
                         f"{tuple(x.shape)}")
    rdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    return _real_slab_call(x, mesh, axis, data_axis, device, rdt,
                           (int(x.shape[-2]), int(x.shape[-1])),
                           inverse=False)


def distributed_irfft2(y, mesh=None, *, axis: str = FFT_AXIS,
                       data_axis: str | None = _AUTO, device=None):
    """Inverse of :func:`distributed_rfft2`: (..., R, bins) half spectrum
    -> (..., R, 2*(bins-1)) real grids. Matches ``torch.fft.irfft2`` (even
    output widths; grids the mesh cannot split run locally)."""
    y = y if isinstance(y, torch.Tensor) else torch.as_tensor(y)
    if y.dim() < 2:
        raise ValueError(f"irfft2 needs a rank >= 2 spectrum, got "
                         f"{tuple(y.shape)}")
    if y.shape[-1] < 2:
        raise ValueError("irfft2: a single-bin half spectrum has no "
                         "default width (2*(bins-1) = 0) — the planned "
                         "grid needs >= 2 bins")
    cdt = torch.complex128 if y.dtype in (torch.complex128, torch.float64) \
        else torch.complex64
    return _real_slab_call(y, mesh, axis, data_axis, device, cdt,
                           (int(y.shape[-2]), 2 * (int(y.shape[-1]) - 1)),
                           inverse=True)


def _real_slab_call(x, mesh, axis, data_axis, device, dtype, tshape, *,
                    inverse: bool):
    """:func:`distributed_rfft2` / :func:`distributed_irfft2` past their
    checks: the real slab on a mesh that splits ``tshape``, else the
    local transform."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core import plan as planbase
    from repro_torch.kernels.stockham import device_key

    mesh = _resolve_mesh(mesh, axis)
    dev = planbase.resolve_device(_device(device, mesh),
                                  "distributed_irfft2" if inverse
                                  else "distributed_rfft2")
    axes = _real_axes(tshape, _complex_of(dtype), device_key(dev))
    if mesh is None or mesh_size(mesh, axis) == 1 \
            or not rslab_feasible(tshape, mesh_size(mesh, axis)):
        x = _replicated(x).to(device=dev, dtype=dtype)
        if inverse:
            return _local_irfft2(x, *axes, cc=tshape[1])
        return _local_rfft2(x, *axes)
    m = distributed._Mesh.of(mesh, axis, _resolve_data_axis(mesh, data_axis))
    x = x.to(dtype) if isinstance(x, DTensor) else x.to(device=dev,
                                                          dtype=dtype)
    return _as_dtensor(rslab_local(x, *axes, m, inverse=inverse,
                                   cc=tshape[1]), m)


def _ft_call(x, mesh, *, axis, threshold, correct, inject, groups,
             group_size, data_axis, recompute, real: bool, name: str):
    """:func:`ft_distributed_fft2` / :func:`ft_distributed_rfft2` past
    their dtype checks: the reference's validation, then
    :func:`ft_slab2_local` on this rank."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core import plan as planbase
    from repro_torch.kernels.ops import axis_fft
    from repro_torch.kernels.stockham import device_key

    if x.dim() != 3:
        raise ValueError(f"{name} expects (B, R, C), got {tuple(x.shape)}")
    mesh = _resolve_mesh(mesh, axis)
    if mesh is None:
        raise ValueError(f"{name} requires a mesh with an '{axis}' axis "
                         f"(see launch.mesh.make_fft_mesh)")
    d = mesh_size(mesh, axis)
    tshape = tuple(int(s) for s in x.shape[1:])
    if real and not rslab_feasible(tshape, d):
        raise ValueError(
            f"the real ft pipeline rides the slab transpose: needs a "
            f"power-of-two grid with {d} | {tshape[0]} and "
            f"{d} | {tshape[-1]}//2, got {tshape}")
    if not real and not slab_feasible(tshape, d):
        raise ValueError(
            f"the ft pipeline rides the slab transpose: needs "
            f"power-of-two axes divisible by {d}, got {tshape}")
    daxis = _resolve_data_axis(mesh, data_axis)
    g = distributed.resolve_abft_groups(
        x.shape[0], groups=groups, group_size=group_size,
        data_shards=mesh_size(mesh, daxis) if daxis else 1)
    dev = planbase.resolve_device(_device(None, mesh), name)
    if not isinstance(x, DTensor):
        x = x.to(dev)
    cdt = x.dtype if x.is_complex() else _complex_of(x.dtype)
    key = device_key(dev)
    axes = (axis_fft(tshape[0], cdt, key),
            axis_fft(tshape[1] // 2 if real else tshape[1], cdt, key))
    return ft_sharded2(x, axes, distributed._Mesh.of(mesh, axis, daxis),
                       groups=g, threshold=float(threshold),
                       correct=bool(correct),
                       inject=distributed._inject_rows(inject, cdt, dev),
                       recompute=bool(recompute), real=real)


def ft_sharded2(x, axes, m, **kw) -> DistFFTResult:
    """:func:`ft_slab2_local` on this rank of ``m``, its ``y`` a DTensor of
    the global result."""
    res, spec, shape = ft_slab2_local(x, axes, m, **kw)
    res.y = distributed._dtensor(res.y, spec, m, shape)
    return res


def ft_distributed_fft2(x, mesh=None, *, axis: str = FFT_AXIS,
                        threshold: float = 1e-4, correct: bool = True,
                        inject=None, groups: int | None = None,
                        group_size: int | None = None,
                        data_axis: str | None = _AUTO,
                        recompute_uncorrectable: bool = False
                        ) -> DistFFTResult:
    """Fault-tolerant slab 2-D forward FFT (grouped two-side ABFT) of (B,
    R, C) grids on ``mesh``, every rank of the mesh calling it
    (:func:`ft_slab2_local`). The batch splits into G checksum groups
    (auto: one a data shard), each carrying a cs2/cs3 checksum grid pair
    through the transpose (2G/B relative overhead); one SEU a group is
    detected, located to its grid and corrected; two are
    ``uncorrectable`` (``recompute_uncorrectable`` reruns the group on the
    plain slab); a checksum-grid hit is a ``checksum_fault``. ``inject``
    rows are ``[fft_device, signal, local_r, col, enable, eps_re, eps_im]``
    on pass 1's output (``local_r`` one of the rank's R rows, ``col`` a
    global C bin). A mesh of one ``fft`` rank runs the same pipeline with
    D = 1."""
    from repro_torch.kernels.ops import _as_complex

    return _ft_call(_as_complex(x), mesh, axis=axis, threshold=threshold,
                    correct=correct, inject=inject, groups=groups,
                    group_size=group_size, data_axis=data_axis,
                    recompute=recompute_uncorrectable, real=False,
                    name="ft_distributed_fft2")


def ft_distributed_rfft2(x, mesh=None, *, axis: str = FFT_AXIS,
                         threshold: float = 1e-4, correct: bool = True,
                         inject=None, groups: int | None = None,
                         group_size: int | None = None,
                         data_axis: str | None = _AUTO,
                         recompute_uncorrectable: bool = False
                         ) -> DistFFTResult:
    """:func:`ft_distributed_fft2` for REAL grids on the real slab: the
    checksum grids are real row sums that fold through the packing trick
    with the data (every map is R-linear with real ids), so the decode is
    exact on the padded half spectrum (``n = R * Cp``). ``res.y`` carries
    the C/2+1 live bins; ``col`` of an inject row addresses the padded
    columns [0, C/2 + D)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if x.is_complex():
        raise ValueError(
            f"ft_distributed_rfft2 takes a real input, got {x.dtype} — "
            f"use ft_distributed_fft2 for complex grids")
    if x.dtype != torch.float64:
        x = x.to(torch.float32)
    return _ft_call(x, mesh, axis=axis, threshold=threshold, correct=correct,
                    inject=inject, groups=groups, group_size=group_size,
                    data_axis=data_axis, recompute=recompute_uncorrectable,
                    real=True, name="ft_distributed_rfft2")
