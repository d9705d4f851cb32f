"""cuFFT-style plan/execute API: one :class:`FFTSpec` -> a cached
:class:`FFTPlan` executor.

An :class:`FFTSpec` is a frozen, hashable description of a transform (shape,
dtype, rank, real input, fault-tolerance config, device); :func:`plan`
resolves it ONCE — the stage plan of every transform axis and its stage
tables uploaded to the device — and hands back an :class:`FFTPlan` whose
executors (``fft/ifft``, ``fft2/ifft2``, ``rfft/irfft``, ``rfft2/irfft2``,
``ft_fft``, ``convolve/correlate``, ``power_spectrum``) run ``kernels.ops``
on those stage plans and tables.

A spec with a ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with an
``fft`` dimension of size > 1) plans the sharded transforms, each rank
running the pipeline's local passes on the block-FFT kernel. Rank 1
(``core.fft.distributed``): ``fft``/``ifft`` (natural or transposed order,
``chunks`` transactions, the batch over a ``data`` dimension), the packed
``rfft``/``irfft``, the grouped two-side ABFT ``ft_fft`` and the spectral
consumers ``convolve``/``correlate``/``power_spectrum`` (the transposed
round trip). Rank 2 and 3 (``core.fft.multidim``): the slab or pencil
``fft``/``ifft`` (``decomp``, chosen by the volume model when ``"auto"``),
the real slab (or composed pencil) ``rfft2``/``irfft2``, the 2-D grouped
ABFT ``ft_fft`` (C2C and real) and ``convolve``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core import plan as planbase
from repro_torch.core.plan import FTConfig

from . import distributed, extensions, multidim, spectral
from .distributed import _AUTO, FFT_AXIS, mesh_axes, mesh_size

__all__ = ["FFTSpec", "FTConfig", "FFTPlan", "plan", "spec_for",
           "plan_cache_info", "plan_cache_clear", "plan_cache_keys"]

_COMPLEX_DTYPES = {"complex64": torch.complex64,
                   "complex128": torch.complex128}


@dataclasses.dataclass(frozen=True)
class FFTSpec:
    """Frozen, hashable description of one batched FFT workload.

    ``shape`` is the full operand shape — leading batch dims plus the last
    ``rank`` transform axes. ``dtype`` must be a complex dtype (executors
    coerce real inputs). ``ft`` attaches an :class:`FTConfig` (rank-1
    complex plans). ``device`` is where the plan runs: ``"cuda"`` (the
    kernels) by default, ``"cpu"`` for the kernels' plain versions. Specs
    are value objects: equal specs hash equal and hit the same cached
    :class:`FFTPlan`.

    ``real=True`` declares the OPERAND real-valued: ``shape`` stays the
    full real shape, ``dtype`` is the complex precision the half spectrum
    carries, and the plan binds the ``rfft/irfft`` (rank 1) or
    ``rfft2/irfft2`` (rank 2) executors — the packed half-length
    transforms. Rank 2 and 3 bind ``fft2/ifft2`` (alias ``fftn/ifftn``):
    every power-of-two axis runs the block-FFT kernel, any other length the
    direct DFT.

    ``mesh`` (a ``DeviceMesh`` with an ``axis`` dimension; build it with
    ``launch.mesh.make_fft_mesh``) selects the sharded pipelines when that
    dimension has more than one rank: the batch shards over ``data_axis``
    (auto-detected ``"data"``; None replicates it), ``natural_order=False``
    is the FFTW-MPI transposed pairing, and ``chunks`` splits the batch
    (a pencil: or the first leading axis of one rank-3 grid) into that
    many overlapped transactions (0 = auto from the modelled all-to-all
    bytes, or ``ft.transactions`` on a rank-1 ft spec; results are bitwise
    the same for every count). ``ft`` on a sharded spec is the grouped
    two-side ABFT (``ft.groups`` / ``ft.group_size`` checksum groups; rank
    2 on the slab). ``decomp`` is the n-D slab/pencil knob (rank >= 2):
    ``"auto"`` is :func:`~repro_torch.core.fft.multidim.choose_decomp`,
    ``"local"`` the local plan on every rank. A sharded plan takes
    ``(B, N)`` operands at rank 1 and a batch of at most one leading
    dimension (or one grid) at rank 2 and 3. On a mesh of one ``fft`` rank
    the plan is the local one.
    """

    shape: tuple[int, ...]
    dtype: str = "complex64"
    rank: int = 1
    mesh: object | None = None
    axis: str = FFT_AXIS
    data_axis: str | None = _AUTO
    decomp: str = "auto"
    natural_order: bool = True
    ft: FTConfig | None = None
    real: bool = False
    device: str = "cuda"
    chunks: int = 1

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        if not shape or any(s <= 0 for s in shape):
            raise ValueError(f"FFTSpec.shape must be a non-empty tuple of "
                             f"positive sizes, got {self.shape!r}")
        object.__setattr__(self, "shape", shape)
        dt = planbase.dtype_name(self.dtype)
        if dt not in _COMPLEX_DTYPES:
            raise ValueError(
                f"FFTSpec.dtype must be one of {tuple(_COMPLEX_DTYPES)} "
                f"(executors coerce real inputs), got {self.dtype!r}")
        object.__setattr__(self, "dtype", dt)
        if self.rank not in (1, 2, 3):
            raise ValueError(f"FFTSpec.rank must be 1, 2, or 3, "
                             f"got {self.rank!r}")
        if len(shape) < self.rank:
            raise ValueError(f"FFTSpec.shape {shape} has fewer axes than "
                             f"rank={self.rank}")
        if self.ft is not None and not isinstance(self.ft, FTConfig):
            raise ValueError(f"FFTSpec.ft must be an FTConfig, "
                             f"got {type(self.ft).__name__}")
        object.__setattr__(self, "device", str(torch.device(self.device)))
        sharded = self._check_mesh()
        if self.rank == 1:
            if self.decomp != "auto":
                raise ValueError(
                    f"FFTSpec.decomp is a multi-dimensional knob (rank >= "
                    f"2); rank-1 transforms are always the pencil digit "
                    f"split — got decomp={self.decomp!r}")
        elif self.decomp not in ("auto", "slab", "pencil", "local"):
            raise ValueError(f"FFTSpec.decomp must be auto|slab|pencil|"
                             f"local, got {self.decomp!r}")
        if not isinstance(self.chunks, int) or isinstance(self.chunks, bool) \
                or self.chunks < 0:
            raise ValueError(
                f"FFTSpec.chunks must be a non-negative int (0 = auto, 1 = "
                f"bulk-synchronous, k = k transactions), got "
                f"{self.chunks!r}")
        sharded = sharded and self.decomp != "local"
        if sharded and self.rank == 1 and len(self.shape) != 2:
            raise ValueError(
                f"a sharded rank-1 plan takes (B, N) operands, got "
                f"shape {self.shape} — flatten the batch dims")
        if sharded and len(self.shape) > self.rank + 1:
            raise ValueError(
                f"a sharded rank-{self.rank} plan takes (B, *grid) or one "
                f"grid, got shape {self.shape} — flatten the batch dims")
        if self.real:
            if not self.natural_order:
                raise ValueError(
                    "real plans are natural-order only — the Hermitian "
                    "unpack indexes half-spectrum bins by k, which the "
                    "transposed digit pairing scrambles")
            if self.rank == 3:
                raise ValueError(
                    "real plans are rank 1 (rfft) or rank 2 (rfft2); rank=3 "
                    "has no real pipeline yet")
            if self.ft is not None and self.rank != 2:
                raise ValueError(
                    "the 1-D real path has no ft pipeline — fault-tolerant "
                    "real transforms are the rank-2 slab (rfft2 with "
                    "FFTSpec(rank=2, real=True, ft=...))")
        if self.ft is not None and self.rank == 3:
            raise ValueError("fault-tolerant transforms are 1-D and 2-D "
                             "(slab) only; rank=3 has no ft pipeline yet")
        if self.ft is not None and self.rank == 2 and not sharded:
            raise ValueError(
                f"fault-tolerant "
                f"{'rfft2 runs' if self.real else '2-D transforms run'} "
                f"the sharded grouped ABFT on the slab transpose: the spec "
                f"needs a mesh with an '{self.axis}' axis of >= 2 devices")

    def _check_mesh(self) -> bool:
        """Validate ``mesh``, ``axis`` and ``data_axis``; whether the mesh
        shards the transform (its ``axis`` dimension has > 1 rank)."""
        if self.mesh is None:
            return False
        names = mesh_axes(self.mesh)
        if not names or not hasattr(self.mesh, "size"):
            raise ValueError(
                f"FFTSpec.mesh must be a torch.distributed DeviceMesh with "
                f"named dimensions (launch.mesh.make_fft_mesh), got "
                f"{type(self.mesh).__name__}")
        if self.axis not in names:
            raise ValueError(
                f"FFTSpec.axis {self.axis!r} is not an axis of the mesh "
                f"{names} — build the mesh with launch.mesh.make_fft_mesh "
                f"or pass the right axis name")
        if self.data_axis not in (None, _AUTO) \
                and self.data_axis not in names:
            raise ValueError(
                f"FFTSpec.data_axis {self.data_axis!r} is not an axis of "
                f"the mesh {names}")
        mesh_dev = getattr(self.mesh, "device_type", None)
        if mesh_dev is not None and mesh_dev != torch.device(
                self.device).type:
            raise ValueError(
                f"FFTSpec.device {self.device!r} is not the mesh's device "
                f"type {mesh_dev!r}")
        return mesh_size(self.mesh, self.axis) > 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return _COMPLEX_DTYPES[self.dtype]

    @property
    def tshape(self) -> tuple[int, ...]:
        """The transform axes (last ``rank`` entries of ``shape``)."""
        return self.shape[-self.rank:]

    @property
    def batch(self) -> int:
        """Total signals: product of the leading (batch) dims."""
        return math.prod(self.shape[:-self.rank])


def spec_for(x, *, rank: int = 1, mesh=None, axis: str = FFT_AXIS,
             data_axis: str | None = _AUTO, decomp: str = "auto",
             natural_order: bool = True, ft: FTConfig | None = None,
             real: bool = False, chunks: int = 1,
             device="cuda") -> FFTSpec:
    """Build the :class:`FFTSpec` describing ``x``'s transform on
    ``device``. With ``mesh=None`` the mesh is inferred from ``x``: a
    ``DTensor`` laid out over an ``axis`` mesh dimension of size > 1 plans
    sharded (the auto-dispatch contract of ``kernels.ops``). On a C2C spec
    real dtypes map to ``complex64``; on a real spec (``real=True``) the
    operand's precision is KEPT: ``float64`` signals plan a ``complex128``
    half spectrum."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if mesh is None:
        from repro_torch.parallel.fft_sharding import infer_fft_mesh
        mesh = infer_fft_mesh(x, axis)
    dt = x.dtype
    if not x.is_complex():
        dt = (torch.complex128 if real and dt == torch.float64
              else torch.complex64)
    return FFTSpec(shape=tuple(x.shape), dtype=planbase.dtype_name(dt),
                   rank=rank, mesh=mesh, axis=axis, data_axis=data_axis,
                   decomp=decomp, natural_order=natural_order, ft=ft,
                   real=real, chunks=chunks, device=str(device))


def _feasible_1d(n: int, shards: int) -> bool:
    """Whether an n-point transform can pencil-split over ``shards``."""
    return (n > 0 and not (n & (n - 1)) and shards > 0
            and not (shards & (shards - 1)) and n >= shards * shards)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _on_local(fn, x):
    """Run the local executor ``fn`` on a ``DTensor`` whose transform axis
    is whole on each rank (redistributed there first when it is sharded),
    and return the result with the operand's placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    last = x.dim() - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim % x.dim() == last
          else p for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    y = fn(x.to_local())
    shape = tuple(x.shape[:-1]) + (y.shape[-1],)
    return DTensor.from_local(y, x.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.Size(
                                  distributed._contiguous_strides(shape)))


@planbase.register_plan_type(FFTSpec)
class FFTPlan(planbase.Plan):
    """Pre-resolved executor bundle for one :class:`FFTSpec`.

    The constructor resolves the device and, for every transform axis, its
    stage plan, the stage tables of every pass and the pass twiddle tables
    of every pass but the last, in each direction (uploaded to the device
    once, kept in ``axes``: one :class:`~repro_torch.kernels.ops.AxisFFT`
    per axis, ``None`` for a length that runs the direct DFT). A rank-1
    complex plan also keeps its axis as ``local_plan``, ``tables[inverse]``
    and ``twiddles[inverse]``. A real plan binds its N/2-point axis (the
    packed half-length transform) and, at rank 1, the full-length C2C that
    its spectral consumers run. The executors are bound to these, so they
    decide nothing. Construct via :func:`plan` (LRU-cached on the spec),
    not directly.

    On a sharded mesh a rank-1 plan is ``decomp="pencil"``: it resolves
    the split (``dist_plan``), the batch's data dimension (``daxis``,
    ``dsize``), an ft plan's checksum groups (``groups``), the transaction
    count (``chunks``; whole groups on an ft plan), the per-rank
    collective volume (``volume``, the reference's ``collective_volume``),
    the block_fft launches of one call on a rank (``launches``: ``fft``
    and ``ifft``, a real plan's ``rfft``/``irfft`` under those names, and
    ``ft_fft``; each group an ft call recomputes adds ``pencil.launches``)
    and
    the placements of its operands, and binds the pencil pipeline's
    per-shard steps (``pencil``: stage and twiddle tables on the device;
    ``spectral_pencil``, the full-length one its spectral consumers run,
    which a real plan keeps beside its half-length ``pencil``). A sharded
    rank-2/3 plan resolves ``decomp`` (slab or pencil; a real plan the
    real slab, or the composed pencil path), ``chunks`` (pencil),
    ``volume`` (``multidim.collective_volume_nd``; None on the composed
    real path, which runs 1-D plans), ``launches`` (block_fft launches of
    one ``fft`` and one ``ifft`` call; at rank 2 also of one ``convolve``
    and, on an ft plan, one ``ft_fft``) and binds its axes (``axes``) and,
    for a pencil, its per-rank steps (``grid_pencil``).
    """

    def __init__(self, spec: FFTSpec):
        from repro_torch.kernels import ops  # lazy: ops imports this module

        super().__init__(spec)
        self.rank = spec.rank
        self.tshape = spec.tshape
        self.batch = spec.batch
        self.n = math.prod(self.tshape)
        self.device = planbase.resolve_device(spec.device, "FFTSpec")
        self.decomp = "local"
        self.groups = None
        mesh = distributed._resolve_mesh(spec.mesh, spec.axis)
        self.sharded = (mesh is not None and spec.decomp != "local"
                        and mesh_size(mesh, spec.axis) > 1)
        self.mesh = mesh if self.sharded else None
        self.shards = mesh_size(mesh, spec.axis) if self.sharded else 1
        self.daxis = (distributed._resolve_data_axis(mesh, spec.data_axis)
                      if self.sharded else None)
        self.dsize = mesh_size(mesh, self.daxis) if self.daxis else 1
        if spec.ft is not None and self.sharded:
            # groups are a mesh-path knob; the local fused-kernel path
            # groups by ``transactions`` instead
            self.groups = distributed.resolve_abft_groups(
                self.batch, groups=spec.ft.groups,
                group_size=spec.ft.group_size, data_shards=self.dsize)
        self.chunks = 1
        self.dist_plan = self.volume = self.pencil = None
        self.spectral_pencil = self.grid_pencil = self.launches = None
        self._rdtype = multidim._real_of(spec.torch_dtype)
        self._fwd = self._inv = None      # C2C executors (None: none bound)
        if spec.real:
            self._build_real(ops)
        else:
            self._build_c2c(ops)

    def _axis(self, ops, n: int, batch: int = 1):
        return ops.axis_fft(n, self.spec.torch_dtype, self.device,
                            batch=batch)

    def _bind_c2c(self, ops, ax):
        """Bind ``_fwd``/``_inv`` to the last-axis transform ``ax``."""
        self._fwd, self._inv = (
            functools.partial(ops._fft_impl, plan=ax.plan,
                              tables=ax.tables[inv],
                              twiddles=ax.twiddles[inv], inverse=inv)
            for inv in (False, True))

    def _model_dsize(self) -> int:
        """The data-shard count the pipeline uses: the batch (and an ft
        plan's groups) must divide over the data dimension, else it
        replicates."""
        if self.dsize <= 1 or self.batch % self.dsize:
            return 1
        if self.groups is not None and self.groups % self.dsize:
            return 1
        return self.dsize

    def _resolve_sharded(self, n: int, *, real: bool = False):
        """Resolve the pencil split of an ``n``-point transform (the packed
        half length of a real one): ``dist_plan``, ``chunks`` (auto from
        the modelled all-to-all bytes when 0, ``ft.transactions`` on an ft
        plan, whose transactions carry whole checksum groups), ``volume``
        and the per-shard steps. The real transforms themselves run as one
        transaction: their ``volume`` models one, and ``chunks`` is kept
        for the spectral consumers, as the reference does."""
        spec = self.spec
        ft = spec.ft
        self.decomp = "pencil"
        m = n // 2 if real else n
        self.dist_plan = distributed.make_dist_plan(m, self.shards,
                                                    spec.axis)
        dsz = self._model_dsize()
        kw = dict(itemsize=spec.torch_dtype.itemsize, data_shards=dsz,
                  natural_order=spec.natural_order, real=real,
                  ft=ft is not None, groups=self.groups or 1)
        batch = max(self.batch, 1)
        rows = (self.groups if ft is not None else batch) // dsz
        requested = spec.chunks
        if requested == 0:
            requested = ft.transactions if ft is not None else \
                distributed.choose_chunks(distributed.collective_volume(
                    n, batch, self.shards, **kw)["all_to_all_bytes"], rows)
        self.chunks = distributed.resolve_chunks(rows, max(1, requested)) \
            if rows else 1
        self.volume = distributed.collective_volume(
            n, batch, self.shards, chunks=1 if real else self.chunks, **kw)
        from repro_torch.kernels.stockham import device_key
        key = device_key(self.device)
        self.pencil = distributed.pencil(m, self.shards, spec.torch_dtype,
                                         key)
        self.spectral_pencil = self.pencil if not real else \
            distributed.pencil(n, self.shards, spec.torch_dtype, key)
        per = self.pencil.launches
        calls = per if real else self.chunks * per
        self.launches = {"fft": calls, "ifft": calls}
        if ft is not None:
            # each transaction's pass 1 also launches over its 2G
            # checksum rows
            self.launches["ft_fft"] = self.chunks * (per + 1)

    def _mesh_view(self):
        return distributed._Mesh.of(self.mesh, self.spec.axis, self.daxis)

    def _sharded_c2c(self, x, *, inverse: bool):
        """The pencil pipeline on this rank (``x`` the global (B, N) value
        or a DTensor); a DTensor result."""
        return distributed.sharded(x, self.pencil, self._mesh_view(),
                                   inverse=inverse,
                                   natural_order=self.spec.natural_order,
                                   chunks=self.chunks)

    def _sharded_rfft(self, x):
        """Packed rfft on the mesh: the half-length C2C rides the pencil
        pipeline (natural order), the Hermitian unpack is local on the
        gathered rows."""
        cc = x.shape[-1]
        z = multidim._pack(multidim._replicated(x))
        zf = distributed.sharded(z, self.pencil, self._mesh_view(),
                                 inverse=False, natural_order=True, chunks=1)
        return _with_local(zf, multidim._unpack_half(zf.to_local(), cc))

    def _sharded_irfft(self, y):
        """Packed irfft on the mesh: the local repack, then the
        half-length inverse on the pencil pipeline (natural order, 1/h in
        its first pass); the interleave of each rank's rows is a view."""
        h = y.shape[-1] - 1
        z = multidim._combine(multidim._replicated(y), 2 * h,
                              inverse=True)
        zt = distributed.sharded(z, self.pencil, self._mesh_view(),
                                 inverse=True, natural_order=True, chunks=1)
        loc = zt.to_local()
        return _with_local(zt, torch.view_as_real(loc).reshape(
            loc.shape[:-1] + (2 * h,)))

    def _build_c2c(self, ops):
        if self.rank > 1 and self.sharded:
            self._build_nd(ops)
            return
        if self.rank == 1 and self.sharded:
            self._resolve_sharded(self.tshape[0])
            self._fwd = functools.partial(self._sharded_c2c, inverse=False)
            self._inv = functools.partial(self._sharded_c2c, inverse=True)
            return
        if self.rank == 1:
            n = self.tshape[0]
            ax = self._axis(ops, n, batch=self.batch)
            if ax is None:
                raise ValueError(f"N must be a power of two, got {n}")
            self.axes = (ax,)
            self.local_plan = ax.plan
            self.tables = ax.tables
            self.twiddles = ax.twiddles
            self._bind_c2c(ops, ax)
            return
        self.axes = tuple(self._axis(ops, n) for n in self.tshape)
        self._fwd = functools.partial(multidim._local_fftn, axes=self.axes,
                                      inverse=False)
        self._inv = functools.partial(multidim._local_fftn, axes=self.axes,
                                      inverse=True)

    def _build_real(self, ops):
        """Bind the real executors: rank 1 ``extensions._rfft/_irfft``
        (plus the full-length C2C of the spectral consumers), rank 2
        ``multidim._local_rfft2/_local_irfft2``."""
        cc = self.tshape[-1]
        if self.rank == 2 and self.sharded:
            self._build_nd_real(ops)
            return
        if self.rank == 1 and self.sharded and cc % 2 == 0 \
                and _feasible_1d(cc // 2, self.shards):
            self._resolve_sharded(cc, real=True)
            self.axes = ()
            self._rfwd = self._sharded_rfft
            self._rinv = self._sharded_irfft
            return
        half = self._axis(ops, cc // 2) if cc % 2 == 0 else None
        if self.rank == 1 and self.sharded and _feasible_1d(cc, self.shards):
            # the half length does not split, the spectral consumers' full
            # length does: they run on the mesh, the rfft locally
            from repro_torch.kernels.stockham import device_key
            self.spectral_pencil = distributed.pencil(
                cc, self.shards, self.spec.torch_dtype,
                device_key(self.device))
        if self.rank == 1:
            self.axes = (half,)
            full = self._axis(ops, cc)
            if full is not None:
                self._bind_c2c(ops, full)
            self._rfwd = functools.partial(extensions._rfft, half=half)
            self._rinv = functools.partial(extensions._irfft, half=half,
                                           n=cc)
            return
        rows = self._axis(ops, self.tshape[-2])
        self.axes = (rows, half)
        self._rfwd = functools.partial(multidim._local_rfft2, rows=rows,
                                       half=half)
        self._rinv = functools.partial(multidim._local_irfft2, rows=rows,
                                       half=half, cc=cc)

    def _build_nd(self, ops):
        """Bind the sharded rank-2/3 C2C executors: resolve ``decomp``
        (``choose_decomp`` when ``"auto"``; an ft spec rides the slab),
        raise the reference's errors on an infeasible one, resolve a
        pencil's ``chunks``, and model ``volume``."""
        from repro_torch.kernels.stockham import device_key

        spec = self.spec
        ft = spec.ft
        decomp = spec.decomp
        if decomp == "auto":
            decomp = multidim.choose_decomp(
                self.tshape, self.mesh, batch=self.batch, ft=ft is not None,
                natural_order=spec.natural_order, axis=spec.axis,
                data_axis=spec.data_axis)
        if ft is not None and decomp != multidim.DECOMP_SLAB:
            raise ValueError(
                "grouped ABFT rides the slab inter-axis transpose: an ft "
                f"spec needs decomp='slab' (or 'auto'), got {decomp!r}")
        if decomp == multidim.DECOMP_SLAB \
                and not multidim.slab_feasible(self.tshape, self.shards):
            raise ValueError(
                f"infeasible decomp: slab needs power-of-two axes with "
                f"{self.shards} | {self.tshape[0]} and "
                f"{self.shards} | {self.tshape[-1]}, got {self.tshape} — "
                f"use decomp='pencil' or a smaller fft axis")
        if decomp == multidim.DECOMP_PENCIL and not multidim.pencil_feasible(
                self.tshape, self.shards, self.dsize):
            raise ValueError(
                f"infeasible decomp: pencil needs "
                f"{self.tshape[-1]} >= fft^2={self.shards ** 2} and "
                f"{self.tshape[-2]} >= data^2={self.dsize ** 2} "
                f"(power-of-two axes), got {self.tshape} — use "
                f"decomp='slab' or a smaller mesh")
        self.decomp = decomp
        self.axes = tuple(self._axis(ops, n) for n in self.tshape)
        self._full_axis = self.axes[-1]
        kw = dict(decomp=decomp, itemsize=spec.torch_dtype.itemsize,
                  natural_order=spec.natural_order)
        if decomp == multidim.DECOMP_PENCIL:
            base = multidim.collective_volume_nd(
                self.tshape, max(self.batch, 1), self.shards,
                data_shards=self.dsize, **kw)
            requested = spec.chunks
            if requested == 0:
                requested = distributed.choose_chunks(
                    base["all_to_all_bytes"], self._nd_chunk_rows())
            self.chunks = self._effective_nd_chunks(max(1, requested))
            self.grid_pencil = multidim.grid_pencil(
                self.tshape, self.shards, self.dsize, spec.torch_dtype,
                device_key(self.device))
            if not spec.natural_order:
                self.grid_pencil.check_transposed_in()
            self.launches = {
                "fft": self.grid_pencil.launches(self.chunks),
                "ifft": self.grid_pencil.launches(
                    self.chunks, transposed_in=not spec.natural_order)}
        else:
            n = sum(ax.plan.num_passes for ax in self.axes)
            self.launches = {"fft": n, "ifft": n}
        if self.rank == 2:
            self._rank2_launches()
        self.volume = multidim.collective_volume_nd(
            self.tshape, max(self.batch, 1), self.shards, ft=ft is not None,
            groups=self.groups or 1,
            data_shards=(self._model_dsize()
                         if decomp == multidim.DECOMP_SLAB else self.dsize),
            chunks=self.chunks, **kw)
        self._fwd = functools.partial(self._sharded_nd, inverse=False)
        self._inv = functools.partial(self._sharded_nd, inverse=True)

    def _conv_axes(self):
        """``(axes, rpair)``: the (rows, cols) axes of the mesh convolution's
        round trip and whether it is the packed real pair — a real plan
        whose grid the real slab tiles; else the full-width complex
        pair."""
        rpair = (self.spec.real
                 and multidim.rslab_feasible(self.tshape, self.shards))
        return (self.axes if rpair
                else (self.axes[0], self._full_axis)), rpair

    def _rank2_launches(self) -> None:
        """Add a sharded rank-2 plan's other calls to ``launches``:
        ``convolve``, :func:`multidim.conv2_local` on a rank that holds
        rows of the cropped result (pass 1 of both operands, the R axis
        forward and inverse, the inverse of the columns; a rank the crop
        leaves no rows skips the last), and on an ft plan ``ft_fft``
        (pass 1 of the data grids, pass 1 of the checksum grids, pass 2;
        each group it recomputes adds ``fft``'s count)."""
        rows = self.axes[0].plan.num_passes
        cols = self._conv_axes()[0][1].plan.num_passes
        self.launches["convolve"] = 3 * cols + 2 * rows
        if self.spec.ft is not None:
            self.launches["ft_fft"] = 2 * self.axes[1].plan.num_passes + rows

    def _nd_chunk_rows(self) -> int:
        """The size of the axis pencil transactions split: the batch when
        it has rows, else the first leading transform axis (one rank-3
        grid)."""
        for size in (max(self.batch, 1),) + tuple(self.tshape[:-2]):
            if size > 1:
                return size
        return 1

    def _effective_nd_chunks(self, requested: int) -> int:
        """The first candidate axis (the batch, then the leading transform
        axes) that carries more than one transaction decides the count."""
        for size in (max(self.batch, 1),) + tuple(self.tshape[:-2]):
            ce = distributed.resolve_chunks(size, requested)
            if ce > 1:
                return ce
        return 1

    def _sharded_nd(self, x, *, inverse: bool):
        """The slab or pencil pipeline on this rank; a DTensor result."""
        m = self._mesh_view()
        if self.decomp == multidim.DECOMP_SLAB:
            out = multidim.slab_local(x, self.axes, m, inverse=inverse)
        else:
            out = multidim.pencil_local(
                x, self.grid_pencil, m, inverse=inverse,
                natural_order=self.spec.natural_order, chunks=self.chunks)
        return multidim._as_dtensor(out, m)

    def _build_nd_real(self, ops):
        """Bind the sharded rank-2 real executors: the real slab when the
        grid tiles (``rslab_feasible``; ``"auto"`` picks it), else — or
        with ``decomp="pencil"`` — the composed path, the 1-D mesh rfft
        over the columns and the 1-D mesh transform over the rows."""
        spec = self.spec
        ft = spec.ft
        cc = self.tshape[-1]
        decomp = spec.decomp
        feasible = multidim.rslab_feasible(self.tshape, self.shards)
        if decomp == "auto":
            decomp = (multidim.DECOMP_SLAB if feasible
                      else multidim.DECOMP_PENCIL)
        if ft is not None and decomp != multidim.DECOMP_SLAB:
            raise ValueError(
                "grouped ABFT rides the slab inter-axis transpose: an ft "
                f"real spec needs decomp='slab' (or 'auto'), got {decomp!r}")
        if decomp == multidim.DECOMP_SLAB and not feasible:
            raise ValueError(
                f"infeasible decomp: the real slab needs power-of-two axes "
                f"with {self.shards} | {self.tshape[0]} and "
                f"{self.shards} | {self.tshape[-1]}//2, got {self.tshape} — "
                f"use decomp='pencil' (the composed real path) or a smaller "
                f"fft axis")
        self.decomp = decomp
        rows = self._axis(ops, self.tshape[0])
        half = self._axis(ops, cc // 2) if cc % 2 == 0 else None
        self.axes = (rows, half)
        self._full_axis = self._axis(ops, cc)
        if decomp == multidim.DECOMP_SLAB:
            self.volume = multidim.collective_volume_nd(
                self.tshape, max(self.batch, 1), self.shards, decomp=decomp,
                itemsize=spec.torch_dtype.itemsize, ft=ft is not None,
                groups=self.groups or 1, data_shards=self._model_dsize(),
                natural_order=True, real=True)
            n = rows.plan.num_passes + half.plan.num_passes
            self.launches = {"fft": n, "ifft": n}
            self._rank2_launches()
            self._rfwd = functools.partial(self._sharded_rslab,
                                           inverse=False)
            self._rinv = functools.partial(self._sharded_rslab, inverse=True)
            return
        kw = dict(mesh=self.mesh, axis=spec.axis, device=str(self.device))
        self._rfwd = functools.partial(multidim._composed_rfft2,
                                       rows_ax=rows, **kw)
        self._rinv = functools.partial(multidim._composed_irfft2,
                                       rows_ax=rows, cc=cc, **kw)

    def _sharded_rslab(self, x, *, inverse: bool):
        m = self._mesh_view()
        return multidim._as_dtensor(multidim.rslab_local(
            x, *self.axes, m, inverse=inverse, cc=self.tshape[-1]), m)

    def _coerce(self, x):
        """Match the plan's dtype and device: a C2C plan coerces real
        inputs to its complex dtype (the legacy contract); a real plan
        REJECTS complex operands and casts to its real precision."""
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        if self.spec.real:
            if x.is_complex():
                raise ValueError(
                    f"a real plan takes a real operand, got {x.dtype} — "
                    f"build a C2C FFTSpec (real=False) for complex signals")
            dtype = self._rdtype
        else:
            dtype = self.spec.torch_dtype
        if _is_dtensor(x):
            if x.device.type != self.device.type:
                raise ValueError(f"the operand lives on {x.device.type}, "
                                 f"the plan on {self.device.type}")
            return x if x.dtype == dtype else x.to(dtype)
        return x.to(device=self.device, dtype=dtype)

    def _check_tshape(self, x):
        if tuple(x.shape[-self.rank:]) != self.tshape:
            raise ValueError(
                f"operand transform axes {tuple(x.shape[-self.rank:])} do "
                f"not match the planned {self.tshape} — build a new "
                f"FFTSpec (plans are shape-specialized, like cufftPlanMany)")
        if self.decomp != "local" and tuple(x.shape) != self.spec.shape:
            raise ValueError(
                f"operand shape {tuple(x.shape)} does not match the "
                f"sharded plan's {self.spec.shape} — build a new FFTSpec")

    def _run(self, fn, x):
        """``fn`` on ``x``: straight on a tensor and on a sharded plan; a
        local plan takes a DTensor's local rows and keeps its placements."""
        if _is_dtensor(x) and self.decomp == "local":
            return _on_local(fn, x)
        return fn(x)

    def shard(self, x):
        """Place ``x`` into the plan's input layout (a no-op on an
        unsharded plan): :func:`~repro_torch.parallel.fft_sharding
        .shard_signals`, a contiguous block of N on each ``fft`` rank."""
        x = self._coerce(x)
        if self.decomp == "local" or (self.rank > 1 and self.spec.real
                                      and self.decomp != "slab"):
            return x
        from repro_torch.parallel.fft_sharding import shard_grid, shard_signals
        if self.rank == 1:
            return shard_signals(x, self.mesh, self.spec.axis,
                                 data_axis=self.daxis)
        return shard_grid(x, self.mesh, self.rank, decomp=self.decomp,
                          axis=self.spec.axis, data_axis=self.daxis)

    def _c2c_only(self):
        if self.spec.real:
            raise ValueError(
                "this plan is real-input — its executors are rfft/irfft "
                "(rfft2/irfft2); build a C2C FFTSpec (real=False) for "
                "fft/ifft")

    def _real_only(self):
        if not self.spec.real:
            raise ValueError(
                "this plan is C2C — build the FFTSpec with real=True for "
                "rfft/irfft")

    def fft(self, x):
        """Forward transform over the planned axes (complex in/out)."""
        self._c2c_only()
        x = self._coerce(x)
        self._check_tshape(x)
        return self._run(self._fwd, x)

    def ifft(self, x):
        """Inverse transform (1/N normalized, N the product of the planned
        axes); a sharded transposed-order plan consumes the forward's
        transposed-digit output (TRANSPOSED_IN)."""
        self._c2c_only()
        x = self._coerce(x)
        self._check_tshape(x)
        return self._run(self._inv, x)

    # rank-2/3 spellings (same executors; the rank lives in the spec)
    def fft2(self, x):
        if self.rank < 2:
            raise ValueError("fft2 needs a rank>=2 FFTSpec")
        return self.fft(x)

    def ifft2(self, x):
        if self.rank < 2:
            raise ValueError("ifft2 needs a rank>=2 FFTSpec")
        return self.ifft(x)

    fftn = fft2
    ifftn = ifft2

    def rfft(self, x):
        """Real-input forward transform -> the ``(..., N/2+1)``-bin half
        spectrum (rank 1) or ``(..., R, C/2+1)`` (rank 2). Requires a real
        plan; complex operands are rejected, not silently truncated."""
        self._real_only()
        x = self._coerce(x)
        self._check_tshape(x)
        return self._run(self._rfwd, x)

    def irfft(self, y):
        """Inverse of :meth:`rfft`: half spectrum -> the planned real
        shape. The spectrum's transform axes must be the planned shape's
        Hermitian half (``last axis -> n//2 + 1`` bins)."""
        self._real_only()
        y = y if isinstance(y, torch.Tensor) else torch.as_tensor(y)
        want = self.tshape[:-1] + (self.tshape[-1] // 2 + 1,)
        if tuple(y.shape[-self.rank:]) != want:
            raise ValueError(
                f"half-spectrum axes {tuple(y.shape[-self.rank:])} do not "
                f"match the planned {want} (the Hermitian half of "
                f"{self.tshape}) — build a new FFTSpec")
        dtype = self.spec.torch_dtype
        if not _is_dtensor(y):
            y = y.to(device=self.device, dtype=dtype)
        elif y.dtype != dtype:
            y = y.to(dtype)
        return self._run(self._rinv, y)

    # rank-2 spellings (same executors; the rank lives in the spec)
    def rfft2(self, x):
        if self.rank != 2:
            raise ValueError("rfft2 needs a rank-2 FFTSpec")
        return self.rfft(x)

    def irfft2(self, y):
        if self.rank != 2:
            raise ValueError("irfft2 needs a rank-2 FFTSpec")
        return self.irfft(y)

    def ft_fft(self, x, *, inject=None, bs=None):
        """Fault-tolerant forward transform (requires ``spec.ft``). On a
        mesh: the sharded grouped two-side ABFT (:class:`~repro_torch.core
        .fft.distributed.DistFFTResult`; ``inject`` its 7-field rows), the
        1-D pencil's or, at rank 2, the slab's (C2C, or real on a real
        spec: ``y`` the half spectrum). Locally (rank 1): the fused ABFT
        kernel pipeline (:class:`~repro_torch.kernels.ops.FTFFTResult`;
        ``inject`` the kernel's 6-field descriptor, ``bs`` its per-call
        tile-size override)."""
        ft = self.spec.ft
        if ft is None:
            raise ValueError("this plan has no FTConfig — set FFTSpec.ft")
        x = self._coerce(x)
        self._check_tshape(x)
        b = math.prod(x.shape[:-self.rank])
        if b != self.batch:
            raise ValueError(
                f"operand batch {b} does not match the planned {self.batch} "
                f"— the ABFT group layout (G={self.groups}) was resolved "
                f"for the spec's batch; build a new FFTSpec")
        if self.rank == 2:
            if x.dim() != 3:
                raise ValueError(
                    f"ft_distributed_{'r' if self.spec.real else ''}fft2 "
                    f"expects (B, R, C), got {tuple(x.shape)}")
            return multidim.ft_sharded2(
                x, self.axes, self._mesh_view(), groups=self.groups,
                threshold=float(ft.threshold), correct=bool(ft.correct),
                inject=distributed._inject_rows(inject, self.spec.torch_dtype,
                                                self.device),
                recompute=bool(ft.recompute_uncorrectable),
                real=self.spec.real)
        if self.decomp == "pencil":
            return distributed.ft_sharded(
                x, self.pencil, self._mesh_view(), groups=self.groups,
                threshold=float(ft.threshold), correct=bool(ft.correct),
                natural_order=self.spec.natural_order, chunks=self.chunks,
                inject=distributed._inject_rows(inject, x.dtype,
                                                self.device),
                recompute=bool(ft.recompute_uncorrectable))
        from repro_torch.kernels import ops as _ops
        return _ops._ft_fft_local(
            x.reshape(b, self.n), self.local_plan, self.tables[False][0],
            transactions=ft.transactions, bs=bs,
            per_signal=ft.per_signal, encoding=ft.encoding,
            threshold=ft.threshold, correct=ft.correct, inject=inject)

    # -- spectral consumers ----------------------------------------------

    def _operands(self, a, v):
        """``a`` and ``v`` on the plan's device, in its real precision when
        both are real (the packed path) and its complex one otherwise;
        and whether they are both real. On a mesh a DTensor operand is
        replicated first: the round trip reads global rows."""
        a, v = (multidim._replicated(t) if _is_dtensor(t)
                else torch.as_tensor(t) for t in (a, v))
        _, real = spectral._result_dtypes(a, v)
        if not real and self.spec.real:
            raise ValueError(
                f"a real plan takes real operands, got {a.dtype} and "
                f"{v.dtype} — build the spec with spectral.conv_spec")
        dt = self._rdtype if real else self.spec.torch_dtype
        return (a.to(device=self.device, dtype=dt),
                v.to(device=self.device, dtype=dt), real)

    def convolve(self, a, v, *, mode: str = "full"):
        """Linear convolution at the planned transform size: 1-D through
        the spectral pair (padded to the plan's N; on a mesh the
        transposed round trip), 2-D through the round trip over the
        planned (nr, nc) grid. The planned size(s) must be the padded FFT
        size of the operands (``spectral.conv_spec``,
        ``multidim.fft_convolve2``)."""
        if self.rank == 1:
            return self._spectral_pair(a, v, conj_kernel=False, mode=mode)
        if self.rank == 2:
            a, v, real = self._operands(a, v)
            if a.dim() < 2 or v.dim() < 2:
                raise ValueError("fft_convolve2 needs 2-D operands")
            grid = multidim._conv2_shape(a.shape[-2:], v.shape[-2:],
                                         self.shards)
            if grid != self.tshape:
                raise ValueError(
                    f"operand grids {tuple(a.shape[-2:])} and "
                    f"{tuple(v.shape[-2:])} need a {grid} plan, but this "
                    f"plan is for {self.tshape} — build the spec with "
                    f"multidim.fft_convolve2")
            if self.sharded:
                return self._sharded_convolve2(a, v, real, mode)
            if real and not self.spec.real:
                a, v = a.to(self.spec.torch_dtype), v.to(self.spec.torch_dtype)
            out = multidim._convolve2(a, v, mode=mode, axes=self.axes,
                                      real=self.spec.real)
            return out.real if real and out.is_complex() else out
        raise ValueError("convolve supports rank 1 and 2 plans")

    def _sharded_convolve2(self, a, v, real: bool, mode: str):
        """The slab round trip of :func:`multidim.conv2_local` on this rank:
        the packed real pair when both operands are real on a real plan
        whose grid the real slab tiles, else the complex pair; a DTensor
        result."""
        if v.dim() == 3 and v.shape[0] not in (1, a.shape[0] if a.dim() == 3
                                                else 1):
            raise ValueError(
                f"kernel batch must be 1 or match the signal batch "
                f"({a.shape[0] if a.dim() == 3 else 1}), got {v.shape[0]}")
        nr, nc = self.tshape
        axes, rpair = self._conv_axes()       # a real plan's operands are real
        if not rpair:
            a, v = a.to(self.spec.torch_dtype), v.to(self.spec.torch_dtype)
        m = self._mesh_view()
        local, spec, shape = multidim.conv2_local(
            multidim._pad2(a, nr, nc), multidim._pad2(v, nr, nc), axes, m,
            sa=tuple(a.shape[-2:]), sv=tuple(v.shape[-2:]), mode=mode,
            real=rpair)
        if real and local.is_complex():
            local = local.real.contiguous()
        return distributed._dtensor(local, spec, m, shape)

    def correlate(self, a, v, *, mode: str = "full"):
        """Cross-correlation (``np.correlate`` conventions), rank-1 only."""
        if self.rank != 1:
            raise ValueError("correlate is 1-D only")
        return self._spectral_pair(a, v, conj_kernel=True, mode=mode)

    def _spectral_pair(self, a, v, *, conj_kernel: bool, mode: str):
        a, v, real = self._operands(a, v)
        la, lv = a.shape[-1], v.shape[-1]
        nfft = spectral._conv_nfft(la, lv, self.shards)
        if nfft != self.tshape[0]:
            raise ValueError(
                f"operand lengths ({la}, {lv}) need an nfft={nfft} plan, "
                f"but this plan is for {self.tshape[0]} — build the spec "
                f"with spectral.conv_spec / fft_convolve")
        out_len = nfft if conj_kernel else la + lv - 1
        a, v = spectral._pad_tail(a, nfft), spectral._pad_tail(v, nfft)
        on_mesh = self.spectral_pencil is not None
        if on_mesh:
            full, like = spectral._on_mesh(
                a, v, self.spectral_pencil, self._mesh_view(),
                conj_kernel=conj_kernel, real=real, out_len=out_len,
                chunks=self.chunks)
        else:
            pair = spectral._spectral_real if real \
                else spectral._spectral_pair
            full = pair(a, v, conj_kernel=conj_kernel, out_len=out_len,
                        fwd=self._fwd, inv=self._inv)
        if conj_kernel:
            full = torch.roll(full, lv - 1, dims=-1)[..., :la + lv - 1]
        out = spectral._crop(full, la, lv, mode)
        return like(out) if on_mesh else out

    def power_spectrum(self, x):
        """Periodogram ``|X|^2 / N`` over the planned axes; on a sharded
        transposed-order plan the bins stay in the transposed digit order
        (one all-to-all, no all-gather). A real plan returns the one-sided
        ``N/2+1``-bin spectrum via the packed rfft (natural order)."""
        if self.spec.real:
            y = self.rfft(x)
        else:
            x = self._coerce(x)
            self._check_tshape(x)
            y = self._fwd(x)
        if _is_dtensor(y):
            from torch.distributed.tensor import DTensor

            return DTensor.from_local(
                y.to_local().abs().square_().div_(self.n), y.device_mesh,
                y.placements, run_check=False, shape=y.shape,
                stride=y.stride())
        return y.abs().square_().div_(self.n)

    def __repr__(self):
        s = self.spec
        return (f"FFTPlan(shape={s.shape}, dtype={s.dtype}, rank={s.rank}, "
                f"real={s.real}, decomp={self.decomp!r}, "
                f"shards={self.shards}, chunks={self.chunks}, "
                f"device={str(self.device)!r}, ft={s.ft is not None})")


def _with_local(like, local: torch.Tensor):
    """A DTensor of ``local`` with ``like``'s mesh and placements (its
    global shape from ``like``'s leading dims and ``local``'s last)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(like.shape[:-1]) + (local.shape[-1],)
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.Size(
                                  distributed._contiguous_strides(shape)))


def plan(spec: FFTSpec) -> FFTPlan:
    """Build (or fetch from the shared plan-layer LRU cache) the
    :class:`FFTPlan` for ``spec``. Equal specs return the SAME plan object."""
    if not isinstance(spec, FFTSpec):
        raise TypeError(f"plan() takes an FFTSpec, got "
                        f"{type(spec).__name__}")
    return planbase.plan(spec)


plan_cache_info = planbase.plan_cache_info
plan_cache_clear = planbase.plan_cache_clear
plan_cache_keys = planbase.plan_cache_keys
