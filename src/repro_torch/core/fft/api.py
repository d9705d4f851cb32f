"""cuFFT-style plan/execute API: one :class:`FFTSpec` -> a cached
:class:`FFTPlan` executor.

An :class:`FFTSpec` is a frozen, hashable description of a transform (shape,
dtype, rank, fault-tolerance config, device); :func:`plan` resolves it ONCE —
the local stage plan and its stage tables uploaded to the device — and hands
back an :class:`FFTPlan` whose executors (``plan.fft / ifft / ft_fft``) run
``kernels.ops`` on that stage plan and those tables. This is the local
rank-1 complex subset of ``repro.core.fft.api``; the other paths raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core import plan as planbase
from repro_torch.core.plan import FTConfig

from .plan import make_plan

__all__ = ["FFTSpec", "FTConfig", "FFTPlan", "plan", "spec_for",
           "plan_cache_info", "plan_cache_clear", "plan_cache_keys"]

_COMPLEX_DTYPES = {"complex64": torch.complex64,
                   "complex128": torch.complex128}


@dataclasses.dataclass(frozen=True)
class FFTSpec:
    """Frozen, hashable description of one batched FFT workload.

    ``shape`` is the full operand shape — leading batch dims plus the last
    ``rank`` transform axes. ``dtype`` must be a complex dtype (executors
    coerce real inputs). ``ft`` attaches an :class:`FTConfig`. ``device`` is
    where the plan runs: ``"cuda"`` (the kernels) by default, ``"cpu"`` for
    the kernels' plain versions. Specs are value objects: equal specs hash
    equal and hit the same cached :class:`FFTPlan`.

    This slice runs rank 1, complex, unsharded transforms: ``rank`` other
    than 1, ``real=True`` and ``mesh`` raise ``NotImplementedError``.
    """

    shape: tuple[int, ...]
    dtype: str = "complex64"
    rank: int = 1
    mesh: object | None = None
    ft: FTConfig | None = None
    real: bool = False
    device: str = "cuda"

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
        if self.mesh is not None:
            raise NotImplementedError(
                "sharded transforms (FFTSpec.mesh) are not ported yet: "
                "ROADMAP queue 1 item 10 (sharded FFT on torch.distributed)")
        if self.real:
            raise NotImplementedError(
                "real-input transforms are not ported yet: ROADMAP queue 1 "
                "item 8 (local extensions)")
        if self.rank != 1:
            raise NotImplementedError(
                f"rank-{self.rank} transforms are not ported yet: ROADMAP "
                f"queue 1 item 8 (local extensions)")

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


def spec_for(x, *, rank: int = 1, ft: FTConfig | None = None,
             device="cuda") -> FFTSpec:
    """Build the :class:`FFTSpec` describing ``x``'s transform on
    ``device``; real dtypes map to ``complex64``."""
    x = torch.as_tensor(x)
    dt = x.dtype if x.is_complex() else torch.complex64
    return FFTSpec(shape=tuple(x.shape), dtype=planbase.dtype_name(dt),
                   rank=rank, ft=ft, device=str(device))


@planbase.register_plan_type(FFTSpec)
class FFTPlan(planbase.Plan):
    """Pre-resolved executor bundle for one :class:`FFTSpec`.

    The constructor resolves the device, the local stage plan, the stage
    tables of every pass and the pass twiddle tables of every pass but the
    last, in each direction (uploaded to the device once, kept here:
    ``tables[inverse][i]`` and ``twiddles[inverse][i]`` for pass i), and
    binds the executors to them, so the executors decide nothing. Construct
    via :func:`plan` (LRU-cached on the spec), not directly.
    """

    def __init__(self, spec: FFTSpec):
        from repro_torch.kernels import ops as _ops  # lazy: ops imports this
        from repro_torch.kernels.stockham import (pass_twiddle_table,
                                                  stage_tables)

        super().__init__(spec)
        self.rank = spec.rank
        self.tshape = spec.tshape
        self.batch = spec.batch
        self.n = math.prod(self.tshape)
        self.device = planbase.resolve_device(spec.device, "FFTSpec")
        self.decomp = "local"
        self.groups = None
        n = self.tshape[0]
        self.local_plan = make_plan(n, batch=self.batch)
        dtype = spec.torch_dtype
        self.tables = {
            inverse: tuple(stage_tables(st, dtype, inverse=inverse,
                                        device=self.device)
                           for st in self.local_plan.stages)
            for inverse in (False, True)
        }
        facs = self.local_plan.kernel_factors
        self.twiddles = {
            inverse: tuple(pass_twiddle_table(math.prod(facs[i:]), dtype,
                                              inverse=inverse,
                                              device=self.device)
                           for i in range(len(facs) - 1))
            for inverse in (False, True)
        }
        self._fwd = functools.partial(_ops._fft_impl, plan=self.local_plan,
                                      tables=self.tables[False],
                                      twiddles=self.twiddles[False],
                                      inverse=False)
        self._inv = functools.partial(_ops._fft_impl, plan=self.local_plan,
                                      tables=self.tables[True],
                                      twiddles=self.twiddles[True],
                                      inverse=True)

    def _coerce(self, x):
        """Match the plan's complex dtype and device (real inputs are
        coerced, the legacy contract)."""
        x = torch.as_tensor(x)
        return x.to(device=self.device, dtype=self.spec.torch_dtype)

    def _check_tshape(self, x):
        if tuple(x.shape[-self.rank:]) != self.tshape:
            raise ValueError(
                f"operand transform axes {tuple(x.shape[-self.rank:])} do "
                f"not match the planned {self.tshape} — build a new "
                f"FFTSpec (plans are shape-specialized, like cufftPlanMany)")

    def fft(self, x):
        """Forward transform over the planned axis (complex in/out)."""
        x = self._coerce(x)
        self._check_tshape(x)
        return self._fwd(x)

    def ifft(self, x):
        """Inverse transform (1/N normalized)."""
        x = self._coerce(x)
        self._check_tshape(x)
        return self._inv(x)

    def ft_fft(self, x, *, inject=None, bs=None):
        """Fault-tolerant forward transform (requires ``spec.ft``): the fused
        ABFT kernel pipeline (:class:`~repro_torch.kernels.ops.FTFFTResult`);
        ``bs`` is its per-call tile-size override."""
        ft = self.spec.ft
        if ft is None:
            raise ValueError("this plan has no FTConfig — set FFTSpec.ft")
        x = self._coerce(x)
        self._check_tshape(x)
        b = math.prod(x.shape[:-self.rank])
        if b != self.batch:
            raise ValueError(
                f"operand batch {b} does not match the planned {self.batch} "
                f"— build a new FFTSpec")
        from repro_torch.kernels import ops as _ops
        return _ops._ft_fft_local(
            x.reshape(b, self.n), self.local_plan, self.tables[False][0],
            transactions=ft.transactions, bs=bs,
            per_signal=ft.per_signal, encoding=ft.encoding,
            threshold=ft.threshold, correct=ft.correct, inject=inject)

    def __repr__(self):
        s = self.spec
        return (f"FFTPlan(shape={s.shape}, dtype={s.dtype}, rank={s.rank}, "
                f"decomp={self.decomp!r}, device={str(self.device)!r}, "
                f"ft={s.ft is not None})")


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
