"""Public entry points over the CUDA kernels.

* :func:`fft` / :func:`ifft` — batched FFT over the last axis; single-pass
  sizes run one block-FFT launch, larger sizes the paper's kernel-level
  N1xN2(xN3) passes, each pass exactly one launch that reads its signals
  strided, applies the pass twiddle on the way out and (the last pass)
  writes the output transposed, with no torch operation on the data
  between launches. The inverse is scaled by 1/N exactly once, in the
  first pass's launch.
* :func:`fft2` / :func:`ifft2` — the 2-D transform over the last two axes
  (a rank-2 plan). Each power-of-two axis of up to 8192 points that is not
  the last is ONE block-FFT launch that reads and writes its strided
  columns in place (:func:`_fft_axis`, ``core.fft.plan.axis_layout``).
* :func:`ft_fft` — the full TurboFFT pipeline: fused two-sided-ABFT kernel ->
  detect -> locate -> delayed batched correction. Returns an
  :class:`FTFFTResult` with the corrected outputs and the FT telemetry.

The entry points build (or LRU-hit) the :class:`~repro_torch.core.fft.api
.FFTPlan` for the operand and run its executor on the spec's device
(``"cuda"`` by default; ``device="cpu"`` runs the kernels' plain versions).
A ``DTensor`` operand on a mesh with an ``fft`` dimension of more than one
rank plans the sharded transform (``core.fft.distributed``), the
reference's auto-dispatch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.abft import twoside
from repro_torch.core.fft import api as fft_api
from repro_torch.core.fft.multidim import _is_pow2
from repro_torch.core.fft.plan import (MAX_BLOCK_N, Plan, StagePlan,
                                       axis_layout, make_plan, pass_layouts)

from .stockham import block_fft, pass_twiddle_table, stage_tables
from .stockham_abft import abft_fft

__all__ = ["fft", "ifft", "fft2", "ifft2", "ft_fft", "FTFFTResult",
           "AxisFFT", "axis_fft"]


def _pad_batch(x: torch.Tensor, bs: int):
    b = x.shape[0]
    pad = (-b) % bs
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, b


def _block_fft_c(x2d: torch.Tensor, stages: Sequence[StagePlan],
                 tables: torch.Tensor, *, inverse: bool,
                 scale: float = 1.0,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Single-pass complex block FFT, (B, N) -> (B, N), times ``scale``,
    into ``out`` (which may be ``x2d``; new when omitted). The kernel's grid
    covers any batch, so no padding to a tile size is needed."""
    return block_fft(x2d.contiguous(), stages, inverse=inverse, scale=scale,
                     tables=tables, out=out)


def _fft_multipass(x2d: torch.Tensor, plan: Plan,
                   tables: Sequence[torch.Tensor],
                   twiddles: Sequence[torch.Tensor], *, inverse: bool,
                   scale: float = 1.0,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel-level N1 x N2 (x N3) composition (paper Fig. 3): pass i is one
    block-FFT launch through ``plan.stages[i]`` in the layout
    :func:`~repro_torch.core.fft.plan.pass_layouts` gives it, times the
    pass twiddle ``twiddles[i]`` (all but the last pass). The first pass
    reads ``x2d`` into a scratch buffer, the middle one (3 passes) works in
    place there, the last writes the transposed output into ``out`` (new
    when omitted; it may be ``x2d``, which the first pass has read whole).
    ``scale`` rides the first pass's launch only."""
    layouts = pass_layouts(x2d.shape[0], plan.kernel_factors)
    scratch = torch.empty_like(x2d)
    y = torch.empty_like(x2d) if out is None else out
    src = x2d
    for i, layout in enumerate(layouts):
        last = i == len(layouts) - 1
        dst = y if last else scratch
        block_fft(src, plan.stages[i], inverse=inverse,
                  scale=scale if i == 0 else 1.0, tables=tables[i],
                  layout=layout, twiddle=None if last else twiddles[i],
                  out=dst)
        src = dst
    return y


def _fft_impl(x: torch.Tensor, plan: Plan, tables: Sequence[torch.Tensor],
              twiddles: Sequence[torch.Tensor] = (), *,
              inverse: bool = False, scale: float | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Run ``plan`` (the FFT plan's local stage plan) with ``tables``, its
    per-pass stage tables in this direction, and ``twiddles``, its pass
    twiddle tables (one per pass but the last), over the last axis of
    ``x``, times ``scale`` (1/N on the inverse when omitted), into ``out``
    (a contiguous tensor of ``x``'s shape, which may be ``x``; new when
    omitted)."""
    shape = x.shape
    x2d = x.reshape(-1, plan.n).contiguous()
    out2d = None if out is None else out.view(-1, plan.n)
    if scale is None:
        scale = 1.0 / plan.n if inverse else 1.0
    if plan.num_passes == 1:
        y = _block_fft_c(x2d, plan.stages[0], tables[0], inverse=inverse,
                         scale=scale, out=out2d)
    else:
        y = _fft_multipass(x2d, plan, tables, twiddles, inverse=inverse,
                           scale=scale, out=out2d)
    return y.reshape(shape)


@dataclasses.dataclass(frozen=True, eq=False)
class AxisFFT:
    """One power-of-two transform axis as a plan binds it: its local stage
    plan, and per direction (``tables[inverse]``, ``twiddles[inverse]``)
    the stage tables of every pass and the pass twiddles of every pass but
    the last, on the plan's device."""

    plan: Plan
    tables: dict
    twiddles: dict


def axis_fft(n: int, dtype: torch.dtype, device, *, batch: int = 1,
             plan: Plan | None = None) -> AxisFFT | None:
    """Upload the stage and pass-twiddle tables of an ``n``-point axis to
    ``device`` (each table once per process: they are cached by stages,
    dtype, direction and device) and bundle them with ``plan``, by default
    the stage plan of ``make_plan(n, batch)``. ``None`` when ``n`` is not
    a power of two: such an axis runs the direct DFT."""
    if not _is_pow2(n):
        return None
    p = make_plan(n, batch=batch) if plan is None else plan
    facs = p.kernel_factors
    return AxisFFT(
        plan=p,
        tables={inv: tuple(stage_tables(st, dtype, inverse=inv,
                                        device=device) for st in p.stages)
                for inv in (False, True)},
        twiddles={inv: tuple(pass_twiddle_table(math.prod(facs[i:]), dtype,
                                                inverse=inv, device=device)
                             for i in range(len(facs) - 1))
                  for inv in (False, True)})


def _fft_axis(x: torch.Tensor, axis: int, plan: Plan,
              tables: Sequence[torch.Tensor],
              twiddles: Sequence[torch.Tensor] = (), *,
              inverse: bool = False, scale: float | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """The transform along ``axis`` of the contiguous ``x`` through ``plan``
    (its per-pass ``tables`` and ``twiddles`` in this direction), times
    ``scale`` (1/N on the inverse when omitted), into ``out`` (a contiguous
    tensor like ``x``, which may be ``x`` itself; new when omitted).

    The last axis is :func:`_fft_impl`. Any other axis of up to
    ``MAX_BLOCK_N`` points is ONE block-FFT launch through
    :func:`~repro_torch.core.fft.plan.axis_layout`: its columns are read
    strided and written back through the same strides, with no copy of the
    operand. A longer non-last axis is moved last (one copy), transformed
    by :func:`_fft_impl` and moved back (a second copy)."""
    axis %= x.dim()
    n = x.shape[axis]
    if n != plan.n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} has {n} points, "
                         f"the plan {plan.n}")
    if scale is None:
        scale = 1.0 / n if inverse else 1.0
    if axis == x.dim() - 1:
        return _fft_impl(x, plan, tables, twiddles, inverse=inverse,
                         scale=scale, out=out)
    if plan.num_passes == 1:
        layout = axis_layout(math.prod(x.shape[:axis]), n,
                             math.prod(x.shape[axis + 1:]))
        return block_fft(x.contiguous(), plan.stages[0], inverse=inverse,
                         scale=scale, tables=tables[0], layout=layout,
                         twiddle=None, out=out)
    y = _fft_impl(x.movedim(axis, -1).contiguous(), plan, tables, twiddles,
                  inverse=inverse, scale=scale).movedim(-1, axis)
    if out is None:
        return y.contiguous()
    return out.copy_(y)


def _as_complex(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    if not x.is_complex():
        x = x.to(torch.complex64)
    return x


def fft(x, *, device="cuda") -> torch.Tensor:
    """TurboFFT forward transform over the last axis (complex in/out), on
    ``device``: builds (or LRU-hits) the plan for the operand and runs it
    (sharded when ``x`` is a DTensor laid out over an ``fft`` mesh)."""
    x = _as_complex(x)
    return fft_api.plan(fft_api.spec_for(x, rank=1, device=device)).fft(x)


def ifft(x, *, device="cuda") -> torch.Tensor:
    """Inverse transform over the last axis (1/N normalized)."""
    x = _as_complex(x)
    return fft_api.plan(fft_api.spec_for(x, rank=1, device=device)).ifft(x)


def fft2(x, *, device="cuda") -> torch.Tensor:
    """2-D forward transform over the last two axes (complex in/out; real
    inputs are coerced to complex64), on ``device``: a rank-2 plan. Odd and
    other non-power-of-two axes run the direct DFT."""
    x = _as_complex(x)
    return fft_api.plan(fft_api.spec_for(x, rank=2, device=device)).fft(x)


def ifft2(x, *, device="cuda") -> torch.Tensor:
    """Inverse of :func:`fft2` (normalized by 1/(R*C))."""
    x = _as_complex(x)
    return fft_api.plan(fft_api.spec_for(x, rank=2, device=device)).ifft(x)


# ---------------------------------------------------------------------------
# Fault-tolerant FFT (the paper's co-design)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FTFFTResult:
    """Outputs + fault-tolerance telemetry of one ft_fft call."""

    y: torch.Tensor              # (B, N) corrected outputs
    delta: torch.Tensor          # (B,) per-signal left-checksum divergence
    group_score: torch.Tensor    # (G,) right-checksum divergence per group
    flagged: torch.Tensor        # (G,) bool — group detected an error
    location: torch.Tensor       # (G,) int32 — decoded corrupted signal id
    corrected: torch.Tensor      # scalar — number of corrections applied


def ft_fft(x, *, transactions: int = 4, bs: int | None = None,
           per_signal: bool = False, encoding: str = "wang",
           threshold: float = 1e-4, correct: bool = True, inject=None,
           groups: int | None = None, group_size: int | None = None,
           natural_order: bool = True,
           recompute_uncorrectable: bool = False, device="cuda"):
    """Fault-tolerant forward FFT with online detection and correction.

    ``per_signal=False`` is the threadblock/multi-transaction scheme of the
    paper (detection via group checksums, location via the e3 encoding);
    ``per_signal=True`` additionally computes thread-level per-signal
    checksums. Locally ``inject`` is the fused kernel's 6-field SEU
    descriptor and the result an :class:`FTFFTResult`.

    A ``DTensor`` on a mesh with an ``fft`` dimension of more than one
    rank (``parallel.shard_signals``) runs the sharded grouped two-side
    ABFT (``core.fft.distributed.ft_distributed_fft``) and returns its
    ``DistFFTResult``: ``groups``/``group_size`` pick the checksum groups
    (auto: one a data shard), ``natural_order=False`` keeps the
    transposed digit order, ``recompute_uncorrectable`` reruns multi-fault
    groups, and ``inject`` takes the 7-field rows. Locally those knobs
    are no-ops and ``transactions`` groups instead.
    """
    x = _as_complex(x)
    ft = fft_api.FTConfig(threshold=threshold, correct=correct,
                          groups=groups, group_size=group_size,
                          recompute_uncorrectable=recompute_uncorrectable,
                          transactions=transactions, per_signal=per_signal,
                          encoding=encoding)
    spec = fft_api.spec_for(x, rank=1, ft=ft, natural_order=natural_order,
                            device=device)
    return fft_api.plan(spec).ft_fft(x, inject=inject, bs=bs)


def _ft_fft_local(
    x: torch.Tensor,
    plan: Plan,
    tables: torch.Tensor,
    *,
    transactions: int = 4,
    bs: int | None = None,
    per_signal: bool = False,
    encoding: str = "wang",
    threshold: float = 1e-4,
    correct: bool = True,
    inject=None,
) -> FTFFTResult:
    """The single-device fused-kernel pipeline behind :func:`ft_fft`:
    ``plan`` is the FFT plan's local stage plan and ``tables`` its forward
    stage tables, shared by the fused kernel and the checksum FFT."""
    b, n = x.shape
    if plan.num_passes != 1:
        raise ValueError(
            f"the fused ABFT kernel is single-pass; got {plan.describe()} — "
            f"ft_fft takes N <= {MAX_BLOCK_N}")
    if bs is None:
        bs = min(plan.bs, b)
    # batches not divisible by bs are padded with zero signals: zero rows
    # add nothing to the group checksums and their 1-based location ids lie
    # beyond the real batch; the padded rows are sliced back off below.
    xp, _ = _pad_batch(x.contiguous(), bs)
    tiles = xp.shape[0] // bs
    txn = min(transactions, tiles)
    while tiles % txn:
        txn -= 1
    stages = plan.stages[0]
    y, delta, cs = abft_fft(xp, stages, bs=bs, transactions=txn,
                            per_signal=per_signal, encoding=encoding,
                            inject=inject, tables=tables)
    sums = twoside.GroupChecksums.from_packed(cs)
    verdict = twoside.detect_locate(
        sums, forward=lambda c: _block_fft_c(c, stages, tables, inverse=False),
        threshold=threshold)
    if correct:
        y, _ = twoside.apply_correction(y, verdict)
    return FTFFTResult(
        y=y[:b],
        delta=delta[:b],
        group_score=verdict.error_score,
        flagged=verdict.flagged,
        location=verdict.location,
        corrected=torch.sum(verdict.flagged.to(torch.int32)),
    )
