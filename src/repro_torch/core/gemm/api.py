"""GEMM plan family on the shared op-agnostic plan layer (``core.plan``).

The paper's ABFT is derived from the GEMV view of the DFT — the same
two-side checksum scheme protects any ``Y = X @ W``. This module is the
plan/execute front door for checked GEMMs, mirroring ``core.fft.api``:

* :class:`GEMMSpec` — frozen, hashable description of one matmul workload
  ``(M, K, N)`` plus an optional :class:`~repro_torch.core.plan.FTConfig`
  and the device it runs on;
* :class:`GEMMPlan` — resolved once per spec (registered on the shared
  registry, cached by the shared LRU): picks the ABFT backend and binds
  ``matmul`` / ``ft_matmul`` executors;
* backends: ``"eager"`` is the two-side ABFT in torch ops
  (:mod:`repro_torch.core.abft.gemm`, the reference's ``"xla"``),
  ``"fused"`` the CUDA kernel (:mod:`repro_torch.kernels.ft_matmul`, the
  reference's ``"pallas"``) whose checksum strips are decoded by the SAME
  :func:`decode_columns`, so the two backends agree by construction.
  ``"auto"`` resolves to ``"fused"`` on a card and to ``"eager"`` on the
  CPU, as the reference's takes the Pallas kernel only on the TPU. The
  fused kernel takes K and N in multiples of its tiles (:func:`spec_for`
  fits them: 64-wide where 128 does not divide); a product whose K or N
  no tile divides is zero-padded to the tiles (a SMOKE config's 48-wide
  projection), and M to a multiple of the kernel's smallest tile row
  count (decode steps have M = the batch): every product of a card plan
  runs on the kernel. ``backend="eager"`` asks for the torch path
  explicitly. On a CPU plan ``"fused"`` runs the kernel's plain torch
  version.

Injection descriptors are ``(4,)`` (or ``(F, 4)``) float rows
``[row, col, enable, eps]`` — ``enable`` lets one fixed program arm or
disarm a fault per step
(:meth:`repro_torch.core.ft.injection.FaultSchedule.for_step_gemm`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import plan as planbase
from repro_torch.core.plan import FTConfig
from repro_torch.core.abft import gemm as abft_gemm
from repro_torch.core.abft.encoding import EPS
from repro_torch.kernels import ft_matmul as ft_kernel

__all__ = ["GEMMSpec", "GEMMPlan", "spec_for", "plan"]

_BACKENDS = ("auto", "eager", "fused")


@dataclasses.dataclass(frozen=True)
class GEMMSpec:
    """Frozen, hashable description of one ``(M, K) @ (K, N)`` workload.

    ``shape`` is ``(M, K, N)`` with M the token axis the checksums ride
    (batched ``(B, T, K)`` activations flatten to ``M = B * T`` — use
    :func:`spec_for`). ``dtype`` is the activations' floating dtype. ``ft``
    attaches the shared :class:`FTConfig`; ``backend`` picks the ABFT
    implementation (see module docstring); ``tiles`` are the fused kernel's
    ``(bm, bk, bn)`` block sizes. ``device`` is where the plan runs:
    ``"cuda"`` (the kernel) by default, ``"cpu"`` for the plain versions.
    Equal specs hash equal and hit the same cached :class:`GEMMPlan`.
    """

    shape: tuple[int, int, int]
    dtype: str = "float32"
    ft: FTConfig | None = None
    backend: str = "auto"
    tiles: tuple[int, int, int] = (128, 128, 128)
    device: str = "cuda"

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        if len(shape) != 3 or any(s <= 0 for s in shape):
            raise ValueError(f"GEMMSpec.shape must be (M, K, N) positive "
                             f"sizes, got {self.shape!r}")
        object.__setattr__(self, "shape", shape)
        dt = planbase.dtype_name(self.dtype)
        if not isinstance(getattr(torch, dt, None), torch.dtype) \
                or not getattr(torch, dt).is_floating_point:
            raise ValueError(f"GEMMSpec.dtype must be a floating dtype, "
                             f"got {self.dtype!r}")
        object.__setattr__(self, "dtype", dt)
        if self.backend not in _BACKENDS:
            raise ValueError(f"GEMMSpec.backend must be one of {_BACKENDS}, "
                             f"got {self.backend!r}")
        tiles = tuple(int(t) for t in self.tiles)
        if len(tiles) != 3 or any(t <= 0 for t in tiles):
            raise ValueError(f"GEMMSpec.tiles must be (bm, bk, bn) positive "
                             f"sizes, got {self.tiles!r}")
        object.__setattr__(self, "tiles", tiles)
        if self.ft is not None and not isinstance(self.ft, FTConfig):
            raise TypeError(f"GEMMSpec.ft must be an FTConfig or None, "
                            f"got {type(self.ft).__name__}")
        object.__setattr__(self, "device", str(torch.device(self.device)))


@planbase.register_plan_type(GEMMSpec)
class GEMMPlan(planbase.Plan):
    """Resolved executor bundle for one :class:`GEMMSpec`.

    ``backend`` is the resolved ABFT implementation and ``device`` the
    resolved device; :meth:`matmul` is the unchecked product,
    :meth:`ft_matmul` the checked one (requires ``spec.ft``). ``volume`` is
    the analytic flop model: the checked product adds four rank-1 GEMVs
    and the output strips, O(MK + KN + MN) against the product's 2MKN.
    """

    def __init__(self, spec: GEMMSpec):
        super().__init__(spec)
        m, k, n = spec.shape
        self.device = planbase.resolve_device(spec.device, "GEMMSpec")
        backend = spec.backend
        if backend == "auto":
            backend = "fused" if self.device.type == "cuda" else "eager"
        if backend == "fused" and self.device.type == "cuda":
            bm, bk, bn = spec.tiles
            ft_kernel.check_kernel_tiles(bm, bn, bk)
        self.backend = backend
        self.volume = {"flops": 2 * m * k * n}
        if spec.ft is not None:
            # e2/e3 input GEMVs (4mk) + predicted strips (4kn) + output
            # strips (3mn) + per-column decode (O(n))
            self.volume["checksum_flops"] = 4 * m * k + 4 * k * n + 3 * m * n

    def describe(self) -> dict:
        d = super().describe()
        m, k, n = self.spec.shape
        d.update(m=m, k=k, n=n, backend=self.backend,
                 dtype=self.spec.dtype, tiles=self.spec.tiles,
                 device=str(self.device))
        return d

    # -- executors ---------------------------------------------------------
    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Unchecked ``x @ w`` with the operands' promoted dtype (the
        baseline the overhead is measured against)."""
        self._check_operands(x, w)
        dt = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(dt), w.to(dt))

    def ft_matmul(self, x: torch.Tensor, w: torch.Tensor, *, inject=None):
        """Checked ``x @ w`` -> ``(y, stats)`` (see
        :func:`repro_torch.core.abft.gemm.decode_columns` for the stats
        contract). ``inject`` is a ``(4,)``/``(F, 4)`` ``[row, col, enable,
        eps]`` descriptor; rows index the flattened token axis."""
        cfg = self.spec.ft
        if cfg is None:
            raise ValueError("ft_matmul on a plan without an FTConfig — "
                             "build the GEMMSpec with ft=FTConfig(...)")
        self._check_operands(x, w)
        inj = _normalize_inject(inject, x.device)
        if self.backend == "fused":
            bm, bk, bn = self.spec.tiles
            y, *stats = _FusedLinear.apply(x, w, inj, bm, bn, bk,
                                           cfg.threshold, cfg.correct)
            return y, dict(zip(_STATS, stats))
        # eager: fold enable into eps -> the eager path's (F, 3) rows
        inj3 = torch.stack([inj[:, 0], inj[:, 1], inj[:, 2] * inj[:, 3]],
                           dim=-1)
        return abft_gemm.ft_matmul(x, w, threshold=cfg.threshold,
                                   with_correction=cfg.correct, inject=inj3)

    __call__ = matmul

    def _check_operands(self, x, w):
        m, k, n = self.spec.shape
        got = (int(math.prod(x.shape[:-1])), int(x.shape[-1]),
               int(w.shape[-1]))
        if w.dim() != 2 or int(w.shape[0]) != k or got != (m, k, n):
            raise ValueError(f"operands {tuple(x.shape)} @ {tuple(w.shape)} "
                             f"do not match GEMMSpec.shape (M, K, N)="
                             f"{(m, k, n)}")
        for name, t in (("x", x), ("w", w)):
            if t.device.type != self.device.type:
                raise ValueError(f"operand {name} is on {t.device}, the plan "
                                 f"runs on {self.device}")

    def __repr__(self):
        s = self.spec
        return (f"GEMMPlan(shape={s.shape}, dtype={s.dtype}, "
                f"backend={self.backend!r}, device={str(self.device)!r}, "
                f"ft={s.ft is not None})")


# the reference's _normalize_inject: one descriptor form for both backends
_normalize_inject = ft_kernel.inject_rows


_STATS = ("flagged", "corrected", "uncorrectable", "score")


class _FusedLinear(torch.autograd.Function):
    """The fused path under autograd: the forward is
    :func:`_ft_matmul_fused` (the kernel on the card, its plain version on
    the CPU); the backward is the gradient of the product it checks, what
    the reference gets by differentiating its eager path, where ``y = xf @
    wf`` in float32 is cast to ``x.dtype``: ``grad_x = g @ wᵀ`` and
    ``grad_w = xᵀ @ g`` in float32, ``grad_x`` cast to ``x.dtype``. No
    gradient flows through the stats or the correction: the corrected
    output is the clean product's. The two products are ``torch.matmul``
    (the reference's are XLA dots outside its kernel) and are not
    checked, as the reference checks none of its backward."""

    @staticmethod
    def forward(ctx, x, w, inj, bm, bn, bk, threshold, with_correction):
        y, stats = _ft_matmul_fused(x, w, inj, bm=bm, bn=bn, bk=bk,
                                    threshold=threshold,
                                    with_correction=with_correction)
        ctx.save_for_backward(x, w)
        out = tuple(stats[k] for k in _STATS)
        ctx.mark_non_differentiable(*out)
        return (y,) + out

    @staticmethod
    def backward(ctx, g, *_):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g2 @ w.float().T).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (x.reshape(-1, x.shape[-1]).float().T @ g2).to(w.dtype)
        return gx, gw, None, None, None, None, None, None


def _ft_matmul_fused(x, w, inj, *, bm, bn, bk, threshold, with_correction):
    """The kernel on ``x`` with M padded by zero rows, when it is not a
    multiple of ``bm``, to a multiple of the kernel's smallest tile row
    count: zero rows add nothing to e2ᵀC, e3ᵀC, e2ᵀX or e3ᵀX, so the strips
    and their decode over the first M rows are those of the unpadded
    product, and a fault's decoded row lies among them. A K or N that is
    no multiple of ``bk`` or ``bn`` is zero-padded likewise (zero columns
    of X against zero rows of W add nothing; zero columns of W give zero
    columns of C and strips, which the decode leaves out).

    X goes to the kernel in float32, so that the product ``c`` it stores
    stays float32 through the correction and is rounded to ``x.dtype`` once
    after it, as on the eager path: the kernel widens every operand to
    float32 as it loads it, so the product is the same, while a bf16 ``c``
    would keep up to half a bf16 step of ``c + eps`` in the corrected
    element."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    t = x2.shape[0]
    k, n = w.shape
    if t % bm:
        bm = min(ft_kernel.KERNEL_TILES)
    if t % bm or k % bk:
        x2 = torch.nn.functional.pad(x2, (0, -k % bk, 0, -t % bm))
    if k % bk or n % bn:
        w = torch.nn.functional.pad(w, (0, -n % bn, 0, -k % bk))
    res = ft_kernel.ft_matmul(x2.contiguous(), w, bm=bm, bn=bn, bk=bk,
                              inject=inj)
    out2 = res.out2[:n]
    d2 = res.pred2[:n] - out2
    d3 = res.pred3[:n] - res.out3[:n]
    scale = torch.sqrt(torch.mean(out2 * out2)) + EPS
    y, stats = abft_gemm.decode_columns(
        res.c[:t, :n], d2, d3, scale, t=t, threshold=threshold,
        with_correction=with_correction)
    return y.reshape(x.shape[:-1] + (n,)).to(x.dtype), stats


def _fit_tiles(k: int, n: int) -> tuple[int, int, int]:
    """The fused kernel's ``(bm, bk, bn)`` for a product of K and N: the
    largest ``bk`` of 128, 64, 32 that divides K and the largest ``bn`` of
    :data:`~repro_torch.kernels.ft_matmul.KERNEL_TILES` that divides N,
    the smallest where none does (the fused path pads to it). A product
    aligned to 128 keeps (128, 128, 128); the sLSTM FFN's 1344 = 64 x 21
    gets 64."""
    bk = next((t for t in (128, 64, 32) if k % t == 0), 32)
    bn = next((t for t in sorted(ft_kernel.KERNEL_TILES, reverse=True)
               if n % t == 0), min(ft_kernel.KERNEL_TILES))
    return (128, bk, bn)


def spec_for(x: torch.Tensor, w: torch.Tensor, *, ft: FTConfig | None = None,
             backend: str = "auto",
             tiles: tuple[int, int, int] | None = None,
             device=None) -> GEMMSpec:
    """Build the :class:`GEMMSpec` describing ``x @ w`` (flattening batched
    activation leading axes into M), on ``x``'s device unless ``device``
    says otherwise, with the tiles of :func:`_fit_tiles` unless ``tiles``
    says otherwise."""
    m, k, n = int(math.prod(x.shape[:-1])), int(x.shape[-1]), int(w.shape[-1])
    return GEMMSpec(shape=(m, k, n), dtype=planbase.dtype_name(x.dtype),
                    ft=ft, backend=backend,
                    tiles=_fit_tiles(k, n) if tiles is None else tiles,
                    device=str(x.device if device is None else device))


def plan(spec: GEMMSpec) -> GEMMPlan:
    """Shared-cache lookup (see :func:`repro_torch.core.plan.plan`)."""
    if not isinstance(spec, GEMMSpec):
        raise TypeError(f"core.gemm.plan() takes a GEMMSpec, got "
                        f"{type(spec).__name__}")
    return planbase.plan(spec)
