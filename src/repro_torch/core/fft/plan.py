"""FFT plans — the paper's template parameters, tuned for Hopper.

The paper generates CUDA kernels from 7 parameters ``(N1, N2, N3, n1, n2, n3,
bs)``: the kernel-level cube (how many global-memory round trips) and the
threadblock-level cube (what fits in shared memory), plus the per-thread batch.
On an H100 the same decisions are:

* ``kernel_factors`` — split N into 1-3 factors; each factor is one
  global-memory round trip, one block-FFT launch along that axis with the
  twiddle and the transpose folded into its layout (:func:`pass_layouts`),
  the paper's 1/2/3-kernel-launch regimes. One signal of up to
  ``MAX_BLOCK_N`` points stays in one CTA's shared memory (64 KiB at
  complex64, 128 KiB at complex128, both under the 227 KB a CTA can hold);
* ``stages`` — the mixed-radix decomposition of each factor. Each stage is a
  thread-level radix-r butterfly held in registers, so radices stay <= 16
  (the paper's register FFT); the bits of N are spread evenly over the
  fewest such stages, larger radices first (8192 -> 16*8*8*8), which keeps
  the number of shared-memory exchanges low;
* ``bs`` — signals per transaction tile of the fused ABFT kernel, picked so
  that the G = B / (bs * T) checksum groups (one CTA each) fill the card's
  132 SMs where the batch allows.

Plans are plain dataclasses the user can build by hand, and
:func:`plan_from_reference` carries a ``repro.core.fft.plan.Plan`` across
field by field, so the port can run exactly the reference's stages.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

__all__ = ["Plan", "StagePlan", "PassLayout", "make_plan", "block_radices",
           "axis_layout", "pass_layouts", "plan_from_reference",
           "MAX_BLOCK_N"]

# Largest signal length executed in a single shared-memory block FFT, for
# both complex64 (64 KiB) and complex128 (128 KiB).
MAX_BLOCK_N = 1 << 13

# Largest radix of one thread-level butterfly.
MAX_RADIX = 16

# H100 SXM streaming multiprocessors: the fused ABFT kernel runs one CTA per
# checksum group, so the default tile size aims for at least this many groups.
NUM_SMS = 132

# Transactions per checksum group that ``_pick_bs`` sizes for: the default of
# ``FTConfig.transactions``.
_DEFAULT_TRANSACTIONS = 4


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One shared-memory Stockham stage: contract with W_r and twiddle."""

    radix: int
    m: int  # remaining length after this stage: stage maps (r, m) -> (r, m)

    @property
    def n(self) -> int:
        return self.radix * self.m


@dataclasses.dataclass(frozen=True)
class Plan:
    """Full plan for an N-point batched FFT.

    ``kernel_factors``: product == N; one entry per global-memory pass (the
    paper's N1, N2, N3). ``stages[i]`` are the radix stages for factor i.
    ``bs`` is the number of signals per transaction tile of the fused ABFT
    kernel.
    """

    n: int
    kernel_factors: tuple[int, ...]
    stages: tuple[tuple[StagePlan, ...], ...]
    bs: int
    inverse: bool = False

    @property
    def num_passes(self) -> int:
        return len(self.kernel_factors)

    def describe(self) -> str:
        facs = "x".join(str(f) for f in self.kernel_factors)
        rads = ";".join(
            "*".join(str(s.radix) for s in st) for st in self.stages
        )
        return f"Plan(N={self.n}={facs}, radices=[{rads}], bs={self.bs})"


@dataclasses.dataclass(frozen=True)
class PassLayout:
    """How one block-FFT launch addresses its signals in flat storage.

    ``axes`` are up to three signal axes, slowest first, each
    ``(count, in_stride, out_stride)``; signal ``(i0, i1, i2)`` starts at
    ``sum(i_a * in_stride_a)`` in the input and ``sum(i_a * out_stride_a)``
    in the output. ``point_in``/``point_out`` are the strides between the
    points of one signal. The pass twiddle of a launch (when it has one) is
    ``w_M^(k * i)``, ``i`` the signal's index along the last (fastest) axis
    and ``M`` the point count times that axis's count.
    """

    axes: tuple[tuple[int, int, int], ...]
    point_in: int = 1
    point_out: int = 1

    @classmethod
    def rows(cls, batch: int, n: int) -> "PassLayout":
        """``batch`` contiguous rows of ``n`` points, in and out."""
        return cls(axes=((batch, n, n),))

    @property
    def signals(self) -> int:
        return math.prod(a[0] for a in self.axes)

    @property
    def fast_count(self) -> int:
        """Count of the fastest signal axis (the pass twiddle's index)."""
        return self.axes[-1][0]


def _merged(axes) -> tuple[tuple[int, int, int], ...]:
    """Drop count-1 axes and fuse neighbours that address as one axis."""
    out: list[tuple[int, int, int]] = []
    for c, si, so in axes:
        if c == 1:
            continue
        if out and out[-1][1] == c * si and out[-1][2] == c * so:
            pc = out.pop()[0]
            c = pc * c
        out.append((c, si, so))
    return tuple(out) or ((1, 0, 0),)


@functools.lru_cache(maxsize=256)
def axis_layout(lead: int, size: int, inner: int) -> PassLayout:
    """The layout of a launch along one axis of a contiguous ``(lead, size,
    inner)`` block: ``lead * inner`` signals of ``size`` points, each point
    ``inner`` apart, read and written in place. The signals' fastest axis
    is ``inner`` (stride 1), as pass 0 of :func:`pass_layouts` has it; the
    last axis of an operand (``inner == 1``) is :meth:`PassLayout.rows`."""
    span = size * inner
    return PassLayout(_merged(((lead, span, span), (inner, 1, 1))),
                      inner, inner)


@functools.lru_cache(maxsize=256)
def pass_layouts(batch: int, kernel_factors: tuple[int, ...]
                 ) -> tuple[PassLayout, ...]:
    """The layout of each pass of a P-pass transform of ``batch`` signals
    of N = prod(kernel_factors) points (the paper's N1 x N2 (x N3)).

    Pass i < P-1 transforms along n_i, the signals' stride the product of
    the later factors, and writes back in the same layout (its twiddle
    index is n_rest, the fastest axis). The last pass reads contiguous rows
    and writes the output transposed, ``y[b, k_P*f1*..*f_{P-1} + ... +
    k2*f1 + k1]``; its fastest axis is k1, stride 1 on the output side.
    """
    facs = tuple(int(f) for f in kernel_factors)
    n = math.prod(facs)
    p = len(facs)
    if p == 1:
        return (PassLayout.rows(batch, n),)
    after = [math.prod(facs[j + 1:]) for j in range(p)]
    layouts = []
    for i in range(p - 1):
        axes = [(batch, n, n)]
        axes += [(facs[j], after[j], after[j]) for j in range(i)]
        axes.append((after[i], 1, 1))
        layouts.append(PassLayout(_merged(axes), after[i], after[i]))
    axes = [(batch, n, n)]
    axes += [(facs[j], after[j], math.prod(facs[:j]))
             for j in range(p - 2, -1, -1)]
    layouts.append(PassLayout(_merged(axes), 1, math.prod(facs[:-1])))
    return tuple(layouts)


def block_radices(n: int) -> tuple[int, ...]:
    """Radices <= ``MAX_RADIX`` for a power-of-two n: the fewest stages, the
    bits spread evenly, larger radices first."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"only power-of-two sizes supported, got {n}")
    log = n.bit_length() - 1
    if log == 0:
        return ()
    max_bits = MAX_RADIX.bit_length() - 1
    nst = -(-log // max_bits)
    base, extra = divmod(log, nst)
    return tuple(1 << (base + (i < extra)) for i in range(nst))


def _stages_for(n: int, radices: Sequence[int]) -> tuple[StagePlan, ...]:
    stages = []
    m = n
    for r in radices:
        if r < 2 or r & (r - 1) or m % r:
            raise ValueError(f"radices {tuple(radices)} do not split {n} "
                             f"into power-of-two stages")
        m //= r
        stages.append(StagePlan(radix=r, m=m))
    if m != 1:
        raise ValueError(f"radices {tuple(radices)} multiply to {n // m}, "
                         f"not {n}")
    return tuple(stages)


def _split_kernel_factors(n: int) -> tuple[int, ...]:
    """Split N into <=3 balanced factors (paper's 1/2/3-launch regimes).

    Regime boundaries follow the paper (§3.3.2): one pass for N <= 2^13, two
    passes for 2^14..2^22, three passes for 2^23..2^29.
    """
    if n <= MAX_BLOCK_N:
        return (n,)
    log = n.bit_length() - 1
    if log <= 22:  # two passes, balanced
        l1 = (log + 1) // 2
        return (1 << l1, 1 << (log - l1))
    l1 = (log + 2) // 3
    l2 = (log - l1 + 1) // 2
    return (1 << l1, 1 << l2, 1 << (log - l1 - l2))


def _pick_bs(batch: int) -> int:
    """Signals per ABFT transaction tile: the largest power of two that
    still leaves ``batch / (bs * 4)`` >= ``NUM_SMS`` checksum groups, else
    1."""
    bs = 1
    while batch // (2 * bs * _DEFAULT_TRANSACTIONS) >= NUM_SMS:
        bs *= 2
    return bs


@functools.lru_cache(maxsize=None)
def make_plan(n: int, batch: int = 1, *, inverse: bool = False) -> Plan:
    """Build the plan for a (batch, n) FFT workload (both precisions share
    one plan on Hopper)."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"N must be a power of two, got {n}")
    factors = _split_kernel_factors(n)
    stages = tuple(_stages_for(f, block_radices(f)) for f in factors)
    return Plan(n=n, kernel_factors=factors, stages=stages,
                bs=_pick_bs(batch), inverse=inverse)


def plan_from_reference(n: int, kernel_factors: Sequence[int],
                        radices: Sequence[Sequence[int]], bs: int,
                        inverse: bool = False) -> Plan:
    """Build the port's :class:`Plan` from a reference plan's fields given as
    plain ints and tuples, e.g. ``(1024, (1024,), ((128, 8),), 8)``.

    With the bitwise-equal tables of :mod:`factors` this is the state that
    crosses over: the port then runs exactly the reference's stages.
    """
    facs = tuple(int(f) for f in kernel_factors)
    prod = math.prod(facs)
    if prod != n:
        raise ValueError(f"kernel_factors {facs} multiply to {prod}, not {n}")
    if len(radices) != len(facs):
        raise ValueError(f"{len(radices)} radix tuples for {len(facs)} "
                         f"kernel factors")
    stages = tuple(_stages_for(f, tuple(int(r) for r in rads))
                   for f, rads in zip(facs, radices))
    return Plan(n=int(n), kernel_factors=facs, stages=stages, bs=int(bs),
                inverse=bool(inverse))

