"""SEU fault model: bit-flips in floating point values + fault schedules.

The paper's error-injection methodology (§5.3.1): flip exactly one bit of the
32-bit (FP32) or 64-bit (FP64) representation of one element of one signal,
plus a Poisson fault schedule for the sustained-injection-rate experiments
(§5.3.2). The bit flips are host-side numpy, as in ``repro.core.ft``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["flip_bit", "random_flip", "FaultSchedule", "poisson_schedule"]


def flip_bit(x: np.ndarray, idx: tuple, bit: int) -> np.ndarray:
    """Flip one bit of one element (host-side, numpy) — exact paper §5.3.1.

    Flips can produce inf/nan patterns (sign/exponent bits) — that is the
    point; numpy warnings about them are suppressed.
    """
    x = np.array(x, copy=True)
    val = x[idx]
    with np.errstate(invalid="ignore", over="ignore"):
        if x.dtype == np.float32 or x.dtype == np.complex64:
            if np.iscomplexobj(x):
                # flip in the real part's representation for bit < 32,
                # imag above
                re = np.float32(val.real)
                im = np.float32(val.imag)
                if bit < 32:
                    re = _flip32(re, bit)
                else:
                    im = _flip32(im, bit - 32)
                x[idx] = re + 1j * im
            else:
                x[idx] = _flip32(np.float32(val), bit)
        elif x.dtype == np.float64 or x.dtype == np.complex128:
            if np.iscomplexobj(x):
                re, im = np.float64(val.real), np.float64(val.imag)
                if bit < 64:
                    re = _flip64(re, bit)
                else:
                    im = _flip64(im, bit - 64)
                x[idx] = re + 1j * im
            else:
                x[idx] = _flip64(np.float64(val), bit)
        else:
            raise TypeError(x.dtype)
    return x


def _flip32(v: np.float32, bit: int) -> np.float32:
    u = np.frombuffer(np.float32(v).tobytes(), dtype=np.uint32)[0]
    u = np.uint32(u ^ np.uint32(1) << np.uint32(bit))
    return np.frombuffer(u.tobytes(), dtype=np.float32)[0]


def _flip64(v: np.float64, bit: int) -> np.float64:
    u = np.frombuffer(np.float64(v).tobytes(), dtype=np.uint64)[0]
    u = np.uint64(u ^ np.uint64(1) << np.uint64(bit))
    return np.frombuffer(u.tobytes(), dtype=np.float64)[0]


def random_flip(rng: np.random.Generator, x: np.ndarray):
    """Flip a uniformly random bit of a uniformly random element.

    Returns (corrupted array, (flat_index, bit), eps) where eps is the
    complex-valued perturbation added (corrupted - original).
    """
    flat = int(rng.integers(x.size))
    idx = np.unravel_index(flat, x.shape)
    nbits = 64 if x.dtype in (np.complex64, np.float64) else 32
    if x.dtype == np.complex128:
        nbits = 128
    bit = int(rng.integers(nbits))
    y = flip_bit(x, idx, bit)
    with np.errstate(invalid="ignore", over="ignore"):
        eps = complex(y[idx]) - complex(x[idx])
    return y, (flat, bit), eps


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Deterministic schedule of SEUs for a run: step -> injection descriptor.

    Each entry is (step, tile, row, col, eps_re, eps_im) matching the fused
    kernel's in-kernel injector.
    """

    entries: tuple[tuple[int, int, int, int, float, float], ...]

    def for_step(self, step: int) -> torch.Tensor:
        """(6,) float32 injection descriptor ``[tile, row, col, enabled,
        eps_r, eps_i]`` for ``step`` (disabled if none)."""
        for (s, tile, row, col, er, ei) in self.entries:
            if s == step:
                return torch.tensor([tile, row, col, 1, er, ei],
                                    dtype=torch.float32)
        return torch.tensor([0, 0, 0, 0, 0.0, 0.0], dtype=torch.float32)

    def for_step_gemm(self, step: int) -> torch.Tensor:
        """(1, 5) float32 GEMM fault descriptor ``[site, row, col, enable,
        eps]`` for ``step`` (all zeros, disabled, if none): the ``tile``
        field addresses the protected-matmul *site* and ``eps_re`` is the
        real perturbation (GEMM activations are real). Feed it to
        ``models.layers.FTContext(inject=...)``."""
        for (s, tile, row, col, er, _ei) in self.entries:
            if s == step:
                return torch.tensor([[tile, row, col, 1, er]],
                                    dtype=torch.float32)
        return torch.zeros((1, 5), dtype=torch.float32)

    @property
    def num_faults(self) -> int:
        return len(self.entries)


def poisson_schedule(
    rng: np.random.Generator,
    *,
    steps: int,
    rate_per_step: float,
    tiles: int,
    bs: int,
    n: int,
    eps_scale: float = 50.0,
) -> FaultSchedule:
    """Poisson-arrival SEU schedule (paper §5.3.2: errors per minute)."""
    entries = []
    for step in range(steps):
        if rng.poisson(rate_per_step) > 0:
            entries.append((
                step,
                int(rng.integers(tiles)),
                int(rng.integers(bs)),
                int(rng.integers(n)),
                float(rng.normal() * eps_scale),
                float(rng.normal() * eps_scale),
            ))
    return FaultSchedule(entries=tuple(entries))
