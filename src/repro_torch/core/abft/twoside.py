"""Two-sided ABFT: detect / locate / correct from checksum divergences.

Implements the paper's Figure 6 pipeline on a linear operator F (the FFT),
given the group checksums:

    cs2_in  = X e2 = sum_b x_b              (correction checksum)
    cs3_in  = X e3 = sum_b id_b * x_b       (location checksum)
    cs2_out = Y e2,  cs3_out = Y e3         (same over the computed outputs)

Under the SEU assumption (one corrupted signal y_s = y~_s + eps per detection
period), linearity gives

    F(cs2_in) - cs2_out = -eps                    -> correction value
    (F(cs3_in) - cs3_out) / (F(cs2_in) - cs2_out) = id_s  -> location

so the corrupted signal is repaired *without recomputation*.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .encoding import EPS

__all__ = ["GroupChecksums", "Verdict", "detect_locate", "apply_correction"]


@dataclasses.dataclass
class GroupChecksums:
    """Complex (G, N) checksum tensors for G transaction groups.

    ``inputs`` is ``[cs2_in, cs3_in]`` as one (2, G, N) tensor where they
    already are one (the fused kernel's layout), so the protected operator
    runs on both in one call without a copy."""

    cs2_in: torch.Tensor
    cs3_in: torch.Tensor
    cs2_out: torch.Tensor
    cs3_out: torch.Tensor
    inputs: torch.Tensor | None = None

    @classmethod
    def from_packed(cls, cs: torch.Tensor) -> "GroupChecksums":
        """From the fused kernel's (4, G, N) complex layout
        ``[X.e2, X.e3, Y.e2, Y.e3]`` (views, no copy)."""
        return cls(cs2_in=cs[0], cs3_in=cs[1], cs2_out=cs[2], cs3_out=cs[3],
                   inputs=cs[:2])


@dataclasses.dataclass
class Verdict:
    """Detection outcome per group."""

    error_score: torch.Tensor   # (G,) relative divergence of the e2 checksum
    flagged: torch.Tensor       # (G,) bool, error_score > threshold
    location: torch.Tensor      # (G,) int32 global signal index
    correction: torch.Tensor    # (G, N) complex correction value (-eps)


def _power(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def detect_locate(
    cs: GroupChecksums,
    forward: Callable[[torch.Tensor], torch.Tensor],
    threshold: float,
) -> Verdict:
    """Run detection + location on group checksums.

    ``forward`` is the protected linear operator applied row by row to the
    input checksums — one extra F per *group* and checksum, amortized over
    its signals. It runs once, on the (2G, N) block ``[cs2_in; cs3_in]``.
    """
    inputs = cs.inputs
    if inputs is None:
        inputs = torch.stack([cs.cs2_in, cs.cs3_in])
    g, n = cs.cs2_in.shape
    f_in = forward(inputs.reshape(2 * g, n)).reshape(2, g, n)
    d2 = f_in[0] - cs.cs2_out                     # == -eps on the error
    d3 = f_in[1] - cs.cs3_out                     # == -id_s * eps
    scale = torch.sqrt(torch.mean(_power(cs.cs2_out), dim=-1)) + EPS
    score = torch.sqrt(torch.mean(_power(d2), dim=-1)) / scale
    flagged = score > threshold
    # |d2|^2-weighted estimate of id_s = d3/d2 (robust to tiny elements)
    num = torch.sum(d3 * torch.conj(d2), dim=-1).real
    den = torch.sum(_power(d2), dim=-1) + EPS
    loc = torch.round(num / den).to(torch.int32) - 1  # ids are 1-based
    return Verdict(error_score=score, flagged=flagged, location=loc,
                   correction=d2)


def apply_correction(y: torch.Tensor, verdict: Verdict
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Add the correction value back onto the located signals (paper §4.1.2).

    y: (B, N) complex outputs, corrected in place (``index_add_``); returns
    (y, per-group applied mask).
    """
    b = y.shape[0]
    loc = torch.clamp(verdict.location, 0, b - 1).to(torch.int64)
    applied = verdict.flagged
    upd = torch.where(applied[:, None], verdict.correction,
                      torch.zeros((), dtype=verdict.correction.dtype,
                                  device=y.device))
    y.index_add_(0, loc, upd.to(y.dtype))
    return y, applied
