"""Fault-tolerance policy + run-level FT runtime statistics.

The policy object is part of every run config (``configs.base.ModelConfig``
carries it): it decides what is protected (FFT ops, linear layers), the
detection threshold, the transaction count, and the checkpoint cadence — the
three-legged stool from the paper's fault model: ABFT for compute SEUs, ECC
for memory (assumed), checkpoint/restart for fail-stop. Fields and defaults
match ``repro.core.ft.policy``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["FTPolicy", "FTStats"]


@dataclasses.dataclass(frozen=True)
class FTPolicy:
    # ABFT (compute soft errors)
    protect_fft: bool = True
    protect_linears: bool = False
    threshold: float = 1e-4          # detection threshold delta (ROC-tuned)
    transactions: int = 4            # multi-transaction group size (kernel)
    per_signal: bool = False         # thread-level checksums on top
    encoding: str = "wang"
    # mesh-path grouped ABFT: one SEU per checksum GROUP per pass, so more
    # groups = more concurrent faults tolerated. None = auto.
    mesh_groups: int | None = None   # explicit group count G, or
    group_size: int | None = None    # signals per group (G = batch / this)
    # a group hit by >1 fault decodes as uncorrectable; recompute just that
    # group's rows instead of failing the whole transform
    recompute_uncorrectable: bool = True
    # fail-stop (checkpoint/restart)
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    # numerical guards for training
    skip_nonfinite_updates: bool = True
    # checked-GEMM backend for protected linears (see core.gemm.GEMMSpec):
    # "auto" resolves to the fused CUDA kernel ("fused") on a card (M, and a
    # K or N no tile divides, zero-padded) and to the torch path ("eager") on
    # the CPU. The reference's names map as "xla" -> "eager" and "pallas" ->
    # "fused".
    gemm_backend: str = "auto"

    def kernel_kwargs(self) -> dict:
        return dict(transactions=self.transactions,
                    per_signal=self.per_signal,
                    encoding=self.encoding,
                    threshold=self.threshold)

    def to_ft_config(self):
        """The op-agnostic :class:`~repro_torch.core.plan.FTConfig` this
        policy implies — attach it to ANY plan spec (``FFTSpec(ft=...)`` for
        the fused-kernel FFT ABFT, ``GEMMSpec(ft=...)`` for the two-side
        checked matmul) and the plan runs with the policy's knobs."""
        from repro_torch.core.plan import FTConfig

        return FTConfig(
            threshold=self.threshold,
            groups=self.mesh_groups,
            group_size=self.group_size,
            recompute_uncorrectable=self.recompute_uncorrectable,
            transactions=self.transactions,
            per_signal=self.per_signal,
            encoding=self.encoding)


@dataclasses.dataclass
class FTStats:
    """Device-side counters threaded through train/serve steps: 0-d float32
    tensors (a plain dataclass; the reference's is a JAX pytree)."""

    detected: torch.Tensor
    corrected: torch.Tensor
    max_score: torch.Tensor
    skipped_updates: torch.Tensor

    @classmethod
    def zeros(cls, device="cuda") -> "FTStats":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(detected=z, corrected=z.clone(), max_score=z.clone(),
                   skipped_updates=z.clone())

    def merge(self, other: "FTStats") -> "FTStats":
        return FTStats(
            detected=self.detected + other.detected,
            corrected=self.corrected + other.corrected,
            max_score=torch.maximum(self.max_score, other.max_score),
            skipped_updates=self.skipped_updates + other.skipped_updates,
        )
