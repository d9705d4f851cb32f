"""Static analysis for the port: plan auditor + repo lint. Port of
``repro.analysis``.

Two passes, one CI entry point (``python -m repro_torch.analysis
--strict``):

* :mod:`repro_torch.analysis.audit` — enumerate a lattice of ``FFTSpec`` /
  ``GEMMSpec`` configurations over the meshes of a fake process group of 8
  ranks, run each plan executor's pipeline on rank 0 at small sizes on the
  CPU, and diff the recorded collectives
  (:mod:`repro_torch.analysis.record`) against the analytic volume models.
  Any count/byte/verdict-width mismatch, unexpected all-gather, or dtype
  downcast between spec and outputs fails.
* :mod:`repro_torch.analysis.lint` — AST rules L001..L005 for repo-specific
  contracts (deprecated FFT kwargs, raw ``torch.fft`` outside core/fft,
  assert-as-input-validation, dispatch off the mesh's dispatch thread,
  frozen-field mutation), gated strict-on-new by a checked-in baseline.

:mod:`repro_torch.analysis.record` stands for the reference's
``repro.analysis.hlo``: the port has no HLO to parse, so it records the
``torch.distributed`` collectives a program issues (its context manager,
``record.record``); ``launch.dryrun`` and ``chip_smoke.py`` record through
it too.
"""
from repro_torch.analysis.record import (CollectiveOp, fake_process_group,
                                         root_signature, summarize)

__all__ = ["CollectiveOp", "root_signature", "summarize",
           "fake_process_group"]
