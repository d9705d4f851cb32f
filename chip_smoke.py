#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the three kernels from ``src/repro_torch/kernels/csrc`` with nvcc
(all at once) and drives the port's paths:

* FFT: the local rank-1 fft / ifft / ft_fft path through
  ``plan(FFTSpec(...))`` at the sizes of ``turbofft_bench.CONFIG``'s corners
  (every case far beyond the 50 MB L2), each result checked against
  ``torch.fft`` at the suite's tolerance (ATOL * max|ref|: 4e-5 complex64,
  1e-11 complex128), and an SEU campaign through the fused ABFT kernel;
* checked GEMM, at the widths of Phi-4-mini 3.8B (d_model 3072, d_ff 8192):
  ``plan(GEMMSpec(...)).ft_matmul`` on the MLP's two product shapes with an
  SEU campaign, then the protected SwiGLU MLP block (rmsnorm -> mlp ->
  residual, bf16 activations, f32 weights, 4 x 512 tokens) under
  ``FTContext`` with a Poisson fault schedule over its three sites;
* the local extensions at typical user grids (``extension_cases``): rfft /
  irfft, fft2 / ifft2 (complex64 and complex128), rfft2 / irfft2, a rank-3
  fftn / ifftn, real and complex fft_convolve and correlate,
  fft_convolve2, power_spectrum (complex and one-sided real), a fft2 whose
  non-last axis is over 8192 points (the copy path), each against its
  ``torch.fft`` counterpart at ATOL[dtype] * max|ref| with its
  ``block_fft`` launches counted, and ``ft_ifft`` over an SEU campaign
  (injected == detected == located == corrected, no false alarm);
* the serving runtime (``serve_phase``): both modes of ``python -m
  repro_torch.launch.serve`` as subprocesses (each prints a rel_err within
  the complex64 tolerance), then one ``ServeRuntime`` (max_batch 16, two
  workers, 2 ms deadline) driven by four client threads with 448 seeded
  requests, half numpy arrays and half card tensors, over seven buckets
  (``serve_tenants`` and an ft campaign of one fault in every other closed
  group of 16): every result on the device its request came from and
  within ATOL of ``torch.fft`` of the zero-padded request; every bucket's
  completed == submitted with nothing failed, rejected or timed out; the
  ``block_fft`` and ``abft_fft`` launches equal to each bucket plan's
  launches a batch over its batches; the ft ledger exact (the location the
  faulted row, no flag on a clean batch); under 2 GB of device memory.
  Then convolve and correlate through ``serve_plan``, and the runtime at
  max_batch 1 against 16 on throughput (printed);
* the LM path (phase 7, ``lm_drive``): Phi-4-mini 3.8B at its published
  widths (d_model 3072, d_ff 8192, vocab 200064) cut to 8 of its 32
  layers (``LM_REDUCED``; f32 params,
  bf16 activations, random weights from a seeded CUDA generator), one
  protected ``Model.apply`` prefill at 4 x 512 tokens against the
  unprotected one (``LM_LOGIT_TOL``), then ``launch.serve.decode`` at
  batch 4 (every protected product's M padded to 64) and 64, each
  unprotected, protected and protected under the CLI's ``FaultSchedule``:
  7 ``ft_matmul`` launches a layer per step and no call of the eager ABFT
  path, the SEU ledger injected == detected == corrected == 2 x 8, the
  SEU run's tokens those of the clean protected run, under 28 GB of device
  memory; then Gemma-3 1B (local and global caches, tied embeddings)
  protected at batch 4 under the same schedule. ``lm_measure`` then times
  the prefill, traces one protected and one unprotected decode step under
  ``torch.profiler`` (kernels, host ms, the device's idle share), holds
  ``ft_matmul`` against its plain version at a decode step's padded MLP
  shape and times it beside ``torch.matmul`` and its byte bound (phase 11
  runs ``python -m repro_torch.launch.serve --mode lm`` at Gemma-3 1B's
  widths);
* the recurrent LM path (phase 8, ``ssm_drive``, then ``ssm_measure``):
  RecurrentGemma-2B (RG-LRU and local attention, d_model 2560, vocab
  256000) and then xLSTM-350M (mLSTM and sLSTM, d_model 1024), each at its
  published widths and, since PR 25, 12 of its 26 or 24 layers
  (``SSM_LAYERS``), with random f32 weights from a
  seeded CUDA generator and bf16 activations, the first freed before the
  second is built: a protected 4 x 512 prefill against the unprotected
  one, 8 decode steps against the forward at float32 activations
  (``SSM_RECURRENCE_TOL``), the float32 protected forward's divergence
  from the unprotected one by positions beside a witness's (the
  unprotected forward with every weight one ulp up, ``ulp_witness``),
  greedy decode unprotected, protected and
  protected under the CLI's schedule (RecurrentGemma at batch 4 and 64,
  xLSTM at 4): one ``ft_matmul`` launch a protected site a step (76 and
  72 at 12 layers), no eager ABFT call, the ledger 2 x layers with the clean run's
  tokens; then the prefill by CUDA events, one primed trace of a
  protected decode step, ``ft_matmul`` against its plain version at the
  path's own products (``SSM_FTMM_SHAPES``: the MLP's, and the sLSTM
  FFN's on 64-wide tiles) (phase 11 runs ``--mode lm --arch xlstm-350m
  --preset full --ft``);
* the MoE path (phase 9, ``moe_drive``, then ``moe_measure``): DeepSeek-V3
  (MLA, 256 routed experts top-8 and a shared expert, d_model 7168, vocab
  129280) cut to 2 of its 61 layers (one dense-FFN block, one MoE block:
  55.8 GB of f32 params) and then Llama-4 Maverick (GQA, top-1 experts
  and a shared expert, d_model 5120, vocab 202048) cut to 2 of 48 layers
  and 64 of its 128 experts, each at its published widths with random
  weights from a seeded CUDA generator, bf16 activations, the first freed
  before the second is built (``MOE_REDUCED``): a protected 4 x 512
  prefill against the unprotected one at bf16 and at float32
  activations, every differing expert choice a near-tie
  (``MOE_NEAR_TIE``: 2^-5 at bf16, 1e-3 at float32) and the logits within
  ``MOE_LOGIT_TOL`` at the positions whose routing and capacity keep
  agree; 8 decode steps against the forward at float32
  (MLA's absorbed path against its naive one); greedy decode at batch 4,
  unprotected, protected and under the CLI's schedule: 7 ``ft_matmul``
  launches a layer a step, 3 eager batched expert products a MoE layer a
  step and no eager 2-D call, the ledger 2 x layers with the clean run's
  tokens, peak memory under 72 GB; then the prefill by events, primed
  traces of a protected and an unprotected step, the expert products
  against their byte bound, ``ft_matmul`` against its plain version at
  the path's products (``MOE_FTMM_SHAPES``) (phase 11 runs ``--mode lm
  --arch deepseek-v3-671b --preset tiny --ft``);
* training (phase 10, ``train_drive``, then ``train_measure``): Gemma-3 1B
  at its published widths (999,812,736 params, f32, with random weights
  from a seeded CUDA generator; bf16 activations) at ``launch.train``'s
  defaults, batch 8 x 256 tokens (M = 2048), lr 3e-4, ``TokenPipeline(
  seed=0)``: (a) one step's loss and gradients at float32 activations
  protected on ``ft_matmul``, protected on the eager path and
  unprotected, held against each other (loss 1e-5 relative, each
  gradient leaf 1e-4 x its max); (b) 20 ``make_train_step`` steps
  protected and 20 unprotected from the same weights: finite losses, the
  last five below the first five, 7 x 26 = 182 ``ft_matmul`` launches a
  protected step and no eager ABFT call, nothing flagged at the policy's
  1e-4; (c) one SEU at one site of every block inside the loss, flagged
  and corrected in each of the 26 blocks, the loss and gradients the
  clean step's; (d) the protected run saved after 5 steps through
  ``CheckpointManager``, restored into fresh tensors and run to step 10,
  its losses within 1e-5 of the uninterrupted run's; then primed traces
  of a protected and an unprotected step, each split into forward (with
  its 182 ``ft_matmul_tile`` kernels), backward and optimizer (with
  none) by when each kernel was launched, ``ft_matmul`` at the step's five product shapes against its plain
  version and ``torch.matmul``, and ``python -m repro_torch.launch.train
  --preset full --ft-linears`` to 1 step (one checkpoint, its last
  step's) and again to 2, which resumes from it;
* the encoder-decoder and the VLM (phase 11, ``encdec_drive``, then
  ``encdec_measure``, one config at a time): Whisper-base (6 + 6 layers,
  d_model 512, vocab 51865; 1500 frames of 80 through the audio stub) and
  InternVL2-1B (24 layers, d_model 896, q/k/v biases, vocab 151655; 256
  patches of 1024 through the patch stub) at their published widths and
  full depth, random weights from a seeded CUDA generator, frames and
  patches standard normal from numpy's SEED: (a) the prefill through
  ``make_prefill_step`` (Whisper 4 x 448 tokens on 4 x 1500 frames,
  InternVL2 4 x 256 tokens after 256 patches), exactly 72 and 168
  ``ft_matmul`` launches and no eager ABFT call, the protected logits
  within LM_LOGIT_TOL x max of the unprotected ones at bf16 and 2e-3 at
  float32; (b) greedy decode (Whisper at batch 4 and 64, InternVL2 at 4),
  protected and unprotected, 36 and 168 launches a protected step, every
  Whisper cross cache still zeros afterwards (the reference's decode
  passes no encoder output), and InternVL2's also under the CLI's SEU
  schedule (its ledger 48 exact, its tokens the clean run's); training at
  launch.train's batch (8 x 256 tokens) with frames or patches: the three
  backends' float32 loss and gradients agree (phase 10's gate (a)), then
  10 bf16 steps protected and 10 unprotected: the loss falls, 72 and 168
  launches a protected step, nothing flagged at 1e-4; then the prefill by
  CUDA events, a primed trace of one protected decode step, ``ft_matmul``
  at the new products, and a primed trace of one protected train step
  (every ``ft_matmul_tile`` in the forward);
* training the recurrent and MoE models (phase 12, ``rm_drive``, then
  ``rm_measure``, one config at a time, each built from a seeded CUDA
  generator and freed before the next; f32 params, bf16 activations,
  ``TokenPipeline(seed=0)`` at each vocabulary): RecurrentGemma-2B and
  xLSTM-350M at their published widths and full depth, DeepSeek-V3 at 1
  of 61 layers with 32 of 256 routed experts and Llama-4 Maverick at 2 of
  48 layers with 8 of 128 (``RM_REDUCED``; each parameter count
  asserted), at batch 8 x 256 (xLSTM 4 x 64): (a) one step's float32 loss
  and gradients on ft_matmul, on the eager path and unprotected, held
  against each other (RecurrentGemma at one period of its pattern, 3
  layers; xLSTM at 4 x 8 tokens, its loss and gradients at
  SSM_WITNESS_FACTOR x ``grad_witness``, the unprotected step with every
  weight one ulp up, where that exceeds the plain tolerances); (b) 10 bf16 steps
  protected and 10 unprotected from the same weights: finite losses, the
  last three below the first three, exactly 164, 144, 7 and 14
  ``ft_matmul`` launches a protected step and 3 eager batched expert
  products a MoE layer, nothing flagged at 1e-4, peak memory under 72 GB;
  (c) one SEU at site 0 of every block inside the loss (RecurrentGemma,
  DeepSeek), flagged and corrected in each, the loss and gradients the
  clean step's; (d) a primed trace of one protected step split into
  forward, backward and optimizer (every ``ft_matmul_tile`` in the
  forward). Last, the CLIs, all started together (each a host-bound
  process of its own): ``python -m repro_torch.launch.train --arch
  xlstm-350m --preset full --ft-linears`` for 3 steps at 4 x 64 (each
  step line ``ft_flagged 0``) and the LM CLIs of phases 7-9 and 11,
  ``python -m repro_torch.launch.serve --mode lm --ft`` for Gemma-3 1B,
  xLSTM-350M, Whisper-base and InternVL2-1B at their published widths
  and DeepSeek-V3 at its SMOKE size: each exits 0 with its ledger exact,
  2 faults a layer detected and corrected, and Whisper's ``injected=2
  detected=0 corrected=0`` (its blocks take no fault descriptor, as the
  reference's).

* the sharded FFT (phase 13, ``sharded_phase``): four processes on
  the one card, a gloo group over a file store (gloo takes CUDA tensors
  and stages them through the host, so its collective times are host
  copies, not NVLink), each driving ``plan(FFTSpec(..., mesh=...))`` on a
  1-D mesh of 4 and a 2 x 2 ``data x fft`` mesh (``make_fft_mesh``) at
  ``SHARD_CASES`` (complex64 2^20 x 256 and 2^25 x 8, whose N2 = 65536
  tail runs two local passes, complex128 2^20 x 16), inputs made on the
  card from SEED: the natural forward and inverse, the transposed forward
  against the digit-permuted spectrum, the TRANSPOSED_IN inverse, each on
  the rank's rows against ``torch.fft`` at ATOL * max|ref|, ``chunks=2``
  bitwise ``chunks=1``, one case through ``shard_signals`` (its ingest
  all-to-all); each call's ``block_fft`` launches held to the plan's.
  Every mesh call of this phase runs under the collective recorder
  (``repro_torch.analysis.record``), and ``audit.check_cell``, the
  checker of ``python -m repro_torch.analysis``, holds its counts and
  bytes exactly to ``plan.volume`` (or to the stated model of a call the
  plan does not model; a recompute's reruns apart); one case's pass-1
  (the offset twiddle) and pass-2 launches held to ``block_fft_plain`` on
  every rank; the local passes' device ms from a primed trace and each
  call's host ms. Then, on the same four ranks, the grouped two-side
  ABFT (``ft_distributed_fft``, ``SHARD_FT_CASES``: complex64 2^20 x 256
  with G = 4 on the 1-D mesh through the whole fault matrix: clean in
  both orders, four SEUs one on each rank, ``correct=False``, a double
  hit and its recompute, cs2- and cs3-row faults, ``chunks=2`` bitwise;
  clean and four SEUs on the 2 x 2 mesh, at 2^25 x 8 and at complex128
  2^20 x 16, threshold 1e-10), each SEU sized from the score formula to
  ``SHARD_FT_SCORE`` times the threshold: every verdict the scenario's,
  the corrected rows within ATOL * max|torch.fft|, the launches (pass 1
  two a transaction: the data rows and the checksum rows) and the
  collectives (all-to-all, data all-gather, one verdict all-reduce a
  transaction, the telemetry gathers) the plan's, host ms beside the
  plain transposed transform's and a primed trace of the local passes
  and the verdict's kernels; and the spectral consumers
  (``SHARD_SPECTRAL``: ``fft_convolve``/``correlate`` of (256, 2^19)
  complex64 signals with a (1, 2^19) kernel, nfft 2^20, ``chunks=2``
  bitwise, the packed real float32 convolution, ``power_spectrum`` in
  transposed order) on both meshes against ``torch.fft`` on the rank's
  rows, their launches and ``spectral_volume``'s collectives. The
  checked cases also hold the checksum-row launch at its row offset to
  ``block_fft_plain``. Then, on the same four ranks, the n-D drive
  (``shard_nd_drive``, its own timing line; each global grid over the 50
  MB L2): the slab ``fft2``/``ifft2`` of complex64 (4, 4096, 4096) on
  both meshes, complex128 (2, 4096, 4096) and the slab ``fftn`` of
  complex64 (1, 512, 512, 512) on the 1-D mesh; the pencil ``fft2`` of
  complex64 (1, 8192, 8192) on 2 x 2 in natural and transposed order and
  its TRANSPOSED_IN inverse, and the pencil ``fftn`` of (1, 512, 512,
  512) on 2 x 2 with ``chunks=2`` (the leading axis) bitwise
  ``chunks=1``; the real slab ``rfft2``/``irfft2`` of float32 (4, 4096,
  4096) on both meshes and the composed pencil path on the 1-D mesh;
  ``fft_convolve2`` of (4, 2048, 2048) float32 and complex64 pairs with a
  (33, 33) kernel on both meshes; the 2-D grouped ABFT
  (``SHARD_ND_FT``): complex64 (8, 4096, 4096), G = 4, through the whole
  fault matrix on the 1-D mesh and clean and four SEUs on 2 x 2, the real
  ABFT of float32 (8, 4096, 4096) clean and four SEUs, complex128 (4,
  2048, 2048) with G = 2 at threshold 1e-10. Each rank's block against
  ``torch.fft`` at ATOL * max|ref|, every call's launches and collectives
  the plan's (``plan.launches``, ``plan.volume``), every verdict the
  scenario's, host ms a call and rank, the local passes' device ms of a
  primed trace of the slab fft2 and the pencil's transposed fft2 beside
  their byte bound, every launch of one slab fft2 and one ifft2 (the
  received blocks read in place, the inverse's send buffer written
  by its R pass) and the checksum-grid launch at its row offset held
  to ``block_fft_plain`` on clones of their operands. Then one rank on NCCL in this process:
  ``make_fft_mesh(1)`` plans the local transform, whose ``fft`` launches
  the same two passes as ``plan.fft``, bitwise, timed beside it and
  ``torch.fft``; its ft plan is the local one (one ``abft_fft`` launch,
  the same result as without the mesh), ``fft_convolve(mesh=...)`` the
  local convolution and its rank-2 plan the local plan (bitwise, the
  same launches). Last on the four ranks, serving over the mesh
  (``shard_serve_drive``): a ``ServeRuntime`` over the mesh of 4
  (max_batch 16, 2 ms; rank 0 leads with three closed-loop client
  threads) serving ``SHARD_SERVE_TENANTS`` of ``serve_tenants`` (c64
  2^20, c128 8192, the real 2^17 bucket, the 2^16 spectrum in the mesh's
  transposed order, the 1024 x 1024 slab); then, on the mesh of 4 and
  on 2 x 2, an ft bucket at c64 2^20 with G = 4 through a runtime whose
  deadline never closes a group early: two closed groups of 16, each one
  batch, the first with one SEU in each checksum group. Each result
  against torch.fft of its zero-padded request at ATOL * max|ref| (the
  spectrum digit-permuted), each batch's launches on each rank
  ``plan.launches``', its data collectives ``plan.volume``'s and the
  verdict's, the runtime's own traffic the stated one, the same
  (command, bucket, fill) sequence on every rank, injected == detected ==
  located == corrected with no false alarm, every runtime thread ended
  and its groups destroyed; per bucket p50/p95/p99 host ms,
  requests/s, batches and mean fill, each rank's device ms of the bucket
  plan's local passes. The NCCL rank then serves a few requests through
  ``ServeRuntime(mesh=make_fft_mesh(1))``, bitwise a local runtime's.
* LM parallelism (phase 14, ``lmp_rank`` in phase 13's four ranks after
  their drives, its collectives under the same recorder, then
  ``lmp_phase`` here): (a) expert parallelism at
  DeepSeek-V3's published MoE widths (d 7168, 256 routed experts, top 8,
  moe_d_ff 2048, one shared expert, capacity factor 1.25: 80 slots an
  expert) on ``make_host_mesh(1, 4)``, 64 experts a rank (11.27 GB of f32
  weights), each expert drawn from its own seed: ``moe_block`` under
  ``use_mesh`` on 4 x 512 tokens at float32 and bf16, unprotected,
  protected and with one SEU in the shared expert's first product; every
  rank's y bitwise equal (SHA-256 digests), y against
  ``_moe_block_portable`` on all 256 experts rebuilt here after the ranks
  exit (2e-5 x max at float32, 2^-5 at bf16), one all-reduce of (T, d)
  over the model group a call plus scalars and nothing as large as an
  expert buffer, 3 ``ft_matmul`` launches a protected call a rank (the
  shared expert) and 0 unprotected, nothing flagged clean, the SEU
  flagged and corrected on every rank with y within tolerance of the
  clean call; host ms a call, a primed trace's device ms beside the
  experts' byte bound, peak memory a rank. (b) the sharded train step of
  Gemma-3 1B at its published widths cut to 4 layers (``LMP_REDUCED``),
  float32 activations, every linear protected, on ``make_host_mesh(2,
  2)``, batch 8 x 256: each rank stores its ``param_specs`` shards only;
  two steps at the schedule's steps 1 and 2 (its step 0 has lr 0, so
  both update) whose metrics are equal on every rank, whose losses, ce and gradient norms
  and gathered params match the one-rank ``make_train_step`` on the full
  batch run here (1e-5 relative; params 1e-6 or 4x the one-rank step's
  own drift from params one ulp up), 28 ``ft_matmul`` launches a step a
  rank, the first step's each held to ``ft_matmul_plain`` on its operands,
  the all-gathers, all-reduces and broadcasts a step the design's; then
  ``compress_allreduce_mean`` on a step's gradients over the data group
  within 0.05 of the exact mean, with a non-zero residual. (c)
  ``pipeline_apply`` of tanh(x @ w) at width 1152 over the four ranks as
  stages, 6 microbatches of 8 rows, within 1e-5 of the sequential product
  in 9 hops; the stage weights and their AdamW state sharded on 4 x 1,
  saved by ``save_sharded`` and restored by ``elastic_restore`` onto 2 x 1
  (ranks 0-1): bitwise the saved values, each leaf the new mesh's shard.

Beside the build, ``python -m repro_torch.analysis --strict --min-specs
84`` runs on this machine's torch (the repo lint and the plan audit on a
fake process group of 8 ranks, on the CPU); its nonzero exit fails the
run. After the build it prints, for every ``abft_fft_kernel`` and
``ft_matmul_tile`` instance, its registers and spill bytes (ptxas), and for
``ft_matmul`` the CTAs an SM runs (occupancy query); a spill in a fast
``abft_fft`` instance or in any ``ft_matmul`` instance, or fewer than two
CTAs a SM of the float32 128 x 128 instance, fails the run. One
``plan.ft_fft`` call must launch one ``abft_fft`` and one ``block_fft``
(the checksum FFT over [X.e2; X.e3]). It then holds each kernel against
its plain torch version on the card at the paths' shapes (``block_fft`` in
every pass's real layout, with its pass twiddle; ``abft_fft`` also bitwise
across repeated calls; ``ft_matmul`` also bitwise on integer operands,
across repeated calls and across its CTA tiles), times kernel, plain
version and the library call (``torch.fft``, ``torch.matmul``) with CUDA
events (and the protected MLP block against the unprotected one), takes
``abft_fft``'s and ``ft_matmul``'s kernels' device times per call from
``torch.profiler``, traces one ``plan.ft_fft`` call (its kernels, device
times and the device's idle share over the call), and runs one
``plan.fft`` call of each FFT case under ``torch.profiler``, which must
show exactly one CUDA kernel per pass, all ``block_fft``. For the
extensions it holds ``block_fft`` against its plain version in every
strided column layout they launch (in place), and runs one call of each
path under ``torch.profiler``: fft2 must be exactly two ``block_fft``
kernels and nothing else, fftn three, the copy path three and two copies;
the other kernels of a call (the Hermitian unpack's, the spectral
products') are listed; each path is timed against ``torch.fft`` and its
byte bound (input + output once at 3.35 TB/s). The last two lines are
the ``kernels`` JSON and ``{"ok": true, "device": ...}``. Any failed check
raises and exits non-zero; without a CUDA device it exits 1 and prints no
result.
"""
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
# the static analysis run beside phase 1: the lattice's specs on 8 fake
# ranks (the reference's 84), and the seconds it may take
ANALYSIS_SPECS = 84
ANALYSIS_TIMEOUT = 300
ATOL = {"complex64": 4e-5, "complex128": 1e-11, "float32": 4e-5,
        "float64": 1e-11}
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_FLOPS = {"complex64": 67e12,          # fp32 outside the tensor cores
              "complex128": 34e12}         # fp64 outside the tensor cores
# (dtype, log2 N, batch): single pass, two passes, three passes, fp64
FFT_CASES = (("complex64", 13, 1024), ("complex64", 20, 256),
             ("complex64", 25, 8), ("complex128", 13, 1024))
FT_CASES = (("complex64", 13, 1024), ("complex128", 13, 1024))
FT_TRANSACTIONS = 4
SEU_STEPS = 8


ABFT_PARTS = ("y", "delta", "X.e2", "X.e3", "Y.e2", "Y.e3")

# the checked-GEMM path at Phi-4-mini 3.8B's MLP widths, (M, K, N)
GEMM_SHAPES = ((2048, 3072, 8192), (2048, 8192, 3072))
GEMM_FT_THRESHOLD = 1e-3
# float32: a clean product and each kernel part to 1e-4 * max|reference|
# (float32 sums of K <= 8192 terms in another order: sqrt(K) * 2^-24 is
# about 5e-6); an element the decode corrected carries the rounding of the
# checksum divergence d2, which scales with the column sums: 1e-4 * max
# |e2^T Y|
GEMM_TOL = 1e-4
BF16_STEP = 2.0 ** -7      # one bf16 rounding step, relative
# the protected bf16 block against the unprotected one: 2^-6 * max|y| (the
# unprotected path rounds W to bf16, 2^-9 relative; both round the three
# products, the gate and the residual sum to bf16)
MLP_TOL = 2.0 ** -6
MLP_BATCH, MLP_TOKENS = 4, 512
# the Poisson schedule over the MLP's three sites: 5 faults in 6 steps, each
# |eps| in [6, 28]; EPS_FLOOR keeps every fault above the detection
# threshold and the location noise at these widths
MLP_STEPS, MLP_SCHEDULE_SEED, MLP_EPS_SCALE, EPS_FLOOR = 6, 6, 16.0, 4.0
FP32_FLOPS = 67e12                         # fp32 outside the tensor cores


def delta_noise(delta_clean):
    """The roundoff scale of a clean call's per-signal divergence: 4x its
    largest value in the plain version (all zeros without per-signal
    checksums: then the dtype's epsilon, so the kernel must write ~0)."""
    import torch
    eps = torch.finfo(delta_clean.dtype).eps
    return 4.0 * max(delta_clean.abs().max().item(), eps)


def abft_vs_plain(got, want, dtype, noise, what):
    """Hold the fused kernel's ``(y, delta, cs)`` against its plain version
    part by part; returns ``{part: (max abs err, err / tol)}``.

    y: ATOL * max|y|. Each checksum row [X.e2, X.e3, Y.e2, Y.e3] of each
    group g: ATOL * max_n |row[g]| -- per row, because the e3 rows grow
    with the 1-based signal id and one tolerance over all of them would
    hide a wrong small row. delta, elementwise: 1e-3 * |plain| (the
    injected signal's divergence is large) plus ``noise``, the roundoff
    scale of clean signals.
    """
    y, delta, cs = got
    yp, dp, csp = want
    out = {}

    def hold(part, err, tol):
        ratio = (err / tol).max().item()
        out[part] = (err.max().item(), ratio)
        check(ratio <= 1.0, f"{what} {part}: err {err.max().item()} "
                            f"(worst {ratio:.3g} x tol)")

    hold("y", (y - yp).abs().max(), ATOL[dtype] * yp.abs().max())
    for j, part in enumerate(ABFT_PARTS[2:]):
        hold(part, (cs[j] - csp[j]).abs().amax(-1),
             ATOL[dtype] * csp[j].abs().amax(-1))
    hold("delta", (delta - dp).abs(), 1e-3 * dp.abs() + noise)
    return {k: out[k] for k in ABFT_PARTS}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(msg):
    print(msg, flush=True)


_PTXAS_FUNCTION = re.compile(
    r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGISTERS = re.compile(r"Used (\d+) registers")
_TYPE_CODES = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
# the second type is a back-reference (S<n>_) when it repeats the first
_FTMM_INSTANCE = re.compile(r"ft_matmul_tileI(f|13__nv_bfloat16)"
                            r"(f|13__nv_bfloat16|S\d*_)Li(\d+)ELi(\d+)E")


def ptxas_info(log: str) -> dict:
    """``{mangled function: {"registers", "stack", "spill_stores",
    "spill_loads"}}`` from the ``-Xptxas -v`` lines of a build log."""
    out, fn = {}, None
    for line in log.splitlines():
        hit = _PTXAS_FUNCTION.search(line)
        if hit:
            fn = hit[1]
            out.setdefault(fn, {})
        elif fn is not None:
            if hit := _PTXAS_FRAME.search(line):
                out[fn].update(stack=int(hit[1]), spill_stores=int(hit[2]),
                               spill_loads=int(hit[3]))
            if hit := _PTXAS_REGISTERS.search(line):
                out[fn]["registers"] = int(hit[1])
    return out


_ABFT_INSTANCE = re.compile(r"abft_fft_kernelI(6float2|7double2)Lb([01])E")


def abft_ptxas(log: str) -> list:
    """Registers, spill bytes and stack of every ``abft_fft_kernel``
    instance in a build log: ``[{"dtype", "fast", "registers",
    "spill_stores", "spill_loads", "stack"}]`` (fast: the register-codelet
    instance; else the generic stages)."""
    rows = []
    for fn, info in ptxas_info(log).items():
        hit = _ABFT_INSTANCE.search(fn)
        if hit:
            rows.append({"dtype": "complex64" if hit[1] == "6float2"
                         else "complex128", "fast": hit[2] == "1", **info})
    return sorted(rows, key=lambda r: (r["dtype"], r["fast"]))


def ft_matmul_ptxas(log: str) -> list:
    """Registers, spill bytes and stack of every ``ft_matmul_tile``
    instance in a build log: ``[{"x", "w", "tile", "registers",
    "spill_stores", "spill_loads", "stack"}]``."""
    rows = []
    for fn, info in ptxas_info(log).items():
        hit = _FTMM_INSTANCE.search(fn)
        if hit:
            w = hit[1] if hit[2].startswith("S") else hit[2]
            rows.append({"x": _TYPE_CODES[hit[1]], "w": _TYPE_CODES[w],
                         "tile": [int(hit[3]), int(hit[4])], **info})
    return sorted(rows, key=lambda r: (r["x"], r["w"], r["tile"]))


def gemm_operands(dev, m, k, n, dtype="float32"):
    """Seeded (M, K) activations ~N(0, 1) in ``dtype`` and float32 (K, N)
    weights ~N(0, 1/K), so the product is ~N(0, 1)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + m + 3 * k + 7 * n)
    x = torch.randn((m, k), device=dev, generator=gen)
    w = torch.randn((k, n), device=dev, generator=gen) / math.sqrt(k)
    return x.to(getattr(torch, dtype)), w


def gemm_plan_phase(dev):
    """(a) ``plan(GEMMSpec(...)).ft_matmul`` at full width: clean products
    against a float64 reference, then an SEU campaign of (F, 4)
    descriptors. Returns the campaign's counts."""
    import numpy as np
    import torch
    from repro_torch.core.gemm import GEMMSpec, plan
    from repro_torch.core.plan import FTConfig
    from repro_torch.kernels.ft_matmul import ft_matmul

    rng = np.random.default_rng(SEED)
    seu = dict(injected=0, flagged=0, corrected=0, uncorrectable=0,
               false_alarms=0, clean_calls=0)
    for m, k, n in GEMM_SHAPES:
        x, w = gemm_operands(dev, m, k, n)
        p = plan(GEMMSpec((m, k, n), dtype="float32",
                          ft=FTConfig(threshold=GEMM_FT_THRESHOLD)))
        check(p.backend == "fused", f"GEMM plan {p}: backend {p.backend}")
        ref = (x.double() @ w.double()).float()
        tol = GEMM_TOL * ref.abs().max().item()
        corr_tol = GEMM_TOL * ref.sum(0).abs().max().item()
        before = ft_matmul.launches
        y, s = p.ft_matmul(x, w)
        check(ft_matmul.launches == before + 1,
              f"plan.ft_matmul {(m, k, n)}: "
              f"{ft_matmul.launches - before} ft_matmul launches")
        clean_err = (y - ref).abs().max().item()
        check(clean_err <= tol, f"ft_matmul clean {(m, k, n)}: "
                                f"{clean_err} > {tol}")
        check(float(s["flagged"]) == 0, f"ft_matmul clean {(m, k, n)}: "
                                        f"{float(s['flagged'])} flagged")
        seu["clean_calls"] += 1
        # one fault; two and three in distinct columns; a clean call; a
        # disabled descriptor
        worst = worst_hit = 0.0
        for nf, enable in ((1, 1), (2, 1), (0, 1), (3, 1), (1, 0)):
            cols = rng.choice(n, size=nf, replace=False)
            rows = rng.integers(0, m, size=nf)
            eps = rng.choice([-1.0, 1.0], size=nf) * rng.uniform(
                20.0, 200.0, size=nf)
            inj = None if nf == 0 else torch.tensor(
                np.stack([rows, cols, np.full(nf, enable), eps], -1),
                dtype=torch.float32)
            y, s = p.ft_matmul(x, w, inject=inj)
            armed = nf * enable
            if armed:
                seu["injected"] += armed
                seu["flagged"] += int(s["flagged"])
                seu["corrected"] += int(s["corrected"])
                seu["uncorrectable"] += int(s["uncorrectable"])
            else:
                seu["false_alarms"] += int(s["flagged"])
                seu["clean_calls"] += 1
            diff = (y - ref).abs()
            if armed:
                at = (torch.as_tensor(rows, device=dev),
                      torch.as_tensor(cols, device=dev))
                hit_err = diff[at].max().item()
                check(hit_err <= corr_tol,
                      f"ft_matmul {(m, k, n)} corrected elements: "
                      f"{hit_err} > {corr_tol}")
                diff[at] = 0.0
                worst_hit = max(worst_hit, hit_err)
            err = diff.max().item()
            check(err <= tol, f"ft_matmul {(m, k, n)} inject {nf}x"
                              f"{enable}: {err} > {tol}")
            worst = max(worst, err)
        log(f"plan.ft_matmul f32 {(m, k, n)} backend={p.backend}: clean err "
            f"{clean_err:.3e} (tol {tol:.3e}); campaign worst err "
            f"{worst:.3e}, worst corrected element {worst_hit:.3e} (tol "
            f"{corr_tol:.3e})")
        del x, w, ref, y
    check(seu["injected"] > 0 and seu["injected"] == seu["flagged"]
          == seu["corrected"] and seu["uncorrectable"] == 0
          and seu["false_alarms"] == 0, f"GEMM SEU campaign: {seu}")
    return seu


def mlp_phase(dev):
    """(b) The protected SwiGLU MLP block of Phi-4-mini 3.8B at full width:
    rmsnorm -> mlp -> residual, bf16 activations, f32 weights, through
    ``FTContext``; then a Poisson fault schedule over its three sites.
    Returns the campaign's counts, the launches of one call and the
    protected and unprotected block as functions of no arguments."""
    import numpy as np
    import torch
    from repro_torch.configs import phi4_mini_3p8b
    from repro_torch.core.ft import FTPolicy, poisson_schedule
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.models import layers

    cfg = phi4_mini_3p8b.CONFIG
    d, d_ff = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = layers.make_mlp_params(gen, d, d_ff, cfg.act,
                                    dtype=getattr(torch, cfg.param_dtype),
                                    device=dev)
    norm_p = layers.make_norm_params(d, cfg.norm, device=dev)
    x = torch.randn((MLP_BATCH, MLP_TOKENS, d), device=dev,
                    generator=gen).to(getattr(torch, cfg.dtype))
    policy = FTPolicy(protect_linears=True, threshold=GEMM_FT_THRESHOLD)
    nbytes = sum(t.numel() * t.element_size() for t in params.values())

    def block(ft=None):
        h = layers.norm(norm_p, x, cfg.norm, cfg.norm_eps)
        return x + layers.mlp(params, h, cfg.act, ft=ft)

    plain = block()
    ctx = layers.FTContext(policy)
    before = ft_matmul.launches
    clean = block(ctx)
    per_call = ft_matmul.launches - before
    check(per_call == 3 and ctx.sites == 3,
          f"protected MLP: {per_call} ft_matmul launches, {ctx.sites} sites")
    summ = ctx.summary()
    check(float(summ["ft_flagged"]) == 0,
          f"protected MLP clean: {float(summ['ft_flagged'])} flagged")
    ymax = clean.float().abs().max().item()
    err = (clean.float() - plain.float()).abs().max().item()
    check(err <= MLP_TOL * plain.float().abs().max().item(),
          f"protected MLP vs unprotected: {err}")
    log(f"MLP {cfg.name} d={d} d_ff={d_ff} x=({MLP_BATCH}, {MLP_TOKENS}) "
        f"{cfg.dtype}, params {cfg.param_dtype} {nbytes / 1e6:.0f} MB: "
        f"protected vs unprotected err {err:.3e} (tol "
        f"{MLP_TOL * ymax:.3e}), max score "
        f"{float(summ['ft_max_score']):.3e}, {per_call} launches per call")

    m = MLP_BATCH * MLP_TOKENS
    sched = poisson_schedule(np.random.default_rng(MLP_SCHEDULE_SEED),
                             steps=MLP_STEPS, rate_per_step=0.8, tiles=3,
                             bs=m, n=d, eps_scale=MLP_EPS_SCALE)
    check(sched.num_faults > 0 and all(abs(e[4]) >= EPS_FLOOR
                                       for e in sched.entries),
          f"MLP schedule: {sched.entries}")
    seu = dict(injected=0, flagged=0, corrected=0, false_alarms=0,
               sites=set())
    for step in range(MLP_STEPS):
        inj = sched.for_step_gemm(step)
        ctx = layers.FTContext(policy, inject=inj)
        y = block(ctx)
        summ = ctx.summary()
        err = (y.float() - clean.float()).abs().max().item()
        if float(inj[0, 3]) > 0:
            eps = abs(float(inj[0, 4]))
            seu["injected"] += 1
            seu["sites"].add(int(inj[0, 0]))
            seu["flagged"] += int(summ["ft_flagged"])
            seu["corrected"] += int(summ["ft_corrected"])
            # the fused path corrects the stored bf16 product: the
            # corrected element keeps about 2^-8 |eps| from each of the two
            # bf16 roundings (c + eps, then d2)
            tol = BF16_STEP * eps + MLP_TOL * ymax
        else:
            eps = 0.0
            seu["false_alarms"] += int(summ["ft_flagged"])
            tol = MLP_TOL * ymax
        check(err <= tol, f"MLP step {step} (site {int(inj[0, 0])}, eps "
                          f"{eps}): err {err} > {tol}")
    seu["sites"] = sorted(seu["sites"])
    log(f"MLP SEU campaign ({MLP_STEPS} steps): {json.dumps(seu)}")
    check(seu["injected"] == sched.num_faults == seu["flagged"]
          == seu["corrected"] and seu["false_alarms"] == 0,
          f"MLP SEU campaign: {seu}")
    return seu, per_call, (lambda: block(layers.FTContext(policy)), block)


def gemm_kernel_phase(dev):
    """(c) ``ft_matmul`` against ``ft_matmul_plain`` on the card: the
    paths' shapes in float32 and bf16 x f32 (at tolerance), each injected
    call also bitwise equal across every CTA tile, integer operands over
    four tile shapes (bitwise), and two calls (bitwise). Returns ({part:
    max abs err}, worst err / tol)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ft_matmul import (KERNEL_TILES, _launch,
                                               ft_matmul, ft_matmul_plain)

    parts = dict.fromkeys(("c", "out2", "pred2", "out3", "pred3"), 0.0)
    worst = 0.0
    for (m, k, n) in GEMM_SHAPES:
        for xdtype in ("float32", "bfloat16"):
            x, w = gemm_operands(dev, m, k, n, xdtype)
            inj = torch.tensor([[m - 1, n // 3, 1, 75.0], [5, 7, 1, -30.0]])
            for inject in (None, inj):
                got = ft_matmul(x, w, inject=inject)
                want = ft_matmul_plain(x, w, inject=inject)
                msg = []
                for part in parts:
                    g = getattr(got, part).float()
                    r = getattr(want, part).float()
                    step = BF16_STEP if (part == "c"
                                         and xdtype == "bfloat16") \
                        else GEMM_TOL
                    err = (g - r).abs().max().item()
                    tol = step * r.abs().max().item()
                    check(err <= tol, f"ft_matmul vs plain {(m, k, n)} "
                                      f"{xdtype} {part}: {err} > {tol}")
                    parts[part] = max(parts[part], err)
                    worst = max(worst, err / tol)
                    msg.append(f"{part} {err:.3e} ({err / tol:.2f} of tol)")
                log(f"ft_matmul vs plain {(m, k, n)} x {xdtype} inject="
                    f"{inject is not None}: " + ", ".join(msg))
            for cta in ((tm, tn) for tm in KERNEL_TILES
                        for tn in KERNEL_TILES):
                other = _launch(x, w, inj, *cta)
                for part in parts:
                    check(torch.equal(getattr(other, part),
                                      getattr(got, part)),
                          f"ft_matmul {(m, k, n)} {xdtype}: CTA tile {cta} "
                          f"changes {part}")
            del x, w, got, want, other
    rng = np.random.default_rng(SEED)
    x = torch.tensor(rng.integers(-4, 5, (256, 128)), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.integers(-4, 5, (128, 128)), dtype=torch.float32,
                     device=dev)
    inj = torch.tensor([[171.0, 40.0, 1.0, 333.0], [3.0, 127.0, 1.0, -50.0]])
    for bm, bk, bn in ((128, 128, 128), (64, 64, 64), (128, 64, 128),
                       (64, 128, 64)):
        for inject in (None, inj):
            got = ft_matmul(x, w, bm=bm, bk=bk, bn=bn, inject=inject)
            want = ft_matmul_plain(x, w, inject=inject)
            for part in parts:
                check(torch.equal(getattr(got, part), getattr(want, part)),
                      f"ft_matmul integer operands tiles {(bm, bk, bn)} "
                      f"inject={inject is not None}: {part} not bitwise")
    x, w = gemm_operands(dev, *GEMM_SHAPES[0])
    a, b = ft_matmul(x, w), ft_matmul(x, w)
    for part in parts:
        check(torch.equal(getattr(a, part), getattr(b, part)),
              f"ft_matmul: two calls differ in {part}")
    log("ft_matmul: integer operands bitwise equal to the plain version "
        "over 4 tile shapes x (clean, injected); two calls bitwise equal; "
        "every CTA tile bitwise equal at the paths' shapes")
    return parts, worst


def gemm_time_phase(dev, cuda_ms, device_kernels):
    """(d) CUDA-event times of ``ft_matmul`` (with the CTA tile it picks),
    its plain version, ``torch.matmul`` and the plan's
    unchecked and checked products; the device time of its kernels per
    call from torch.profiler (``x_checksums`` and a ``strip_reduce`` for the
    input checksums, ``ft_matmul_tile`` and a ``strip_reduce`` for the
    product and its strips). Returns one row per case."""
    import torch
    from repro_torch.core.gemm import GEMMSpec, plan
    from repro_torch.core.plan import FTConfig
    from repro_torch.kernels.ft_matmul import (device_cta_tile, ft_matmul,
                                               ft_matmul_plain)

    rows = []
    cases = [(shape, "float32") for shape in GEMM_SHAPES]
    cases.append((GEMM_SHAPES[0], "bfloat16"))
    for (m, k, n), xdtype in cases:
        x, w = gemm_operands(dev, m, k, n, xdtype)
        xf = x.float()        # torch.matmul takes one dtype: the promoted
        cta = device_cta_tile(m, n, 128, 128, x.dtype, w.dtype, dev)
        ms = cuda_ms(lambda: ft_matmul(x, w), iters=10, warmup=2)
        plain = cuda_ms(lambda: ft_matmul_plain(x, w), iters=10, warmup=2)
        lib = cuda_ms(lambda: torch.matmul(xf, w), iters=10, warmup=2)
        calls = 5
        kern = device_kernels(lambda: [ft_matmul(x, w) for _ in range(calls)])
        dev_ms = {}
        for part, per_call in (("ft_matmul_tile", 1), ("strip_reduce", 2),
                               ("x_checksums", 1)):
            got = [t for name, t in kern if part in name]
            check(len(got) == per_call * calls,
                  f"ft_matmul {(m, k, n)} under torch.profiler: {len(got)} "
                  f"{part} for {calls} calls")
            dev_ms[part] = sum(got) / calls
        tile_ms, strip_ms = dev_ms["ft_matmul_tile"], dev_ms["strip_reduce"]
        xsum_ms = dev_ms["x_checksums"]
        # each input read once, each output written once: x and w in; c and
        # the four strips out. Operations: the product, the input checksums
        # (3mk), the predicted strips (4kn) and the output strips (3mn)
        nbytes = (x.numel() * x.element_size() + w.numel() * 4
                  + m * n * x.element_size() + 4 * n * 4)
        flops = 2 * m * k * n + 3 * m * k + 4 * k * n + 3 * m * n
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        p = plan(GEMMSpec((m, k, n), dtype=xdtype,
                          ft=FTConfig(threshold=GEMM_FT_THRESHOLD)))
        mm = cuda_ms(lambda: p.matmul(x, w), iters=10, warmup=2)
        ft = cuda_ms(lambda: p.ft_matmul(x, w), iters=10, warmup=2)
        row = {"shape": [m, k, n], "x": xdtype, "w": "float32", "ms": ms,
               "cta": list(cta),
               "device_ms": sum(dev_ms.values()), "tile_device_ms": tile_ms,
               "strip_device_ms": strip_ms, "checksum_device_ms": xsum_ms,
               "plain_ms": plain,
               "library_ms": lib, "bound_ms": max(tb, tf),
               "bound_by": "bytes" if tb >= tf else "operations",
               "tflops": flops / ms / 1e9, "plan_matmul_ms": mm,
               "plan_ft_matmul_ms": ft, "ft_overhead": ft / mm - 1}
        rows.append(row)
        log(f"times ft_matmul {(m, k, n)} x {xdtype}: kernel {ms:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s, CTA tile {cta[0]}x{cta[1]}; "
            f"device {tile_ms:.4f} ms ft_matmul_tile + {xsum_ms:.4f} ms "
            f"x_checksums + {strip_ms:.4f} ms strip_reduce x2), plain "
            f"{plain:.4f} ms, torch.matmul {lib:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"plan.matmul {mm:.4f} ms, plan.ft_matmul {ft:.4f} ms "
            f"(checked-GEMM overhead {ft / mm - 1:+.1%})")
        del x, w, xf
    return rows


# The local extensions at full width: typical user grids, each well beyond
# the 50 MB L2. Each case is (label, dtype of its tolerance, block_fft
# launches a call, the count of the call's other CUDA kernels when it is
# fixed (None: listed, not checked), make inputs, the port's call,
# torch.fft's call); inputs are made from SEED.
FT_IFFT_CASE = ("complex64", 13, 1024)    # (dtype, log2 N, batch), bs = 1
# (dtype, shape, axis) of the block_fft launches over strided columns that
# the extensions run, held against the plain version in phase 4
AXIS_LAYOUTS = (("complex64", (4, 4096, 4096), 1),
                ("complex128", (2, 4096, 4096), 1),
                ("complex64", (4, 4096, 2049), 1),
                ("complex64", (512, 512, 512), 1),
                ("complex64", (512, 512, 512), 0))


def _seeded(dev, shape, dtype, salt=0):
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + sum(shape) + salt)
    return torch.randn(shape, dtype=getattr(torch, dtype), device=dev,
                       generator=gen)


def extension_cases(dev):
    """The extensions' paths as a user calls them, at full width."""
    import torch
    from repro_torch.core.fft import (FFTSpec, extensions, fft_convolve2,
                                      make_plan, plan, spectral)

    def rfft_pair(dtype, shape):
        cdt = "complex128" if dtype == "float64" else "complex64"
        make = lambda: (_seeded(dev, shape, dtype),)         # noqa: E731
        spec = lambda: (torch.fft.rfft(_seeded(dev, shape, dtype)),)  # noqa
        passes = make_plan(shape[-1] // 2).num_passes
        return [
            (f"rfft {dtype} {shape}", cdt, passes, None, make,
             extensions.rfft, torch.fft.rfft),
            (f"irfft {dtype} {shape}", dtype, passes, None, spec,
             extensions.irfft, torch.fft.irfft)]

    def grid(dtype, shape, rank, copies=0):
        # copies: the other kernels of a call (the copy path's two)
        p = plan(FFTSpec(shape=shape, dtype=dtype, rank=rank))
        make = lambda: (_seeded(dev, shape, dtype),)         # noqa: E731
        dims = tuple(range(-rank, 0))
        launches = sum(make_plan(n).num_passes for n in shape[-rank:])
        name = "fftn" if rank == 3 else "fft2"
        return [
            (f"{name} {dtype} {shape}", dtype, launches, copies, make,
             p.fft, lambda x: torch.fft.fftn(x, dim=dims)),
            (f"i{name} {dtype} {shape}", dtype, launches, copies, make,
             p.ifft, lambda x: torch.fft.ifftn(x, dim=dims))]

    def conv_ref(a, v):
        n = spectral._conv_nfft(a.shape[-1], v.shape[-1])
        out = torch.fft.ifft(torch.fft.fft(a, n=n) * torch.fft.fft(v, n=n))
        return out[..., :a.shape[-1] + v.shape[-1] - 1]

    def conv_real_ref(a, v, corr=False):
        la, lv = a.shape[-1], v.shape[-1]
        n = spectral._conv_nfft(la, lv)
        if corr:
            v = v.flip(-1)
        return torch.fft.irfft(torch.fft.rfft(a, n=n) * torch.fft.rfft(v, n=n),
                               n=n)[..., :la + lv - 1]

    sig, taps = (1024, 7168), (1025,)
    real_sig = lambda: (_seeded(dev, sig, "float32"),         # noqa: E731
                        _seeded(dev, taps, "float32", 1))
    cplx_sig = lambda: (_seeded(dev, sig, "complex64"),       # noqa: E731
                        _seeded(dev, taps, "complex64", 1))
    img = lambda: (_seeded(dev, (4, 2048, 2048), "float32"),  # noqa: E731
                   _seeded(dev, (33, 33), "float32", 1))

    def conv2_ref(a, v):
        s = (4096, 4096)
        full = torch.fft.irfft2(torch.fft.rfft2(a, s=s)
                                * torch.fft.rfft2(v, s=s), s=s)
        return full[..., :2080, :2080]

    r2 = (4, 4096, 4096)
    cases = (rfft_pair("float32", (1024, 16384))
             + rfft_pair("float64", (1024, 16384))
             + rfft_pair("float32", (256, 1 << 21))
             + grid("complex64", (4, 4096, 4096), 2)
             + grid("complex128", (2, 4096, 4096), 2)
             + [(f"rfft2 float32 {r2}", "complex64", 2, None,
                 lambda: (_seeded(dev, r2, "float32"),), extensions.rfft2,
                 torch.fft.rfft2),
                (f"irfft2 float32 {r2}", "float32", 2, None,
                 lambda: (torch.fft.rfft2(_seeded(dev, r2, "float32")),),
                 extensions.irfft2, torch.fft.irfft2)]
             + grid("complex64", (512, 512, 512), 3)
             + [("fft_convolve float32 (1024, 7168) * 1025", "float32", 2,
                 None, real_sig, spectral.fft_convolve, conv_real_ref),
                ("correlate float32 (1024, 7168) * 1025", "float32", 2,
                 None, real_sig, spectral.correlate,
                 lambda a, v: conv_real_ref(a, v, corr=True)),
                ("fft_convolve complex64 (1024, 7168) * 1025", "complex64",
                 3, None, cplx_sig, spectral.fft_convolve, conv_ref),
                ("fft_convolve2 float32 (4, 2048, 2048) * (33, 33)",
                 "float32", 6, None, img, fft_convolve2, conv2_ref),
                ("power_spectrum complex64 (1024, 8192)", "float32", 1,
                 None, lambda: (_seeded(dev, (1024, 8192), "complex64"),),
                 spectral.power_spectrum,
                 lambda x: torch.fft.fft(x).abs() ** 2 / x.shape[-1]),
                ("power_spectrum real float32 (1024, 16384)", "float32", 1,
                 None, lambda: (_seeded(dev, (1024, 16384), "float32"),),
                 lambda x: spectral.power_spectrum(x, real=True),
                 lambda x: torch.fft.rfft(x).abs() ** 2 / x.shape[-1])]
             # a non-last axis over 8192 points: the copy path
             + grid("complex64", (2, 16384, 512), 2, copies=2)[:1])
    return cases


def extensions_drive(cases):
    """Drive every extension path once, as a user calls it: each result
    against torch.fft's at ATOL[dtype] * max|ref|, and the block_fft
    launches of the call by the wrapper's count. Returns one row a path."""
    import torch
    from repro_torch.kernels.stockham import block_fft

    rows = []
    for label, dtype, blk, _, make, port, ref in cases:
        inp = make()
        before = block_fft.launches
        got = port(*inp)
        launches = block_fft.launches - before
        want = ref(*inp)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{label}: {tuple(got.shape)} {got.dtype} against torch.fft's "
              f"{tuple(want.shape)} {want.dtype}")
        err = (got - want).abs().max().item()
        tol = ATOL[dtype] * want.abs().max().item()
        check(err <= tol, f"{label}: err {err} > {tol}")
        check(launches == blk, f"{label}: {launches} block_fft launches, "
                               f"not {blk}")
        nbytes = sum(t.numel() * t.element_size() for t in inp) \
            + got.numel() * got.element_size()
        rows.append({"path": label, "max_abs_err": err, "tol": tol,
                     "block_fft_launches": launches, "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        log(f"extension {label}: err {err:.3e} tol {tol:.3e}, {launches} "
            f"block_fft launches")
        del inp, got, want
    return rows


def ft_ifft_campaign(dev):
    """``ft_ifft`` (complex64 (1024, 8192), T = 4, bs = 1) over an SEU
    schedule: injected == detected == located == corrected, no flag on a
    clean call, the output within ATOL of ``torch.fft.ifft``."""
    import numpy as np
    import torch
    from repro_torch.core.fft import extensions
    from repro_torch.core.ft import poisson_schedule

    dtype, logn, b = FT_IFFT_CASE
    n, bs = 1 << logn, 1
    x = _seeded(dev, (b, n), dtype)
    ref = torch.fft.ifft(x)
    tol = ATOL[dtype] * ref.abs().max().item()
    kw = dict(transactions=FT_TRANSACTIONS, bs=bs)
    seu = {"injected": 0, "detected": 0, "located": 0, "corrected": 0,
           "false_alarms": 0, "clean_calls": 0}
    sched = poisson_schedule(np.random.default_rng(SEED + 1),
                             steps=SEU_STEPS, rate_per_step=0.8,
                             tiles=b // bs, bs=bs, n=n)
    worst = 0.0
    for step in range(-1, SEU_STEPS):     # step -1: a clean call
        inj = None if step < 0 else sched.for_step(step)
        res = extensions.ft_ifft(x, inject=inj, **kw)
        flagged = res.flagged.cpu().numpy()
        if inj is not None and float(inj[3]) > 0:
            seu["injected"] += 1
            seu["detected"] += int(flagged.sum() == 1)
            want_sig = int(inj[0]) * bs + int(inj[1])
            seu["located"] += int(flagged.sum() == 1 and int(
                res.location.cpu().numpy()[flagged][0]) == want_sig)
            seu["corrected"] += int(res.corrected)
        else:
            seu["false_alarms"] += int(flagged.sum())
            seu["clean_calls"] += 1
        err = (res.y - ref).abs().max().item()
        check(err <= tol, f"ft_ifft step {step}: err {err} > {tol}")
        worst = max(worst, err)
    log(f"ft_ifft {dtype} N=2^{logn} B={b} T={FT_TRANSACTIONS} bs={bs}: "
        f"SEU campaign {json.dumps(seu)}; worst err {worst:.3e} (tol "
        f"{tol:.3e})")
    check(seu["injected"] > 0 and seu["injected"] == seu["detected"]
          == seu["located"] == seu["corrected"] and seu["false_alarms"] == 0,
          f"ft_ifft SEU campaign: {seu}")
    return dict(seu, max_abs_err=worst, tol=tol)


def extensions_measure(cases, rows, cuda_ms, device_kernels):
    """Per path: one call's CUDA kernels under torch.profiler (the
    block_fft launches the wrapper counted; fft2 two and fftn three and
    nothing else, the copy path two copies; the other kernels are listed),
    and the port's and torch.fft's CUDA-event times beside the byte bound
    (input + output once)."""
    for row, (label, _, blk, n_other, make, port, ref) in zip(rows, cases):
        inp = make()
        kern = []
        for _ in range(3):      # the tracer can drop an event, never add one
            kern = device_kernels(lambda: port(*inp))
            if sum("block_fft" in k for k, _ in kern) == blk:
                break
        names = [k for k, _ in kern]
        n_blk = sum("block_fft" in k for k in names)
        others = [k[:60] for k in names if "block_fft" not in k]
        check(n_blk == blk and n_other in (None, len(others)),
              f"{label} under torch.profiler: {n_blk} block_fft (want "
              f"{blk}) and {len(others)} other kernels (want {n_other}): "
              f"{others}")
        ms = cuda_ms(lambda: port(*inp), iters=5, warmup=1)
        lib = cuda_ms(lambda: ref(*inp), iters=5, warmup=1)
        row.update(ms=ms, torch_fft_ms=lib, kernels=len(names),
                   block_fft_device_ms=sum(t for k, t in kern
                                           if "block_fft" in k),
                   device_ms=sum(t for _, t in kern), other_kernels=others)
        log(f"times {label}: port {ms:.4f} ms ({len(names)} kernels, "
            f"{n_blk} block_fft {row['block_fft_device_ms']:.4f} ms on the "
            f"device), torch.fft {lib:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms; others: {others}")
        del inp


# The serving runtime at full width: the tenants users of the paper's grid
# send (turbofft_bench: N from 2^3 to 2^25, batch up to 1024), each a
# (bucket label, request shapes, dtype, submit kwargs, requests, torch.fft
# of a request zero-padded to the bucket).
SERVE_CONFIG = dict(max_batch=16, workers=2, deadline_ms=2.0,
                    queue_depth=512)
SERVE_CLIENTS = 4            # client 0 runs the ft campaign
SERVE_WINDOW = 48            # requests a client keeps in flight (3 x 48
                             # over 6 buckets: enough to fill batches of 16)
FT_GROUPS = 8                # closed groups of max_batch ft requests
SERVE_MEMORY_LIMIT = 2e9     # bytes of device memory for the whole phase
CONV_SHAPE, CONV_TAPS = (16, 7168), 1025
SERVE_CLI = (("fft", "n=1048576,batch=16"),
             ("serve", "n=8192,workers=2,max_batch=16,deadline_ms=2"))


def serve_tenants():
    import torch

    def fft_to(n):
        return lambda x: torch.fft.fft(x, n=n)

    return (
        ("fft:8192:c64", ((6000,), (8192,)), "complex64", {}, 96,
         fft_to(8192)),
        ("fft:8192:c128", ((8192,),), "complex128", {}, 48, fft_to(8192)),
        ("fft:1048576:c64", ((700000,), (1 << 20,)), "complex64", {}, 32,
         fft_to(1 << 20)),
        ("fft:131072:c64:real", ((100000,),), "float32", {"real": True}, 48,
         lambda x: torch.fft.rfft(x, n=1 << 17)),
        ("spectrum:65536:c64", ((50000,),), "complex64", {"op": "spectrum"},
         48, lambda x: torch.fft.fft(x, n=1 << 16).abs().square()
         / (1 << 16)),
        ("fft:1024x1024:c64", ((1000, 1000),), "complex64", {}, 48,
         lambda x: torch.fft.fft2(x, s=(1024, 1024))),
    )


def _serve_request(dev, i, shape, dtype, on_card):
    """Request ``i``: seeded, as a numpy array or a tensor on the card."""
    import numpy as np
    if on_card:
        return _seeded(dev, shape, dtype, salt=i)
    rng = np.random.default_rng(SEED + i)
    x = rng.standard_normal(shape)
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _check_served(dev, label, x, y, ref, dtype):
    """A served result: on the device its request came from, within
    ATOL[dtype] * max|ref| of torch.fft's transform of the zero-padded
    request on the card. Returns the error."""
    import numpy as np
    import torch
    if torch.is_tensor(x):
        check(torch.is_tensor(y) and y.device == x.device,
              f"serve {label}: a card request came back as {type(y)}")
        xd, yd = x, y
    else:
        check(isinstance(y, np.ndarray),
              f"serve {label}: a numpy request came back as {type(y)}")
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    want = ref(xd)
    check(tuple(yd.shape) == tuple(want.shape),
          f"serve {label}: shape {tuple(yd.shape)} for {tuple(want.shape)}")
    err = (yd - want).abs().max().item()
    tol = ATOL[dtype] * want.abs().max().item()
    check(err <= tol, f"serve {label}: err {err} > {tol}")
    return err


def serve_cli(dev, env):
    """Both CLI modes as subprocesses on ``dev``, started together; each
    must exit 0 and print a rel_err within the complex64 tolerance."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", mode,
         "--device", dev.type, "--fft-spec", spec], cwd=ROOT, env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for mode, spec in SERVE_CLI]
    rows = []
    try:
        for (mode, spec), proc in zip(SERVE_CLI, procs):
            out, _ = proc.communicate(timeout=300)
            hit = re.findall(r"rel_err=(\S+)", out)
            check(proc.returncode == 0 and hit,
                  f"launch.serve --mode {mode}: exit {proc.returncode}\n"
                  f"{out[-3000:]}")
            err = float(hit[-1])
            check(err <= ATOL["complex64"],
                  f"launch.serve --mode {mode}: rel_err {err}")
            line = [ln for ln in out.splitlines() if "rel_err=" in ln][-1]
            log(f"launch.serve --mode {mode} --fft-spec {spec}: {line}")
            rows.append({"mode": mode, "spec": spec, "rel_err": err,
                         "line": line})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rows


def _ft_campaign(dev, rt, start, out, errors):
    """Client 0: FT_GROUPS closed groups of max_batch ft requests (complex64,
    8192 points, numpy and card tensors in turn), one Fault in every other
    group, as ``benchmarks/fft_serving.py``'s ``run_ft_campaign`` paces it:
    a group is sent, then its results are awaited. The requests are made
    before ``start``. Appends (group, faulted row or -1, requests, handles,
    results) to ``out``."""
    import numpy as np
    from repro_torch.serve import Fault

    mb = SERVE_CONFIG["max_batch"]
    rng = np.random.default_rng(SEED + 99)
    try:
        groups = []
        for g in range(FT_GROUPS):
            xs = [_serve_request(dev, 10_000 + g * mb + i, (8192,),
                                 "complex64", i % 2 == 1) for i in range(mb)]
            frow = int(rng.integers(mb)) if g % 2 == 0 else -1
            fault = Fault(row=0, col=int(rng.integers(8192)),
                          eps_re=float(rng.choice((-1, 1))
                                       * (150.0 + 100.0 * rng.random())))
            groups.append((g, frow, fault, xs))
        start.wait()
        for g, frow, fault, xs in groups:
            hs = [rt.submit(x, ft=True, faults=fault if i == frow else None)
                  for i, x in enumerate(xs)]
            out.append((g, frow, xs, hs,
                        [h.result(timeout=120.0) for h in hs]))
    except Exception as e:                     # reported by the main thread
        errors.append(e)


def _client(dev, rt, share, start, out, errors):
    """Clients 1..3: their share of the tenants' requests, made before
    ``start``, then sent in their seeded order with SERVE_WINDOW in flight.
    Appends (tenant, request, handle, result) to ``out``."""
    import collections
    try:
        reqs = [(tenant, _serve_request(dev, i, shape, tenant[2], i % 2 == 1))
                for i, (tenant, shape) in share]
        start.wait()
        window = collections.deque()
        for tenant, x in reqs:
            window.append((tenant, x, rt.submit(x, **tenant[3])))
            if len(window) >= SERVE_WINDOW:
                item = window.popleft()
                out.append(item + (item[2].result(timeout=120.0),))
        while window:
            item = window.popleft()
            out.append(item + (item[2].result(timeout=120.0),))
    except Exception as e:                     # reported by the main thread
        errors.append(e)


def _check_ft_group(g, frow, hs):
    """A closed ft group's batches, in submission order: the faulted batch
    flags, corrects and locates the faulted row; the others raise no
    alarm."""
    start = 0
    while start < len(hs):
        fill = hs[start].info["batch_fill"]
        has = start <= frow < start + fill
        for i in range(start, start + fill):
            info = hs[i].info
            check(info["flagged"] == has and info["corrected"] == int(has),
                  f"ft group {g} row {i}: {info}")
            if has:
                check(info["location"] == frow - start,
                      f"ft group {g}: located {info['location']}, faulted "
                      f"row {frow - start}")
        start += fill


def serve_phase(dev):
    """The serving runtime on the card (``repro_torch.serve``): the CLI in
    both modes, then one ServeRuntime (max_batch 16, 2 workers, 2 ms
    deadline) driven by 4 client threads over the tenants of
    ``serve_tenants`` and an ft campaign, with exact launch counts. The
    clients make their requests first; the timed run is sending them and
    awaiting the results, which are checked after it. Then convolve and
    correlate unbatched through ``serve_plan``, and the same runtime at
    max_batch 1 against 16 on throughput. Returns a dict."""
    import threading

    import numpy as np
    import torch
    from repro_torch.kernels.stockham import block_fft
    from repro_torch.kernels.stockham_abft import abft_fft
    from repro_torch.core.fft import api
    from repro_torch.serve import (Fault, QueueFullError, RuntimeConfig,
                                   ServeRuntime, build_fft_spec, serve_plan)

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cli = serve_cli(dev, env)
    t_cli = time.perf_counter() - t_phase

    tenants = serve_tenants()
    rng = np.random.default_rng(SEED)
    order = []                             # (tenant, request shape)
    for tenant in tenants:
        shapes, count = tenant[1], tenant[4]
        order += [(tenant, shapes[j % len(shapes)]) for j in range(count)]
    order = [order[k] for k in rng.permutation(len(order))]
    shares = [[] for _ in range(SERVE_CLIENTS - 1)]
    for i, req in enumerate(order):
        shares[i % len(shares)].append((i, req))
    n_requests = len(order) + FT_GROUPS * SERVE_CONFIG["max_batch"]
    ft_tenant = ("fft:8192:c64:ft", ((8192,),), "complex64", {"ft": True})
    # a throwaway runtime first: a process's first batches load torch's
    # copy kernels (CUDA loads modules at first use), which the measured
    # run should not count. Each bucket's batch is a card, a host and a
    # card request, so the host rows take the indexed copy
    with ServeRuntime(RuntimeConfig(**SERVE_CONFIG, device=str(dev))) as rt:
        hs = [rt.submit(_serve_request(dev, 30_000 + j, t[1][0], t[2],
                                       j != 1), **t[3])
              for t in tenants + (ft_tenant,) for j in range(3)]
        hs.append(rt.submit(_serve_request(dev, 30_003, (8192,),
                                           "complex64", False),
                            ft=True, faults=Fault(col=5)))
        rt.drain()
        for h in hs:
            h.result(timeout=120.0)
    with ServeRuntime(RuntimeConfig(**SERVE_CONFIG, device=str(dev))) as rt:
        # admit (plan and warm) every bucket, and count each plan's
        # launches a batch, before the counted run
        per_batch = {}
        keys = [rt.bucketer.key_for(shapes[-1], dtype, **kw)
                for _, shapes, dtype, kw, _, _ in tenants]
        keys.append(rt.bucketer.key_for(ft_tenant[1][0], ft_tenant[2],
                                        **ft_tenant[3]))
        for key in keys:
            p = rt.admit(key)
            xb = torch.zeros((SERVE_CONFIG["max_batch"],) + key.tshape,
                             dtype=rt._payload_dtype(p), device=dev)
            before = (block_fft.launches, abft_fft.launches)
            serve_plan(p, xb, op=key.op)
            per_batch[key.label] = (block_fft.launches - before[0],
                                    abft_fft.launches - before[1])
        check([k.label for k in keys[:-1]] == [t[0] for t in tenants],
              f"serve buckets {[k.label for k in keys]}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        block_fft.launches = 0
        abft_fft.launches = 0
        served, ft_groups, errors = [], [], []
        start = threading.Barrier(SERVE_CLIENTS + 1)
        threads = [threading.Thread(target=_ft_campaign,
                                    args=(dev, rt, start, ft_groups, errors))]
        threads += [threading.Thread(target=_client, args=(
            dev, rt, share, start, served, errors)) for share in shares]
        for th in threads:
            th.start()
        start.wait(timeout=300)          # every client has made its requests
        t0 = time.perf_counter()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not errors, f"serve clients failed: {errors[:1]!r}")
        check(not any(th.is_alive() for th in threads),
              "a serve client did not finish")
        torch.cuda.synchronize()
        launches = {"block_fft": block_fft.launches,
                    "abft_fft": abft_fft.launches}
        peak = torch.cuda.max_memory_allocated() - base
        buckets = rt.stats()["buckets"]
    results, device_ms = [], {}
    for tenant, x, h, y in served:
        results.append(_check_served(dev, tenant[0], x, y, tenant[5],
                                     tenant[2]))
        device_ms.setdefault(tenant[0], []).append(h.info["device_ms"])
    for g, frow, xs, hs, ys in ft_groups:
        _check_ft_group(g, frow, hs)
        for x, h, y in zip(xs, hs, ys):
            results.append(_check_served(
                dev, "fft:8192:c64:ft", x, y,
                lambda v: torch.fft.fft(v, n=8192), "complex64"))
            device_ms.setdefault("fft:8192:c64:ft", []).append(
                h.info["device_ms"])
    del served, ft_groups
    check(len(results) == n_requests >= 400,
          f"serve: {len(results)} results of {n_requests} requests")
    want = {"block_fft": 0, "abft_fft": 0}
    for label, st in buckets.items():
        check(st["completed"] == st["submitted"] and st["failed"]
              == st["rejected"] == st["timeouts"] == 0,
              f"serve bucket {label}: {st}")
        want["block_fft"] += st["batches"] * per_batch[label][0]
        want["abft_fft"] += st["batches"] * per_batch[label][1]
    check(launches == want and launches["abft_fft"] > 0,
          f"serve launches {launches}, the plans' launches a batch over "
          f"the batches {want}")
    ft = buckets["fft:8192:c64:ft"]
    check(ft["injected"] == ft["detected"] == ft["corrected"]
          == FT_GROUPS // 2 and ft.get("uncorrectable", 0) == 0,
          f"serve ft campaign: {ft}")
    rows = {}
    for label, st in buckets.items():
        rows[label] = {k: st[k] for k in ("submitted", "batches",
                                          "p50_ms", "p95_ms", "p99_ms")}
        rows[label].update(
            mean_fill=st["batch_occupancy"] * SERVE_CONFIG["max_batch"],
            requests_per_s=st["completed"] / wall,
            batch_device_ms=float(np.mean(device_ms[label])),
            launches_per_batch=dict(zip(("block_fft", "abft_fft"),
                                        per_batch[label])))
        log(f"serve {label}: p50 {st['p50_ms']:.3f} ms, p95 "
            f"{st['p95_ms']:.3f} ms, p99 {st['p99_ms']:.3f} ms; "
            f"{st['batches']} batches, mean fill "
            f"{rows[label]['mean_fill']:.2f} of {SERVE_CONFIG['max_batch']}, "
            f"{rows[label]['requests_per_s']:.1f} requests/s; a request's "
            f"batch {rows[label]['batch_device_ms']:.4f} ms on the card "
            f"(mean); launches a batch {per_batch[label]}")
    log(f"serve: {len(results)} requests from {SERVE_CLIENTS} clients in "
        f"{wall:.3f} s ({len(results) / wall:.1f} requests/s), worst err "
        f"{max(results):.3e}; launches {json.dumps(launches)} = the plans' "
        f"launches a batch over the batches; ft campaign injected "
        f"{ft['injected']} detected {ft['detected']} corrected "
        f"{ft['corrected']}; peak device memory {peak / 1e9:.3f} GB")
    check(peak < SERVE_MEMORY_LIMIT, f"serve phase peak memory {peak}")

    # convolve and correlate, unbatched through serve_plan
    conv = {}
    a = _seeded(dev, CONV_SHAPE, "float32")
    v = _seeded(dev, (CONV_TAPS,), "float32", 1)
    la, lv = CONV_SHAPE[-1], CONV_TAPS
    nfft = 1 << (la + lv - 2).bit_length()
    for op, vv in (("convolve", v), ("correlate", v.flip(-1))):
        p = api.plan(build_fft_spec(CONV_SHAPE, op=op,
                                    kernel_shape=(CONV_TAPS,),
                                    device=str(dev)))
        before = block_fft.launches
        y, info = serve_plan(p, a, op=op, kernel=v)
        blk = block_fft.launches - before
        full = torch.fft.irfft(torch.fft.rfft(a, n=nfft)
                               * torch.fft.rfft(vv, n=nfft), n=nfft)
        start = (min(la, lv) - 1) // 2
        ref = full[..., start:start + max(la, lv)]
        err = (y - ref).abs().max().item()
        tol = ATOL["float32"] * ref.abs().max().item()
        check(y.shape == ref.shape and err <= tol,
              f"serve_plan {op}: err {err} > {tol}")
        conv[op] = {"max_abs_err": err, "tol": tol, "block_fft": blk,
                    "info": info}
        log(f"serve_plan {op} float32 {CONV_SHAPE} * {CONV_TAPS}: err "
            f"{err:.3e} tol {tol:.3e}, {blk} block_fft launches, {info}")

    # the same runtime at max_batch 1 and 16 on throughput (printed only)
    thr = {}
    xs = [_serve_request(dev, 20_000 + i, (8192,), "complex64", False)
          for i in range(32)]
    for mb in (1, SERVE_CONFIG["max_batch"]):
        with ServeRuntime(RuntimeConfig(**dict(SERVE_CONFIG, max_batch=mb),
                                        device=str(dev))) as rt:
            rt.submit(xs[0]).result(timeout=60.0)
            hs = []
            t0 = time.perf_counter()
            for i in range(512):
                while True:
                    try:
                        hs.append(rt.submit(xs[i % len(xs)]))
                        break
                    except QueueFullError:
                        time.sleep(0.0005)
            for h in hs:
                h.result(timeout=120.0)
            thr[mb] = len(hs) / (time.perf_counter() - t0)
    log(f"serve throughput, complex64 8192-point numpy requests, 512 "
        f"back to back: max_batch=1 {thr[1]:.1f} requests/s, max_batch="
        f"{SERVE_CONFIG['max_batch']} {thr[SERVE_CONFIG['max_batch']]:.1f} "
        f"requests/s")
    seconds = time.perf_counter() - t_phase
    log(f"serve phase: {seconds:.1f} s (CLI {t_cli:.1f} s)")
    return {"requests": len(results), "clients": SERVE_CLIENTS,
            "config": SERVE_CONFIG, "wall_s": wall, "buckets": rows,
            "launches": launches, "peak_memory_bytes": peak,
            "max_abs_err": max(results), "ft": ft, "unbatched": conv,
            "throughput_rps": {str(k): v for k, v in thr.items()},
            "cli": cli, "seconds": seconds}


# ---- phase 7: the LM path. Phi-4-mini 3.8B at its published widths, cut in
# depth (LM_REDUCED; f32 params, bf16 activations, random weights from a
# seeded CUDA generator):
# one protected prefill, then greedy decode at batch 4 (M padded to 64 in
# every protected product) and 64 (aligned), each unprotected, protected
# and protected under the CLI's FaultSchedule; then Gemma-3 1B (local and
# global caches, tied embeddings) once, protected, and the CLI on the card
LM_ARCH, LM_SMALL_ARCH = "phi4_mini_3p8b", "gemma3_1b"
LM_LAYERS = 8
LM_REDUCED = ("8 of 32 layers, for the script's time (1202 s with phase 12 "
              "at 16 layers on a slow host, PR 25): the decode runs are "
              "host-bound; every width published")
LM_PREFILL = (4, 512)              # (batch, tokens): M = 2048, no padding
LM_BATCHES = (4, 64)
LM_PROMPT, LM_GEN = 16, 32
LM_FT_THRESHOLD = 1e-3
LM_MEMORY_LIMIT = 28e9             # bytes of device memory, params included
LM_SITES = 7                       # protected products a block: q k v o, MLP
# the protected prefill against the unprotected one, on the last 16
# positions' logits: LM_LOGIT_TOL * max|unprotected|. The unprotected path
# rounds every weight to bf16 (2^-9 relative) and the protected one keeps
# it float32; over 32 blocks those differences add up in the residual
# stream, so the gate is loose: a broken product is off by O(1)
LM_LOGIT_TOL = 2.0 ** -4
DECODE_SHAPE = (4, 3072, 8192)     # a decode step's MLP up product
LM_CLI = ("--mode", "lm", "--arch", "gemma3-1b", "--preset", "full", "--ft")


def protect(cfg):
    """``cfg`` with every linear protected at LM_FT_THRESHOLD."""
    return dataclasses.replace(cfg, ft=dataclasses.replace(
        cfg.ft, protect_linears=True, threshold=LM_FT_THRESHOLD))


def lm_prefill(tag, models, params, tokens, sites, gated=True):
    """One protected ``Model.apply`` of ``tokens`` (``sites`` ft_matmul
    launches, no flag, finite float32 logits) against the unprotected one
    on the last 16 positions, held to LM_LOGIT_TOL * max when ``gated``
    and recorded either way. Returns the results dict."""
    import torch
    from repro_torch.kernels.ft_matmul import ft_matmul

    b, t = tokens.shape
    before = ft_matmul.launches
    logits, aux = models["protected"].apply(params, {"tokens": tokens})
    launches = ft_matmul.launches - before
    check(launches == sites, f"{tag} protected prefill: {launches} "
                             f"ft_matmul launches, not {sites}")
    check(tuple(logits.shape) == (b, t, models["protected"].cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"{tag} protected prefill logits {tuple(logits.shape)} "
          f"{logits.dtype}")
    check(float(aux["ft_flagged"]) == 0, f"{tag} protected prefill: flagged")
    tail_p = logits[:, -16:].clone()
    del logits
    plain, _ = models["unprotected"].apply(params, {"tokens": tokens})
    tail_u = plain[:, -16:].clone()
    del plain
    scale = tail_u.abs().max().item()
    err = (tail_p - tail_u).abs().max().item()
    agree = (tail_p.argmax(-1) == tail_u.argmax(-1)).float().mean().item()
    check(not gated or err <= LM_LOGIT_TOL * scale,
          f"{tag} protected vs unprotected prefill logits: {err} > "
          f"{LM_LOGIT_TOL} * {scale}")
    log(f"{tag} prefill {b} x {t}: {launches} ft_matmul launches, max "
        f"score {float(aux['ft_max_score']):.3e}; protected vs unprotected "
        f"logits err {err:.4e} ("
        + (f"tol {LM_LOGIT_TOL * scale:.4e}, " if gated else "not gated, ")
        + f"max {scale:.4e}), argmax agreement {agree:.3f}")
    return {"shape": [b, t], "ft_matmul_launches": launches,
            "max_score": float(aux["ft_max_score"]), "logit_err": err,
            "logit_max": scale,
            "logit_tol": LM_LOGIT_TOL * scale if gated else None,
            "argmax_agreement": agree}


def lm_decode(tag, models, params, prompts, sites, layers_n, batched=None,
              batched_per_step=0):
    """Greedy ``launch.serve.decode`` of ``prompts`` (prompt LM_PROMPT, gen
    LM_GEN) unprotected, protected and protected under the CLI's schedule:
    ``sites`` ft_matmul launches a protected step, the ledger 2 x
    ``layers_n`` exact, the SEU run's tokens the clean protected run's.
    The encoder-decoder has no SEU run: its blocks take no fault
    descriptor (ROADMAP queue 3 "In the reference itself" item 9). With ``batched`` (a counter of the eager batched expert products,
    ``{"calls": n}``), a protected step also makes ``batched_per_step`` of
    them and an unprotected one none. Returns the runs' rows."""
    import torch
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.launch.serve import decode, demo_schedule

    batch = prompts.shape[0]
    vocab = models["protected"].cfg.vocab_size
    steps = LM_PROMPT + LM_GEN - 1
    runs, toks = {}, {}
    seu = not models["protected"].cfg.is_encdec
    for label, model, sched in (
            ("unprotected", models["unprotected"], None),
            ("protected", models["protected"], None),
            ("protected+SEU", models["protected"],
             demo_schedule(batch, LM_PROMPT)))[:3 if seu else 2]:
        decode(model, params, prompts[:, :2], 2)       # warm-up
        torch.cuda.synchronize()
        before = ft_matmul.launches
        calls_before = batched["calls"] if batched is not None else 0
        t0 = time.perf_counter()
        out = decode(model, params, prompts, LM_GEN, schedule=sched)
        toks[label], stats = out if sched is not None else (out, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ft_matmul.launches - before
        tk = toks[label]
        check(tuple(tk.shape) == (batch, LM_GEN)
              and int(tk.min()) >= 0 and int(tk.max()) < vocab,
              f"{tag} decode {label} batch {batch}: {tuple(tk.shape)}")
        want = 0 if label == "unprotected" else sites * steps
        check(launches == want, f"{tag} decode {label} batch {batch}: "
                                f"{launches} ft_matmul launches, not {want}")
        row = {"batch": batch, "run": label, "wall_s": wall,
               "ms_per_step": wall / steps * 1e3,
               "tokens_per_s": batch * LM_GEN / wall,
               "ft_matmul_launches": launches,
               "launches_per_step": launches / steps}
        if batched is not None:
            calls = batched["calls"] - calls_before
            want = 0 if label == "unprotected" else batched_per_step * steps
            check(calls == want, f"{tag} decode {label} batch {batch}: "
                                 f"{calls} eager expert products, not {want}")
            row["expert_products_per_step"] = calls / steps
        if stats is not None:
            ledger = {"injected": sched.num_faults * layers_n,
                      "detected": float(stats.detected),
                      "corrected": float(stats.corrected),
                      "max_score": float(stats.max_score)}
            check(ledger["injected"] == ledger["detected"]
                  == ledger["corrected"] == 2 * layers_n,
                  f"{tag} decode SEU ledger batch {batch}: {ledger}")
            check(torch.equal(tk, toks["protected"]),
                  f"{tag} decode batch {batch}: the SEU run's tokens are "
                  f"not the clean protected run's")
            row["ledger"] = ledger
        runs[label] = row
        log(f"{tag} decode batch {batch} {label}: {wall:.3f} s, "
            f"{row['ms_per_step']:.2f} ms a step, "
            f"{row['tokens_per_s']:.1f} tokens/s, "
            f"{row['launches_per_step']:.0f} ft_matmul launches a step"
            + (f", {row['expert_products_per_step']:.0f} eager expert "
               f"products a step" if "expert_products_per_step" in row
               else "")
            + (f"; ledger {json.dumps(row['ledger'])}"
               if "ledger" in row else ""))
    agree = (toks["protected"] == toks["unprotected"]).float().mean()
    runs["token_agreement"] = agree.item()
    runs["ft_overhead_per_step"] = (runs["protected"]["ms_per_step"]
                                    / runs["unprotected"]["ms_per_step"] - 1)
    log(f"{tag} decode batch {batch}: protected step "
        f"{runs['ft_overhead_per_step']:+.1%} over unprotected; greedy "
        f"tokens agree at {agree.item():.3f}")
    return runs


def lm_drive(dev):
    """Drive the LM path once (counts are the caller's to reset and read):
    Phi-4-mini's prefill and decode runs, then Gemma-3 1B's. Returns
    (results dict, Phi-4-mini's model pair and params, prefill tokens, the
    batch-4 prompts) for the measurements that follow."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.launch.serve import decode, demo_schedule
    from repro_torch.models import Model, count_params

    res = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    full = get_config(LM_ARCH)
    check((full.num_layers, full.d_model, full.d_ff, full.vocab_size)
          == (32, 3072, 8192, 200064), f"{LM_ARCH}: {full}")
    base = dataclasses.replace(full, num_layers=LM_LAYERS)
    log(f"LM {LM_ARCH} reduced: {LM_REDUCED}")
    res["reduced"] = LM_REDUCED
    layers_n, vocab = base.num_layers, base.vocab_size
    models = {"unprotected": Model(base), "protected": Model(protect(base))}
    t0 = time.perf_counter()
    params = models["unprotected"].init(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    param_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    res["params"] = count_params(base)
    res["param_bytes"] = param_bytes
    res["init_s"] = time.perf_counter() - t0
    check(res["params"] == sum(t.numel() for t in tree.leaves(params)),
          "count_params disagrees with the initialised tree")
    log(f"LM {base.name}: {res['params']} params, {param_bytes / 1e9:.2f} GB "
        f"({base.param_dtype}), activations {base.dtype}, initialised on "
        f"the card in {res['init_s']:.1f} s")

    # one protected prefill at 4 x 512 tokens, against the unprotected one
    b, t = LM_PREFILL
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, vocab, (b, t), generator=gen, device=dev,
                           dtype=torch.int32)
    res["prefill"] = lm_prefill("LM", models, params, tokens,
                                LM_SITES * layers_n)

    # greedy decode: each batch unprotected, protected, protected + SEUs
    rng = np.random.default_rng(SEED)
    steps = LM_PROMPT + LM_GEN - 1
    res["decode"] = []
    prompts4 = None
    for batch in LM_BATCHES:
        prompts = torch.as_tensor(
            rng.integers(0, vocab, (batch, LM_PROMPT)), dtype=torch.int32,
            device=dev)
        prompts4 = prompts if prompts4 is None else prompts4
        res["decode"].append(lm_decode("LM", models, params, prompts,
                                       LM_SITES * layers_n, layers_n))
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    check(res["peak_memory_bytes"] < LM_MEMORY_LIMIT,
          f"LM path peak memory {res['peak_memory_bytes']} bytes")
    log(f"LM {base.name} path peak device memory "
        f"{res['peak_memory_bytes'] / 1e9:.2f} GB (params "
        f"{param_bytes / 1e9:.2f} GB)")

    # Gemma-3 1B once, protected under the CLI's schedule
    small = protect(get_config(LM_SMALL_ARCH))
    gm = Model(small)
    gparams = gm.init(torch.Generator(device=dev).manual_seed(SEED),
                      device=dev)
    prompts = torch.as_tensor(
        rng.integers(0, small.vocab_size, (4, LM_PROMPT)),
        dtype=torch.int32, device=dev)
    sched = demo_schedule(4, LM_PROMPT)
    torch.cuda.synchronize()
    before = ft_matmul.launches
    t0 = time.perf_counter()
    tk, stats = decode(gm, gparams, prompts, LM_GEN, schedule=sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ft_matmul.launches - before
    ledger = {"injected": sched.num_faults * small.num_layers,
              "detected": float(stats.detected),
              "corrected": float(stats.corrected)}
    check(launches == LM_SITES * small.num_layers * steps,
          f"{small.name} decode: {launches} ft_matmul launches")
    check(ledger["injected"] == ledger["detected"] == ledger["corrected"],
          f"{small.name} decode ledger: {ledger}")
    check(tuple(tk.shape) == (4, LM_GEN) and int(tk.max()) < small.vocab_size,
          f"{small.name} decode tokens {tuple(tk.shape)}")
    res["small"] = {"arch": small.name, "params": count_params(small),
                    "batch": 4, "wall_s": wall,
                    "ms_per_step": wall / steps * 1e3,
                    "tokens_per_s": 4 * LM_GEN / wall,
                    "ft_matmul_launches": launches, "ledger": ledger}
    log(f"LM {small.name} ({res['small']['params']} params, tied "
        f"embeddings, local window {small.window_size}) protected decode "
        f"batch 4 with the CLI schedule: {wall:.3f} s, "
        f"{res['small']['ms_per_step']:.2f} ms a step, {launches} "
        f"ft_matmul launches, ledger {json.dumps(ledger)}")
    del gparams, gm
    return res, models, params, tokens, prompts4


def ftmm_at(dev, shape, cuda_ms, what, iters=50):
    """``ft_matmul`` against its plain version at a product (M, K, N) of an
    LM path, as the plan runs it: the tiles ``spec_for`` fits to K and N,
    M padded with zero rows to a multiple of 64 where it is no multiple of
    the tile's 128. With a bf16 X every part is held to the plain version
    (``c`` to BF16_STEP, the strips to GEMM_TOL, each times max|plain|),
    the float32 X the plan hands the kernel must give the same product and
    strips, and the padded product's first M rows the unpadded product.
    Timed against the plain version, ``torch.matmul`` and the plan's call;
    returns the row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.gemm import plan, spec_for
    from repro_torch.core.plan import FTConfig
    from repro_torch.kernels.ft_matmul import ft_matmul, ft_matmul_plain

    m, k, n = shape
    x, w = gemm_operands(dev, m, k, n, "bfloat16")
    p = plan(spec_for(x, w, ft=FTConfig(threshold=LM_FT_THRESHOLD)))
    check(p.backend == "fused", f"{what} {shape}: plan {p.backend}")
    bm, bk, bn = p.spec.tiles
    bm = bm if m % bm == 0 else 64
    xp = F.pad(x, (0, 0, 0, -m % bm))
    tiles = dict(bm=bm, bn=bn, bk=bk)
    got, want = ft_matmul(xp, w, **tiles), ft_matmul_plain(xp, w)
    errs = {}
    for part in ("c", "out2", "pred2", "out3", "pred3"):
        g, r = getattr(got, part).float(), getattr(want, part).float()
        step_tol = BF16_STEP if part == "c" else GEMM_TOL
        errs[part] = (g - r).abs().max().item()
        check(errs[part] <= step_tol * r.abs().max().item(),
              f"ft_matmul vs plain at the {what} {shape} tiles {tiles} "
              f"{part}: {errs[part]}")
    unpadded = ft_matmul_plain(x, w).c.float()
    check(not bool(got.c[m:].any())
          and (got.c[:m].float() - unpadded).abs().max().item()
          <= BF16_STEP * unpadded.abs().max().item(),
          f"ft_matmul at the {what} {shape}: the padded product's first "
          f"rows are not the unpadded product")
    # the plan hands the kernel a float32 X (its c stays float32 through
    # the correction): the same product, rounded once afterwards
    xpf = xp.float()
    wide = ft_matmul(xpf, w, **tiles)
    check(torch.equal(wide.c.to(torch.bfloat16), got.c)
          and all(torch.equal(getattr(wide, part), getattr(got, part))
                  for part in ("out2", "pred2", "out3", "pred3")),
          f"ft_matmul at the {what} {shape}: a float32 X does not give the "
          f"bf16 X's product")
    xf = x.float()
    nbytes = (x.numel() * 2 + w.numel() * 4 + m * n * 2 + 4 * n * 4)
    flops = 2 * m * k * n + 3 * m * k + 4 * k * n + 3 * m * n
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {
        "shape": [m, k, n], "padded_m": int(xp.shape[0]), "tiles": tiles,
        "x": "bfloat16", "w": "float32",
        "ms": cuda_ms(lambda: ft_matmul(xp, w, **tiles), iters=iters),
        "float32_x_ms": cuda_ms(lambda: ft_matmul(xpf, w, **tiles),
                                iters=iters),
        "plain_ms": cuda_ms(lambda: ft_matmul_plain(xp, w), iters=iters),
        "library_ms": cuda_ms(lambda: torch.matmul(xf, w), iters=iters),
        "library_bf16_ms": cuda_ms(lambda: torch.matmul(
            x, w.to(torch.bfloat16)), iters=iters),
        "plan_ft_matmul_ms": cuda_ms(lambda: p.ft_matmul(x, w), iters=iters),
        "bound_ms": max(tb, tf),
        "bound_by": "bytes" if tb >= tf else "operations",
        "max_abs_err": errs}


def prefill_ms(tag, models, params, batch, cuda_ms):
    """Each of ``models``' prefill of ``batch`` (its tokens, and frames or
    patches) through ``make_prefill_step``, by CUDA events after a
    warm-up. Returns ``{label: ms}``."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import make_prefill_step

    out = {}
    for label, m in models.items():
        step = make_prefill_step(m, RunConfig(model=m.cfg))
        out[label] = cuda_ms(lambda step=step: step(params, batch),
                             iters=1, warmup=1)
    log(f"{tag} prefill {tuple(batch['tokens'].shape)} by events: protected "
        f"{out['protected']:.2f} ms, unprotected {out['unprotected']:.2f} "
        f"ms")
    return out


def trace_steps(tag, models, params, prompts4, sites, host_ms, trace_call,
                host_iters=3, top_n=10):
    """One decode step at ``prompts4``'s batch under a primed
    torch.profiler for each of ``models`` (the protected one must show
    ``sites`` ft_matmul_tile kernels, the unprotected one none), in their
    order: kernels, device ms, the window and its idle share, host ms a
    step, the kernels by name. Returns ``{label: row}``."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import make_serve_step

    tok = prompts4[:, :1]
    out = {}
    for label, model in models.items():
        step = make_serve_step(model, RunConfig(model=model.cfg))
        cache = model.init_cache(batch=prompts4.shape[0],
                                 max_len=LM_PROMPT + LM_GEN,
                                 device=prompts4.device)
        fn = lambda: step(params, cache, tok, 0)        # noqa: E731
        want = sites if label == "protected" else 0
        kern, window, idle = trace_call(
            fn, lambda names: sum("ft_matmul_tile" in k for k in names)
            == want)
        host = host_ms(fn, iters=host_iters)
        groups = {}
        for name, ms in kern:
            key = re.sub(r"^void ", "", name)[:60]
            n, tot = groups.get(key, (0, 0.0))
            groups[key] = (n + 1, tot + ms)
        top = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top_n]
        row = {"batch": int(prompts4.shape[0]), "kernels": len(kern),
               "ft_matmul_tile": sum("ft_matmul_tile" in k for k, _ in kern),
               "ft_matmul_tile_ms": sum(ms for k, ms in kern
                                        if "ft_matmul_tile" in k),
               "device_ms": sum(ms for _, ms in kern), "window_ms": window,
               "idle_share": idle, "host_ms": host,
               "top": [[k, n, ms] for k, (n, ms) in top]}
        out[label] = row
        log(f"{tag} decode step trace (batch {row['batch']}, {label}): "
            f"{row['kernels']} kernels, {row['ft_matmul_tile']} "
            f"ft_matmul_tile ({row['ft_matmul_tile_ms']:.3f} ms), "
            f"{row['device_ms']:.3f} ms on the device in a "
            f"{window:.3f} ms window (idle {idle:.1%}); host {host:.3f} ms "
            f"a step; by name: " + "; ".join(
                f"{k} x{n} {ms:.3f} ms" for k, (n, ms) in top))
    return out


def ftmm_rows(dev, tag, shapes, cuda_ms, iters=20, prefill_iters=20):
    """``ftmm_at`` at each of ``shapes`` (``iters`` timed calls at a
    decode step's M, ``prefill_iters`` at a larger one), logged. Returns
    the rows."""
    rows = []
    for shape in shapes:
        row = ftmm_at(dev, shape, cuda_ms, f"{tag} product",
                      iters=iters if shape[0] < 64 else prefill_iters)
        rows.append(row)
        log(f"{tag} ft_matmul at {tuple(shape)} (M padded to "
            f"{row['padded_m']}, tiles {json.dumps(row['tiles'])}) bf16 x "
            f"f32: {row['ms']:.4f} ms (float32 X {row['float32_x_ms']:.4f} "
            f"ms), plain {row['plain_ms']:.4f} ms, torch.matmul f32 "
            f"{row['library_ms']:.4f} ms, plan.ft_matmul "
            f"{row['plan_ft_matmul_ms']:.4f} ms; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); err "
            f"{json.dumps(row['max_abs_err'])}")
    return rows


def lm_clis(runs):
    """``python -m repro_torch.launch.serve *argv`` on the card for each
    ``(argv, detected)`` of ``runs``, all started together: each must exit
    0, inject the demo schedule's 2 faults and report ``detected`` faults
    detected and corrected. Returns each run's ``generated`` line, ledger
    line and seconds (from the start of all, process start included)."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = []
    try:
        for argv, detected in runs:
            out = tempfile.TemporaryFile(mode="w+")
            procs.append((argv, detected, out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve", *argv],
                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
                text=True)))
        res = []
        for argv, detected, out, proc in procs:
            code = proc.wait(timeout=300)
            seconds = time.perf_counter() - t0
            out.seek(0)
            text = out.read()
            hit = re.search(r"ft: injected=(\d+) detected=(\d+) "
                            r"corrected=(\d+)", text)
            check(code == 0 and hit and hit[1] == "2"
                  and hit[2] == hit[3] == str(detected),
                  f"launch.serve {' '.join(argv)}: exit {code}\n"
                  f"{text[-3000:]}")
            line = next(ln for ln in text.splitlines()
                        if ln.startswith("generated"))
            res.append({"argv": list(argv), "line": line, "ft": hit[0],
                        "seconds": seconds})
            log(f"launch.serve {' '.join(argv)}: {line}; {hit[0]} "
                f"({seconds:.1f} s with the process start)")
        return res
    finally:
        for _, _, out, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()


def lm_measure(dev, models, params, tokens, prompts4, cuda_ms, host_ms,
               trace_call):
    """Times of the LM path and its kernel at the decode shape: the
    prefill by CUDA events, primed torch.profiler traces of one protected
    and one unprotected decode step (kernels, host ms, device idle share),
    ``ft_matmul`` against its plain version at a decode step's padded MLP
    shape. Returns a dict (phase 11 adds the CLI's ``--mode lm`` run)."""
    res = {}
    res["prefill_ms"] = {
        label: cuda_ms(lambda m=m: m.apply(params, {"tokens": tokens}),
                       iters=2, warmup=1)
        for label, m in models.items()}
    log(f"LM prefill {tuple(tokens.shape)} by events: protected "
        f"{res['prefill_ms']['protected']:.2f} ms, unprotected "
        f"{res['prefill_ms']['unprotected']:.2f} ms")

    # one decode step at batch 4 under torch.profiler, protected (it must
    # show 7 ft_matmul_tile kernels a layer) and unprotected
    res["decode_trace"] = trace_steps(
        "LM", {k: models[k] for k in ("protected", "unprotected")}, params,
        prompts4, LM_SITES * models["protected"].cfg.num_layers, host_ms,
        trace_call, host_iters=5, top_n=12)

    # ft_matmul at a decode step's MLP up product: M = 4 padded to 64
    res["decode_shape"] = ds = ftmm_at(dev, DECODE_SHAPE, cuda_ms,
                                       "LM decode shape")
    log(f"ft_matmul at the decode shape {DECODE_SHAPE} (M padded to "
        f"{ds['padded_m']}) bf16 x f32: {ds['ms']:.4f} ms (float32 X, as "
        f"the plan runs it: {ds['float32_x_ms']:.4f} ms), plain "
        f"{ds['plain_ms']:.4f} ms, torch.matmul f32 {ds['library_ms']:.4f} "
        f"ms (bf16 weights {ds['library_bf16_ms']:.4f} ms), plan.ft_matmul "
        f"{ds['plan_ft_matmul_ms']:.4f} ms; bound {ds['bound_ms']:.4f} ms "
        f"({ds['bound_by']}); err {json.dumps(ds['max_abs_err'])}")
    return res


# ---- phase 8: the recurrent LM path. RecurrentGemma-2B (RG-LRU and local
# attention) and xLSTM-350M (mLSTM and sLSTM) at their published widths (f32
# params, bf16 activations, random weights from a seeded CUDA generator):
# a protected 4 x 512 prefill against the unprotected one, 8 decode steps
# against the forward at float32 activations (the doubling scan against
# the sequential recurrence at real decays), then greedy decode,
# unprotected, protected and protected under the CLI's FaultSchedule,
# RecurrentGemma at batch 4 and 64, xLSTM at batch 4; xLSTM's CLI on the
# card. One config at a time, the first freed before the second is built
SSM_ARCHS = ("recurrentgemma_2b", "xlstm_350m")
# (layers, d_model, d_ff, vocab, heads): the published widths
SSM_WIDTHS = {"recurrentgemma_2b": (26, 2560, 7680, 256000, 10),
              "xlstm_350m": (24, 1024, 0, 50304, 4)}
SSM_BATCHES = {"recurrentgemma_2b": (4, 64), "xlstm_350m": (4,)}
# the depth phase 8 runs, for the script's time (1202 s on a slow host with
# both at full depth, PR 25): RecurrentGemma's four periods of (rglru,
# rglru, local), xLSTM's six (mlstm, slstm) pairs; every width published
SSM_LAYERS = {"recurrentgemma_2b": 12, "xlstm_350m": 12}
# protected products a block, by mixer: RG-LRU 3 + the MLP's 3, local
# attention 4 + 3, mLSTM 5, sLSTM 4 + its SwiGLU's 3
SSM_SITES = {"rglru": 6, "local": 7, "mlstm": 5, "slstm": 7}
# the protected prefill is held to the unprotected one (LM_LOGIT_TOL, as in
# phase 7) on RecurrentGemma; xLSTM's difference is recorded: with random
# weights its recurrence is chaotic (at float32 the one-ulp witness below
# departs from the unprotected forward as far as the protected one does),
# and a bf16 weight rounding of 2^-9 departs further, so no tolerance on
# its last positions holds it
SSM_PREFILL_GATED = ("recurrentgemma_2b",)
SSM_RECURRENCE_STEPS = 8
# decode against the forward, and the protected forward against the
# unprotected one, at float32 activations over the first 8 steps: the
# reference's test_prefill_decode_equivalence bound, 2e-3 * max|forward|
SSM_RECURRENCE_TOL = 2e-3
# positions [lo, hi) over which the float32 protected forward's divergence
# from the unprotected one is held, in each window, to SSM_RECURRENCE_TOL *
# max or SSM_WITNESS_FACTOR times the divergence of the witness, the
# unprotected forward with every weight one ulp up (``ulp_witness``):
# xLSTM's random-weight recurrence is chaotic, and the witness departs as
# far as the protected forward does (to all of max|logits| after 64
# positions on an NVIDIA H100), so its tail is the model's, not the path's
SSM_WINDOWS = ((0, 8), (8, 64), (64, 256), (256, 512))
SSM_WITNESS_FACTOR = 4
SSM_CLI = ("--mode", "lm", "--arch", "xlstm-350m", "--preset", "full",
           "--ft")
# ft_matmul against its plain version at the products (M, K, N) each
# config's path gives it that phase 7 does not: the MLP's (RecurrentGemma)
# and the sLSTM FFN's (xLSTM, 1344 = 64 x 21: 64-wide tiles), at a batch-4
# decode step (M padded to 64) and at the 4 x 512 prefill
SSM_FTMM_SHAPES = {
    "recurrentgemma_2b": ((4, 2560, 7680), (4, 7680, 2560),
                          (2048, 2560, 7680)),
    "xlstm_350m": ((4, 1024, 1344), (4, 1344, 1024), (2048, 1024, 1344),
                   (2048, 1344, 1024))}


def _window_errs(a, b):
    """max|a - b| and max|b| over each SSM_WINDOWS span of positions."""
    return [{"positions": [lo, hi],
             "err": (a[:, lo:hi] - b[:, lo:hi]).abs().max().item(),
             "max": b[:, lo:hi].abs().max().item()}
            for lo, hi in SSM_WINDOWS]


def _fingerprint(leaves):
    """An int32 sum of each float32 leaf's bits: it wraps, in any order, and
    copies nothing (an int64 one would copy each leaf at twice its size)."""
    import torch

    return [int(t.view(torch.int32).sum(dtype=torch.int32)) for t in leaves]


@contextlib.contextmanager
def ulp_up(params):
    """Every float32 parameter moved one ulp up (``nextafter`` toward +inf,
    in place) for the block: a perturbation at the rounding level of the
    one between the protected and the unprotected products, for which the
    model itself, and not the protected path, answers. The parameters are
    moved back after, and held bit for bit."""
    import torch
    from repro_torch import tree

    leaves = [t for t in tree.leaves(params) if t.dtype == torch.float32]
    before = _fingerprint(leaves)
    with torch.no_grad():
        for t in leaves:
            t.nextafter_(t.new_full((), math.inf))
    try:
        yield
    finally:
        with torch.no_grad():
            for t in leaves:
                t.nextafter_(t.new_full((), -math.inf))
    check(before == _fingerprint(leaves),
          "ulp_up: the parameters did not come back bit for bit")


def ulp_witness(model, params, tokens):
    """``model.apply``'s logits of ``tokens`` with every parameter one ulp
    up (``ulp_up``)."""
    import torch

    with ulp_up(params), torch.no_grad():
        return model.apply(params, {"tokens": tokens})[0]


def ssm_drive(dev, arch):
    """Drive the recurrent LM path of ``arch`` once (counts are the
    caller's to reset and read): the prefill, the recurrence check and the
    decode runs. Returns (results dict, the model pair, params, prefill
    tokens, the batch-4 prompts) for the measurements that follow."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import Model, count_params
    from repro_torch.models.transformer import effective_kinds

    res = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    full = get_config(arch)
    check((full.num_layers, full.d_model, full.d_ff, full.vocab_size,
           full.num_heads) == SSM_WIDTHS[arch], f"{arch}: {full}")
    base = dataclasses.replace(full, num_layers=SSM_LAYERS[arch])
    res["reduced"] = (f"{SSM_LAYERS[arch]} of {full.num_layers} layers, "
                      f"for the script's time")
    layers_n, vocab = base.num_layers, base.vocab_size
    kinds = effective_kinds(base)
    sites = sum(SSM_SITES[k.split("|")[0]] for k in kinds)
    res["kinds"] = {k: kinds.count(k) for k in sorted(set(kinds))}
    res["sites_per_step"] = sites
    models = {"unprotected": Model(base), "protected": Model(protect(base))}
    t0 = time.perf_counter()
    params = models["unprotected"].init(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    param_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    res["params"] = count_params(base)
    res["param_bytes"] = param_bytes
    res["init_s"] = time.perf_counter() - t0
    check(res["params"] == sum(t.numel() for t in tree.leaves(params)),
          f"{arch}: count_params disagrees with the initialised tree")
    log(f"SSM {base.name}: {res['params']} params, {param_bytes / 1e9:.2f} "
        f"GB ({base.param_dtype}), activations {base.dtype}, layers "
        f"{json.dumps(res['kinds'])}, {sites} protected products a step; "
        f"initialised on the card in {res['init_s']:.1f} s")

    # one protected prefill at 4 x 512 tokens, against the unprotected one
    b, t = LM_PREFILL
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, vocab, (b, t), generator=gen, device=dev,
                           dtype=torch.int32)
    tag = f"SSM {base.name}"
    res["prefill"] = lm_prefill(tag, models, params, tokens, sites,
                                gated=arch in SSM_PREFILL_GATED)

    # float32 activations, where both paths take the float32 weights: the
    # recurrence on the card (decode steps against the forward, the doubling
    # scan against the sequential recurrence at real decays), and the
    # protected forward against the unprotected one, held over the first
    # steps and traced over SSM_WINDOWS beside the witness: the unprotected
    # forward with every weight one ulp off
    f32 = {label: Model(dataclasses.replace(m.cfg, dtype="float32"))
           for label, m in models.items()}
    full = {"unprotected": f32["unprotected"].apply(
        params, {"tokens": tokens})[0]}
    witness = ulp_witness(f32["unprotected"], params, tokens)
    profile = {"witness": _window_errs(witness, full["unprotected"])}
    del witness
    full["protected"] = f32["protected"].apply(params, {"tokens": tokens})[0]
    profile["protected"] = _window_errs(full["protected"],
                                        full["unprotected"])
    steps8 = SSM_RECURRENCE_STEPS
    head = full["unprotected"][:, :steps8]
    cache = f32["unprotected"].init_cache(batch=b, max_len=steps8,
                                          dtype=torch.float32, device=dev)
    dec = torch.cat([f32["unprotected"].decode_step(
        params, cache, tokens[:, i:i + 1], i)[0] for i in range(steps8)],
        dim=1)
    scale = head.abs().max().item()
    err = (dec - head).abs().max().item()
    ft_err = (full["protected"][:, :steps8] - head).abs().max().item()
    check(bool(torch.isfinite(dec).all())
          and err <= SSM_RECURRENCE_TOL * scale
          and ft_err <= SSM_RECURRENCE_TOL * scale,
          f"{arch} at float32 over {steps8} steps: decode vs forward {err}, "
          f"protected vs unprotected {ft_err}, tol {SSM_RECURRENCE_TOL} * "
          f"{scale}")
    tail = {label: x[:, -16:] for label, x in full.items()}
    tail_err = (tail["protected"] - tail["unprotected"]).abs().max().item()
    tail_agree = (tail["protected"].argmax(-1)
                  == tail["unprotected"].argmax(-1)).float().mean().item()
    # the protected forward may depart from the unprotected one as the
    # model departs under a one-ulp perturbation, and no faster
    for w, v in zip(profile["protected"], profile["witness"]):
        check(w["err"] <= max(SSM_RECURRENCE_TOL * w["max"],
                              SSM_WITNESS_FACTOR * v["err"]),
              f"{arch} at float32 over positions {w['positions']}: "
              f"protected vs unprotected {w['err']} > max("
              f"{SSM_RECURRENCE_TOL} * {w['max']}, {SSM_WITNESS_FACTOR} * "
              f"the one-ulp witness's {v['err']})")
    res["recurrence"] = {"shape": [b, steps8], "err": err, "max": scale,
                         "tol": SSM_RECURRENCE_TOL * scale,
                         "protected_err": ft_err,
                         "protected_tail_err": tail_err,
                         "protected_tail_max":
                             tail["unprotected"].abs().max().item(),
                         "protected_tail_argmax_agreement": tail_agree,
                         "profile": profile}
    log(f"SSM {base.name} at float32: {steps8} decode steps vs the forward "
        f"err {err:.4e}, protected vs unprotected forward err {ft_err:.4e} "
        f"(tol {SSM_RECURRENCE_TOL * scale:.4e}); over the last 16 of "
        f"{t} positions protected vs unprotected err {tail_err:.4e} (max "
        f"{res['recurrence']['protected_tail_max']:.4e}), argmax agreement "
        f"{tail_agree:.3f}")
    log(f"SSM {base.name} at float32, err / max against the unprotected "
        f"forward by positions: " + "; ".join(
            f"[{w['positions'][0]}, {w['positions'][1]}) protected "
            f"{w['err'] / w['max']:.3e}, one-ulp witness "
            f"{v['err'] / v['max']:.3e}"
            for w, v in zip(profile["protected"], profile["witness"])))
    del full, head, tail, dec, cache, f32

    # greedy decode: each batch unprotected, protected, protected + SEUs
    rng = np.random.default_rng(SEED)
    res["decode"] = []
    prompts4 = None
    for batch in SSM_BATCHES[arch]:
        prompts = torch.as_tensor(
            rng.integers(0, vocab, (batch, LM_PROMPT)), dtype=torch.int32,
            device=dev)
        prompts4 = prompts if prompts4 is None else prompts4
        res["decode"].append(lm_decode(tag, models, params, prompts, sites,
                                       layers_n))
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"SSM {base.name} path peak device memory "
        f"{res['peak_memory_bytes'] / 1e9:.2f} GB (params "
        f"{param_bytes / 1e9:.2f} GB)")
    return res, models, params, tokens, prompts4


def ssm_measure(dev, arch, sites, models, params, tokens, prompts4, cuda_ms,
                host_ms, trace_call):
    """Times of ``arch``'s recurrent LM path (``sites`` protected products
    a decode step): the prefill through
    ``make_prefill_step`` by CUDA events, and one protected and one
    unprotected decode step at batch 4 under a primed torch.profiler
    (kernels, host ms, device ms, idle share), ``ft_matmul`` against its
    plain version at SSM_FTMM_SHAPES. Returns a dict (for xLSTM phase 11
    adds the CLI's ``--mode lm --preset full --ft`` run)."""
    res = {"prefill_ms": prefill_ms(f"SSM {arch}", models, params,
                                    {"tokens": tokens},
                                    cuda_ms)}

    # one decode step at batch 4 under torch.profiler, protected (one
    # ft_matmul_tile kernel a site) and unprotected
    res["decode_trace"] = trace_steps(f"SSM {arch}", models, params,
                                      prompts4, sites, host_ms, trace_call)
    res["ftmm_shapes"] = ftmm_rows(dev, f"SSM {arch}", SSM_FTMM_SHAPES[arch],
                                   cuda_ms)
    return res


# ---- phase 9: the MoE path. DeepSeek-V3 (MLA, 256 routed experts top-8
# and a shared expert) and then Llama-4 Maverick (GQA, top-1 experts and a
# shared expert, MoE every other layer) at their published widths, cut to 2
# layers (f32 params, bf16 activations, random weights from a seeded CUDA
# generator): a protected 4 x 512 prefill against the unprotected one held
# where the routing agrees, with every differing expert choice a near-tie;
# 8 decode steps against the forward at float32 activations; greedy decode
# at batch 4 unprotected, protected and protected under the CLI's schedule
# (7 ft_matmul launches and, in a MoE layer, 3 eager expert products a
# layer a step, the ledger exact); peak memory; then the times. One config
# at a time, the first freed before the second is built
MOE_ARCHS = ("deepseek_v3_671b", "llama4_maverick")
# the cuts (ModelConfig fields) and what they leave out
MOE_CUTS = {"deepseek_v3_671b": dict(num_layers=2, first_k_dense=1),
            "llama4_maverick": dict(num_layers=2, num_experts=64)}
MOE_REDUCED = {
    "deepseek_v3_671b": "2 of 61 layers (first_k_dense 3 -> 1: one MLA + "
                        "dense-FFN block, then one MLA + MoE block with all "
                        "256 routed experts and the shared expert); f32 "
                        "params as the port keeps them (55.8 GB)",
    "llama4_maverick": "2 of 48 layers (the MoE block, then a dense block); "
                       "64 of 128 routed experts (all 128 hold 64.4 GB at "
                       "f32 in the MoE layer alone); f32 params (42.0 GB)"}
# (d_model, heads, kv heads, d_ff, dense d_ff, vocab, experts in the config,
# top_k, moe_d_ff, shared experts, q/kv LoRA, rope/nope/v): published widths
MOE_WIDTHS = {
    "deepseek_v3_671b": (7168, 128, 128, 2048, 18432, 129280, 256, 8, 2048,
                         1, 1536, 512, 64, 128, 128),
    "llama4_maverick": (5120, 40, 8, 8192, 0, 202048, 128, 1, 8192, 1, 0, 0,
                        0, 0, 0)}
MOE_SITES = 7                      # protected products a layer: 4 + 3
MOE_EXPERT_PRODUCTS = 3            # eager batched products a MoE layer
MOE_MEMORY_LIMIT = 72e9            # bytes of device memory, params included
# a (token, slot) expert choice that differs between the protected and the
# unprotected prefill must be a near-tie: the unprotected router's k-th and
# (k+1)-th probabilities within MOE_NEAR_TIE[activations] of the k-th; the
# logits are held to MOE_LOGIT_TOL[activations] * max where the routing
# agrees. At float32 activations the two paths differ by their sums' order
# (1e-3, and the 2e-3 of decode vs forward). At bf16 each path rounds its
# products' outputs, and the unprotected one every weight (2^-9), which
# moves DeepSeek-V3's routers by percents of the k-th probability (the
# phase prints each layer's largest move and each flip's): the bf16 bound
# is eight bf16 steps, 2^-5, and the float32 run holds flips to 1e-3
MOE_NEAR_TIE = {"bfloat16": 2.0 ** -5, "float32": 1e-3}
MOE_LOGIT_TOL = {"bfloat16": LM_LOGIT_TOL, "float32": SSM_RECURRENCE_TOL}
MOE_CLI = ("--mode", "lm", "--arch", "deepseek-v3-671b", "--preset", "tiny",
           "--ft")
# ft_matmul against its plain version at the products the MoE path gives
# it, at a batch-4 decode step (M padded to 64) and at the 4 x 512 prefill:
# DeepSeek's MLA (wq_a, wq_b, wkv_a on 64-wide tiles, wo), dense FFN and
# shared expert; Llama-4's projections, FFN and shared expert
_MOE_KN = {
    "deepseek_v3_671b": ((7168, 1536), (1536, 24576), (7168, 576),
                         (16384, 7168), (7168, 18432), (18432, 7168),
                         (7168, 2048), (2048, 7168)),
    "llama4_maverick": ((5120, 5120), (5120, 1024), (5120, 8192),
                        (8192, 5120))}
MOE_FTMM_SHAPES = {arch: tuple((m, k, n) for m in (4, 2048)
                               for k, n in kn)
                   for arch, kn in _MOE_KN.items()}


def moe_config(arch):
    """``arch``'s published config with MOE_CUTS applied, its widths
    checked against MOE_WIDTHS."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    widths = (full.d_model, full.num_heads, full.num_kv_heads, full.d_ff,
              full.dense_d_ff, full.vocab_size, full.num_experts,
              full.top_k, full.moe_d_ff, full.num_shared_experts,
              full.q_lora_rank, full.kv_lora_rank, full.qk_rope_head_dim,
              full.qk_nope_head_dim, full.v_head_dim)
    check(widths == MOE_WIDTHS[arch], f"{arch}: {widths}")
    return full, dataclasses.replace(full, **MOE_CUTS[arch])


def _routing(routes, cfg, tokens_n):
    """Per MoE layer of one forward (``routes``: its ``moe._route`` calls'
    (probs, gate_idx) in order): the (T, E) masks of the routed and of the
    kept choices (the capacity dispatch's ``moe._slots``)."""
    import torch
    from repro_torch.models import moe
    e, k = cfg.num_experts, cfg.top_k
    cap = max(math.ceil(tokens_n * k / e * cfg.capacity_factor), 8)
    out = []
    for probs, idx in routes:
        routed = torch.zeros((tokens_n, e), dtype=torch.bool,
                             device=idx.device)
        routed.scatter_(1, idx.long(), True)
        order, keep, _, src = moe._slots(idx, cap, e)
        kept = torch.zeros_like(routed)
        kept[src[keep], idx.reshape(-1)[order][keep].long()] = True
        out.append((probs, routed, kept))
    return out


def moe_prefill(tag, models, params, tokens):
    """One protected ``Model.apply`` of ``tokens`` against the unprotected
    one, with each MoE layer's routing recorded: the differing (token,
    slot) expert choices counted, each a near-tie (MOE_NEAR_TIE of the
    models' activations) in the unprotected router; the float32 logits
    held to MOE_LOGIT_TOL * max at the positions whose routing and
    capacity keep agree in every MoE layer (a disagreement in a layer that
    attention follows also leaves out the later positions of its
    sequence), at least half of them. The protected run makes MOE_SITES
    ft_matmul launches a layer and MOE_EXPERT_PRODUCTS eager expert
    products a MoE layer, and flags nothing. Returns the results dict."""
    import torch
    from repro_torch.core.abft import gemm as abft_gemm
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.models import moe
    from repro_torch.models.transformer import effective_kinds

    cfg = models["protected"].cfg
    near_tie, logit_tol = MOE_NEAR_TIE[cfg.dtype], MOE_LOGIT_TOL[cfg.dtype]
    b, t = tokens.shape
    kinds = effective_kinds(cfg)
    moe_layers = [i for i, kd in enumerate(kinds) if kd.endswith("|moe")]
    route, batched = moe._route, abft_gemm.ft_matmul_batched
    rec, calls = [], [0]

    def recorded(*args):
        out = route(*args)
        rec.append((out[0], out[2]))
        return out

    def counted(*args, **kwargs):
        calls[0] += 1
        return batched(*args, **kwargs)

    moe._route, abft_gemm.ft_matmul_batched = recorded, counted
    try:
        before = ft_matmul.launches
        logits_p, aux = models["protected"].apply(params, {"tokens": tokens})
        launches = ft_matmul.launches - before
        expert_calls = calls[0]
        routes_p, rec[:] = list(rec), []
        logits_u, _ = models["unprotected"].apply(params, {"tokens": tokens})
        routes_u = list(rec)
    finally:
        moe._route, abft_gemm.ft_matmul_batched = route, batched
    layers_n = cfg.num_layers
    check(launches == MOE_SITES * layers_n
          and expert_calls == MOE_EXPERT_PRODUCTS * len(moe_layers),
          f"{tag} protected prefill: {launches} ft_matmul launches, "
          f"{expert_calls} eager expert products")
    check(tuple(logits_p.shape) == (b, t, cfg.vocab_size)
          and bool(torch.isfinite(logits_p).all()),
          f"{tag} protected prefill logits {tuple(logits_p.shape)}")
    check(float(aux["ft_flagged"]) == 0, f"{tag} protected prefill: flagged")
    check(len(routes_p) == len(routes_u) == len(moe_layers),
          f"{tag}: {len(routes_p)}, {len(routes_u)} router calls")
    k = cfg.top_k
    clean = torch.ones((b, t), dtype=torch.bool, device=tokens.device)
    layers_rows, gaps = [], []
    for layer, (p, u) in zip(moe_layers, zip(
            _routing(routes_p, cfg, b * t), _routing(routes_u, cfg, b * t))):
        (probs_p, routed_p, kept_p), (probs_u, routed_u, kept_u) = p, u
        flipped = (routed_p != routed_u).any(-1)
        moved = flipped | (kept_p != kept_u).any(-1)
        n_choices = int((routed_u & ~routed_p).sum())
        top_u = probs_u.topk(k + 1, dim=-1).values
        top_p = probs_p.topk(k + 1, dim=-1).values
        gap_u = (top_u[:, k - 1] - top_u[:, k]) / top_u[:, k - 1]
        gap_p = (top_p[:, k - 1] - top_p[:, k]) / top_p[:, k - 1]
        flips = torch.nonzero(flipped).flatten().tolist()
        for tok in flips:
            gaps.append({"layer": layer, "token": tok,
                         "gap": gap_u[tok].item(),
                         "protected_gap": gap_p[tok].item(),
                         "router_change": ((probs_p[tok] - probs_u[tok])
                                           .abs().max()
                                           / top_u[tok, k - 1]).item()})
        # a token's changed output reaches its later positions through
        # any layer that follows this one
        last = layer == cfg.num_layers - 1
        for tok in torch.nonzero(moved).flatten().tolist():
            bi, pi = divmod(tok, t)
            if last:
                clean[bi, pi] = False
            else:
                clean[bi, pi:] = False
        cap = max(math.ceil(b * t * k / cfg.num_experts
                            * cfg.capacity_factor), 8)
        layers_rows.append({
            "layer": layer, "capacity": cap,
            "differing_choices": n_choices, "flipped_tokens": len(flips),
            "keep_moved_tokens": int(moved.sum()),
            "dropped_choices": b * t * k - int(kept_u.sum()),
            "router_change_max": ((probs_p - probs_u).abs().max(-1).values
                                  / top_u[:, k - 1]).max().item(),
            "gap_median": gap_u.median().item()})
    for g in gaps:
        check(g["gap"] < near_tie,
              f"{tag} prefill: a routing flip at a wide gap: {g}")
    n_clean = int(clean.sum())
    check(n_clean >= clean.numel() // 2,
          f"{tag} prefill: {n_clean} of {clean.numel()} positions agree")
    sel_p, sel_u = logits_p[clean], logits_u[clean]
    del logits_p, logits_u
    scale = sel_u.abs().max().item()
    err = (sel_p - sel_u).abs().max().item()
    agree = (sel_p.argmax(-1) == sel_u.argmax(-1)).float().mean().item()
    del sel_p, sel_u
    check(err <= logit_tol * scale,
          f"{tag} protected vs unprotected prefill logits at the agreeing "
          f"positions: {err} > {logit_tol} * {scale}")
    log(f"{tag} prefill {b} x {t} at {cfg.dtype}: {launches} ft_matmul "
        f"launches, "
        f"{expert_calls} eager expert products, max score "
        f"{float(aux['ft_max_score']):.3e}; routing by MoE layer "
        f"{json.dumps(layers_rows)}; flips {json.dumps(gaps)} (near-tie "
        f"bound {near_tie}); logits at {n_clean} of {b * t} positions err "
        f"{err:.4e} (tol {logit_tol * scale:.4e}), argmax agreement "
        f"{agree:.3f}")
    return {"shape": [b, t], "activations": cfg.dtype,
            "near_tie": near_tie, "ft_matmul_launches": launches,
            "expert_products": expert_calls,
            "max_score": float(aux["ft_max_score"]), "routing": layers_rows,
            "flips": gaps, "clean_positions": n_clean, "logit_err": err,
            "logit_max": scale, "logit_tol": logit_tol * scale,
            "argmax_agreement": agree}


def moe_drive(dev, arch):
    """Drive the MoE path of ``arch`` once (counts are the caller's to
    reset and read): the prefill gate, decode against the forward and the
    decode runs. Returns (results dict, the model pair, params, prefill
    tokens, the batch-4 prompts) for the measurements that follow."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.core.abft import gemm as abft_gemm
    from repro_torch.models import Model, count_params
    from repro_torch.models.transformer import effective_kinds

    res = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    full, base = moe_config(arch)
    kinds = effective_kinds(base)
    moe_layers = sum(kd.endswith("|moe") for kd in kinds)
    res["kinds"] = list(kinds)
    res["reduced"] = MOE_REDUCED[arch]
    res["full_params"] = count_params(full)
    models = {"unprotected": Model(base), "protected": Model(protect(base))}
    t0 = time.perf_counter()
    params = models["unprotected"].init(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    param_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    res["params"] = count_params(base)
    res["param_bytes"] = param_bytes
    res["init_s"] = time.perf_counter() - t0
    check(res["params"] == sum(t.numel() for t in tree.leaves(params)),
          f"{arch}: count_params disagrees with the initialised tree")
    tag = f"MoE {base.name}"
    log(f"{tag}: {res['params']} params of the full config's "
        f"{res['full_params']}, {param_bytes / 1e9:.2f} GB "
        f"({base.param_dtype}), activations {base.dtype}, layers "
        f"{json.dumps(res['kinds'])}, {base.num_experts} experts top-"
        f"{base.top_k}; initialised on the card in {res['init_s']:.1f} s")
    log(f"{tag} reduced: {res['reduced']}")

    # the prefill gate at bf16 activations (capacity drops occur), then at
    # float32 activations, where the two paths differ by their sums' order
    b, t = LM_PREFILL
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, base.vocab_size, (b, t), generator=gen,
                           device=dev, dtype=torch.int32)
    res["prefill"] = moe_prefill(tag, models, params, tokens)
    res["prefill_float32"] = moe_prefill(
        tag, {label: Model(dataclasses.replace(m.cfg, dtype="float32"))
              for label, m in models.items()}, params, tokens)

    # float32 activations: 8 decode steps (MLA's absorbed path) against the
    # forward (its naive path), no capacity drop in the forward (the
    # reference's test_prefill_decode_equivalence)
    f32 = Model(dataclasses.replace(base, dtype="float32",
                                    capacity_factor=8.0))
    steps8 = SSM_RECURRENCE_STEPS
    head = f32.apply(params, {"tokens": tokens[:, :steps8]})[0]
    cache = f32.init_cache(batch=b, max_len=steps8, dtype=torch.float32,
                           device=dev)
    dec = torch.cat([f32.decode_step(params, cache, tokens[:, i:i + 1], i)[0]
                     for i in range(steps8)], dim=1)
    scale = head.abs().max().item()
    err = (dec - head).abs().max().item()
    check(bool(torch.isfinite(dec).all())
          and err <= SSM_RECURRENCE_TOL * scale,
          f"{tag} at float32 over {steps8} steps: decode vs forward {err}, "
          f"tol {SSM_RECURRENCE_TOL} * {scale}")
    res["decode_vs_forward"] = {"shape": [b, steps8], "err": err,
                                "max": scale,
                                "tol": SSM_RECURRENCE_TOL * scale}
    log(f"{tag} at float32: {steps8} decode steps vs the forward err "
        f"{err:.4e} (tol {SSM_RECURRENCE_TOL * scale:.4e})")
    del head, cache, dec, f32

    # greedy decode at batch 4: unprotected, protected, protected + SEUs,
    # the eager expert products counted
    batched_fn = abft_gemm.ft_matmul_batched
    counter = {"calls": 0}

    def counted(*args, **kwargs):
        counter["calls"] += 1
        return batched_fn(*args, **kwargs)

    abft_gemm.ft_matmul_batched = counted
    try:
        rng = np.random.default_rng(SEED)
        prompts4 = torch.as_tensor(
            rng.integers(0, base.vocab_size, (4, LM_PROMPT)),
            dtype=torch.int32, device=dev)
        res["decode"] = [lm_decode(
            tag, models, params, prompts4, MOE_SITES * base.num_layers,
            base.num_layers, batched=counter,
            batched_per_step=MOE_EXPERT_PRODUCTS * moe_layers)]
    finally:
        abft_gemm.ft_matmul_batched = batched_fn
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    check(res["peak_memory_bytes"] < MOE_MEMORY_LIMIT,
          f"{tag} path peak memory {res['peak_memory_bytes']} bytes")
    log(f"{tag} path peak device memory "
        f"{res['peak_memory_bytes'] / 1e9:.2f} GB (params "
        f"{param_bytes / 1e9:.2f} GB)")
    return res, models, params, tokens, prompts4


def expert_products(dev, cfg, params, cuda_ms):
    """The three routed-expert products of the model's MoE layer at a
    batch-4 decode step (C = 8 rows an expert, bf16 activations, its f32
    weights): the protected ones (three eager batched checked products)
    and the unprotected ones (each weight cast to bf16 for its product),
    timed by CUDA events against the byte bound of reading the three
    weights once at HBM_BYTES_PER_S."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.ssm import silu

    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = next(layer["moe"] for layer in params["stack"]["prefix"].values()
             if "moe" in layer)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    buf = torch.randn((e, 8, d), generator=gen, device=dev).to(
        torch.bfloat16)

    def protected():
        g, _ = moe._ft_expert_matmul(buf, p["wi_gate"], LM_FT_THRESHOLD,
                                     True)
        u, _ = moe._ft_expert_matmul(buf, p["wi_up"], LM_FT_THRESHOLD, True)
        return moe._ft_expert_matmul(silu(g) * u, p["wo"], LM_FT_THRESHOLD,
                                     True)[0]

    def unprotected():
        g = torch.bmm(buf, p["wi_gate"].to(torch.bfloat16))
        u = torch.bmm(buf, p["wi_up"].to(torch.bfloat16))
        return torch.bmm(silu(g) * u, p["wo"].to(torch.bfloat16))

    w_bytes = 3 * e * d * f * 4
    row = {"shape": [e, 8, d, f], "weight_bytes": w_bytes,
           "bound_ms": w_bytes / HBM_BYTES_PER_S * 1e3,
           "protected_ms": cuda_ms(protected, iters=5, warmup=1),
           "unprotected_ms": cuda_ms(unprotected, iters=5, warmup=1)}
    return row


def moe_measure(dev, arch, models, params, tokens, prompts4, cuda_ms,
                host_ms, trace_call):
    """Times of ``arch``'s MoE path: the prefill by CUDA events, one
    protected and one unprotected decode step at batch 4 under a primed
    torch.profiler (kernels, host ms, device ms, idle share), the three
    expert products against their byte bound, ``ft_matmul`` against its
    plain version at MOE_FTMM_SHAPES. Returns a dict (for DeepSeek phase
    11 adds the CLI's ``--mode lm --preset tiny --ft`` run)."""
    cfg = models["protected"].cfg
    res = {"prefill_ms": prefill_ms(f"MoE {arch}", models, params,
                                    {"tokens": tokens},
                                    cuda_ms)}
    res["decode_trace"] = trace_steps(
        f"MoE {arch}", models, params, prompts4,
        MOE_SITES * cfg.num_layers, host_ms, trace_call)

    res["expert_products"] = ep = expert_products(dev, cfg, params,
                                                  cuda_ms)
    log(f"MoE {arch} expert products at a decode step {tuple(ep['shape'])} "
        f"(E, C, d, f): protected {ep['protected_ms']:.3f} ms, unprotected "
        f"{ep['unprotected_ms']:.3f} ms; byte bound of the "
        f"{ep['weight_bytes'] / 1e9:.1f} GB of f32 weights read once "
        f"{ep['bound_ms']:.3f} ms")

    res["ftmm_shapes"] = ftmm_rows(dev, f"MoE {arch}",
                                   MOE_FTMM_SHAPES[arch], cuda_ms,
                                   prefill_iters=5)
    return res


# ---- phase 10: training. Gemma-3 1B at its published widths (f32 params,
# bf16 activations, random weights from a seeded CUDA generator) at
# launch.train's defaults: batch 8 x 256 tokens (M = 2048 in every
# product), lr 3e-4, remat "none", TokenPipeline(seed=0). Every protected
# linear's forward runs on ft_matmul; its backward is the product's
# gradient (torch.matmul), as the reference's autodiff gives
TRAIN_ARCH = "gemma3_1b"
TRAIN_PARAMS = 999_812_736         # count_params at the published widths
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_VOCAB = 262144
TRAIN_LR = 3e-4
TRAIN_STEPS = 20
TRAIN_WARMUP = 5                   # steps of a run left out of its times
TRAIN_SITES = 7                    # protected products a block: q k v o, MLP
# (a), (c), (d): losses relative; gradients, each leaf x its max. At
# float32 activations the three backends differ by their sums' order
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
# (c): site 4 (the MLP's gate product) of every block, token row 5,
# column 7, +300
TRAIN_SEU = (4.0, 5.0, 7.0, 1.0, 300.0)
TRAIN_SAVE_AFTER = 5               # (d): save after 5 steps, go on to 10
TRAIN_RESTART_STEPS = 10
# the step's five product shapes (M, K, N): q and o, k and v, o's input,
# the MLP's up and down
TRAIN_FTMM_SHAPES = ((2048, 1152, 1024), (2048, 1152, 256),
                     (2048, 1024, 1152), (2048, 1152, 6912),
                     (2048, 6912, 1152))
# the fewest steps and writes that exercise the restart: one step and its
# checkpoint (12 GB), then one step resumed from it and its own checkpoint
# (two writes, where (10, 12) wrote three and ran 12 steps: phase 14's room)
TRAIN_CLI = ("--arch", "gemma3-1b", "--preset", "full", "--ft-linears",
             "--ckpt-every", "10")
TRAIN_CLI_STEPS = (1, 2)
TRAIN_PARTS = ("forward", "backward", "optimizer")


def _build_dir():
    """The checkout's ``build/`` (git-ignored), where phase 10 writes its
    checkpoints (12 GB each) and removes them."""
    path = os.path.join(ROOT, "build")
    os.makedirs(path, exist_ok=True)
    return path


def _leaf_errs(got, want):
    """Each leaf's max |got - want| over its max |want|, worst first."""
    from repro_torch import tree

    errs = []
    for (path, g), w in zip(tree.leaves_with_path(got), tree.leaves(want)):
        errs.append((((g - w).abs().max() / w.abs().max()).item(),
                     "/".join(path)))
    return sorted(errs, reverse=True)


def train_setup(dev):
    """Gemma-3 1B's configs (unprotected, protected at the policy's 1e-4
    threshold), its params on the card and the run config of
    ``launch.train.build``."""
    import torch
    from repro_torch.launch.train import build
    from repro_torch.models import Model, count_params

    base, run = build(TRAIN_ARCH, "full", steps=TRAIN_STEPS,
                      batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR)
    prot, prun = build(TRAIN_ARCH, "full", steps=TRAIN_STEPS,
                       batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                       ft_linears=True)
    check((base.num_layers, base.d_model, base.d_ff, base.vocab_size,
           base.dtype, prot.ft.threshold)
          == (26, 1152, 6912, TRAIN_VOCAB, "bfloat16", 1e-4),
          f"{TRAIN_ARCH}: {base}")
    check(count_params(base) == TRAIN_PARAMS,
          f"{TRAIN_ARCH}: {count_params(base)} params")
    t0 = time.perf_counter()
    params = Model(base).init(torch.Generator(device=dev).manual_seed(SEED),
                              device=dev)
    torch.cuda.synchronize()
    log(f"train {base.name}: {TRAIN_PARAMS} params, "
        f"{4 * TRAIN_PARAMS / 1e9:.2f} GB f32 ({16 * TRAIN_PARAMS / 1e9:.2f} "
        f"GB with gradients and both AdamW moments), activations "
        f"{base.dtype}, initialised in {time.perf_counter() - t0:.1f} s")
    return ({"unprotected": (Model(base), run),
             "protected": (Model(prot), prun)}, params)


def _batch(dev, step):
    """``launch.train``'s batch of ``step``: TokenPipeline(seed=0) at
    Gemma-3's vocabulary, on ``dev``."""
    import torch
    from repro_torch.data import TokenPipeline

    pipe = TokenPipeline(seed=0, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         vocab_size=TRAIN_VOCAB)
    return {k: torch.from_numpy(v).to(dev) for k, v in pipe(step).items()}


def _f32_on(cfg, backend=None):
    """``cfg`` at float32 activations, every linear protected on the GEMM
    ``backend`` ("fused": ft_matmul; "eager"), or unprotected."""
    return dataclasses.replace(cfg, dtype="float32", ft=dataclasses.replace(
        cfg.ft, protect_linears=backend is not None,
        gemm_backend=backend or cfg.ft.gemm_backend))


def backend_agreement(tag, cfg, params, batch, sites, eager_calls,
                      loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_GRAD_TOL):
    """One step's loss and gradients at float32 activations three ways:
    protected on ft_matmul (``sites`` launches), protected on the eager
    path (``sites`` eager ABFT calls) and unprotected, the latter two held
    against the first (the loss to ``loss_tol`` relative, each gradient
    leaf to ``grad_tol`` x its max), nothing flagged. Returns (the rows,
    the fused run's loss and gradients)."""
    import torch
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.models import Model
    from repro_torch.train.loop import _value_and_grad

    res, ref = {}, None
    for label, backend in (("fused", "fused"), ("eager", "eager"),
                           ("unprotected", None)):
        before, calls = ft_matmul.launches, len(eager_calls)
        (total, (_, aux)), grads = _value_and_grad(
            Model(_f32_on(cfg, backend)), params, batch, block_q=1024,
            remat="none")
        launches = ft_matmul.launches - before
        calls = len(eager_calls) - calls
        check(launches == (sites if label == "fused" else 0)
              and calls == (sites if label == "eager" else 0),
              f"{tag} {label}: {launches} ft_matmul launches, {calls} "
              f"eager ABFT calls")
        check(float(aux["ft_flagged"]) == 0
              and bool(torch.isfinite(total)),
              f"{tag} {label}: loss {float(total)}, flagged "
              f"{float(aux['ft_flagged'])}")
        row = {"loss": float(total), "ft_matmul_launches": launches,
               "eager_calls": calls, "max_score": float(aux["ft_max_score"])}
        if ref is None:
            ref = (total, grads)
        else:
            rel = abs(float(total) - float(ref[0])) / abs(float(ref[0]))
            errs = _leaf_errs(grads, ref[1])
            check(rel <= loss_tol and errs[0][0] <= grad_tol,
                  f"{tag} {label} vs fused: loss {rel:.3e}, worst leaf "
                  f"{errs[0]} (tolerances {loss_tol:.3e}, {grad_tol:.3e})")
            row.update(loss_rel_err=rel, worst_leaf=list(errs[0]))
            del grads
        res[label] = row
        log(f"{tag} {label} at float32 activations: loss "
            f"{row['loss']:.7f}, {launches} ft_matmul launches, {calls} "
            f"eager ABFT calls, max score {row['max_score']:.3e}"
            + (f"; vs fused: loss {row['loss_rel_err']:.3e} relative, "
               f"worst gradient leaf {row['worst_leaf'][0]:.3e} of its max "
               f"({row['worst_leaf'][1]})" if "worst_leaf" in row else ""))
    return res, ref


def train_grad_gate(dev, base, params, eager_calls):
    """(a): one step's loss and gradients at float32 activations three
    ways, protected on ft_matmul, protected on the eager path, unprotected,
    held against each other (``backend_agreement``); (c): one SEU at
    TRAIN_SEU's site of every block, corrected in each, the loss and
    gradients the clean step's. Returns the results dict."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.transformer import layer_groups
    from repro_torch.train.loop import _value_and_grad

    f32 = _f32_on(base.cfg)
    res, ref = backend_agreement("train (a)", base.cfg, params,
                                 _batch(dev, 0),
                                 base.cfg.num_layers * TRAIN_SITES,
                                 eager_calls)

    # (c) one SEU at one site: every block builds its own FTContext, so the
    # site addresses one product in each of the prefix, repeated and tail
    # blocks of layer_groups
    g = layer_groups(f32)
    blocks = len(g.prefix) + g.n_super * len(g.super_block) + len(g.tail)
    check(blocks == base.cfg.num_layers, f"layer groups {g}")
    inject = torch.tensor([TRAIN_SEU], dtype=torch.float32, device=dev)
    (total, (_, aux)), grads = _value_and_grad(
        Model(_f32_on(base.cfg, "fused")), params, _batch(dev, 0),
        block_q=1024, remat="none", inject=inject)
    rel = abs(float(total) - float(ref[0])) / abs(float(ref[0]))
    errs = _leaf_errs(grads, ref[1])
    seu = {"site": TRAIN_SEU, "blocks": blocks,
           "groups": [len(g.prefix), g.n_super, len(g.super_block),
                      len(g.tail)],
           "ft_flagged": float(aux["ft_flagged"]),
           "ft_corrected": float(aux["ft_corrected"]),
           "max_score": float(aux["ft_max_score"]), "loss_rel_err": rel,
           "worst_leaf": list(errs[0])}
    check(seu["ft_flagged"] == seu["ft_corrected"] == blocks
          and rel <= TRAIN_LOSS_TOL and errs[0][0] <= TRAIN_GRAD_TOL,
          f"train (c) SEU step: {seu}")
    log(f"train (c) SEU at site {int(TRAIN_SEU[0])} (row "
        f"{int(TRAIN_SEU[1])}, column {int(TRAIN_SEU[2])}, +{TRAIN_SEU[4]}) "
        f"of every block: {blocks} blocks addressed (prefix "
        f"{len(g.prefix)} + {g.n_super} x {len(g.super_block)} repeated + "
        f"tail {len(g.tail)}), flagged {seu['ft_flagged']:.0f}, corrected "
        f"{seu['ft_corrected']:.0f}, max score {seu['max_score']:.3e}; vs "
        f"the clean step: loss {rel:.3e} relative, worst gradient leaf "
        f"{errs[0][0]:.3e} of its max")
    res["seu"] = seu
    return res


def train_run(tag, model, run, params, opt_state, start, stop, eager_calls,
              batch, sites, mgr=None, batched=None, batched_per_step=0):
    """Steps ``start``..``stop - 1`` of ``make_train_step`` on ``params``
    and ``opt_state`` (written in place), each between CUDA events, on
    ``batch(device, step)``; every loss finite; a protected step makes
    exactly ``sites`` ft_matmul launches, flags nothing and calls no eager
    ABFT path; an unprotected one launches nothing. With ``batched`` (a
    counter of the eager batched expert products, ``{"calls": n}``), a
    protected step also makes exactly ``batched_per_step`` of them and an
    unprotected one none. With ``mgr``, the state is saved after
    TRAIN_SAVE_AFTER steps. Returns the rows."""
    import torch
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.train import make_train_step

    step_fn = make_train_step(model, run)
    want = sites if model.cfg.ft.protect_linears else 0
    rows = []
    for step in range(start, stop):
        b = batch(model_dev(params), step)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        before, calls = ft_matmul.launches, len(eager_calls)
        experts = batched["calls"] if batched is not None else 0
        e0.record()
        params, opt_state, m = step_fn(params, opt_state, b, step)
        e1.record()
        e1.synchronize()
        row = {k: float(v) for k, v in m.items()}
        row.update(step=step, ms=e0.elapsed_time(e1),
                   ft_matmul_launches=ft_matmul.launches - before)
        if batched is not None:
            row["expert_products"] = batched["calls"] - experts
            want_experts = batched_per_step if want else 0
            check(row["expert_products"] == want_experts,
                  f"train {tag} step {step}: {row['expert_products']} eager "
                  f"batched expert products (not {want_experts})")
        check(math.isfinite(row["loss"]) and row["skipped_updates"] == 0,
              f"train {tag} step {step}: {row}")
        check(row["ft_matmul_launches"] == want
              and len(eager_calls) == calls,
              f"train {tag} step {step}: {row['ft_matmul_launches']} "
              f"ft_matmul launches (not {want}), "
              f"{len(eager_calls) - calls} eager ABFT calls")
        check(row["ft_flagged"] == 0,
              f"train {tag} step {step}: a clean step flagged "
              f"{row['ft_flagged']:.0f} at threshold "
              f"{model.cfg.ft.threshold}")
        rows.append(row)
        if mgr is not None and step == TRAIN_SAVE_AFTER - 1:
            # the write is waited for at once: on a background thread it
            # would share the host with the timed, host-bound steps
            mgr.save(step, (params, opt_state))
            mgr.wait()
    return rows


def model_dev(params):
    return params["embed"]["embedding"].device


def train_drive(dev, eager_calls):
    """Drive training once (counts are the caller's to reset and read): (a)
    and (c) at float32 activations, then (b) TRAIN_STEPS steps protected
    and TRAIN_STEPS unprotected from the same weights, the protected run
    saved after TRAIN_SAVE_AFTER steps, and (d) the restart from that
    checkpoint into fresh tensors, to step TRAIN_RESTART_STEPS. Returns
    (results, models, the initial params) for ``train_measure``."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch import optim, tree
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint

    models, params0 = train_setup(dev)
    sites = TRAIN_SITES * models["protected"][0].cfg.num_layers
    res = {"arch": TRAIN_ARCH, "params": TRAIN_PARAMS,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "lr": TRAIN_LR}
    res["grad_gate"] = train_grad_gate(dev, models["protected"][0], params0,
                                       eager_calls)
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt_", dir=_build_dir())
    try:
        mgr = CheckpointManager(ckpt_dir)
        for label in ("protected", "unprotected"):
            model, run = models[label]
            params = tree.tree_map(lambda t: t.detach().clone(), params0)
            opt_state = optim.init_state(params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            rows = train_run(label, model, run, params, opt_state, 0,
                             TRAIN_STEPS, eager_calls, _batch, sites,
                             mgr if label == "protected" else None)
            losses = [r["loss"] for r in rows]
            first, last = np.mean(losses[:5]), np.mean(losses[-5:])
            check(last < first, f"train {label}: the loss did not fall: "
                                f"{losses}")
            # the median: a host-bound step's time moves with the host's load
            timed = [r["ms"] for r in rows[TRAIN_WARMUP:]]
            res[label] = {
                "losses": losses, "rows": rows,
                "first5_mean": float(first), "last5_mean": float(last),
                "ms_per_step": float(np.median(timed)),
                "ms_per_step_range": [float(np.min(timed)),
                                      float(np.max(timed))],
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
                / (float(np.median(timed)) / 1e3),
                "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                "ft_matmul_launches_per_step":
                    rows[-1]["ft_matmul_launches"],
                "ft_flagged": sum(r["ft_flagged"] for r in rows)}
            log(f"train (b) {label}: {TRAIN_STEPS} steps, loss "
                f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 5 "
                f"{first:.4f}, last 5 {last:.4f}); "
                f"{res[label]['ms_per_step']:.2f} ms a step, the median of "
                f"steps {TRAIN_WARMUP}-{TRAIN_STEPS - 1} (range "
                f"{min(timed):.2f}-{max(timed):.2f}), "
                f"{res[label]['tokens_per_s']:.0f} tokens/s, "
                f"{rows[-1]['ft_matmul_launches']} ft_matmul launches a "
                f"step, flagged {res[label]['ft_flagged']:.0f}, peak "
                f"{res[label]['peak_memory_bytes'] / 1e9:.2f} GB")
            del params, opt_state
            torch.cuda.empty_cache()

        # (d): restore the protected run's state after step 4 into fresh
        # tensors and go on to the tenth step
        t0 = time.perf_counter()
        mgr.wait()
        model, run = models["protected"]
        zeros = tree.tree_map(torch.zeros_like, params0)
        (params, opt_state), meta = restore_checkpoint(
            ckpt_dir, (zeros, optim.init_state(zeros)))
        del zeros
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(meta["step"] == TRAIN_SAVE_AFTER - 1
              and int(opt_state.step) == TRAIN_SAVE_AFTER,
              f"train (d): restored {meta}, step {int(opt_state.step)}")
        rows = train_run("restart", model, run, params, opt_state,
                         TRAIN_SAVE_AFTER, TRAIN_RESTART_STEPS, eager_calls,
                         _batch, sites)
        del params, opt_state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    want = res["protected"]["losses"][TRAIN_SAVE_AFTER:TRAIN_RESTART_STEPS]
    errs = [abs(r["loss"] - w) / abs(w) for r, w in zip(rows, want)]
    res["restart"] = {"losses": [r["loss"] for r in rows],
                      "uninterrupted": want, "rel_errs": errs,
                      "save_wait_and_restore_s": restore_s}
    check(max(errs) <= TRAIN_LOSS_TOL,
          f"train (d) restart: losses {res['restart']}")
    log(f"train (d) restart after {TRAIN_SAVE_AFTER} steps through "
        f"CheckpointManager ({restore_s:.1f} s to finish the write and "
        f"restore {12 * TRAIN_PARAMS / 1e9:.1f} GB): steps "
        f"{TRAIN_SAVE_AFTER}-"
        f"{TRAIN_RESTART_STEPS - 1} losses within {max(errs):.3e} relative "
        f"of the uninterrupted run")
    return res, models, params0


def train_cli(steps):
    """``python -m repro_torch.launch.train`` at TRAIN_CLI, first to
    ``steps[0]`` steps, then again to ``steps[1]`` on the same checkpoint
    directory: each exits 0 with finite losses and nothing flagged, the
    second resumes from the first's last step. Returns the runs' rows."""
    import shutil
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ckpt_dir = tempfile.mkdtemp(prefix="cli_ckpt_", dir=_build_dir())
    out = []
    try:
        for i, n in enumerate(steps):
            argv = [*TRAIN_CLI, "--steps", str(n), "--ckpt-dir", ckpt_dir,
                    "--log-every", "1"]
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", *argv],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=600)
            text = proc.stdout + proc.stderr
            lines = re.findall(r"step +(\d+) loss (\S+) ce \S+ gnorm \S+ "
                               r"ft_flagged (\d+)", text)
            first = 0 if i == 0 else steps[i - 1]
            resumed = f"[restore] resumed from step {first - 1}"
            check(proc.returncode == 0
                  and [int(s) for s, _, _ in lines] == list(range(first, n))
                  and all(math.isfinite(float(loss)) and f == "0"
                          for _, loss, f in lines)
                  and (i == 0) == (resumed not in text),
                  f"launch.train {' '.join(argv)}: exit {proc.returncode}\n"
                  f"{text[-3000:]}")
            row = {"argv": argv, "seconds": time.perf_counter() - t0,
                   "steps": [[int(s), float(loss)] for s, loss, _ in lines],
                   "resumed": i > 0}
            out.append(row)
            log(f"launch.train {' '.join(argv)}: steps "
                f"{lines[0][0]}-{lines[-1][0]}, loss {lines[0][1]} -> "
                f"{lines[-1][1]}" + (f"; '{resumed}'" if i else "")
                + f" ({row['seconds']:.1f} s with the process start and "
                  f"the checkpoints)")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def train_split(evs, mark):
    """One traced train step's kernels by part, each kernel counted once,
    at the host time of the runtime call that launched it (the call and
    the kernel share the tracer's correlation id): before the backward's
    first ``autograd::engine::evaluate_function`` op the forward (with
    the schedule's scalar kernels), up to the end of its last one the
    backward, after it the optimizer. The primer's kernels and the call
    ``mark``'s own device-side range are left out. Returns ``({part:
    [kernels, device ms, ft_matmul_tile kernels]} over TRAIN_PARTS, the
    names of the kernels no launch was found for)``."""
    import torch
    from repro_torch.kernels.trace_age import PRIMER

    cuda_dev = torch.autograd.DeviceType.CUDA
    t_mark = mark.time_range.start
    host = [e for e in evs
            if e.device_type != cuda_dev and e.time_range.start >= t_mark]
    bwd = [e.time_range for e in host
           if e.name.startswith("autograd::engine::evaluate_function")]
    t0 = min((r.start for r in bwd), default=math.inf)
    t1 = max((r.end for r in bwd), default=math.inf)
    launch = {e.id: e.time_range.start for e in host
              if e.name.startswith("cu")}
    out = {part: [0, 0.0, 0] for part in TRAIN_PARTS}
    unmatched = []
    for k in evs:
        if (k.device_type != cuda_dev or PRIMER in k.name
                or k.name == mark.name):
            continue
        t = launch.get(k.id)
        if t is None:
            unmatched.append(k.name)
            continue
        row = out["forward" if t < t0 else "backward" if t <= t1
                  else "optimizer"]
        row[0] += 1
        row[1] += k.time_range.elapsed_us() / 1e3
        row[2] += "ft_matmul_tile" in k.name
    return out, unmatched


def trace_train_step(tag, model, run, params, batch, want, trace_call):
    """A primed torch.profiler trace of one ``make_train_step`` step on
    ``params`` (updated in place) and a fresh optimizer state, its kernels
    split into forward, backward and optimizer (``train_split``): every
    kernel counted, and all ``want`` ft_matmul_tile kernels in the
    forward. Returns (the parts, the trace's row)."""
    from repro_torch import optim
    from repro_torch.train import make_train_step

    opt_state = optim.init_state(params)
    step_fn = make_train_step(model, run)
    counter = iter(range(4, 100))

    def fn():
        step_fn(params, opt_state, batch, next(counter))

    kern, window, idle, (split, unmatched) = trace_call(
        fn, lambda names: sum("ft_matmul_tile" in k for k in names)
        == want, split=train_split)
    device_ms = sum(kms for _, kms in kern)
    check(not unmatched
          and sum(n for n, _, _ in split.values()) == len(kern)
          and split["backward"][0] > 0 and split["optimizer"][0] > 0
          and [split[p][2] for p in TRAIN_PARTS] == [want, 0, 0],
          f"{tag} step split: {split} of {len(kern)} kernels, {want} "
          f"ft_matmul_tile wanted in the forward; no launch found for "
          f"{len(unmatched)}: {sorted(set(unmatched))[:10]}")
    parts = {p: {"kernels": n, "device_ms": ms, "share": ms / device_ms,
                 "ft_matmul_tile": f} for p, (n, ms, f) in split.items()}
    log(f"{tag} step parts (device time of the traced step's kernels by "
        f"when they were launched): " + ", ".join(
            f"{p} {ms:.2f} ms ({ms / device_ms:.1%}, {n} kernels, {f} "
            f"ft_matmul_tile)" for p, (n, ms, f) in split.items()))
    groups = {}
    for name, kms in kern:
        key = re.sub(r"^void ", "", name)[:60]
        n, tot = groups.get(key, (0, 0.0))
        groups[key] = (n + 1, tot + kms)
    top = sorted(groups.items(), key=lambda kv: -kv[1][1])[:10]
    row = {"kernels": len(kern),
           "ft_matmul_tile": sum("ft_matmul_tile" in k for k, _ in kern),
           "ft_matmul_tile_ms": sum(kms for k, kms in kern
                                    if "ft_matmul_tile" in k),
           "device_ms": device_ms, "window_ms": window, "idle_share": idle,
           "top": [[k, n, kms] for k, (n, kms) in top]}
    log(f"{tag} step trace: {row['kernels']} kernels, "
        f"{row['ft_matmul_tile']} ft_matmul_tile "
        f"({row['ft_matmul_tile_ms']:.3f} ms), {row['device_ms']:.3f} ms on "
        f"the device in a {window:.3f} ms window (idle {idle:.1%}); by "
        f"name: " + "; ".join(f"{k} x{n} {kms:.3f} ms"
                              for k, (n, kms) in top))
    return parts, row


def train_measure(dev, models, params0, cuda_ms, host_ms, trace_call):
    """Phase 10's measurements after the drive: a primed torch.profiler
    trace of one ``make_train_step`` step protected and one unprotected,
    its kernels split into forward, backward and optimizer
    (``train_split``: ft_matmul only in the forward), the protected loss
    and gradients under remat "block" and "dots" (twice the launches,
    nothing flagged), ft_matmul against its plain version at the step's
    five product shapes, and the CLI run twice on one checkpoint
    directory. Returns a dict."""
    import torch
    from repro_torch import tree
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.train.loop import _value_and_grad

    res = {"parts": {}, "trace": {}}
    params = tree.tree_map(lambda t: t.detach().clone(), params0)
    for label in ("protected", "unprotected"):
        model, run = models[label]
        want = TRAIN_SITES * model.cfg.num_layers \
            if label == "protected" else 0
        res["parts"][label], res["trace"][label] = trace_train_step(
            f"train ({label})", model, run, params, _batch(dev, 4), want,
            trace_call)
    # remat: each block's checks run again in the recompute, so a
    # protected step launches ft_matmul twice a product; the stats are the
    # first forward's (nothing flagged)
    res["remat"] = {}
    model, run = models["protected"]
    want = 2 * TRAIN_SITES * model.cfg.num_layers
    for remat in ("block", "dots"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        before = ft_matmul.launches
        e0.record()
        (total, (_, aux)), grads = _value_and_grad(
            model, params, _batch(dev, 0), block_q=run.parallel.attn_block_q,
            remat=remat)
        e1.record()
        e1.synchronize()
        row = {"ft_matmul_launches": ft_matmul.launches - before,
               "ft_flagged": float(aux["ft_flagged"]),
               "ms": e0.elapsed_time(e1),
               "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
        del grads
        check(row["ft_matmul_launches"] == want and row["ft_flagged"] == 0
              and math.isfinite(float(total)),
              f"train remat {remat}: {row}, loss {float(total)}")
        res["remat"][remat] = row
        log(f"train remat {remat!r}: loss and gradients in "
            f"{row['ms']:.2f} ms (the first call), "
            f"{row['ft_matmul_launches']} ft_matmul launches (forward and "
            f"recompute), flagged {row['ft_flagged']:.0f}, peak "
            f"{row['peak_memory_bytes'] / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()
    res["ftmm_shapes"] = ftmm_rows(dev, "train", TRAIN_FTMM_SHAPES, cuda_ms,
                                   prefill_iters=10)
    res["cli"] = train_cli(TRAIN_CLI_STEPS)
    return res


# ---- phase 11: the encoder-decoder and the VLM. Whisper-base (6 encoder
# and 6 decoder layers, d_model 512, vocab 51865; the audio frontend stub
# takes 1500 frames of 80) and then InternVL2-1B (24 layers, d_model 896,
# GQA with q/k/v biases, vocab 151655; the patch frontend stub takes 256
# patches of 1024) at their published widths and full depth (f32 params,
# bf16 activations, random weights from a seeded CUDA generator, frames
# and patches standard normal from numpy's SEED): (a) the prefill through
# make_prefill_step, protected against unprotected at bf16 and at float32;
# (b) greedy decode, protected and unprotected (Whisper's cross caches
# still zeros after it: the reference's decode passes no encoder output,
# ROADMAP queue 3 "In the reference itself" item 8); training through
# make_train_step at launch.train's batch with frames or patches: the
# three backends at float32, then ENCDEC_TRAIN_STEPS bf16 steps each way;
# then the times. One config at a time, the first freed before the second
# is built; both CLIs at the end, started together
ENCDEC_ARCHS = ("whisper_base", "internvl2_1b")
# (layers, d_model, d_ff, vocab, heads): the published widths; Whisper's
# layers are each of its encoder's and decoder's
ENCDEC_WIDTHS = {"whisper_base": (6, 512, 2048, 51865, 8),
                 "internvl2_1b": (24, 896, 4864, 151655, 14)}
# ft_matmul launches of a protected Model.apply and of a protected decode
# step: Whisper 6 a block (q k v o, wi wo) in its 6 encoder and 6 decoder
# blocks, and in a decode step its decoder's alone (the cross-attention's
# products are plain, as the frontend's and the head's); InternVL2 7 a
# layer (q k v o, the SwiGLU's three)
ENCDEC_SITES = {"whisper_base": (72, 36), "internvl2_1b": (168, 168)}
# the prefill (batch, tokens): Whisper's 448 is its decoder's maximum, and
# its encoder's products run at M = 4 x 1500 = 6000, which the GEMM plan
# pads to 6016 (no multiple of 128: 64-row tiles); InternVL2's 256 tokens
# follow its 256 patches, so the logits cover 512 positions
ENCDEC_PREFILL = {"whisper_base": (4, 448), "internvl2_1b": (4, 256)}
ENCDEC_BATCHES = {"whisper_base": (4, 64), "internvl2_1b": (4,)}
# the float32 prefill, protected against unprotected: the two differ by
# their sums' order
ENCDEC_F32_TOL = 2e-3
ENCDEC_TRAIN_STEPS = 10
# the CLIs at the published widths, with the demo schedule: Whisper's
# blocks take no fault descriptor (queue 3 item 9: 0 detected), each of
# InternVL2's 24 layers takes both faults
ENCDEC_CLI = {"whisper_base": (("--mode", "lm", "--arch", "whisper-base",
                                "--preset", "full", "--ft"), 0),
              "internvl2_1b": (("--mode", "lm", "--arch", "internvl2-1b",
                                "--preset", "full", "--ft"), 48)}
# the new products (K, N), timed at a decode step's M (4, padded to 64)
# and at the prefill's (Whisper's encoder: 6000; InternVL2: 4 x 512)
_ENCDEC_KN = {"whisper_base": ((512, 512), (512, 2048), (2048, 512)),
              "internvl2_1b": ((896, 896), (896, 128), (896, 4864),
                               (4864, 896))}
ENCDEC_FTMM_SHAPES = {
    arch: tuple((m, k, n) for m in (4, big) for k, n in _ENCDEC_KN[arch])
    for arch, big in (("whisper_base", 6000), ("internvl2_1b", 2048))}


def encdec_inputs(dev, cfg, batch, seed):
    """The frontend stub's input of ``batch`` examples: Whisper's frames
    (batch, 1500, 80) or InternVL2's patch embeddings (batch, 256, 1024),
    float32 standard normal from numpy's ``seed``, as the reference's
    ``tests/test_models_smoke._batch_for`` draws them."""
    import numpy as np
    import torch

    if cfg.is_encdec:
        key, n = "frames", cfg.max_source_positions
    else:
        key, n = "patch_embeds", cfg.num_patches
    x = np.random.default_rng(seed).standard_normal(
        (batch, n, cfg.frontend_dim), dtype=np.float32)
    return {key: torch.from_numpy(x).to(dev)}


def encdec_prefill(tag, models, params, batch, sites, eager_calls):
    """(a): the prefill of ``batch`` through ``make_prefill_step`` (the
    last position's float32 logits), protected (``sites`` ft_matmul
    launches, no eager ABFT call, no flag) against unprotected, at the
    config's bf16 activations (LM_LOGIT_TOL x max) and at float32
    (ENCDEC_F32_TOL x max). Returns the rows by activation type."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step

    out = {}
    for dtype, tol in (("bfloat16", LM_LOGIT_TOL),
                       ("float32", ENCDEC_F32_TOL)):
        logits, score, measured = {}, 0.0, None
        for label, m in models.items():
            cfg = dataclasses.replace(m.cfg, dtype=dtype)
            step = make_prefill_step(Model(cfg), RunConfig(model=cfg))
            before, calls = ft_matmul.launches, len(eager_calls)
            logits[label], aux = step(params, batch)
            launches = ft_matmul.launches - before
            want = sites if label == "protected" else 0
            check(launches == want and len(eager_calls) == calls
                  and float(aux["ft_flagged"]) == 0,
                  f"{tag} {label} prefill at {dtype}: {launches} ft_matmul "
                  f"launches (not {want}), {len(eager_calls) - calls} eager "
                  f"ABFT calls, flagged {float(aux['ft_flagged'])}")
            score = max(score, float(aux["ft_max_score"]))
            if label == "protected":
                measured = launches
        p, u = logits["protected"], logits["unprotected"]
        b = batch["tokens"].shape[0]
        vocab = models["protected"].cfg.vocab_size
        check(tuple(p.shape) == (b, vocab) and p.dtype == torch.float32
              and bool(torch.isfinite(p).all()),
              f"{tag} prefill at {dtype}: logits {tuple(p.shape)} {p.dtype}")
        scale = u.abs().max().item()
        err = (p - u).abs().max().item()
        agree = (p.argmax(-1) == u.argmax(-1)).float().mean().item()
        check(err <= tol * scale, f"{tag} protected vs unprotected prefill "
                                  f"at {dtype}: {err} > {tol} * {scale}")
        out[dtype] = {"shape": list(batch["tokens"].shape),
                      "ft_matmul_launches": measured, "max_score": score,
                      "logit_err": err, "logit_max": scale,
                      "logit_tol": tol * scale, "argmax_agreement": agree}
        log(f"{tag} prefill {tuple(batch['tokens'].shape)} at {dtype} "
            f"through make_prefill_step: {measured} ft_matmul launches, max "
            f"score {score:.3e}; protected vs unprotected last-position "
            f"logits err {err:.4e} (tol {tol * scale:.4e}, max "
            f"{scale:.4e}), argmax agreement {agree:.3f}")
    return out


def encdec_decode(tag, models, params, prompts, sites):
    """(b): ``lm_decode`` of ``prompts`` (InternVL2's also under the
    CLI's schedule, its ledger and tokens gated), every cache the decode
    makes kept; the encoder-decoder's cross caches must still be all zeros
    after it. Returns lm_decode's rows."""
    from repro_torch.models import Model

    held = []
    init_cache = Model.init_cache

    def keep(self, *args, **kwargs):
        held.append(init_cache(self, *args, **kwargs))
        return held[-1]

    Model.init_cache = keep
    try:
        rows = lm_decode(tag, models, params, prompts, sites,
                         models["protected"].cfg.num_layers)
    finally:
        Model.init_cache = init_cache
    if models["protected"].cfg.is_encdec:
        cross = [c[k] for cache in held for c in
                 (layer["cross"] for layer in cache["decoder"].values())
                 for k in ("k", "v")]
        check(held and not any(bool(t.any()) for t in cross),
              f"{tag} decode: a cross cache is no longer zeros")
        rows["zero_cross_caches"] = len(cross)
        log(f"{tag} decode batch {prompts.shape[0]}: all {len(cross)} cross "
            f"caches of its {len(held)} decodes are still zeros (the "
            f"reference's decode passes no encoder output)")
    return rows


def encdec_train_batch(cfg, dev, step):
    """Training's batch of ``step`` for ``cfg``: ``launch.train``'s tokens
    (TokenPipeline(seed=0), 8 x 256) with frames or patches from numpy's
    SEED + step, on ``dev``."""
    import torch
    from repro_torch.data import TokenPipeline

    pipe = TokenPipeline(seed=0, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         vocab_size=cfg.vocab_size)
    out = {k: torch.from_numpy(v).to(dev) for k, v in pipe(step).items()}
    out.update(encdec_inputs(dev, cfg, TRAIN_BATCH, SEED + step))
    return out


def encdec_train(dev, arch, params0, sites, eager_calls):
    """Training at launch.train's batch (8 x 256 tokens of
    ``TokenPipeline(seed=0)``) with frames or patches from numpy's SEED +
    step: one step's loss and gradients at float32 activations on the
    three backends (``backend_agreement``), then ENCDEC_TRAIN_STEPS bf16
    steps protected and as many unprotected from the same weights: finite
    losses, the last five below the first five, ``sites`` ft_matmul
    launches a protected step (``encdec_measure``'s trace puts them all in
    the forward), and nothing flagged at the policy's threshold. Returns
    the results."""
    import numpy as np
    import torch
    from repro_torch import optim, tree
    from repro_torch.launch.train import build
    from repro_torch.models import Model

    tag = f"{arch} train"
    runs = {label: build(arch, "full", steps=ENCDEC_TRAIN_STEPS,
                         batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                         ft_linears=label == "protected")
            for label in ("protected", "unprotected")}
    prot = runs["protected"][0]
    check(prot.ft.threshold == 1e-4, f"{tag}: {prot.ft}")
    batch = functools.partial(encdec_train_batch, prot)

    res = {"batch": [TRAIN_BATCH, TRAIN_SEQ], "lr": TRAIN_LR,
           "steps": ENCDEC_TRAIN_STEPS}
    res["grad_gate"], _ = backend_agreement(tag, prot, params0,
                                            batch(dev, 0), sites, eager_calls)
    for label, (cfg, run) in runs.items():
        params = tree.tree_map(lambda t: t.detach().clone(), params0)
        opt_state = optim.init_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        rows = train_run(f"{arch} {label}", Model(cfg), run, params,
                         opt_state, 0, ENCDEC_TRAIN_STEPS, eager_calls,
                         batch, sites)
        losses = [r["loss"] for r in rows]
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        check(last < first, f"{tag} {label}: the loss did not fall: "
                            f"{losses}")
        timed = [r["ms"] for r in rows[TRAIN_WARMUP:]]
        ms = float(np.median(timed))
        res[label] = {
            "losses": losses, "first5_mean": float(first),
            "last5_mean": float(last), "ms_per_step": ms,
            "ms_per_step_range": [float(np.min(timed)),
                                  float(np.max(timed))],
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "ft_matmul_launches_per_step": rows[-1]["ft_matmul_launches"],
            "ft_flagged": sum(r["ft_flagged"] for r in rows)}
        log(f"{tag} {label}: {ENCDEC_TRAIN_STEPS} bf16 steps, loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 5 {first:.4f}, "
            f"last 5 {last:.4f}); {ms:.2f} ms a step, the median of steps "
            f"{TRAIN_WARMUP}-{ENCDEC_TRAIN_STEPS - 1} (range "
            f"{min(timed):.2f}-{max(timed):.2f}), "
            f"{res[label]['tokens_per_s']:.0f} tokens/s, "
            f"{rows[-1]['ft_matmul_launches']} ft_matmul launches a step, "
            f"flagged "
            f"{res[label]['ft_flagged']:.0f}, peak "
            f"{res[label]['peak_memory_bytes'] / 1e9:.2f} GB")
        del params, opt_state
        torch.cuda.empty_cache()
    res["ft_overhead_per_step"] = (res["protected"]["ms_per_step"]
                                   / res["unprotected"]["ms_per_step"] - 1)
    return res


def encdec_drive(dev, arch, eager_calls):
    """Drive phase 11's ``arch`` once (counts are the caller's to reset
    and read): the prefill gates, the decode runs and training. Returns
    (results, the model pair, params, the prefill batch, the batch-4
    prompts) for the measurements that follow."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import Model, count_params

    res = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = get_config(arch)
    layers_n = base.decoder_layers or base.num_layers
    check((layers_n, base.d_model, base.d_ff, base.vocab_size,
           base.num_heads) == ENCDEC_WIDTHS[arch]
          and base.encoder_layers in (0, layers_n), f"{arch}: {base}")
    sites, step_sites = ENCDEC_SITES[arch]
    models = {"unprotected": Model(base), "protected": Model(protect(base))}
    t0 = time.perf_counter()
    params = models["unprotected"].init(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    param_bytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    res["params"] = count_params(base)
    res["param_bytes"] = param_bytes
    res["init_s"] = time.perf_counter() - t0
    check(res["params"] == sum(t.numel() for t in tree.leaves(params)),
          f"{arch}: count_params disagrees with the initialised tree")
    tag = base.name
    log(f"{tag}: {res['params']} params, {param_bytes / 1e9:.2f} GB "
        f"({base.param_dtype}), activations {base.dtype}, {sites} protected "
        f"products a forward and {step_sites} a decode step; initialised "
        f"on the card in {res['init_s']:.1f} s")

    # (a) the prefill, protected against unprotected
    b, t = ENCDEC_PREFILL[arch]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    batch = {"tokens": torch.randint(0, base.vocab_size, (b, t),
                                     generator=gen, device=dev,
                                     dtype=torch.int32),
             **encdec_inputs(dev, base, b, SEED)}
    res["prefill"] = encdec_prefill(tag, models, params, batch, sites,
                                    eager_calls)

    # (b) greedy decode, unprotected and protected
    rng = np.random.default_rng(SEED)
    res["decode"] = []
    prompts4 = None
    for n in ENCDEC_BATCHES[arch]:
        prompts = torch.as_tensor(
            rng.integers(0, base.vocab_size, (n, LM_PROMPT)),
            dtype=torch.int32, device=dev)
        prompts4 = prompts if prompts4 is None else prompts4
        res["decode"].append(encdec_decode(tag, models, params, prompts,
                                           step_sites))
    res["serve_peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)

    # training: Whisper's (d), InternVL2's (c)
    res["train"] = encdec_train(dev, arch, params, sites, eager_calls)
    return res, models, params, batch, prompts4


def encdec_measure(dev, arch, models, params, batch, prompts4, cuda_ms,
                   host_ms, trace_call):
    """Phase 11's times for ``arch``: the prefill through
    ``make_prefill_step`` by CUDA events, protected and unprotected; one
    protected decode step at batch 4 under a primed torch.profiler
    (kernels, device ms, idle share, ft_matmul_tile ms); ``ft_matmul``
    against its plain version, ``torch.matmul`` and its bound at
    ENCDEC_FTMM_SHAPES; last, one protected train step at training's
    batch under a primed torch.profiler (``trace_train_step``: every
    ft_matmul launch in the forward), which updates ``params`` in place.
    Returns a dict."""
    from repro_torch.launch.train import build
    from repro_torch.models import Model

    tag = models["protected"].cfg.name
    sites, step_sites = ENCDEC_SITES[arch]
    res = {"prefill_ms": prefill_ms(tag, models, params, batch, cuda_ms)}
    res["decode_trace"] = trace_steps(
        tag, {"protected": models["protected"]}, params, prompts4,
        step_sites, host_ms, trace_call)
    res["ftmm_shapes"] = ftmm_rows(dev, tag, ENCDEC_FTMM_SHAPES[arch],
                                   cuda_ms)
    cfg, run = build(arch, "full", steps=ENCDEC_TRAIN_STEPS,
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                     ft_linears=True)
    res["train_parts"], res["train_trace"] = trace_train_step(
        f"{arch} train (protected)", Model(cfg), run, params,
        encdec_train_batch(cfg, dev, 4), sites, trace_call)
    return res


# ---- phase 12: training the recurrent and MoE models. RecurrentGemma-2B
# and xLSTM-350M at their published widths and full depth, DeepSeek-V3 and
# Llama-4 Maverick at their published widths cut in depth and experts
# (RM_REDUCED), one at a time, the first freed before the next is built:
# f32 params (16 bytes a param to train, with the gradients and both AdamW
# moments), bf16 activations, random weights from a seeded CUDA generator,
# TokenPipeline(seed=0) batches at each model's vocabulary, lr 3e-4. Every
# protected linear's forward runs on ft_matmul and its backward is the
# product's gradient; the routed experts' three checked products are the
# eager batched ones, differentiated through their correction
RM_ARCHS = ("recurrentgemma_2b", "xlstm_350m", "deepseek_v3_671b",
            "llama4_maverick")
# the cuts (ModelConfig fields) of training at one card
RM_CUTS = {"recurrentgemma_2b": {}, "xlstm_350m": {},
           "deepseek_v3_671b": dict(num_layers=1, first_k_dense=0,
                                    num_experts=32),
           "llama4_maverick": dict(num_layers=2, num_experts=8)}
RM_PARAMS = {"recurrentgemma_2b": 2_894_435_840,
             "xlstm_350m": 442_344_496,
             "deepseek_v3_671b": 3_494_042_624,
             "llama4_maverick": 3_453_158_400}
# (batch, tokens): launch.train's defaults but for xLSTM, whose mLSTM
# saves two (B, 4, 512, 512) float32 states a time step for the backward
# and whose step is host-bound
RM_BATCH = {"recurrentgemma_2b": (8, 256), "xlstm_350m": (4, 64),
            "deepseek_v3_671b": (8, 256), "llama4_maverick": (8, 256)}
# ft_matmul launches a protected step: SSM_SITES over the blocks, MOE_SITES
# a layer (the MoE layers' routed experts are eager batched products)
RM_SITES = {"recurrentgemma_2b": 164, "xlstm_350m": 144,
            "deepseek_v3_671b": 7, "llama4_maverick": 14}
# (a) and (c) at one period of RecurrentGemma's block pattern (rglru,
# rglru, local): three float32 gradient trees of all 26 layers are 11.6 GB
# each beside the float32 activations
RM_GRAD_LAYERS = {"recurrentgemma_2b": 3}
# (a) held to SSM_WITNESS_FACTOR x the one-ulp witness (loss and gradients)
# where that is larger than TRAIN_LOSS_TOL and TRAIN_GRAD_TOL, as phase 8's
# windows: xLSTM's random-weight recurrence is chaotic. It runs at RM_GRAD_BATCH's 4 x 8 tokens: at 4 x 64 the
# witness moves the float32 gradients by 1.08 of a leaf's max and the
# loss by 3.2e-4 (an NVIDIA H100), so a gate at a factor of it could tell
# no fault from the chaos; phase 8 holds the forward's first 8 positions
RM_WITNESSED = ("xlstm_350m",)
RM_GRAD_BATCH = {"xlstm_350m": (4, 8)}
# (d) traces xLSTM's step at 4 x 4 tokens: at 4 x 64 it is 178074 kernels,
# and tracing it took 106 s of the phase, at 4 x 8 35899 kernels and 37 s
# (an NVIDIA H100)
RM_TRACE_BATCH = {"xlstm_350m": (4, 4)}
RM_SEU_ARCHS = ("recurrentgemma_2b", "deepseek_v3_671b")
# (c): site 0 of every block (RG-LRU's first product, local attention's
# q, MLA's wq_a), token row 5, column 7, +300
RM_SEU = (0.0, 5.0, 7.0, 1.0, 300.0)
RM_STEPS = 10
RM_REDUCED = {
    "recurrentgemma_2b": "26 of 26 layers at batch 8 x 256 for (b) and "
                         "(d); gates (a) and (c) at one period of the "
                         "block pattern, 3 layers (rglru, rglru, local): "
                         "three float32 gradient trees of 26 layers are "
                         "11.6 GB each beside the float32 activations",
    "xlstm_350m": "24 of 24 layers; batch 4 x 64 tokens, not 8 x 256: each "
                  "mLSTM time step saves two (B, 4, 512, 512) float32 "
                  "states, 206 GB at 8 x 256 (26 GB at 4 x 64), and the "
                  "step is host-bound, about 50 torch kernels a time step "
                  "of an mLSTM/sLSTM pair; gate (a) at 4 x 8 tokens, where "
                  "the one-ulp witness is small enough to gate on, and "
                  "(d)'s trace at 4 x 4 (178074 kernels at 4 x 64)",
    "deepseek_v3_671b": "1 of 61 layers (first_k_dense 3 -> 0: one MLA + "
                        "MoE block); 32 of 256 routed experts, top-8 and "
                        "the shared expert kept (capacity 640 an expert at "
                        "8 x 256); all 256 experts are 45.1 GB of f32 "
                        "weights, 180 GB to train. The reference's init "
                        "draws an expert weight with fan-in E, so at 32 "
                        "experts they are 2.8x the published model's",
    "llama4_maverick": "2 of 48 layers (the MoE block, then a dense block, "
                       "as phase 9); 8 of 128 routed experts, top-1 and "
                       "the shared expert kept: each routed expert is "
                       "0.5 GB of f32 weights, 2 GB to train. The "
                       "reference's init draws an expert weight with "
                       "fan-in E, so at 8 experts they are 4x the "
                       "published model's (std 0.35, not 0.088)"}
RM_CLI = ("--arch", "xlstm-350m", "--preset", "full", "--ft-linears",
          "--steps", "3", "--batch", "4", "--seq", "64", "--log-every", "1")


def rm_setup(arch, layers=None):
    """``arch``'s protected and unprotected configs with RM_CUTS (and
    ``layers`` layers, if given), the run config of ``launch.train.build``
    at RM_STEPS, and the protected products a forward and the eager
    batched expert products a step, derived from SSM_SITES and MOE_SITES.
    The published widths and the parameter count are checked."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build
    from repro_torch.models import count_params
    from repro_torch.models.transformer import effective_kinds

    if arch in SSM_ARCHS:
        full = get_config(arch)
        widths = (full.num_layers, full.d_model, full.d_ff, full.vocab_size,
                  full.num_heads)
        check(widths == SSM_WIDTHS[arch], f"{arch}: {widths}")
    else:
        moe_config(arch)
    b, t = RM_BATCH[arch]
    out = {}
    for label in ("protected", "unprotected"):
        cfg, run = build(arch, "full", steps=RM_STEPS, batch=b, seq=t,
                         lr=TRAIN_LR, ft_linears=label == "protected")
        cfg = dataclasses.replace(cfg, **RM_CUTS[arch])
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        out[label] = (cfg, dataclasses.replace(run, model=cfg))
    cfg = out["protected"][0]
    if arch in SSM_ARCHS:
        sites = sum(SSM_SITES[kind.split("|")[0]]
                    for kind in effective_kinds(cfg))
        batched = 0
    else:
        sites = MOE_SITES * cfg.num_layers
        batched = MOE_EXPERT_PRODUCTS * sum(
            cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    if layers is None:
        check(count_params(cfg) == RM_PARAMS[arch]
              and sites == RM_SITES[arch] and cfg.dtype == "bfloat16"
              and cfg.ft.threshold == 1e-4,
              f"{arch}: {count_params(cfg)} params, {sites} sites, "
              f"{cfg.dtype}, threshold {cfg.ft.threshold}")
    return out, sites, batched


def rm_params(dev, cfg):
    """``cfg``'s params drawn on the card from the seeded generator: every
    call gives the same weights."""
    import torch
    from repro_torch.models import Model

    return Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)


def rm_batch(arch, cfg, dev, step, shape=None):
    """``launch.train``'s batch of ``step`` at ``shape`` (RM_BATCH[arch]
    by default): TokenPipeline(seed=0) at ``cfg``'s vocabulary, on
    ``dev``."""
    import torch
    from repro_torch.data import TokenPipeline

    b, t = shape or RM_BATCH[arch]
    pipe = TokenPipeline(seed=0, batch=b, seq_len=t,
                         vocab_size=cfg.vocab_size)
    return {k: torch.from_numpy(v).to(dev) for k, v in pipe(step).items()}


def grad_witness(cfg, params, batch):
    """The unprotected float32 step's gradients with every parameter one
    ulp up (``ulp_up``) against its gradients: (the worst leaf's error over
    its max and its name, the loss's relative move)."""
    from repro_torch.models import Model
    from repro_torch.train.loop import _value_and_grad

    model = Model(_f32_on(cfg))
    (t0, _), g0 = _value_and_grad(model, params, batch, block_q=1024,
                                  remat="none")
    with ulp_up(params):
        (t1, _), g1 = _value_and_grad(model, params, batch, block_q=1024,
                                      remat="none")
    worst = _leaf_errs(g1, g0)[0]
    return worst, abs(float(t1) - float(t0)) / abs(float(t0))


def rm_grad_gates(dev, arch, eager_calls):
    """(a) one step's loss and gradients at float32 activations on the
    three backends (``backend_agreement``; xLSTM's held to
    SSM_WITNESS_FACTOR x ``grad_witness``, at RM_GRAD_BATCH), at
    RM_GRAD_LAYERS' depth where it cuts one; (c) for RM_SEU_ARCHS, one SEU
    at site 0 of every block
    inside the loss: flagged and corrected in each block, the loss and
    gradients the clean fused step's. Returns (the results, the eager ABFT
    calls (a) makes)."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.transformer import layer_groups
    from repro_torch.train.loop import _value_and_grad

    layers = RM_GRAD_LAYERS.get(arch)
    runs, sites, _ = rm_setup(arch, layers)
    cfg = runs["protected"][0]
    tag = f"{arch} train"
    res = {"layers": cfg.num_layers, "sites": sites}
    params = rm_params(dev, cfg)
    shape = RM_GRAD_BATCH.get(arch, RM_BATCH[arch])
    res["batch"] = list(shape)
    batch = rm_batch(arch, cfg, dev, 0, shape)
    loss_tol, grad_tol = TRAIN_LOSS_TOL, TRAIN_GRAD_TOL
    if arch in RM_WITNESSED:
        (worst, leaf), loss_move = grad_witness(cfg, params, batch)
        # as phase 8's windows: the plain tolerance, or the witness's
        # factor where the model's own conditioning is worse
        loss_tol = max(TRAIN_LOSS_TOL, SSM_WITNESS_FACTOR * loss_move)
        grad_tol = max(TRAIN_GRAD_TOL, SSM_WITNESS_FACTOR * worst)
        res["witness"] = {"worst_leaf": [worst, leaf],
                          "loss_rel_move": loss_move, "loss_tol": loss_tol,
                          "grad_tol": grad_tol}
        log(f"{tag} (a) witness at {shape[0]} x {shape[1]} tokens: the "
            f"unprotected float32 step with every weight one ulp up moves "
            f"the gradients by {worst:.3e} of a leaf's max ({leaf}) and "
            f"the loss by {loss_move:.3e}; the backends are held to "
            f"{SSM_WITNESS_FACTOR} x those or TRAIN_GRAD_TOL and "
            f"TRAIN_LOSS_TOL, whichever is larger: {grad_tol:.3e} and "
            f"{loss_tol:.3e}")
    res["grad_gate"], ref = backend_agreement(
        f"{tag} (a)", cfg, params, batch, sites, eager_calls,
        loss_tol=loss_tol, grad_tol=grad_tol)
    if arch in RM_SEU_ARCHS:
        f32 = _f32_on(cfg, "fused")
        g = layer_groups(f32)
        blocks = len(g.prefix) + g.n_super * len(g.super_block) + len(g.tail)
        check(blocks == cfg.num_layers, f"layer groups {g}")
        inject = torch.tensor([RM_SEU], dtype=torch.float32, device=dev)
        (total, (_, aux)), grads = _value_and_grad(
            Model(f32), params, batch, block_q=1024, remat="none",
            inject=inject)
        rel = abs(float(total) - float(ref[0])) / abs(float(ref[0]))
        errs = _leaf_errs(grads, ref[1])
        del grads
        seu = {"site": RM_SEU, "blocks": blocks,
               "ft_flagged": float(aux["ft_flagged"]),
               "ft_corrected": float(aux["ft_corrected"]),
               "max_score": float(aux["ft_max_score"]),
               "loss_rel_err": rel, "worst_leaf": list(errs[0])}
        check(seu["ft_flagged"] == seu["ft_corrected"] == blocks
              and rel <= TRAIN_LOSS_TOL and errs[0][0] <= TRAIN_GRAD_TOL,
              f"{tag} (c) SEU step: {seu}")
        res["seu"] = seu
        log(f"{tag} (c) SEU at site 0 (row {int(RM_SEU[1])}, column "
            f"{int(RM_SEU[2])}, +{RM_SEU[4]}) of every block: flagged "
            f"{seu['ft_flagged']:.0f}, corrected {seu['ft_corrected']:.0f} "
            f"of {blocks} blocks, max score {seu['max_score']:.3e}; vs the "
            f"clean step: loss {rel:.3e} relative, worst gradient leaf "
            f"{errs[0][0]:.3e} of its max ({errs[0][1]})")
    del params, ref
    torch.cuda.empty_cache()
    return res, sites


def rm_drive(dev, arch, eager_calls, batched):
    """Drive phase 12's ``arch`` once (counts are the caller's to reset
    and read): gates (a) and (c) (``rm_grad_gates``), then (b) RM_STEPS
    bf16 steps protected and as many unprotected, each run from the seeded
    weights drawn anew (the same bits): finite losses, the mean of the
    last three below the mean of the first three, RM_SITES[arch]
    ft_matmul launches and MOE_EXPERT_PRODUCTS eager batched products a MoE
    layer a protected step (``train_run``; ``rm_measure``'s trace puts
    every ft_matmul launch in the forward), nothing flagged at the
    policy's threshold, peak memory under MOE_MEMORY_LIMIT. Returns (the
    results, the protected model and run, the eager calls of (a))."""
    import numpy as np
    import torch
    from repro_torch import optim, tree
    from repro_torch.models import Model

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    runs, sites, per_step = rm_setup(arch)
    b, t = RM_BATCH[arch]
    res = {"params": RM_PARAMS[arch], "reduced": RM_REDUCED[arch],
           "batch": [b, t], "lr": TRAIN_LR, "steps": RM_STEPS,
           "sites_per_step": sites, "expert_products_per_step": per_step}
    log(f"{arch} train: {RM_PARAMS[arch]} params, "
        f"{4 * RM_PARAMS[arch] / 1e9:.2f} GB f32 "
        f"({16 * RM_PARAMS[arch] / 1e9:.2f} GB with gradients and both "
        f"AdamW moments), batch {b} x {t}, {sites} ft_matmul launches and "
        f"{per_step} eager batched expert products a protected step; "
        f"reduced: {RM_REDUCED[arch]}")
    t0 = time.perf_counter()
    gates, gate_sites = rm_grad_gates(dev, arch, eager_calls)
    res.update(gates)
    res["gates_s"] = time.perf_counter() - t0
    prints = None
    t0 = time.perf_counter()
    for label in ("protected", "unprotected"):
        cfg, run = runs[label]
        params = rm_params(dev, cfg)
        fp = _fingerprint(tree.leaves(params))
        check(prints is None or fp == prints,
              f"{arch}: the {label} run's weights are not the protected "
              f"run's")
        prints = fp
        opt_state = optim.init_state(params)
        torch.cuda.synchronize()
        rows = train_run(f"{arch} {label}", Model(cfg), run, params,
                         opt_state, 0, RM_STEPS, eager_calls,
                         functools.partial(rm_batch, arch, cfg), sites,
                         batched=batched, batched_per_step=per_step)
        losses = [r["loss"] for r in rows]
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        check(all(math.isfinite(x) for x in losses) and last < first,
              f"{arch} train {label}: the loss did not fall: {losses}")
        timed = [r["ms"] for r in rows[TRAIN_WARMUP:]]
        ms = float(np.median(timed))
        res[label] = {
            "losses": losses, "first3_mean": float(first),
            "last3_mean": float(last), "ms_per_step": ms,
            "ms_per_step_range": [float(np.min(timed)),
                                  float(np.max(timed))],
            "tokens_per_s": b * t / (ms / 1e3),
            "ft_matmul_launches_per_step": rows[-1]["ft_matmul_launches"],
            "expert_products_per_step": rows[-1].get("expert_products", 0),
            "ft_flagged": sum(r["ft_flagged"] for r in rows)}
        log(f"{arch} train (b) {label}: {RM_STEPS} bf16 steps, loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 3 {first:.4f}, "
            f"last 3 {last:.4f}); {ms:.2f} ms a step, the median of steps "
            f"{TRAIN_WARMUP}-{RM_STEPS - 1} (range {min(timed):.2f}-"
            f"{max(timed):.2f}), {res[label]['tokens_per_s']:.0f} tokens/s, "
            f"{rows[-1]['ft_matmul_launches']} ft_matmul launches and "
            f"{res[label]['expert_products_per_step']} eager batched expert "
            f"products a step, flagged {res[label]['ft_flagged']:.0f}")
        del params, opt_state
        torch.cuda.empty_cache()
    res["runs_s"] = time.perf_counter() - t0
    res["ft_overhead_per_step"] = (res["protected"]["ms_per_step"]
                                   / res["unprotected"]["ms_per_step"] - 1)
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    check(res["peak_memory_bytes"] < MOE_MEMORY_LIMIT,
          f"{arch} train: peak {res['peak_memory_bytes'] / 1e9:.2f} GB")
    log(f"{arch} train: FT overhead {res['ft_overhead_per_step']:+.1%} a "
        f"step; peak {res['peak_memory_bytes'] / 1e9:.2f} GB (limit "
        f"{MOE_MEMORY_LIMIT / 1e9:.0f} GB); gates (a) and (c) "
        f"{res['gates_s']:.1f} s, the two runs {res['runs_s']:.1f} s")
    return res, runs["protected"], gate_sites


def rm_measure(dev, arch, prot, trace_call):
    """(d): one protected step of ``arch`` at its RM_BATCH (RM_TRACE_BATCH
    where it cuts one) under a primed torch.profiler
    (``trace_train_step``: every ft_matmul_tile kernel in the forward), on
    the seeded weights. Returns a dict."""
    import torch
    from repro_torch.models import Model

    cfg, run = prot
    t0 = time.perf_counter()
    params = rm_params(dev, cfg)
    shape = RM_TRACE_BATCH.get(arch, RM_BATCH[arch])
    res = {"trace_batch": list(shape)}
    res["parts"], res["trace"] = trace_train_step(
        f"{arch} train (protected) at {shape[0]} x {shape[1]}", Model(cfg),
        run, params, rm_batch(arch, cfg, dev, 4, shape), RM_SITES[arch],
        trace_call)
    del params
    torch.cuda.empty_cache()
    res["trace_s"] = time.perf_counter() - t0
    return res


def rm_cli_start():
    """``python -m repro_torch.launch.train *RM_CLI`` on the card, started
    in the background: returns (the process, its output file, the start
    time)."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *RM_CLI],
        cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, out, time.perf_counter()


def rm_cli_finish(proc, out, t0):
    """The RM_CLI process's end: it must exit 0 and print its three step
    lines with finite losses and ``ft_flagged 0``. Returns its row."""
    try:
        code = proc.wait(timeout=600)
        seconds = time.perf_counter() - t0
        out.seek(0)
        text = out.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
    lines = re.findall(r"step +(\d+) loss (\S+) ce \S+ gnorm \S+ "
                       r"ft_flagged (\d+)", text)
    check(code == 0 and [int(s) for s, _, _ in lines] == [0, 1, 2]
          and all(math.isfinite(float(loss)) and f == "0"
                  for _, loss, f in lines),
          f"launch.train {' '.join(RM_CLI)}: exit {code}\n{text[-3000:]}")
    log(f"launch.train {' '.join(RM_CLI)}: steps 0-2, loss {lines[0][1]} "
        f"-> {lines[-1][1]}, ft_flagged 0 ({seconds:.1f} s with the "
        f"process start)")
    return {"argv": list(RM_CLI), "seconds": seconds,
            "steps": [[int(s), float(loss)] for s, loss, _ in lines]}


# ---- phase 13: the sharded FFT on torch.distributed. Four ranks on the
# one card over gloo (which stages CUDA tensors through the host, so its
# collective times are host copies, not NVLink), on a 1-D mesh of 4 and a
# 2 x 2 data x fft mesh, at turbofft_bench's corners; then one rank on NCCL
# through make_fft_mesh(1), where the plan is the local one.
SHARD_CASES = (("complex64", 20, 256), ("complex64", 25, 8),
               ("complex128", 20, 16))
SHARD_MESHES = ((4, 1), (2, 2))         # (fft shards, data shards)
SHARD_RANKS = 4
SHARD_CHECKED_CASES = (1, 2)            # their launches against the plain one
SHARD_INGEST_CASE = 2                   # its input through shard_signals
SHARD_TIMEOUT = 420                     # seconds the four ranks may take
# check_cell's relative tolerance on a call's bytes: exact, since a rank's
# byte counts here stay below 1e9 and 1e-10 of them is under one byte
SHARD_COLL_RTOL = 1e-10
                                        # (phases 13 and 14)
SHARD_ONE_RANK = ("complex64", 20, 256)
# the grouped two-side ABFT: (dtype, log2 N, batch, G, threshold, meshes,
# the whole fault matrix); an SEU's score over the threshold
SHARD_FT_CASES = (("complex64", 20, 256, 4, 1e-4, ((4, 1), (2, 2)), True),
                  ("complex64", 25, 8, 4, 1e-4, ((4, 1),), False),
                  ("complex128", 20, 16, 4, 1e-10, ((4, 1),), False))
SHARD_FT_SCORE = 300.0
# the spectral consumers: (dtype, log2 L, batch): (B, L) signals with a
# (1, L) kernel, nfft 2L
SHARD_SPECTRAL = ("complex64", 19, 256)
SHARD_ONE_RANK_FT = ("complex64", 13, 1024)
SHARD_ONE_RANK_CONV = ("complex64", 17, 64)
SHARD_ONE_RANK_2D = (4, 4096, 4096)


def _stated_model(count, nbytes):
    """The model of a sharded call that ``plan.volume`` does not model (a
    TRANSPOSED_IN inverse, the 2-D convolution's round trip): ``count``
    all-to-alls of ``nbytes`` in all, nothing else."""
    return {"all_to_all_count": count, "all_gather_count": 0,
            "all_to_all_bytes": float(nbytes), "gather_hlo": 0.0,
            "psum_hlo": 0.0, "hlo_bytes": float(nbytes),
            "exposed_fraction": 1.0 / count}


def _audit_call(fail, what, res, model, dtype, *, exposed=False,
                tail=(0, 0)):
    """One mesh call's recorded collectives against ``model`` through
    ``audit.check_cell``, the CPU audit's own checker, its counts and
    bytes held exactly (every finding fails the phase): ``res`` a drive's
    ``call`` result, ``dtype`` the spec dtype (its real dtype for a real
    output), ``exposed`` the chunked pipeline's 1/C check. ``tail`` is
    ``(groups, bytes)`` of a recompute, which reruns each uncorrectable
    group on the plain pipeline after the modelled ops: one all-to-all of
    ``bytes`` a group, which no model counts. Returns the ops' summary."""
    from repro_torch.analysis.audit import check_cell
    from repro_torch.analysis.record import summarize

    y, _, ops, _ = res
    n, nbytes = tail
    rerun = [(op.kind, op.payload_bytes) for op in ops[len(ops) - n:]]
    if n and rerun != [("all-to-all", nbytes)] * n:
        fail(f"{what}: the recompute's collectives {rerun}, not {n} "
             f"all-to-all(s) of {nbytes} B")
    rep = check_cell(None, (), model, tag=what, dtype=dtype, strict=False,
                     rtol=SHARD_COLL_RTOL, check_exposed=exposed,
                     ops=ops[:len(ops) - n], out=y)
    for f in rep.findings:
        fail(str(f))
    return summarize(ops)


def shard_drive(rank, trace):
    """One rank's drive of the sharded transform: every case on both
    meshes, each call's results against torch.fft on this rank's rows,
    its block_fft launches and collectives against the plan's, chunks=2
    bitwise chunks=1; in the checked cases every launch of the rank's
    steps against block_fft_plain (``shard_launch_checks``); device ms of
    the local passes and host ms of whole transforms."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis.record import record as recording
    from repro_torch.core.fft import FFTSpec, plan
    from repro_torch.kernels.stockham import block_fft
    from repro_torch.kernels.trace_age import PRIMER, prime
    from repro_torch.launch.mesh import make_fft_mesh

    dev = torch.device("cuda", 0)
    out = {"rank": rank, "cases": [], "launches": 0, "failures": []}
    gen = torch.Generator(device=dev)

    def fail(msg):
        out["failures"].append(msg)

    def call(fn, what=None):
        """(result, launches, recorded collectives, host ms) of one call,
        every rank starting together."""
        print(f"{time.perf_counter():.3f} {what or label} {fn}", file=trace,
              flush=True)
        dist.barrier()
        torch.cuda.synchronize()
        before = block_fft.launches
        t0 = time.perf_counter()
        with recording() as ops:
            y = fn()
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return (y, block_fft.launches - before, ops, ms)

    def err_ratio(got, want):
        tol = ATOL[str(want.dtype).split(".")[-1]] * want.abs().max().item()
        return (got - want).abs().max().item() / tol

    block_fft.launches = 0
    # what a process's first sharded call would pay besides its transform,
    # timed apart: the import of DTensor's package (with dynamo, fx and
    # sympy), then gloo's first CUDA collectives, one element a rank
    t0 = time.perf_counter()
    import torch.distributed.tensor  # noqa: F401
    out["dtensor_import_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    one = torch.zeros(SHARD_RANKS, dtype=torch.complex64, device=dev)
    dist.all_to_all_single(torch.empty_like(one), one)
    dist.all_gather_into_tensor(torch.empty_like(one), one[:1])
    torch.cuda.synchronize()
    out["first_collectives_ms"] = (time.perf_counter() - t0) * 1e3
    for shards, data in SHARD_MESHES:
        mesh = make_fft_mesh(shards, data)
        d = mesh.get_local_rank("fft")
        md = mesh.get_local_rank("data") if data > 1 else 0
        for ci, (dtype, logn, b) in enumerate(SHARD_CASES):
            n = 1 << logn
            gen.manual_seed(SEED + logn + b)
            x = torch.randn((b, n), dtype=getattr(torch, dtype), device=dev,
                            generator=gen)
            ref = torch.fft.fft(x)
            spec = dict(dtype=dtype, mesh=mesh)
            p = plan(FFTSpec((b, n), **spec))
            pt = plan(FFTSpec((b, n), natural_order=False, **spec))
            pc = plan(FFTSpec((b, n), natural_order=False, chunks=2, **spec))
            pen = p.pencil
            tail = pen.launches - 1
            rows = b // data
            r0 = md * rows
            label = f"{dtype} 2^{logn}x{b} on ({data}, {shards})"
            row = {"case": label, "n1": pen.n1, "n2": pen.n2, "tail": tail,
                   "mesh": [data, shards], "calls": {}}

            def record(name, res, want_launches, model, exposed=False):
                _, launches, _, ms = res
                if launches != want_launches:
                    fail(f"{label} {name}: {launches} block_fft launches, "
                         f"not {want_launches}")
                row["calls"][name] = {
                    "launches": launches, "host_ms": ms,
                    "collectives": _audit_call(fail, f"{label} {name}", res,
                                               model, dtype,
                                               exposed=exposed)}

            v, vt, vc = p.volume, pt.volume, pc.volume

            res = call(lambda: p.fft(x))
            record("fft", res, 1 + tail, v, True)
            row["fft"] = err_ratio(res[0].to_local(), ref[r0:r0 + rows])
            del res
            res = call(lambda: p.ifft(ref))
            record("ifft", res, 1 + tail, v, True)
            row["ifft"] = err_ratio(res[0].to_local(), x[r0:r0 + rows])
            del res
            # the transposed order: this rank's contiguous block of
            # y[k1*N2 + k2] = X[k1 + N1*k2]
            res = call(lambda: pt.fft(x))
            yt = res[0]
            record("fft transposed", res, 1 + tail, vt, True)
            del res
            span = n // shards
            want_t = ref.view(b, pen.n2, pen.n1).transpose(1, 2).reshape(
                b, n)[r0:r0 + rows, d * span:(d + 1) * span]
            row["fft_transposed"] = err_ratio(yt.to_local(), want_t)
            del want_t
            inv_bytes = rows * n * x.element_size() // shards
            res = call(lambda: pt.ifft(yt))
            xb = res[0]
            record("ifft transposed-in", res, tail + 1,
                   _stated_model(1, inv_bytes))
            del res
            w = rows // shards
            mine = x[r0 + d * w:r0 + (d + 1) * w]
            row["ifft_transposed_in"] = err_ratio(xb.to_local(), mine)
            res = call(lambda: pc.fft(x))
            record("fft transposed chunks=2", res, 2 * (1 + tail), vc, True)
            row["chunks_bitwise"] = bool(torch.equal(res[0].to_local(),
                                                     yt.to_local()))
            res2 = call(lambda: pc.ifft(res[0]))
            record("ifft transposed-in chunks=2", res2, 2 * (tail + 1),
                   _stated_model(2, inv_bytes), True)
            row["chunks_bitwise"] &= bool(torch.equal(res2[0].to_local(),
                                                      xb.to_local()))
            if not row["chunks_bitwise"]:
                fail(f"{label}: chunks=2 is not bitwise chunks=1")
            del res, res2, xb
            if shards == 4 and ci == SHARD_INGEST_CASE:
                xs = p.shard(x)
                res = call(lambda: p.fft(xs))
                ingest = rows * n * x.element_size() // shards
                # the ingest all-to-all of ``shard_signals`` besides
                record("fft of shard_signals", res, 1 + tail,
                       dict(v, all_to_all_count=v["all_to_all_count"] + 1,
                            all_to_all_bytes=v["all_to_all_bytes"] + ingest,
                            hlo_bytes=v["hlo_bytes"] + ingest))
                row["fft_shard_signals"] = err_ratio(res[0].to_local(),
                                                     ref[r0:r0 + rows])
                del res, xs
            print(f"{time.perf_counter():.3f} {label} trace and checks",
                  file=trace, flush=True)
            if shards == 4:
                # the local passes' device time, from a primed trace of the
                # transposed forward (the other ranks' kernels share the
                # card meanwhile)
                dist.barrier()
                pt.fft(x)
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    prime()
                    pt.fft(x)
                    torch.cuda.synchronize()
                kern = [e.time_range.elapsed_us() / 1e3
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "block_fft" in e.name and PRIMER not in e.name]
                row["local_passes_device_ms"] = sum(kern)
                row["local_passes_traced"] = len(kern)
            print(f"{time.perf_counter():.3f} {label} traced", file=trace,
                  flush=True)
            if shards == 4 and ci in SHARD_CHECKED_CASES:
                row.update(shard_launch_checks(pen, x, yt.to_local(), d,
                                               err_ratio))
            for key in SHARD_ERRORS:
                if row.get(key, 0) > 1:
                    fail(f"{label} {key}: error {row[key]:.3f} x tol")
            out["cases"].append(row)
            del x, ref, yt
            torch.cuda.empty_cache()
    out["ft"] = shard_ft_drive(rank, call, fail, err_ratio, gen, trace)
    out["spectral"] = shard_spectral_drive(call, fail, err_ratio, gen)
    t_nd = time.perf_counter()
    out["nd"] = shard_nd_drive(rank, call, fail, err_ratio, gen, trace)
    out["nd_seconds"] = time.perf_counter() - t_nd
    t_serve = time.perf_counter()
    out["serve"] = shard_serve_drive(rank, fail, trace)
    out["serve_seconds"] = time.perf_counter() - t_serve
    # the main path's launches: those of the calls held to the plan, not
    # the checks' direct ones nor the traced repeats
    out["launches_fft"] = sum(c["launches"] for row in out["cases"]
                              for c in row["calls"].values())
    out["launches_ft"] = sum(c["launches"] for row in out["ft"]
                             for c in row["calls"].values())
    out["launches_spectral"] = sum(c["launches"] for row in out["spectral"]
                                   for c in row["calls"].values())
    out["launches_nd"] = sum(c["launches"] for row in out["nd"]
                             for c in row["calls"].values())
    out["launches_serve"] = sum(b["launches"] for row in out["serve"]
                                for b in row["batches"])
    out["launches"] = (out["launches_fft"] + out["launches_ft"]
                       + out["launches_spectral"] + out["launches_nd"]
                       + out["launches_serve"])
    return out


def _transposed_block(ref, pen, r0, rows, d):
    """Rank ``d``'s block of the transposed order of ``ref`` (B, N)'s
    rows ``r0 .. r0+rows``: y[k1*N2 + k2] = X[k1 + N1*k2]."""
    b, n = ref.shape
    span = n // pen.shards
    return ref.view(b, pen.n2, pen.n1).transpose(1, 2).reshape(b, n)[
        r0:r0 + rows, d * span:(d + 1) * span]


def _ft_scenarios(b, g, n1, n, thr, shards, matrix):
    """The fault matrix of one ft case: (name, inject rows, keywords,
    expected verdict), each SEU's |eps| from the verdict's score formula
    (score ~ |eps| / (sqrt(n1) sqrt(s N)) for unit-variance complex
    normal inputs) at ``SHARD_FT_SCORE`` times ``thr``. The four SEUs sit
    in four groups on fft ranks j mod ``shards``: one a rank on either
    mesh of four."""
    s = b // g
    eps = SHARD_FT_SCORE * thr * math.sqrt(n1) * math.sqrt(s * n)

    def seu(dev, sig, row, col):
        return [dev, sig, row, col, 1, eps, -0.5 * eps]

    four = [seu(j % shards, j * s + (j + 1) % s, 3 + j, j)
            for j in range(g)]
    locs = [j * s + (j + 1) % s for j in range(g)]
    t = dict(natural_order=False)
    cases = [("clean transposed", None, t, "clean"),
             ("four SEUs transposed", four, t, ("four", locs))]
    if matrix:
        double = [seu(0, 2 * s, 5, 1), seu(1, 2 * s + 1, 6, 2)]
        cases += [("clean natural", None, {}, "clean"),
                  ("correct=False", four, dict(t, correct=False),
                   "nocorrect"),
                  ("double hit", double, t, "double"),
                  ("double hit, recompute", double,
                   dict(t, recompute_uncorrectable=True), "recompute"),
                  ("cs2 row", [seu(1, b + 1, 4, 2)], t, ("checksum", 1)),
                  ("cs3 row", [seu(2, b + g + 2, 4, 2)], t,
                   ("checksum", 2)),
                  ("four SEUs transposed chunks=2", four,
                   dict(t, chunks=2), ("four", locs))]
    return cases


def _ft_verdict_failures(res, want, g, correct_err):
    """What in ``res``'s telemetry is not the scenario ``want``'s."""
    fl = res.flagged.tolist()
    fix = res.correctable.tolist()
    csf = res.checksum_fault.tolist()
    bad = res.uncorrectable.tolist()
    kind = want if isinstance(want, str) else want[0]
    out = []
    if kind == "clean":
        if any(fl):
            out.append(f"flagged {fl}")
    elif kind == "four":
        if not (all(fl) and all(fix)) or res.location.tolist() != want[1] \
                or int(res.corrected) != g:
            out.append(f"flagged {fl} correctable {fix} location "
                       f"{res.location.tolist()} corrected "
                       f"{int(res.corrected)}")
    elif kind == "nocorrect":
        if not all(fl) or int(res.corrected) != 0:
            out.append(f"flagged {fl} corrected {int(res.corrected)}")
    elif kind == "double":
        if bad != [j == 2 for j in range(g)] or any(fix) \
                or int(res.corrected) != 0:
            out.append(f"uncorrectable {bad} correctable {fix}")
    elif kind == "recompute":
        if int(res.recomputed) != 1:
            out.append(f"recomputed {int(res.recomputed)}")
    elif kind == "checksum":
        want_csf = [j == want[1] for j in range(g)]
        if csf != want_csf or fl != want_csf or any(fix):
            out.append(f"checksum_fault {csf} flagged {fl}")
    if kind in ("nocorrect", "double"):
        if correct_err < 50:
            out.append(f"the error persists at only {correct_err:.3f} x "
                       f"tol")
    elif correct_err > 1:
        out.append(f"error {correct_err:.3f} x tol")
    return out


def shard_ft_drive(rank, call, fail, err_ratio, gen, trace):
    """One rank's drive of the grouped two-side ABFT at ``SHARD_FT_CASES``:
    each scenario's verdicts, its rows against torch.fft (the largest
    error over the ranks, an all-reduce outside the call), its launches
    and collectives against the plan's; host ms beside the plain
    transposed transform's; a primed trace of one clean call on the 1-D
    mesh (the block_fft passes and the verdict's other kernels)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.fft import FFTSpec, FTConfig, plan
    from repro_torch.core.fft.distributed import ft_distributed_fft
    from repro_torch.kernels.trace_age import PRIMER, prime
    from repro_torch.launch.mesh import make_fft_mesh

    dev = torch.device("cuda", 0)
    rows_out = []
    for ci, (dtype, logn, b, g, thr, meshes, matrix) in enumerate(
            SHARD_FT_CASES):
        n = 1 << logn
        gen.manual_seed(SEED + 7 + logn + b)
        x = torch.randn((b, n), dtype=getattr(torch, dtype), device=dev,
                        generator=gen)
        ref = torch.fft.fft(x)
        for shards, data in meshes:
            mesh = make_fft_mesh(shards, data)
            d = mesh.get_local_rank("fft")
            md = mesh.get_local_rank("data") if data > 1 else 0
            rows = b // data
            r0 = md * rows
            gl = g // data
            ft = FTConfig(threshold=thr, groups=g)
            pft = plan(FFTSpec((b, n), dtype=dtype, mesh=mesh, ft=ft,
                               natural_order=False))
            pen = pft.pencil
            tail = pen.launches - 1
            label = f"ft {dtype} 2^{logn}x{b} G={g} on ({data}, {shards})"
            row = {"case": label, "n1": pen.n1, "n2": pen.n2, "calls": {},
                   "errors": {}}
            want_t = _transposed_block(ref, pen, r0, rows, d)
            # the whole matrix on the 1-D mesh, clean and four SEUs on 2 x 2
            for name, inj, kw, want in _ft_scenarios(
                    b, g, pen.n1, n, thr, shards, matrix and data == 1):
                kw = dict(kw)
                ce = min(kw.get("chunks", 1), gl)
                nat = kw.get("natural_order", True)
                res = call(lambda: ft_distributed_fft(
                    x, mesh, threshold=thr, groups=g, inject=inj, **kw),
                    f"{label} {name}")
                out, launches, _, ms = res
                blk = out.y.to_local()
                err = err_ratio(blk, ref[r0:r0 + rows] if nat else want_t)
                del blk
                emax = torch.tensor([err], device=dev)
                dist.all_reduce(emax, op=dist.ReduceOp.MAX)
                err = float(emax)
                row["errors"][name] = err
                for msg in _ft_verdict_failures(out, want, g, err):
                    fail(f"{label} {name}: {msg}")
                recomputed = int(out.recomputed)
                # this data shard reruns the uncorrectable groups it owns
                mine = sum(out.uncorrectable.tolist()[md * gl:(md + 1) * gl]) \
                    if kw.get("recompute_uncorrectable") else 0
                vol = plan(FFTSpec((b, n), dtype=dtype, mesh=mesh, ft=ft,
                                   chunks=ce, natural_order=nat)).volume
                want_l = ce * (2 + tail) + mine * (1 + tail)
                row["calls"][name] = {
                    "launches": launches, "host_ms": ms,
                    "collectives": _audit_call(
                        fail, f"{label} {name}", res, vol, dtype,
                        exposed=True, tail=(mine, (b // g) * n // shards
                                            * x.element_size())),
                    "flagged": out.flagged.tolist(),
                    "location": out.location.tolist(),
                    "group_score": out.group_score.tolist(),
                    "shard_delta": max(out.shard_delta.tolist()),
                    "corrected": int(out.corrected),
                    "recomputed": recomputed}
                if launches != want_l:
                    fail(f"{label} {name}: {launches} block_fft launches, "
                         f"not {want_l}")
                del res
                if name == "four SEUs transposed":
                    four_y = out.y.to_local().clone()
                if name.endswith("chunks=2") and not torch.equal(
                        out.y.to_local(), four_y):
                    fail(f"{label}: chunks=2 is not bitwise chunks=1")
                del out
            del four_y, want_t
            # the plain transposed transform of the same input, beside
            pt = plan(FFTSpec((b, n), dtype=dtype, mesh=mesh,
                              natural_order=False))
            res = call(lambda: pt.fft(x), f"{label} plain transposed")
            row["plain_transposed_host_ms"] = res[3]
            del res
            if ci == 0 and data == 1:
                dist.barrier()
                ft_distributed_fft(x, mesh, threshold=thr, groups=g,
                                   natural_order=False)
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    prime()
                    ft_distributed_fft(x, mesh, threshold=thr, groups=g,
                                       natural_order=False)
                    torch.cuda.synchronize()
                kern = [(e.name, e.time_range.elapsed_us() / 1e3)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and PRIMER not in e.name]
                # the local passes; gloo's collectives and their staging
                # copies and fills; the rest: the checks', the verdict's
                # and the relayouts' torch kernels, the five largest
                parts = {"block_fft": [], "gloo": [], "torch": []}
                by_name = {}
                for k, t in kern:
                    part = "block_fft" if "block_fft" in k else \
                        "gloo" if k.startswith(("Memcpy", "Memset",
                                                "gloo:")) else "torch"
                    parts[part].append(t)
                    if part == "torch":
                        by_name.setdefault(k[:60], []).append(t)
                row["trace"] = {f"{k}_ms": sum(v) for k, v in parts.items()}
                row["trace"].update({k: len(v) for k, v in parts.items()})
                row["trace"]["torch_top"] = sorted(
                    ([k, sum(v), len(v)] for k, v in by_name.items()),
                    key=lambda r: -r[1])[:5]
            print(f"{time.perf_counter():.3f} {label} done", file=trace,
                  flush=True)
            rows_out.append(row)
        del x, ref
        torch.cuda.empty_cache()
    return rows_out


def shard_spectral_drive(call, fail, err_ratio, gen):
    """One rank's drive of the spectral consumers on both meshes
    (``SHARD_SPECTRAL``): convolve and correlate against torch.fft on the
    rank's rows, ``chunks=2`` bitwise, the packed real convolution,
    ``power_spectrum`` in transposed order; launches and collectives
    against the plan's and ``spectral_volume``'s."""
    import torch

    from repro_torch.core.fft import plan
    from repro_torch.core.fft import spectral
    from repro_torch.core.fft.distributed import (collective_volume, pencil,
                                                  spectral_volume)
    from repro_torch.kernels.stockham import device_key
    from repro_torch.launch.mesh import make_fft_mesh

    dev = torch.device("cuda", 0)
    dtype, logl, b = SHARD_SPECTRAL
    la = lv = 1 << logl
    nfft = 2 * la
    gen.manual_seed(SEED + 11)
    cdt = getattr(torch, dtype)
    a = torch.randn((b, la), dtype=cdt, device=dev, generator=gen)
    v = torch.randn((1, lv), dtype=cdt, device=dev, generator=gen)
    ar = torch.randn((b, la), dtype=torch.float32, device=dev, generator=gen)
    vr = torch.randn((1, lv), dtype=torch.float32, device=dev, generator=gen)
    xs = torch.randn((b, nfft), dtype=cdt, device=dev, generator=gen)
    fv = torch.fft.fft(v, n=nfft)
    fvr = torch.fft.fft(vr.to(cdt), n=nfft)
    rows_out = []
    for shards, data in SHARD_MESHES:
        mesh = make_fft_mesh(shards, data)
        d = mesh.get_local_rank("fft")
        md = mesh.get_local_rank("data") if data > 1 else 0
        per = b // data
        w = per // shards
        r0 = md * per + d * w           # this rank's result rows
        pen = pencil(nfft, shards, cdt, device_key(dev))
        tail = pen.launches - 1
        label = f"spectral {dtype} ({b}, 2^{logl}) on ({data}, {shards})"
        row = {"case": label, "calls": {}, "errors": {}}
        fa = torch.fft.fft(a[r0:r0 + w], n=nfft)
        want = {"convolve": torch.fft.ifft(fa * fv)[:, :la + lv - 1],
                "correlate": torch.roll(torch.fft.ifft(fa * fv.conj()),
                                        lv - 1, dims=-1)[:, :la + lv - 1]}
        del fa
        fr = torch.fft.fft(ar[r0:r0 + w].to(cdt), n=nfft)
        want["real convolve"] = torch.fft.ifft(fr * fvr).real[
            :, :la + lv - 1]
        del fr
        item = a.element_size()
        calls = [("convolve", lambda: spectral.fft_convolve(a, v, mesh),
                  1, False, 1),
                 ("correlate", lambda: spectral.correlate(a, v, mesh),
                  1, False, 1),
                 ("convolve chunks=2", lambda: plan(spectral.conv_spec(
                     a, v, mesh, chunks=2)).convolve(a, v), 2, False, 1),
                 ("real convolve", lambda: spectral.fft_convolve(ar, vr,
                                                                 mesh),
                  1, True, 0)]
        bulk = None
        for name, fn, ce, real, kv in calls:
            res = call(fn, f"{label} {name}")
            y, launches, _, ms = res
            vol = spectral_volume(nfft, b, shards, kernel_batch=1,
                                  itemsize=item, data_shards=data,
                                  real=real, chunks=ce)
            want_l = ce * (2 + 2 * tail) + kv
            row["calls"][name] = {
                "launches": launches, "host_ms": ms,
                "collectives": _audit_call(fail, f"{label} {name}", res,
                                           vol, "float32" if real
                                           else dtype)}
            if launches != want_l:
                fail(f"{label} {name}: {launches} block_fft launches, not "
                     f"{want_l}")
            del res
            loc = y.to_local()
            key = name.replace(" chunks=2", "")
            row["errors"][name] = err_ratio(loc, want[key])
            if name == "convolve":
                bulk = loc.clone()
            elif name == "convolve chunks=2" and not torch.equal(loc, bulk):
                fail(f"{label}: chunks=2 is not bitwise chunks=1")
            del y, loc
        del bulk, want
        # the periodogram in transposed order: ONE all-to-all
        res = call(lambda: spectral.power_spectrum(xs, mesh),
                   f"{label} power")
        y, launches, _, ms = res
        # the periodogram's reals: held to the transposed plan's volume
        row["calls"]["power_spectrum"] = {
            "launches": launches, "host_ms": ms,
            "collectives": _audit_call(
                fail, f"{label} power_spectrum", res, collective_volume(
                    nfft, b, shards, itemsize=item, data_shards=data,
                    natural_order=False), "float32")}
        del res
        rows_ps = per
        ref = torch.fft.fft(xs[md * per:(md + 1) * per]).abs().square_() \
            / nfft
        row["errors"]["power_spectrum"] = err_ratio(
            y.to_local(), _transposed_block(ref, pen, 0, rows_ps, d))
        del ref, y
        if launches != 1 + tail:
            fail(f"{label} power_spectrum: {launches} launches, not "
                 f"{1 + tail}")
        for key, e in row["errors"].items():
            if e > 1:
                fail(f"{label} {key}: error {e:.3f} x tol")
        rows_out.append(row)
        torch.cuda.empty_cache()
    return rows_out


# the n-D drive (shard_nd_drive): the users' grids, each global grid over
# the 50 MB L2. (label, dtype, global shape, rank, meshes as (fft, data))
SHARD_ND_SLAB = (("fft2", "complex64", (4, 4096, 4096), 2, ((4, 1), (2, 2))),
                 ("fft2", "complex128", (2, 4096, 4096), 2, ((4, 1),)),
                 ("fftn", "complex64", (1, 512, 512, 512), 3, ((4, 1),)))
SHARD_ND_PENCIL = (("fft2", "complex64", (1, 8192, 8192), 2, (2, 2), False),
                   ("fftn", "complex64", (1, 512, 512, 512), 3, (2, 2), True))
SHARD_ND_REAL = ("float32", (4, 4096, 4096), ((4, 1), (2, 2)))
SHARD_ND_CONV = (((4, 2048, 2048), (33, 33)), ("float32", "complex64"),
                 ((4, 1), (2, 2)))
# the 2-D ABFT: (dtype, shape, G, threshold, meshes, the whole matrix, real)
SHARD_ND_FT = (("complex64", (8, 4096, 4096), 4, 1e-4, ((4, 1),), True,
                False),
               ("complex64", (8, 4096, 4096), 4, 1e-4, ((2, 2),), False,
                False),
               ("float32", (8, 4096, 4096), 4, 1e-4, ((4, 1),), False, True),
               ("complex128", (4, 2048, 2048), 2, 1e-10, ((4, 1),), False,
                False))


def _nd_block(ref, y):
    """This rank's block of the global ``ref`` as the DTensor ``y`` lays
    its value out (``torch.chunk`` blocks of each sharded dimension)."""
    idx = [slice(None)] * ref.dim()
    mesh = y.device_mesh
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, y.placements)):
        if pl.is_shard():
            n, c = mesh.size(i), mesh.get_local_rank(name)
            per = -(-ref.shape[pl.dim] // n)
            lo = min(c * per, ref.shape[pl.dim])
            idx[pl.dim] = slice(lo, min(lo + per, ref.shape[pl.dim]))
    return ref[tuple(idx)]


def _nd_transposed(ref, gp):
    """The pencil's transposed digit order of ``ref`` (..., R, C): y[..,
    kr1*r2 + kr2, kc1*c2 + kc2] = X[.., kr1 + r1*kr2, kc1 + c1*kc2]."""
    shape = ref.shape
    nl = ref.dim() - 2
    z = ref.reshape(shape[:-2] + (gp.r2, gp.r1, gp.pc.n2, gp.pc.n1))
    perm = list(range(nl)) + [nl + 1, nl, nl + 3, nl + 2]
    return z.permute(perm).reshape(shape)


def _nd_seu_eps(thr, s, rr, cw, cc):
    """An SEU's |eps| whose group score is ``SHARD_FT_SCORE`` times ``thr``:
    score ~ |eps| / (sqrt(Cw) sqrt(s R C)) for unit-variance inputs (Cw
    the pass-1 width: C, or Cp on the real path)."""
    return SHARD_FT_SCORE * thr * math.sqrt(cw) * math.sqrt(s * rr * cc)


ND_VS_PLAIN = ("fft_launches_vs_plain", "ifft_launches_vs_plain",
               "checksum_grids_vs_plain")


def shard_nd_drive(rank, call, fail, err_ratio, gen, trace):
    """One rank's drive of the n-D FFT on the mesh (``SHARD_ND_*``):
    every call's rank block against torch.fft, its ``block_fft`` launches
    against ``plan.launches`` (``ft_fft``'s and ``convolve``'s entries for
    the ABFT and the convolution, ``fft``'s a recomputed group),
    its collectives against ``plan.volume`` (the model's), chunks=2
    bitwise, the ABFT's verdicts; the host ms of each call; a primed
    trace of the slab fft2 and of the pencil's transposed fft2 (the local
    passes' device ms beside their byte bound); every launch of one slab
    fft2 and one ifft2, and the checksum-grid launch, held to
    block_fft_plain."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis.record import summarize
    from repro_torch.core.fft import FFTSpec, FTConfig, multidim, plan
    from repro_torch.kernels.trace_age import PRIMER, prime
    from repro_torch.launch.mesh import make_fft_mesh

    dev = torch.device("cuda", 0)
    rows_out = []

    def record(row, label, name, res, want_l, model, dtype, tail=(0, 0)):
        y, launches, _, ms = res
        row["calls"][name] = {
            "launches": launches, "host_ms": ms,
            "collectives": _audit_call(fail, f"{label} {name}", res, model,
                                       dtype, tail=tail)}
        if launches != want_l:
            fail(f"{label} {name}: {launches} block_fft launches, not "
                 f"{want_l}")
        return y

    def check_err(row, label, name, got, want):
        e = err_ratio(got, want)
        row["errors"][name] = e
        if e > 1:
            fail(f"{label} {name}: error {e:.3f} x tol")

    def traced_local(fn):
        """The block_fft kernels' device ms of one primed call."""
        dist.barrier()
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            prime()
            fn()
            torch.cuda.synchronize()
        kern = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "block_fft" in e.name and PRIMER not in e.name]
        return sum(kern), len(kern)

    meshes = {}

    def mesh_of(d, dd):
        if (d, dd) not in meshes:
            meshes[d, dd] = make_fft_mesh(d, dd)
        return meshes[d, dd]

    # -- slab fft2 / fftn (and ifft) ------------------------------------
    for ci, (kind, dtype, shape, nd, mlist) in enumerate(SHARD_ND_SLAB):
        gen.manual_seed(SEED + 101 + ci)
        x = torch.randn(shape, dtype=getattr(torch, dtype), device=dev,
                        generator=gen)
        ref = torch.fft.fftn(x, dim=tuple(range(-nd, 0)))
        for d, dd in mlist:
            mesh = mesh_of(d, dd)
            label = f"nd slab {kind} {dtype} {shape} on ({dd}, {d})"
            row = {"case": label, "calls": {}, "errors": {}}
            p = plan(FFTSpec(shape, rank=nd, mesh=mesh, decomp="slab",
                             dtype=dtype))
            res = call(lambda: p.fft(x), f"{label} fft")
            y = record(row, label, "fft", res, p.launches["fft"],
                       p.volume, dtype)
            del res
            check_err(row, label, "fft", y.to_local(), _nd_block(ref, y))
            if kind == "fft2" and dtype == "complex64":
                res = call(lambda: p.ifft(y), f"{label} ifft")
                xb = record(row, label, "ifft", res, p.launches["ifft"],
                            p.volume, dtype)
                del res
                check_err(row, label, "ifft", xb.to_local(),
                          _nd_block(x, xb))
                del xb
            if ci == 0 and (d, dd) == (4, 1):
                blk = y.to_local().numel() * y.to_local().element_size()
                ms, n = traced_local(lambda: p.fft(x))
                row["local_passes_device_ms"] = ms
                row["local_passes_traced"] = n
                row["local_passes_bound_ms"] = 4 * blk / HBM_BYTES_PER_S * 1e3
                row.update(shard_nd_launch_checks(x, p, err_ratio))
                for key in ND_VS_PLAIN:
                    if row[key] > 1:
                        fail(f"{label} {key}: error {row[key]:.3f} x tol")
            del y
            rows_out.append(row)
        del x, ref
        torch.cuda.empty_cache()
    # -- pencil: natural, transposed, TRANSPOSED_IN; chunks --------------
    for ci, (kind, dtype, shape, nd, (d, dd), chunked) in enumerate(
            SHARD_ND_PENCIL):
        gen.manual_seed(SEED + 111 + ci)
        x = torch.randn(shape, dtype=getattr(torch, dtype), device=dev,
                        generator=gen)
        mesh = mesh_of(d, dd)
        label = f"nd pencil {kind} {dtype} {shape} on ({dd}, {d})"
        row = {"case": label, "calls": {}, "errors": {}}
        spec = dict(rank=nd, mesh=mesh, decomp="pencil", dtype=dtype)
        ref = torch.fft.fftn(x, dim=tuple(range(-nd, 0)))
        pt = plan(FFTSpec(shape, natural_order=False, **spec))
        gp = pt.grid_pencil
        if not chunked:
            p = plan(FFTSpec(shape, **spec))
            res = call(lambda: p.fft(x), f"{label} fft natural")
            y = record(row, label, "fft natural", res, p.launches["fft"],
                       p.volume, dtype)
            del res
            check_err(row, label, "fft natural", y.to_local(), ref)
            del y
        res = call(lambda: pt.fft(x), f"{label} fft transposed")
        yt = record(row, label, "fft transposed", res, pt.launches["fft"],
                    pt.volume, dtype)
        del res
        want_t = _nd_transposed(ref, gp)
        del ref
        check_err(row, label, "fft transposed", yt.to_local(),
                  _nd_block(want_t, yt))
        del want_t
        if chunked:
            p2 = plan(FFTSpec(shape, natural_order=False, chunks=2, **spec))
            row["chunks"] = p2.chunks
            res = call(lambda: p2.fft(x), f"{label} fft transposed chunks=2")
            y2 = record(row, label, "fft transposed chunks=2", res,
                        p2.launches["fft"], p2.volume, dtype)
            del res
            row["chunks_bitwise"] = bool(torch.equal(y2.to_local(),
                                                     yt.to_local()))
            if not row["chunks_bitwise"] or p2.chunks != 2:
                fail(f"{label}: chunks=2 ({p2.chunks}) is not bitwise "
                     f"chunks=1")
            del y2
        else:
            res = call(lambda: pt.ifft(yt), f"{label} ifft transposed-in")
            xi = record(row, label, "ifft transposed-in", res,
                        pt.launches["ifft"], pt.volume, dtype)
            del res
            check_err(row, label, "ifft transposed-in", xi.to_local(),
                      _nd_block(x.reshape(xi.shape), xi))
            del xi
            blk = yt.to_local().numel() * yt.to_local().element_size()
            ms, n = traced_local(lambda: pt.fft(x))
            row["local_passes_device_ms"] = ms
            row["local_passes_traced"] = n
            row["local_passes_bound_ms"] = 8 * blk / HBM_BYTES_PER_S * 1e3
        del yt, x
        rows_out.append(row)
        torch.cuda.empty_cache()
    # -- the real slab and the composed pencil path -----------------------
    dtype, shape, mlist = SHARD_ND_REAL
    gen.manual_seed(SEED + 121)
    xr = torch.randn(shape, dtype=getattr(torch, dtype), device=dev,
                     generator=gen)
    refr = torch.fft.rfft2(xr)
    for d, dd, dec in [m + ("slab",) for m in mlist] + [(4, 1, "pencil")]:
        mesh = mesh_of(d, dd)
        label = f"nd real {dec} rfft2 {dtype} {shape} on ({dd}, {d})"
        row = {"case": label, "calls": {}, "errors": {}}
        p = plan(FFTSpec(shape, rank=2, real=True, decomp=dec, mesh=mesh))
        if dec == "slab":
            res = call(lambda: p.rfft2(xr), f"{label} rfft2")
            y = record(row, label, "rfft2", res, p.launches["fft"],
                       p.volume, p.spec.dtype)
            del res
            check_err(row, label, "rfft2", y.to_local(), _nd_block(refr, y))
            res = call(lambda: p.irfft2(y), f"{label} irfft2")
            xb = record(row, label, "irfft2", res, p.launches["ifft"],
                        p.volume, dtype)
            del res
            check_err(row, label, "irfft2", xb.to_local(),
                      _nd_block(xr, xb))
        else:
            # the composed path runs 1-D plans: their launches and
            # collectives are recorded, not held to an n-D model
            for name, fn in (("rfft2", lambda: p.rfft2(xr)),
                             ("irfft2", lambda: p.irfft2(y))):
                res = call(fn, f"{label} {name}")
                row["calls"][name] = {"launches": res[1],
                                      "collectives": summarize(res[2]),
                                      "host_ms": res[3]}
                if name == "rfft2":
                    y = res[0]
                    check_err(row, label, name, y.to_local(), refr)
                else:
                    xb = res[0]
                    check_err(row, label, name, xb.to_local(), xr)
                del res
        del y, xb
        rows_out.append(row)
    del xr, refr
    torch.cuda.empty_cache()
    # -- fft_convolve2 ------------------------------------------------------
    (sa, sv), dts, mlist = SHARD_ND_CONV
    for di, dtype in enumerate(dts):
        gen.manual_seed(SEED + 131 + di)
        a = torch.randn(sa, dtype=getattr(torch, dtype), device=dev,
                        generator=gen)
        v = torch.randn(sv, dtype=getattr(torch, dtype), device=dev,
                        generator=gen)
        s = (sa[-2] + sv[-2] - 1, sa[-1] + sv[-1] - 1)
        full = torch.fft.ifft2(torch.fft.fft2(a, s=s) * torch.fft.fft2(v,
                                                                       s=s))
        if dtype == "float32":
            full = full.real
        want = full[:, 16:16 + sa[-2], 16:16 + sa[-1]]     # mode "same"
        del full
        for d, dd in mlist:
            mesh = mesh_of(d, dd)
            label = f"nd fft_convolve2 {dtype} {sa} * {sv} on ({dd}, {d})"
            row = {"case": label, "calls": {}, "errors": {}}
            nr, nc = multidim._conv2_shape(sa[-2:], sv, d)
            real = dtype == "float32"
            cw = nc // 2 + d if real else nc
            ba = sa[0] // dd
            item = 8
            res = call(lambda: multidim.fft_convolve2(a, v, mesh,
                                                      mode="same"),
                       f"{label}")
            pc = plan(multidim.conv2_spec(a, v, mesh))
            a2a_bytes = (ba + 1) * nr * cw // d * item \
                + ba * sa[-2] * cw // d * item
            y = record(row, label, "convolve same", res,
                       pc.launches["convolve"], _stated_model(2, a2a_bytes),
                       dtype)
            del res
            check_err(row, label, "convolve same", y.to_local(),
                      _nd_block(want, y))
            del y
            rows_out.append(row)
        del a, v, want
        torch.cuda.empty_cache()
    # -- the 2-D grouped ABFT -------------------------------------------
    for ci, (dtype, shape, g, thr, mlist, matrix, real) in enumerate(
            SHARD_ND_FT):
        gen.manual_seed(SEED + 141 + ci)
        x = torch.randn(shape, dtype=getattr(torch, dtype), device=dev,
                        generator=gen)
        ref = torch.fft.rfft2(x) if real else torch.fft.fft2(x)
        b, rr, cc = shape
        s = b // g
        for d, dd in mlist:
            mesh = mesh_of(d, dd)
            md = mesh.get_local_rank("data") if dd > 1 else 0
            gl = g // dd
            cw = cc // 2 + d if real else cc
            eps = _nd_seu_eps(thr, s, rr, cw, cc)

            def seu(dev_, sig, row_, col):
                return [dev_ % d, sig, row_, col, 1, eps, -0.5 * eps]

            if g == 4:
                four = [seu(j, j * s + (j + 1) % s, 3 + j, j) for j in
                        range(g)]
                locs = [j * s + (j + 1) % s for j in range(g)]
            else:           # two groups: one SEU each
                four = [seu(j, j * s + 1, 3 + j, j) for j in range(g)]
                locs = [j * s + 1 for j in range(g)]
            cases = [("clean", None, {}, "clean"),
                     ("SEUs", four, {}, ("four", locs))]
            if matrix:
                double = [seu(0, 2 * s, 5, 1), seu(1, 2 * s + 1, 6, 2)]
                cases += [("correct=False", four, dict(correct=False),
                           "nocorrect"),
                          ("double hit", double, {}, "double"),
                          ("double hit, recompute", double,
                           dict(recompute_uncorrectable=True), "recompute"),
                          ("cs2 grid", [seu(1, b + 1, 4, 2)], {},
                           ("checksum", 1)),
                          ("cs3 grid", [seu(2, b + g + 2, 4, 2)], {},
                           ("checksum", 2))]
            label = (f"nd ft {'rfft2' if real else 'fft2'} {dtype} {shape} "
                     f"G={g} on ({dd}, {d})")
            row = {"case": label, "calls": {}, "errors": {}}
            for name, inj, kw, want in cases:
                ft = FTConfig(threshold=thr, groups=g, **kw)
                p = plan(FFTSpec(shape, rank=2, real=real, mesh=mesh, ft=ft,
                                 dtype="complex128" if dtype in (
                                     "complex128", "float64")
                                 else "complex64"))
                res = call(lambda: p.ft_fft(x, inject=inj),
                           f"{label} {name}")
                out = res[0]
                mine = sum(out.uncorrectable.tolist()[md * gl:(md + 1) * gl]) \
                    if kw.get("recompute_uncorrectable") else 0
                grp = s * rr * cw // d * (x.element_size() * (2 if real
                                                              else 1))
                # a recomputed group reruns the plain slab: one
                # all-to-all a group, which no model counts
                record(row, label, name, res, p.launches["ft_fft"]
                       + mine * p.launches["fft"], p.volume, p.spec.dtype,
                       tail=(mine, grp))
                del res
                blk = out.y.to_local()
                err = err_ratio(blk, _nd_block(ref, out.y))
                emax = torch.tensor([err], device=dev)
                dist.all_reduce(emax, op=dist.ReduceOp.MAX)
                err = float(emax)
                row["errors"][name] = err
                row["calls"][name].update(
                    flagged=out.flagged.tolist(),
                    location=out.location.tolist(),
                    group_score=out.group_score.tolist(),
                    shard_delta=max(out.shard_delta.tolist()),
                    corrected=int(out.corrected),
                    recomputed=int(out.recomputed))
                for msg in _ft_verdict_failures(out, want, g, err):
                    fail(f"{label} {name}: {msg}")
                del out, blk
            rows_out.append(row)
        del x, ref
        torch.cuda.empty_cache()
    return rows_out


@contextlib.contextmanager
def _held_to_plain(err_ratio):
    """Every ``block_fft`` launch inside the block (``stockham``'s and
    ``ops``' name for it) runs on the card and, on clones of its operands,
    on ``block_fft_plain``: yields ``{"launches", "worst"}``, the launches
    held and the largest error over tolerance. The kernel counts these
    launches on the wrapper, not on the main path's counter."""
    from repro_torch.kernels import ops, stockham

    kernel, by_ops = stockham.block_fft, ops.block_fft
    rec = {"launches": 0, "worst": 0.0}

    def checked(x, stages, *, out=None, tables=None, **kw):
        x0 = x.clone()
        o0 = None if out is None else (
            x0 if out.data_ptr() == x.data_ptr() else out.clone())
        got = kernel(x, stages, out=out, tables=tables, **kw)
        want = stockham.block_fft_plain(x0, stages, out=o0, **kw)
        rec["worst"] = max(rec["worst"], err_ratio(got, want))
        rec["launches"] += 1
        return got

    checked.launches = 0
    stockham.block_fft = ops.block_fft = checked
    try:
        yield rec
    finally:
        stockham.block_fft, ops.block_fft = kernel, by_ops


def shard_nd_launch_checks(x, p, err_ratio):
    """On every rank, at the slab fft2 case's shapes: one ``p.fft`` and one
    ``p.ifft`` with every launch held to block_fft_plain on clones of its
    card operands (the forward's pass 1 reading the rank's rows of the
    global grids in place and its R pass reading the all-to-all's
    received blocks; the inverse's R pass writing the send buffer's
    blocks and its last-axis pass), each call's launch count against
    ``p.launches``; and the ABFT's checksum-grid launch — 2G = 8 grids of
    the rank's rows into the pass-1 buffer at row offset B, the data rows
    untouched. Returns each one's error over tolerance and the launches
    held."""
    import torch

    from repro_torch.core.fft import multidim as md
    from repro_torch.kernels import stockham

    rec = {}
    with _held_to_plain(err_ratio) as fwd:
        y = p.fft(x)
    with _held_to_plain(err_ratio) as inv:
        p.ifft(y)
    del y
    rec["fft_launches_vs_plain"] = fwd["worst"]
    rec["ifft_launches_vs_plain"] = inv["worst"]
    rec["launches_held"] = [fwd["launches"], inv["launches"]]
    if rec["launches_held"] != [p.launches["fft"], p.launches["ifft"]]:
        rec["fft_launches_vs_plain"] = float("inf")    # a launch unheld
    xv, _, _ = md._grid_rows(x, p._mesh_view(), 2, 0)
    rows = xv.shape[0]
    cs = xv[:min(rows, 8)].repeat(-(-8 // rows), 1, 1)[:8].contiguous()
    buf = torch.zeros((rows + 8,) + tuple(xv.shape[1:]), dtype=x.dtype,
                      device=x.device)

    def grids():
        buf.zero_()
        md._last_axis(cs, p.axes[-1], buf[rows:], inverse=False)
        return buf.clone()

    got = grids()
    real = stockham.block_fft
    stockham.block_fft = lambda *a, tables=None, **k: \
        stockham.block_fft_plain(*a, **k)
    try:
        want = grids()
    finally:
        stockham.block_fft = real
    rec["checksum_grids_vs_plain"] = err_ratio(got, want)
    if got[:rows].any():
        rec["checksum_grids_vs_plain"] = float("inf")   # wrote a data row
    return rec


# serving over a mesh (shard_serve_drive): on the mesh of 4 a ServeRuntime
# (rank 0 leads) with three closed-loop client threads over these tenants
# of serve_tenants(), then on each mesh (4 and 2 x 2) the ft campaign
# through a runtime whose deadline never closes a group early
SHARD_SERVE_CONFIG = dict(max_batch=16, deadline_ms=2.0, queue_depth=512)
SHARD_SERVE_FT_DEADLINE_MS = 60000.0
SHARD_SERVE_TENANTS = ("fft:1048576:c64", "fft:8192:c128",
                       "fft:131072:c64:real", "spectrum:65536:c64",
                       "fft:1024x1024:c64")
SHARD_SERVE_CLIENTS = 3
# the ft bucket: c64 2^20, G groups, two closed groups of max_batch
# requests (each one batch), the first with one SEU in each checksum group
# (rows SHARD_SERVE_SEU_ROWS)
SHARD_SERVE_FT = dict(threshold=1e-4, groups=4)
SHARD_SERVE_FT_N = 1 << 20
SHARD_SERVE_SEU_ROWS = (1, 6, 9, 14)
SHARD_SERVE_MESHES = (((4, 1), True), ((2, 2), False))   # (mesh, tenants)
# the one NCCL rank: a runtime over make_fft_mesh(1) against a local one
SHARD_SERVE_ONE_RANK = (("fft", (700000,), "complex64", {}),
                        ("fft", (1 << 20,), "complex64", {}),
                        ("spectrum", (50000,), "complex64",
                         {"op": "spectrum"}),
                        ("ft", (8192,), "complex64", {"ft": True}))


def shard_serve_drive(rank, fail, trace):
    """One rank's drive of serving over a mesh (``SHARD_SERVE_*``): on the
    mesh of 4 a ``ServeRuntime`` (rank 0 leads: three closed-loop client
    threads over ``SHARD_SERVE_TENANTS`` of ``serve_tenants``), then on
    each mesh the ft campaign through a runtime whose deadline never
    closes a group early: two closed groups of c64 2^20 at G = 4, each one
    batch, one SEU a checksum group in the first. Every batch on every
    rank is held to its bucket plan: ``block_fft`` launches to
    ``plan.launches``, the plan's collectives to ``plan.volume`` (and the
    verdict's), the control group's to two flag all-reduces, the
    runtime's stated traffic (header, SEU rows, payload, result blocks)
    counted apart. On rank 0 each result against torch.fft of its
    zero-padded request (the spectrum in the mesh's digit order) at ATOL
    * max|ref|, the ft verdicts. Each rank's device ms of every bucket
    plan's local passes from a primed trace of one zero batch. One record
    a runtime."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis.record import record
    from repro_torch.core.fft import FTConfig
    from repro_torch.core.fft.distributed import make_dist_plan
    from repro_torch.kernels.stockham import block_fft
    from repro_torch.kernels.trace_age import PRIMER, prime
    from repro_torch.launch.mesh import make_fft_mesh
    from repro_torch.serve import RuntimeConfig, ServeRuntime
    from repro_torch.serve import serve_plan

    dev = torch.device("cuda", 0)
    mb = SHARD_SERVE_CONFIG["max_batch"]
    recorder = record()
    batches = []
    run_all = ServeRuntime._run_all

    def spied(self, key, fill, inject, *rest):
        start = len(recorder.ops)
        before = {k: list(v) for k, v in self.channel.traffic.items()}
        launches0 = block_fft.launches
        t0 = time.perf_counter()
        try:
            return run_all(self, key, fill, inject, *rest)
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            ctrl = self.channel.group
            plan = self._plans[key]
            # the runtime's broadcasts, sends and receives are its stated
            # traffic, counted by its channel
            calls = [op for op in recorder.ops[start:] if op.kind in (
                "all-to-all", "all-gather", "all-reduce")]
            batches.append({
                "label": key.label, "fill": fill, "host_ms": ms,
                "launches": block_fft.launches - launches0,
                "ops": [op for op in calls if op.group is not ctrl],
                "ctrl": [(op.kind, op.payload_bytes) for op in calls
                         if op.group is ctrl],
                "traffic": {k: [v[0] - before[k][0], v[1] - before[k][1]]
                            for k, v in self.channel.traffic.items()},
                "faults": 0 if inject is None else int(inject.shape[0]),
                "plan": {"launches": plan.launches, "volume": plan.volume,
                         "groups": plan.groups, "dtype": plan.spec.dtype,
                         "itemsize": self._payloads[key].itemsize}})

    ServeRuntime._run_all = spied
    recorder.__enter__()
    tenants = {t[0]: t for t in serve_tenants()}
    ft = FTConfig(threshold=SHARD_SERVE_FT["threshold"],
                  groups=SHARD_SERVE_FT["groups"], correct=True,
                  recompute_uncorrectable=True)
    out = []
    try:
        for (d, dd), with_tenants in SHARD_SERVE_MESHES:
            mesh = make_fft_mesh(d, dd)
            n1 = make_dist_plan(SHARD_SERVE_FT_N, d).n1
            eps = SHARD_FT_SCORE * SHARD_SERVE_FT["threshold"] * math.sqrt(
                n1) * math.sqrt(mb // SHARD_SERVE_FT["groups"]
                                * SHARD_SERVE_FT_N)
            runs = [("tenants", RuntimeConfig(ft=ft, **SHARD_SERVE_CONFIG))
                    ] if with_tenants else []
            runs.append(("ft", RuntimeConfig(ft=ft, **dict(
                SHARD_SERVE_CONFIG,
                deadline_ms=SHARD_SERVE_FT_DEADLINE_MS))))
            for kind, cfg in runs:
                label = f"serve {kind} over ({dd}, {d})"
                print(f"{time.perf_counter():.3f} {label}", file=trace,
                      flush=True)
                batches.clear()
                row = {"mesh": [dd, d], "run": kind}
                dist.barrier()
                t0 = time.perf_counter()
                rt = ServeRuntime(cfg, mesh=mesh)
                if rank == 0:
                    row.update(_serve_tenants_lead(dev, rt, tenants, fail,
                                                   label)
                               if kind == "tenants" else
                               _serve_ft_lead(dev, rt, eps, fail, label))
                rt.close()
                row["seconds"] = time.perf_counter() - t0
                row["commands"] = [list(c) for c in rt.commands]
                row["traffic"] = rt.stats()["mesh"]["traffic"]
                row["threads_alive"] = sum(t.is_alive() for t in rt._workers)
                if row["threads_alive"] or not rt.channel.closed:
                    fail(f"{label}: {row['threads_alive']} runtime threads "
                         f"alive after close, groups destroyed "
                         f"{rt.channel.closed}")
                if rt.failures:
                    fail(f"{label}: failed batches {rt.failures}")
                _check_served_batches(batches, mb, fail, label)
                row["local_passes_device_ms"] = {}
                for key in rt._keys:
                    # each bucket plan's local passes on this rank: a
                    # primed trace of one zero batch, every rank together
                    p = rt._plans[key]
                    xb = torch.zeros((mb,) + key.tshape,
                                     dtype=rt._payloads[key], device=dev)
                    dist.barrier()
                    serve_plan(p, xb, op=key.op)
                    torch.cuda.synchronize()
                    acts = [torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]
                    with torch.profiler.profile(activities=acts) as prof:
                        prime()
                        serve_plan(p, xb, op=key.op)
                        torch.cuda.synchronize()
                    kern = [e.time_range.elapsed_us() / 1e3
                            for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA
                            and "block_fft" in e.name
                            and PRIMER not in e.name]
                    row["local_passes_device_ms"][key.label] = [sum(kern),
                                                                len(kern)]
                    del xb
                row["batches"] = [{k: b[k] for k in ("label", "fill",
                                                     "launches", "host_ms")}
                                  for b in batches]
                out.append(row)
                del rt
                torch.cuda.empty_cache()
    finally:
        ServeRuntime._run_all = run_all
        recorder.__exit__(None, None, None)
    return out


def _check_served_batches(batches, mb, fail, label):
    """Each served batch on this rank against its bucket plan: the
    ``block_fft`` launches, the data groups' collectives, the control
    group's two flag all-reduces, the runtime's stated traffic."""
    for b in batches:
        p = b["plan"]
        want_l = p["launches"]["ft_fft" if p["groups"] else "fft"]
        if b["launches"] != want_l:
            fail(f"{label} {b['label']}: {b['launches']} block_fft "
                 f"launches, not {want_l}")
        # the data groups' ops against the plan's volume, the verdict's
        # terms included on an ft bucket (the assembled result is the
        # leader's alone: no output dtypes here)
        _audit_call(fail, f"{label} {b['label']}", (None, 0, b["ops"], 0.0),
                    p["volume"], p["dtype"])
        if b["ctrl"] != [("all-reduce", 8), ("all-reduce", 8)]:
            fail(f"{label} {b['label']}: control group {b['ctrl']}")
        t = b["traffic"]
        payload = mb * p["itemsize"] * math.prod(
            int(v) for v in re.findall(r"\d+", b["label"].split(":")[1]))
        if t["payload"] != [1, payload] or t["flag"] != [2, 16] \
                or t["control"] != ([1, 56 * b["faults"]] if b["faults"]
                                    else [0, 0]):
            fail(f"{label} {b['label']}: control traffic {t}")


def _bucket_rows(stats, errs, wall, fail, label):
    """Each bucket's served numbers from the runtime's telemetry; a failed
    or unfinished request fails."""
    mb = SHARD_SERVE_CONFIG["max_batch"]
    out = {}
    for name, st in stats.items():
        out[name] = {
            "err_over_tol": errs.get(name),
            "p50_ms": st["p50_ms"], "p95_ms": st["p95_ms"],
            "p99_ms": st["p99_ms"], "completed": st["completed"],
            "rps": st["completed"] / wall, "batches": st["batches"],
            "mean_fill": st["batch_occupancy"] * mb,
            "pad_waste": st["pad_waste"]}
        if st["failed"] or st["completed"] != st["submitted"]:
            fail(f"{label} {name}: {st}")
    return out


def _serve_tenants_lead(dev, rt, tenants, fail, label):
    """The leader's tenants: the requests made first, then the clients
    started together and awaited (the timed run), then every result
    checked. Returns the bucket rows."""
    import threading

    import torch

    shares = [[] for _ in range(SHARD_SERVE_CLIENTS)]
    i = 0
    for name in SHARD_SERVE_TENANTS:
        tenant = tenants[name]
        for k in range(tenant[4]):
            shape = tenant[1][k % len(tenant[1])]
            shares[i % SHARD_SERVE_CLIENTS].append((i, (tenant, shape)))
            i += 1
    start = threading.Event()
    outs, errors = [], []
    threads = [threading.Thread(target=_client, args=(
        dev, rt, share, start, outs, errors)) for share in shares]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    start.set()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"{label}: clients failed: {errors[:1]}")
        return {}
    errs = {}
    for tenant, x, h, y in outs:
        name, dtype = tenant[0], tenant[2]
        ref = tenant[5]
        if name.startswith("spectrum"):
            p = rt._plans[next(k for k in rt._plans if k.label == name)]
            n = p.tshape[0]
            ref = (lambda x, n=n, pen=p.pencil: torch.fft.fft(
                x, n=n).abs().square().div(n).view(pen.n2, pen.n1).t()
                .reshape(n))
        errs[name] = max(errs.get(name, 0.0),
                         _served_err(dev, name, x, y, ref, dtype, fail))
    return {"wall_s": wall, "buckets": _bucket_rows(
        rt.stats()["buckets"], errs, wall, fail, label)}


def _serve_ft_lead(dev, rt, eps, fail, label):
    """The leader's ft campaign: two closed groups of max_batch c64 2^20
    requests, made first, each sent and awaited; the runtime's deadline
    never closes a group early, so each is one batch. The faulted group's
    verdict: its four SEUs, one alone in each checksum group, flagged,
    located at their batch rows and corrected; the clean group's nothing.
    Returns the bucket row and the verdicts."""
    import numpy as np
    import torch

    from repro_torch.serve import Fault

    mb = SHARD_SERVE_CONFIG["max_batch"]
    rng = np.random.default_rng(SEED + 77)
    groups = []
    for g in range(2):
        xs = [_serve_request(dev, 20_000 + g * mb + j, (SHARD_SERVE_FT_N,),
                             "complex64", j % 2 == 1) for j in range(mb)]
        faults = {}
        if g == 0:
            for r in SHARD_SERVE_SEU_ROWS:
                faults[r] = Fault(row=int(rng.integers(1, 64)),
                                  col=int(rng.integers(SHARD_SERVE_FT_N)),
                                  eps_re=eps, eps_im=-0.5 * eps)
        groups.append((g, xs, faults))
    rt.admit(rt.bucketer.key_for((SHARD_SERVE_FT_N,), "complex64", ft=True))
    t0 = time.perf_counter()
    done = []
    for g, xs, faults in groups:
        hs = [rt.submit(x, ft=True, faults=faults.get(j))
              for j, x in enumerate(xs)]
        done.append((g, xs, faults, hs, [h.result(timeout=300.0)
                                         for h in hs]))
    wall = time.perf_counter() - t0
    ft_label = f"fft:{SHARD_SERVE_FT_N}:c64:ft"
    verdicts, err = [], 0.0
    for g, xs, faults, hs, ys in done:
        rows = sorted(faults)
        want = {"batch_fill": mb, "flagged": len(rows), "locations": rows,
                "corrected": len(rows), "uncorrectable": 0,
                "checksum_faults": 0, "recomputed": 0}
        info = hs[0].info
        got = {k: info[k] for k in want}
        verdicts.append({"group": g, "seus": len(rows), "got": got,
                         "score": info["score"]})
        if got != want or any(h.info != info for h in hs):
            fail(f"{label} ft group {g}: {got}, not {want}")
        for x, y in zip(xs, ys):
            err = max(err, _served_err(dev, "ft", x, y,
                                       lambda v: torch.fft.fft(v),
                                       "complex64", fail))
    stats = rt.stats()["buckets"]
    st = stats.get(ft_label, {})
    ledger = [st.get(k) for k in ("injected", "detected", "corrected")]
    seus = len(SHARD_SERVE_SEU_ROWS)
    if ledger != [seus, seus, seus]:
        fail(f"{label}: ft ledger injected/detected/corrected {ledger}, "
             f"not {[seus] * 3}")
    return {"wall_s": wall, "ft": verdicts, "buckets": _bucket_rows(
        stats, {ft_label: err}, wall, fail, label)}


def _served_err(dev, label, x, y, ref, dtype, fail):
    """A served result against ``ref`` of its request on the card, in
    units of ATOL[dtype] * max|ref|; a result of another kind than its
    request, or an error over 1, fails."""
    import numpy as np
    import torch
    if torch.is_tensor(x):
        if not (torch.is_tensor(y) and y.device == x.device):
            fail(f"{label}: a card request came back as {type(y)}")
            return float("inf")
        xd, yd = x, y
    else:
        if not isinstance(y, np.ndarray):
            fail(f"{label}: a numpy request came back as {type(y)}")
            return float("inf")
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    want = ref(xd)
    if tuple(yd.shape) != tuple(want.shape):
        fail(f"{label}: shape {tuple(yd.shape)} for {tuple(want.shape)}")
        return float("inf")
    e = (yd - want).abs().max().item() / (
        ATOL[dtype] * want.abs().max().item())
    if e > 1:
        fail(f"{label}: error {e:.3f} x tol")
    return e


SHARD_ERRORS = ("fft", "ifft", "fft_transposed", "ifft_transposed_in",
                "fft_shard_signals", "pass1_vs_plain", "pass2_vs_plain",
                "passA_vs_plain", "passB_vs_plain", "checksum_rows_vs_plain")


def shard_launch_checks(pen, x, yt_local, d, err_ratio):
    """Each launch of rank ``d``'s steps at this case's shapes, the kernel
    against its plain version on the same card tensors: pass 1 (the
    twiddle of the rank's global columns) on ``x``, every pass of the N2
    tail in its layout on pass 1's output, pass A's launches (two on a
    two-pass tail, the second reading the first's output) on this rank's
    transposed-order block ``yt_local`` (B, N/D), pass B, and the ABFT's
    second pass-1 launch: 2G = 8 checksum rows into a send buffer of B +
    8 rows at row offset B. Returns the largest error over tolerance of
    each step."""
    import torch

    from repro_torch.core.fft import distributed as sd
    from repro_torch.core.fft.plan import pass_layouts
    from repro_torch.kernels.stockham import block_fft, block_fft_plain

    b, n = x.shape
    shards = pen.shards

    def both(launch, src, shape):
        got = launch(src, torch.zeros(shape, dtype=x.dtype, device=x.device))
        want = launch(src, torch.zeros_like(got), plain=True)
        return got, err_ratio(got, want)

    rec = {}
    src = sd.Source(x.view(-1), d * pen.n2l, n, pen.n2)
    got, rec["pass1_vs_plain"] = both(
        pen.pass1_launch(src, b, d, inverse=False), src.flat[src.base:],
        (shards, pen.n1l, b, pen.n2l))
    z = got.permute(2, 1, 0, 3).reshape(b * pen.n1l, pen.n2)
    del got
    ax = pen.ax2
    facs = ax.plan.kernel_factors
    errs = []
    for i, layout in enumerate(pass_layouts(z.shape[0], facs)):
        kw = dict(layout=layout, twiddle=None if i == len(facs) - 1
                  else ax.twiddles[False][i])
        k = block_fft(z, ax.plan.stages[i], tables=ax.tables[False][i],
                      out=torch.zeros_like(z), **kw)
        errs.append(err_ratio(k, block_fft_plain(
            z, ax.plan.stages[i], out=torch.zeros_like(z), **kw)))
        del k
    rec["pass2_vs_plain"] = max(errs)
    del z
    row_len, w = pen.n1l * pen.n2, b // shards
    y = yt_local.contiguous().view(-1)
    errs = []
    for launch in pen.pass_a_launches(shards, w * row_len, w, row_len, d):
        y, e = both(launch, y, (shards, w, pen.n1l, pen.n2))
        errs.append(e)
    rec["passA_vs_plain"] = max(errs)
    rec["passA_launches"] = len(errs)
    _, rec["passB_vs_plain"] = both(
        pen.pass_b_launch(w), y.transpose(0, 1).reshape(w, pen.n1, pen.n2),
        (w, pen.n1, pen.n2))
    del y
    cs = torch.randn((8, pen.n1, pen.n2l), dtype=x.dtype, device=x.device,
                     generator=torch.Generator(device=x.device).manual_seed(
                         SEED + d))
    nrow = b + 8
    launch = pen.pass1_launch(sd.Source(cs.view(-1), 0, pen.n1 * pen.n2l,
                                        pen.n2l), 8, d, inverse=False,
                              out_rows=nrow)
    got, want = (torch.zeros((shards, pen.n1l, nrow, pen.n2l),
                             dtype=x.dtype, device=x.device)
                 for _ in range(2))
    launch(cs.view(-1), got.view(-1)[b * pen.n2l:])
    launch(cs.view(-1), want.view(-1)[b * pen.n2l:], plain=True)
    rec["checksum_rows_vs_plain"] = err_ratio(got, want)
    if got[:, :, :b].any():
        rec["checksum_rows_vs_plain"] = float("inf")   # wrote a data row
    return rec


def shard_rank(rank, store, out_dir):
    """The entry point of one of the four ranks: a gloo group over a file
    store, phase 13's drive, then phase 14's (``lmp_rank``), each record
    written to ``out_dir``."""
    import faulthandler
    import gc

    import torch
    import torch.distributed as dist

    trace = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
    faulthandler.enable(trace)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=SHARD_RANKS)
    try:
        res = shard_drive(rank, trace)
    except Exception:                 # reported by the main process
        res = {"rank": rank, "failures": [traceback.format_exc()],
               "cases": [], "launches": 0}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    # phase 14 in the same processes, the sharded FFT's buffers and plans
    # freed
    from repro_torch.core.plan import plan_cache_clear

    del res
    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    try:
        res = lmp_rank(rank, out_dir, trace)
    except Exception:                 # reported by the main process
        res = {"rank": rank, "failures": [traceback.format_exc()]}
    with open(os.path.join(out_dir, f"rank{rank}-lm.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def sharded_phase(dev, cuda_ms, smi):
    """Phase 13: four gloo ranks on the one card (``shard_rank``), then one
    NCCL rank in this process. ``smi`` is the card's name and power limit,
    logged beside the serving drive's numbers. Returns its record; raises
    on a failure."""
    import socket
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.core.fft import FFTSpec, plan
    from repro_torch.kernels.stockham import block_fft
    from repro_torch.launch.mesh import make_fft_mesh

    rec = {}
    out_dir = tempfile.mkdtemp(prefix="shards-", dir=_build_dir())
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=shard_rank,
                         args=(r, os.path.join(out_dir, "store"), out_dir))
             for r in range(SHARD_RANKS)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    deadline = t0 + SHARD_TIMEOUT
    for proc in procs:
        proc.join(max(1.0, deadline - time.perf_counter()))
    alive = [proc for proc in procs if proc.is_alive()]
    for proc in alive:
        # faulthandler writes the rank's stacks into its log on SIGABRT
        os.kill(proc.pid, signal.SIGABRT)
        proc.join(10)
        if proc.is_alive():
            proc.kill()
            proc.join()
    rec["four_ranks_seconds"] = time.perf_counter() - t0
    if alive:
        for r in range(SHARD_RANKS):
            for name in (f"rank{r}.json", f"rank{r}-lm.json"):
                path = os.path.join(out_dir, name)
                if os.path.exists(path):
                    with open(path) as f:
                        for msg in json.load(f).get("failures", []):
                            log(f"{name}: {msg}")
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                log(f"rank {r} (exit code {procs[r].exitcode})'s log ends:\n"
                    + "".join(f.readlines()[-40:]))
    check(not alive, f"phases 13-14: {len(alive)} ranks still ran after "
          f"{SHARD_TIMEOUT} s (their logs above)")
    ranks = []
    for r in range(SHARD_RANKS):
        path = os.path.join(out_dir, f"rank{r}.json")
        if not os.path.exists(path):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                log(f"phase 13 rank {r}'s log ends:\n"
                    + "".join(f.readlines()[-30:]))
        check(os.path.exists(path), f"phase 13: rank {r} wrote no record "
              f"(exit code {procs[r].exitcode})")
        with open(path) as f:
            ranks.append(json.load(f))
    for res in ranks:
        for msg in res["failures"]:
            log(f"phase 13 rank {res['rank']}: {msg}")
    check(all(not res["failures"] for res in ranks),
          "phase 13: a rank failed (above)")
    check(all(res["launches"] > 0 for res in ranks),
          f"phase 13: a rank launched no block_fft: "
          f"{[res['launches'] for res in ranks]}")
    for k in ("dtensor_import_ms", "first_collectives_ms"):
        rec[k] = [res[k] for res in ranks]
    log(f"  before the first call in each rank's process: the import of "
        f"torch.distributed.tensor "
        f"{[round(v, 1) for v in rec['dtensor_import_ms']]} host ms, gloo's "
        f"first CUDA all-to-all and all-gather (one element a rank) "
        f"{[round(v, 1) for v in rec['first_collectives_ms']]} host ms")
    for row in ranks[0]["cases"]:
        calls = {k: (round(c["host_ms"], 1), c["launches"])
                 for k, c in row["calls"].items()}
        errs = {k: round(row[k], 4) for k in SHARD_ERRORS if k in row}
        log(f"  rank 0 {row['case']} (n1 {row['n1']}, n2 {row['n2']}, "
            f"tail {row['tail']} passes): err/tol {errs}; host ms and "
            f"launches {calls}; local passes "
            f"{row.get('local_passes_device_ms', float('nan')):.4f} device "
            f"ms")
    for i, row in enumerate(ranks[0]["ft"]):
        host = {r: {k: round(c["host_ms"], 1) for k, c in
                    res["ft"][i]["calls"].items() if "transposed" in k}
                for r, res in enumerate(ranks)}
        plain = [round(res["ft"][i]["plain_transposed_host_ms"], 1)
                 for res in ranks]
        four = row["calls"]["four SEUs transposed"]
        errs = {k: round(e, 4) for k, e in row["errors"].items()}
        launches = {k: c["launches"] for k, c in row["calls"].items()}
        log(f"  {row['case']} (n1 {row['n1']}, n2 {row['n2']}): err/tol "
            f"{errs}; launches {launches}; four SEUs scores "
            f"{[f'{v:.3g}' for v in four['group_score']]}, clean "
            f"{max(row['calls']['clean transposed']['group_score']):.3g}, "
            f"shard_delta {four['shard_delta']:.3g}; gloo host-staged ms a "
            f"rank {host}, the plain transposed transform {plain}"
            + (f"; traced: {row['trace']}" if "trace" in row else ""))
    for i, row in enumerate(ranks[0]["spectral"]):
        errs = {k: round(max(res["spectral"][i]["errors"][k]
                             for res in ranks), 4)
                for k in row["errors"]}
        calls = {k: (round(c["host_ms"], 1), c["launches"])
                 for k, c in row["calls"].items()}
        log(f"  {row['case']}: err/tol (worst rank) {errs}; host ms and "
            f"launches {calls}")
    nd_keys = ("local_passes_device_ms", "local_passes_bound_ms",
               "local_passes_traced", "chunks", "chunks_bitwise",
               "launches_held") + ND_VS_PLAIN
    for i, row in enumerate(ranks[0]["nd"]):
        errs = {k: round(max(res["nd"][i]["errors"][k] for res in ranks), 4)
                for k in row["errors"]}
        calls = {k: [round(res["nd"][i]["calls"][k]["host_ms"], 1)
                     for res in ranks] + [c["launches"]]
                 for k, c in row["calls"].items()}
        extra = {k: row[k] for k in nd_keys if k in row}
        log(f"  {row['case']}: err/tol (worst rank) {errs}; host ms of "
            f"ranks 0-3 and launches {calls}"
            + (f"; rank 0 {extra}" if extra else ""))
    rec["nd_seconds"] = max(res["nd_seconds"] for res in ranks)
    log(f"  the n-D drive took {rec['nd_seconds']:.1f} s (slowest rank)")
    for i, row in enumerate(ranks[0]["serve"]):
        cmds = [res["serve"][i]["commands"] for res in ranks]
        check(all(c == cmds[0] for c in cmds) and cmds[0][-1][0] == "stop",
              f"phase 13 serve over {row['mesh']}: the ranks ran different "
              f"commands")
        runs = [c for c in cmds[0] if c[0] == "run"]
        log(f"  serve {row['run']} over (data, fft) = {tuple(row['mesh'])}: "
            f"{len(runs)} batches, the same (command, bucket, fill) "
            f"sequence of {len(cmds[0])} on every rank, "
            f"{row['seconds']:.1f} s; control-group traffic on rank 0 "
            f"[calls, bytes] {row['traffic']} ({smi})")
        for name, b in row.get("buckets", {}).items():
            dev_ms = [round(res["serve"][i]["local_passes_device_ms"][
                name][0], 4) for res in ranks]
            host = [round(x["host_ms"], 1) for x in row["batches"]
                    if x["label"] == name]
            log(f"    {name}: err/tol {b['err_over_tol']:.4f}; latency "
                f"p50/p95/p99 {b['p50_ms']:.1f}/{b['p95_ms']:.1f}/"
                f"{b['p99_ms']:.1f} host ms; {b['rps']:.1f} requests/s; "
                f"{b['batches']} batches, mean fill {b['mean_fill']:.2f}; "
                f"rank 0's batch host ms {host}; local passes of a batch "
                f"{dev_ms} device ms on ranks 0-3 ({smi})")
        for v in row.get("ft", []):
            log(f"    ft group {v['group']}, one batch with {v['seus']} "
                f"SEUs: {v['got']}, score {v['score']:.3g}")
    rec["serve_seconds"] = max(res["serve_seconds"] for res in ranks)
    log(f"  the serving drive took {rec['serve_seconds']:.1f} s (slowest "
        f"rank)")
    rec["ranks"] = ranks
    rec["out_dir"] = out_dir
    rec["launches"] = sum(res["launches"] for res in ranks)
    rec["launches_ft"] = sum(res["launches_ft"] for res in ranks)
    rec["launches_spectral"] = sum(res["launches_spectral"]
                                   for res in ranks)
    rec["launches_nd"] = sum(res["launches_nd"] for res in ranks)
    rec["launches_serve"] = sum(res["launches_serve"] for res in ranks)

    # (a) one rank on NCCL: make_fft_mesh(1) plans the local transform
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1, device_id=dev)
    try:
        dtype, logn, b = SHARD_ONE_RANK
        n = 1 << logn
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + logn + b)
        x = torch.randn((b, n), dtype=getattr(torch, dtype), device=dev,
                        generator=gen)
        mesh = make_fft_mesh(1)
        p1 = plan(FFTSpec((b, n), dtype=dtype, mesh=mesh))
        p0 = plan(FFTSpec((b, n), dtype=dtype))
        check(p1.decomp == "local" and p1.shards == 1,
              f"phase 13: the one-rank plan is {p1!r}")
        block_fft.launches = 0
        y1 = p1.fft(x)
        torch.cuda.synchronize()
        one = block_fft.launches
        check(one == p0.local_plan.num_passes == 2,
              f"phase 13: the one-rank plan launched {one} block_fft")
        check(torch.equal(y1, p0.fft(x)),
              "phase 13: the one-rank plan is not bitwise plan.fft")
        rec["one_rank"] = {"case": f"{dtype} 2^{logn}x{b}", "launches": one,
                           "mesh_ms": cuda_ms(lambda: p1.fft(x)),
                           "plan_ms": cuda_ms(lambda: p0.fft(x)),
                           "torch_fft_ms": cuda_ms(
                               lambda: torch.fft.fft(x))}
        rec["launches"] += one
        del x, y1
        # the ft plan on the one-rank mesh is the local one: the fused
        # kernel, the same result as without the mesh
        from repro_torch.core.fft import FTConfig, spectral
        from repro_torch.kernels.stockham_abft import abft_fft
        dtype, logn, b = SHARD_ONE_RANK_FT
        n = 1 << logn
        x = torch.randn((b, n), dtype=getattr(torch, dtype), device=dev,
                        generator=gen)
        pf1 = plan(FFTSpec((b, n), dtype=dtype, ft=FTConfig(), mesh=mesh))
        pf0 = plan(FFTSpec((b, n), dtype=dtype, ft=FTConfig()))
        check(pf1.decomp == "local", f"phase 13: the one-rank ft plan is "
              f"{pf1!r}")
        b0, a0 = block_fft.launches, abft_fft.launches
        r1 = pf1.ft_fft(x)
        torch.cuda.synchronize()
        ft_launches = (block_fft.launches - b0, abft_fft.launches - a0)
        r0 = pf0.ft_fft(x)
        check(ft_launches == (1, 1), f"phase 13: the one-rank ft plan "
              f"launched {ft_launches} (block_fft, abft_fft)")
        check(torch.equal(r1.y, r0.y) and torch.equal(r1.flagged,
                                                      r0.flagged),
              "phase 13: the one-rank ft plan is not the local one")
        # fft_convolve on the one-rank mesh is the local convolution
        dtype, logl, b = SHARD_ONE_RANK_CONV
        a = torch.randn((b, 1 << logl), dtype=getattr(torch, dtype),
                        device=dev, generator=gen)
        v = torch.randn((1, 1 << logl), dtype=getattr(torch, dtype),
                        device=dev, generator=gen)
        b1 = block_fft.launches
        c1 = spectral.fft_convolve(a, v, mesh)
        torch.cuda.synchronize()
        conv_launches = block_fft.launches - b1
        check(torch.equal(c1, spectral.fft_convolve(a, v)),
              "phase 13: fft_convolve on the one-rank mesh is not the "
              "local one")
        rec["one_rank"]["ft_fft"] = {
            "case": f"{SHARD_ONE_RANK_FT[0]} 2^{SHARD_ONE_RANK_FT[1]}x"
                    f"{SHARD_ONE_RANK_FT[2]}",
            "launches": {"block_fft": ft_launches[0],
                         "abft_fft": ft_launches[1]}}
        rec["one_rank"]["convolve"] = {
            "case": f"{dtype} ({b}, 2^{logl}) with a (1, 2^{logl}) kernel",
            "launches": conv_launches}
        rec["launches"] += ft_launches[0] + conv_launches
        rec["abft_launches"] = ft_launches[1]
        del x, r1, r0, a, v, c1
        # a rank-2 plan on the one-rank mesh is the local one: bitwise,
        # with the same launches
        x = torch.randn(SHARD_ONE_RANK_2D, dtype=torch.complex64,
                        device=dev, generator=gen)
        q1 = plan(FFTSpec(x.shape, rank=2, mesh=mesh))
        q0 = plan(FFTSpec(x.shape, rank=2))
        check(q1.decomp == "local", f"phase 13: the one-rank rank-2 plan "
              f"is {q1!r}")
        counts = []
        for q in (q1, q0):
            b1 = block_fft.launches
            y = q.fft(x)
            torch.cuda.synchronize()
            counts.append(block_fft.launches - b1)
            if q is q1:
                y1 = y
        check(counts[0] == counts[1] and torch.equal(y1, y),
              f"phase 13: the one-rank rank-2 plan is not the local one "
              f"(launches {counts})")
        rec["one_rank"]["fft2"] = {"case": f"complex64 {SHARD_ONE_RANK_2D}",
                                   "launches": counts[0]}
        rec["launches"] += counts[0]
        del x, y, y1
        rec["one_rank"]["serve"] = one_rank_serve(dev, mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec


def one_rank_serve(dev, mesh):
    """A ``ServeRuntime`` over the one-rank NCCL mesh serves
    ``SHARD_SERVE_ONE_RANK`` bitwise equal to a local one: it is the local
    runtime (no command channel, two workers on their own streams, the
    fused ABFT with its one SEU a batch). Four requests a tenant, numpy
    and card tensors in turn, one batch each."""
    import torch

    from repro_torch.serve import Fault, RuntimeConfig, ServeRuntime

    reqs = [(name, _serve_request(dev, 30_000 + 4 * t + j, shape, dtype,
                                  j % 2 == 1), kw)
            for t, (name, shape, dtype, kw) in enumerate(SHARD_SERVE_ONE_RANK)
            for j in range(4)]
    runs = []
    for m in (mesh, None):
        with ServeRuntime(RuntimeConfig(max_batch=4, deadline_ms=60000.0),
                          mesh=m) as rt:
            hs = [rt.submit(x, faults=Fault(col=11, eps_re=300.0)
                            if name == "ft" and j % 4 == 2 else None, **kw)
                  for j, (name, x, kw) in enumerate(reqs)]
            rt.drain()
            runs.append(([torch.as_tensor(h.result(timeout=120.0)).cpu()
                          for h in hs], rt.channel is None,
                         [h.info.get("corrected") for h in hs]))
    (mine, local_a, fixed_a), (theirs, local_b, fixed_b) = runs
    same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
    check(same and local_a and local_b and fixed_a == fixed_b
          and fixed_a[-2] == 1,
          f"phase 13: the runtime over the one-rank mesh is not the local "
          f"one (bitwise {same}, local {local_a, local_b}, corrected "
          f"{fixed_a} vs {fixed_b})")
    return {"requests": len(reqs), "bitwise": same,
            "tenants": [t[0] for t in SHARD_SERVE_ONE_RANK]}


# ---- phase 14: LM parallelism on torch.distributed, in phase 13's four
# gloo ranks on the one card (after their sharded-FFT drives, their buffers
# freed), then the plain comparisons in this process after they exit.
# (a) expert parallelism: DeepSeek-V3's MoE block at its published widths
# (d 7168, 256 routed experts, top 8, moe_d_ff 2048, one shared expert,
# capacity factor 1.25: 80 slots an expert at 2048 tokens) on
# make_host_mesh(1, 4), 64 experts a rank, each drawn expert by expert
# from its own seed; (b) the sharded train step: Gemma-3 1B at its
# published widths cut to LMP_TRAIN_LAYERS layers, every linear protected,
# on make_host_mesh(2, 2); (c) pipeline_apply over the four ranks as
# stages, and elastic_restore of the stage weights onto ranks 0-1
LMP_MOE_ARCH = "deepseek_v3_671b"
LMP_EP_MESH = (1, 4)
LMP_EP_X = (4, 512)                       # 2048 tokens: cap 80 at 1.25
LMP_EP_CAP = 8 * 2048 // 256 * 5 // 4     # ceil(2048 * 8 / 256 * 1.25)
# y of EP against the portable path on the same weights and input: the
# reference test's bound at float32; bf16 at 2^-5 (four ranks' partial
# sums added in another order than the portable path's k-sum)
LMP_EP_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -5}
LMP_FT_THRESHOLD = 1e-3
# an SEU in the shared expert's first product (site 0), token row 5,
# column 7, +300
LMP_EP_SEU = (0.0, 5.0, 7.0, 1.0, 300.0)
LMP_TRAIN_ARCH = "gemma3_1b"
LMP_TRAIN_LAYERS = 4
LMP_TRAIN_MESH = (2, 2)
LMP_TRAIN_BATCH = (8, 256)                # 4 x 256 tokens a data rank
LMP_TRAIN_STEPS = 2
# the schedule's step of the first: its step 0 has lr 0 (the warm-up's
# s / max(warmup, 1)) and would update nothing
LMP_TRAIN_FIRST_STEP = 1
LMP_TRAIN_SITES = 7                       # protected products a block
LMP_REDUCED = ("Gemma-3 1B at 4 of its 26 layers (phase 14's sharded "
               "step), for the script's time; float32 activations, so that "
               "the sharded step can be held to the one-rank step")
# the sharded step against the one-rank step: tests/test_torch_train.py's
# tolerances (loss, ce and grad_norm 1e-5 relative, params 1e-6, or 4x the
# one-rank step's own drift from params one ulp up where that is larger)
LMP_LOSS_TOL = 1e-5
LMP_PARAM_TOL = 1e-6
LMP_WITNESS_FACTOR = 4
LMP_COMPRESS_TOL = 0.05                   # the reference test's bound
LMP_PIPE = (1152, 6, 8)                   # width, microbatches, rows
LMP_PIPE_TOL = 1e-5
LMP_DEVICE = "cuda"                       # the ranks' and meshes' device


def lmp_moe_cfg():
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(LMP_MOE_ARCH),
                              capacity_factor=1.25)
    check((cfg.d_model, cfg.num_experts, cfg.top_k, cfg.moe_d_ff,
           cfg.num_shared_experts) == (7168, 256, 8, 2048, 1),
          f"phase 14: {cfg.name} is not DeepSeek-V3's published MoE")
    return cfg


def lmp_experts(cfg, lo, hi, dev):
    """Routed experts ``lo``..``hi - 1``, each (wi_gate, wi_up, wo) drawn
    from its own seed, so any process rebuilds any expert."""
    import torch

    d, f = cfg.d_model, cfg.moe_d_ff
    out = {k: torch.empty((hi - lo,) + s, device=dev) for k, s in
           (("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d)))}
    gen = torch.Generator(device=dev)
    for i in range(lo, hi):
        gen.manual_seed(SEED * 1000 + 14_000 + i)
        for k, fan in (("wi_gate", d), ("wi_up", d), ("wo", f)):
            out[k][i - lo].normal_(generator=gen).mul_(fan ** -0.5)
    return out


def lmp_moe_inputs(cfg, dev):
    """The router, the shared expert and the input, from SEED."""
    import torch

    d, e, fs = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)

    def n(shape, fan):
        return torch.randn(shape, generator=gen, device=dev) * fan ** -0.5

    params = {"router": n((d, e), d),
              "shared": {"wi_gate": n((d, fs), d), "wi_up": n((d, fs), d),
                         "wo": n((fs, d), fs)}}
    x = torch.randn(LMP_EP_X + (d,), generator=gen, device=dev)
    return params, x


def _op_row(op):
    """A recorded collective (``repro_torch.analysis.record``) as phase
    14's record keeps it: ``[kind, payload bytes, group ranks]``
    (``"world"`` for the default group)."""
    import torch.distributed as dist

    return [op.kind, op.payload_bytes,
            dist.get_process_group_ranks(op.group)
            if op.group is not None else "world"]


def _digest(t):
    """SHA-256 of ``t``'s bytes: equal digests, bitwise equal tensors."""
    import hashlib

    import torch

    return hashlib.sha256(t.detach().contiguous().view(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()


def lmp_ep_drive(rank, out_dir, calls, res, fail):
    """(a) on this rank: ``moe_block`` under ``use_mesh`` at float32 and
    bf16, unprotected and protected, and one SEU; each call's collectives,
    ft_matmul launches, host ms and y's digest; rank 0 saves its y's."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.ft import FTPolicy
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.kernels.trace_age import PRIMER, prime
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.layers import FTContext
    from repro_torch.parallel import sharding

    dev = torch.device(LMP_DEVICE)
    cfg = lmp_moe_cfg()
    mesh = make_host_mesh(*LMP_EP_MESH, device=LMP_DEVICE)
    e_loc = cfg.num_experts // LMP_EP_MESH[1]
    m = mesh.get_local_rank("model")
    try:
        params, x = lmp_moe_inputs(cfg, dev)
        params.update(lmp_experts(cfg, m * e_loc, (m + 1) * e_loc, dev))
        torch.cuda.synchronize()
        built = torch.ones(1)
    except torch.OutOfMemoryError:
        built = torch.zeros(1)
    # every rank learns whether all four hold their experts, so that a
    # failed allocation fails them all rather than leaving three in the
    # combine's all-reduce
    dist.all_reduce(built, op=dist.ReduceOp.MIN)
    if not built.item():
        raise RuntimeError("phase 14 (a): a rank could not allocate its "
                           "experts")
    res["ep_weight_bytes"] = sum(params[k].numel() * 4
                                 for k in ("wi_gate", "wi_up", "wo"))
    buffer_bytes = e_loc * LMP_EP_CAP * cfg.d_model * 2   # bf16, the least
    rows = {}
    for dtype in ("float32", "bfloat16"):
        for ft_on in (False, True, "seu"):
            tag = f"{dtype}/{'seu' if ft_on == 'seu' else 'ft' if ft_on else 'plain'}"
            ft = (FTContext(FTPolicy(protect_linears=True,
                                     threshold=LMP_FT_THRESHOLD),
                            inject=torch.tensor(LMP_EP_SEU)
                            if ft_on == "seu" else None)
                  if ft_on else None)
            xd = x.to(getattr(torch, dtype))
            dist.barrier()
            torch.cuda.synchronize()
            before = ft_matmul.launches
            del calls[:]
            t0 = time.perf_counter()
            with torch.no_grad(), sharding.use_mesh(mesh):
                y, aux = moe.moe_block(params, xd, cfg, ft=ft)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            row = {"host_ms": ms, "launches": ft_matmul.launches - before,
                   "calls": [_op_row(op) for op in calls],
                   "aux": float(aux),
                   "digest": _digest(y), "finite":
                       bool(torch.isfinite(y).all())}
            if ft is not None:
                row.update({k: float(v) for k, v in ft.summary().items()})
            big = [_op_row(op) for op in calls if op.payload_bytes > 64]
            want = [["all-reduce", y.numel() * y.element_size(),
                     list(range(4))]]
            if big != want or any(op.payload_bytes >= buffer_bytes
                                  for op in calls):
                fail(f"phase 14 (a) {tag}: collectives {row['calls']}, "
                     f"want one "
                     f"{want[0]} and scalars")
            if row["launches"] != (3 if ft_on else 0):
                fail(f"phase 14 (a) {tag}: {row['launches']} ft_matmul "
                     f"launches")
            if ft_on is True and row["ft_flagged"] != 0:
                fail(f"phase 14 (a) {tag}: clean call flagged {row}")
            if ft_on == "seu" and (row["ft_flagged"] != 1
                                   or row["ft_corrected"] != 1):
                fail(f"phase 14 (a) {tag}: the SEU gave {row}")
            if ft_on == "seu":
                clean = rows[f"{dtype}/ft"]["y"]
                err = ((y.float() - clean).abs().max()
                       / clean.abs().max()).item()
                row["err_vs_clean"] = err
                if err > LMP_EP_TOL[dtype]:
                    fail(f"phase 14 (a) {tag}: y {err:.3e} x max off the "
                         f"clean protected call")
            if rank == 0 and ft_on != "seu":
                torch.save(y.float().cpu(), os.path.join(
                    out_dir, f"lmp-y-{tag.replace('/', '-')}.pt"))
            row["y"] = y.float() if ft_on is True else None
            rows[tag] = row
    for row in rows.values():
        row.pop("y")
    # device ms of one unprotected float32 call's kernels, primed trace
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prime()
        with torch.no_grad(), sharding.use_mesh(mesh):
            moe.moe_block(params, x, cfg)
        torch.cuda.synchronize()
    kern = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and PRIMER not in e.name]
    gemm = [ms for n, ms in kern if "gemm" in n.lower() or "xmma" in n
            or "cutlass" in n.lower() or "sm90" in n]
    res["ep_trace"] = {"kernels": len(kern),
                       "device_ms": sum(ms for _, ms in kern),
                       "gemm_kernels": len(gemm), "gemm_device_ms": sum(gemm),
                       "bound_ms": res["ep_weight_bytes"] / HBM_BYTES_PER_S
                       * 1e3}
    res["ep"] = rows
    res["ep_peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, x
    torch.cuda.empty_cache()


def lmp_train_drive(rank, out_dir, calls, res, fail):
    """(b) on this rank: LMP_TRAIN_STEPS sharded steps of the cut Gemma-3
    1B, its shards, launches and collectives a step, the first step's
    ``ft_matmul`` launches (M = the rank's 1024 rows) each held to the
    plain version; rank 0 saves the gathered params; then
    ``compress_allreduce_mean`` on one step's gradients over the data
    group against the exact mean."""
    import torch
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import compress_allreduce_mean, sharding
    from repro_torch.train import loop
    from repro_torch.tree import leaves, leaves_with_path, tree_map

    dev = torch.device(LMP_DEVICE)
    model, run = lmp_train_setup()
    mesh = make_host_mesh(*LMP_TRAIN_MESH, device=LMP_DEVICE)
    full = lmp_train_params(model, dev)
    specs = sharding.param_specs(full, mesh, fsdp=run.parallel.fsdp)
    params = tree_map(lambda t: t.contiguous().clone(),
                      sharding.shard_tree(full, specs, mesh))
    flat = dict(sharding.flat_specs(specs))
    want = {path: sharding.shard_shape(tuple(t.shape), flat[path], mesh)
            for path, t in leaves_with_path(full)}
    del full
    torch.cuda.empty_cache()
    state = optim.init_state(params)
    res["train_shard_bytes"] = sum(p.numel() * 4 for p in leaves(params))
    res["train_want_bytes"] = sum(math.prod(s) * 4 for s in want.values())
    res["train_shapes_ok"] = all(
        tuple(p.shape) == want[path] == tuple(mu.shape) == tuple(nu.shape)
        for (path, p), mu, nu in zip(leaves_with_path(params),
                                     leaves(state.mu), leaves(state.nu)))
    if not res["train_shapes_ok"] or \
            res["train_shard_bytes"] != res["train_want_bytes"]:
        fail(f"phase 14 (b): the rank's shards are not param_specs' "
             f"({res['train_shard_bytes']} bytes, want "
             f"{res['train_want_bytes']})")
    step_fn = loop.make_train_step(model, run, mesh)
    steps = []
    for s in range(LMP_TRAIN_STEPS):
        batch = lmp_train_batch(dev, s)
        dist.barrier()
        torch.cuda.synchronize()
        before = ft_matmul.launches
        del calls[:]
        held = _ftmm_held_to_plain() if s == 0 else contextlib.nullcontext()
        t0 = time.perf_counter()
        with held as rec:
            params, state, m = step_fn(params, state, batch,
                                       LMP_TRAIN_FIRST_STEP + s)
        torch.cuda.synchronize()
        steps.append({"host_ms": (time.perf_counter() - t0) * 1e3,
                      "launches": ft_matmul.launches - before,
                      "calls": [_op_row(op) for op in calls],
                      "metrics": {k: float(v) for k, v in m.items()}})
        if rec is not None:
            rec["shapes"] = sorted(rec["shapes"])
            res["train_held"] = rec
            if rec["launches"] != steps[-1]["launches"] or rec["worst"] > 1 \
                    or {sh[0] for sh in rec["shapes"]} != {
                        LMP_TRAIN_BATCH[0] // LMP_TRAIN_MESH[0]
                        * LMP_TRAIN_BATCH[1]}:
                fail(f"phase 14 (b): the first step's ft_matmul launches "
                     f"against the plain version: {rec}")
    res["train_steps"] = steps
    res["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    whole = sharding.gather_tree(params, specs, mesh)
    if rank == 0:
        torch.save({"/".join(p): t.cpu() for p, t in
                    leaves_with_path(whole)},
                   os.path.join(out_dir, "lmp-params.pt"))
    # the compressed mean on one step's gradients over the data group
    batch = lmp_train_batch(dev, 0)
    bspecs = sharding.batch_specs(batch, mesh)
    local = {k: sharding.shard_leaf(v, bspecs[k], mesh)
             for k, v in batch.items()}
    with sharding.use_mesh(mesh):
        _, grads = loop._value_and_grad(
            model, whole, local, block_q=run.parallel.attn_block_q,
            remat=run.parallel.remat)
    del whole
    # leaf by leaf (the protocol is a leaf's), so that four ranks' float32
    # and int32 copies of one leaf at a time are alive on the card
    worst, rmax, ms = 0.0, 0.0, 0.0
    for g in leaves(grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, resid = compress_allreduce_mean(
            {"g": g}, {"g": torch.zeros_like(g)}, mesh, ("data",))
        torch.cuda.synchronize()
        ms += (time.perf_counter() - t0) * 1e3
        exact = sharding.all_reduce_over(g.clone(), mesh, ("data",)) / 2
        scale = exact.abs().max().item()
        if scale > 0:
            worst = max(worst, (mean["g"] - exact).abs().max().item() / scale)
        rmax = max(rmax, resid["g"].abs().max().item())
        del mean, resid, exact
    res["compress_host_ms"] = ms
    res["compress"] = {"max_rel_err": worst, "residual_max": rmax}
    if not (worst < LMP_COMPRESS_TOL and rmax > 0):
        fail(f"phase 14 (b) compress_allreduce_mean: {res['compress']}")


@contextlib.contextmanager
def _ftmm_held_to_plain():
    """Every ``ft_matmul`` launch inside the block is held to
    ``ft_matmul_plain`` on the same operands (each part to GEMM_TOL x
    max|plain|, a bf16 X's product to BF16_STEP): yields ``{"launches",
    "worst", "shapes"}``, the launches held, the largest error over its
    tolerance and the (M, K, N) seen. The kernel's own launch is the main
    path's, counted on ``ft_matmul.launches``; the plain version adds
    none."""
    import torch
    from repro_torch.kernels import ft_matmul as ftk

    launch = ftk._launch
    rec = {"launches": 0, "worst": 0.0, "shapes": set()}

    def checked(x, w, inject, tm, tn):
        got = launch(x, w, inject, tm, tn)
        want = ftk.ft_matmul_plain(x, w, inject=inject)
        for part in ("c", "out2", "pred2", "out3", "pred3"):
            g = getattr(got, part).float()
            r = getattr(want, part).float()
            step = BF16_STEP if (part == "c"
                                 and x.dtype == torch.bfloat16) else GEMM_TOL
            err = (g - r).abs().max().item()
            tol = step * r.abs().max().item()
            rec["worst"] = max(rec["worst"], err / tol if tol > 0
                               else (0.0 if err == 0 else math.inf))
        rec["launches"] += 1
        rec["shapes"].add((x.shape[0], x.shape[1], w.shape[1]))
        return got

    ftk._launch = checked
    try:
        yield rec
    finally:
        ftk._launch = launch


def lmp_train_setup():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, RunConfig
    from repro_torch.models import Model

    base = get_config(LMP_TRAIN_ARCH)
    check((base.d_model, base.num_heads, base.num_kv_heads, base.d_ff,
           base.vocab_size) == (1152, 4, 1, 6912, TRAIN_VOCAB),
          f"phase 14: {base.name} is not Gemma-3 1B's published widths")
    cfg = dataclasses.replace(
        base, num_layers=LMP_TRAIN_LAYERS, dtype="float32",
        ft=dataclasses.replace(base.ft, protect_linears=True,
                               threshold=LMP_FT_THRESHOLD))
    run = RunConfig(model=cfg, parallel=ParallelConfig(remat="none"),
                    learning_rate=TRAIN_LR, warmup_steps=1, total_steps=20)
    return Model(cfg), run


def lmp_train_params(model, dev):
    import torch

    return model.init(torch.Generator(device=dev).manual_seed(SEED + 14),
                      device=dev)


def lmp_train_batch(dev, step):
    import torch
    from repro_torch.data import TokenPipeline

    b, t = LMP_TRAIN_BATCH
    pipe = TokenPipeline(seed=14, batch=b, seq_len=t,
                         vocab_size=TRAIN_VOCAB)
    return {k: torch.from_numpy(v).to(dev) for k, v in pipe(step).items()}


def lmp_pipe_drive(rank, out_dir, calls, res, fail):
    """(c) on this rank: ``pipeline_apply`` of tanh(x @ w) over the four
    ranks as stages against the sequential product, its hops; then the
    stage weights and their AdamW state sharded on a 4 x 1 mesh, saved by
    ``save_sharded`` and restored by ``elastic_restore`` onto 2 x 1."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import optim
    from repro_torch.launch.elastic import elastic_restore, save_sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import pipeline_apply, sharding
    from repro_torch.tree import leaves, tree_map

    dev = torch.device(LMP_DEVICE)
    width, micro, rows_n = LMP_PIPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 1400)
    ws = torch.randn((4, width, width), generator=gen, device=dev) \
        * width ** -0.5
    x = torch.randn((micro, rows_n, width), generator=gen, device=dev)
    stage = DeviceMesh(LMP_DEVICE, torch.arange(4), mesh_dim_names=("stage",))
    dist.barrier()
    del calls[:]
    t0 = time.perf_counter()
    out = pipeline_apply(lambda w, v: torch.tanh(v @ w), ws[rank], x, stage)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    hops = [op.payload_bytes for op in calls if op.kind == "all-to-all"]
    seq = x
    for i in range(4):
        seq = torch.tanh(seq @ ws[i])
    err = (out - seq).abs().max().item()
    res["pipe"] = {"host_ms": ms, "err": err, "hops": len(hops),
                   "hop_bytes": hops[0] if hops else 0,
                   "calls": len(calls)}
    if err > LMP_PIPE_TOL or len(hops) != 4 + micro - 1 or any(
            nbytes != rows_n * width * 4 for nbytes in hops):
        fail(f"phase 14 (c) pipeline_apply: {res['pipe']}")
    # elastic: the stage weights sharded on 4 x 1, restored onto 2 x 1
    big = make_host_mesh(4, 1, device=LMP_DEVICE)
    small = make_host_mesh(2, 1, device=LMP_DEVICE)
    params = {"pipe": {"w": ws}}
    specs = sharding.param_specs(params, big)
    shards = tree_map(lambda t: t.contiguous().clone(),
                      sharding.shard_tree(params, specs, big))
    st = optim.init_state(shards)
    st.step.fill_(3)
    for m_, v in zip(leaves(st.mu), leaves(st.nu)):
        m_.normal_(generator=gen)
        v.uniform_(generator=gen)
    ckpt = os.path.join(out_dir, "lmp-ckpt")
    save_sharded(ckpt, 3, (shards, st), specs, big)
    mu_whole = sharding.gather_tree(st.mu, specs, big)
    dist.barrier()
    if rank < 2:
        template = (tree_map(torch.zeros_like, params),
                    optim.init_state(params))
        (rp, ro), meta = elastic_restore(ckpt, template, small)
        nspecs = sharding.param_specs(params, small)
        want_p = sharding.shard_tree(params, nspecs, small)
        want_mu = sharding.shard_tree(mu_whole, nspecs, small)
        ok = (meta["step"] == 3 and int(ro.step) == 3
              and all(torch.equal(a, b) for a, b in
                      zip(leaves(rp), leaves(want_p)))
              and all(torch.equal(a, b) for a, b in
                      zip(leaves(ro.mu), leaves(want_mu)))
              and tuple(rp["pipe"]["w"].shape) == (4, width // 2, width))
        res["elastic"] = {"ok": ok, "shape": list(rp["pipe"]["w"].shape)}
        if not ok:
            fail(f"phase 14 (c) elastic_restore onto 2 x 1: {res['elastic']}")
    dist.barrier()


def lmp_rank(rank, out_dir, trace):
    """Phase 14 on one of phase 13's four ranks, its collectives recorded
    (``repro_torch.analysis.record``: each drive empties and reads the
    list of ``CollectiveOp`` records it is given); its record."""
    import torch

    from repro_torch.analysis.record import record
    from repro_torch.kernels.ft_matmul import ft_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"rank": rank, "failures": []}
    if LMP_DEVICE == "cuda":
        res["free_bytes_at_start"], _ = torch.cuda.mem_get_info()
        res["allocated_at_start"] = torch.cuda.memory_allocated()
        print(f"phase 14: {res['free_bytes_at_start'] / 1e9:.2f} GB free on "
              f"the card, {res['allocated_at_start'] / 1e9:.2f} GB held here",
              file=trace, flush=True)
    torch.cuda.reset_peak_memory_stats()
    ft_matmul.launches = 0
    t0 = time.perf_counter()
    with record() as calls:
        for part in (lmp_ep_drive, lmp_train_drive, lmp_pipe_drive):
            print(f"{time.perf_counter():.3f} phase 14 {part.__name__}",
                  file=trace, flush=True)
            t1 = time.perf_counter()
            part(rank, out_dir, calls, res, res["failures"].append)
            res[f"{part.__name__}_seconds"] = time.perf_counter() - t1
    res["launches"] = ft_matmul.launches
    res["seconds"] = time.perf_counter() - t0
    return res


def _lmp_want_collectives(model, run, mesh_shape_):
    """A sharded step's collectives on one rank of ``make_host_mesh(
    *LMP_TRAIN_MESH)``, as the design gives them: one all-gather a param
    leaf's sharded dim and axis of size > 1 (its output the gathered
    size); one all-reduce a gradient leaf over data (the leaf whole), and
    two of the metrics (5 sums, the score); three broadcasts over model
    (the norm's per-leaf sums, the metrics, the score)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel import sharding
    from repro_torch.tree import leaves_with_path

    mesh = AbstractMesh(mesh_shape_, ("data", "model"))
    meta = model.init(None, device="meta")
    flat = dict(sharding.flat_specs(sharding.param_specs(
        meta, mesh, fsdp=run.parallel.fsdp)))
    gathers, gather_bytes, leaves_n, whole = 0, 0, 0, 0
    for path, leaf in leaves_with_path(meta):
        shape = list(sharding.shard_shape(tuple(leaf.shape), flat[path],
                                          mesh))
        for dim, e in enumerate(flat[path]):
            for a in reversed(sharding.spec_axes(e)):
                if mesh.shape[a] > 1:
                    shape[dim] *= mesh.shape[a]
                    gathers += 1
                    gather_bytes += math.prod(shape) * 4
        leaves_n += 1
        whole += leaf.numel() * 4
    return {"all-gather": [gathers, gather_bytes],
            "all-reduce": [leaves_n + 2, whole + 5 * 4 + 4],
            "broadcast": [3, 4 * leaves_n + 5 * 4 + 4]}


def lmp_phase(dev, out_dir, ranks, smi):
    """Phase 14's checks in this process after the ranks exit: (a) EP's y
    against ``_moe_block_portable`` on all 256 experts rebuilt from their
    seeds, every rank's y bitwise equal; (b) the sharded step's losses and
    gathered params against the one-rank step on the full batch, its
    launches and collectives a step; (c) the pipeline and elastic rows.
    Returns the phase's record."""
    import torch

    from repro_torch.models import moe
    from repro_torch.tree import leaves_with_path, tree_map

    t0 = time.perf_counter()
    for res in ranks:
        for msg in res["failures"]:
            log(f"phase 14 rank {res['rank']}: {msg}")
    check(all(not res["failures"] for res in ranks),
          "phase 14: a rank failed (above)")
    rec = {"rank_seconds": [res["seconds"] for res in ranks],
           "launches": sum(res["launches"] for res in ranks)}
    # (a)
    cfg = lmp_moe_cfg()
    params, x = lmp_moe_inputs(cfg, dev)
    params.update(lmp_experts(cfg, 0, cfg.num_experts, dev))
    torch.cuda.synchronize()
    ep = {}
    for dtype in ("float32", "bfloat16"):
        xd = x.to(getattr(torch, dtype))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            want, aux = moe._moe_block_portable(params, xd, cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        want = want.float()
        for prot in ("plain", "ft"):
            tag = f"{dtype}/{prot}"
            got = torch.load(os.path.join(
                out_dir, f"lmp-y-{dtype}-{prot}.pt")).to(dev)
            err = ((got - want).abs().max() / want.abs().max()).item()
            digests = {res["ep"][tag]["digest"] for res in ranks}
            rows = [res["ep"][tag] for res in ranks]
            ep[tag] = {"err_vs_portable": err, "bitwise_ranks":
                       len(digests) == 1, "aux": rows[0]["aux"],
                       "aux_portable": float(aux), "plain_ms": plain_ms,
                       "host_ms": [r["host_ms"] for r in rows],
                       "launches": [r["launches"] for r in rows],
                       "seu": [[ranks[i]["ep"][f"{dtype}/seu"][k]
                                for k in ("ft_flagged", "ft_corrected",
                                          "err_vs_clean")]
                               for i in range(len(ranks))]}
            check(err <= LMP_EP_TOL[dtype] and len(digests) == 1
                  and all(r["finite"] for r in rows)
                  and abs(rows[0]["aux"] - float(aux))
                  <= 1e-5 * abs(float(aux)),
                  f"phase 14 (a) {tag}: y {err:.3e} x max off the portable "
                  f"path (tolerance {LMP_EP_TOL[dtype]}), {len(digests)} "
                  f"distinct y's over the ranks, aux {rows[0]['aux']} vs "
                  f"{float(aux)}")
            log(f"phase 14 (a) EP {tag}: y within {err:.3e} x max of the "
                f"portable path over all 256 experts, the four ranks' y "
                f"bitwise equal, aux {rows[0]['aux']:.6f} (portable "
                f"{float(aux):.6f}); host ms a call a rank "
                f"{[round(v, 1) for v in ep[tag]['host_ms']]} (portable in "
                f"this process {plain_ms:.1f}); ft_matmul launches "
                f"{ep[tag]['launches']}; SEU (flagged, corrected, err vs "
                f"clean) {ep[tag]['seu'] if prot == 'ft' else '-'}")
    tr = ranks[0]["ep_trace"]
    rec["ep"] = ep
    rec["ep_trace"] = [res["ep_trace"] for res in ranks]
    rec["ep_peak_bytes"] = [res["ep_peak_bytes"] for res in ranks]
    log(f"phase 14 (a) traced unprotected float32 call, rank 0: "
        f"{tr['kernels']} kernels, {tr['device_ms']:.3f} device ms, "
        f"{tr['gemm_kernels']} GEMM kernels {tr['gemm_device_ms']:.3f} ms "
        f"against the experts' byte bound {tr['bound_ms']:.3f} ms "
        f"({ranks[0]['ep_weight_bytes'] / 1e9:.2f} GB a rank at 3.35 TB/s; "
        f"four ranks share the card); GEMM device ms a rank "
        f"{[round(r['gemm_device_ms'], 3) for r in rec['ep_trace']]}; peak "
        f"GB a rank {[round(b / 1e9, 2) for b in rec['ep_peak_bytes']]} "
        f"({smi})")
    del params, x, xd, want, got
    torch.cuda.empty_cache()
    # (b)
    model, run = lmp_train_setup()
    from repro_torch import optim
    from repro_torch.train import loop

    def one_rank(p):
        st = optim.init_state(p)
        step = loop.make_train_step(model, run)
        ms = []
        for s in range(LMP_TRAIN_STEPS):
            p, st, m = step(p, st, lmp_train_batch(dev, s),
                            LMP_TRAIN_FIRST_STEP + s)
            ms.append({k: float(v) for k, v in m.items()})
        return p, ms

    p1, ms1 = one_rank(lmp_train_params(model, dev))
    up = tree_map(lambda t: torch.nextafter(t, torch.full_like(
        t, math.inf)), lmp_train_params(model, dev))
    pu, _ = one_rank(up)
    del up
    drift = max((a - b).abs().max().item() for (_, a), (_, b) in
                zip(leaves_with_path(pu), leaves_with_path(p1)))
    del pu
    got = torch.load(os.path.join(out_dir, "lmp-params.pt"))
    perr = max((got["/".join(p)].to(dev) - t).abs().max().item()
               for p, t in leaves_with_path(p1))
    tol = max(LMP_PARAM_TOL, LMP_WITNESS_FACTOR * drift)
    steps0 = ranks[0]["train_steps"]
    same = all(res["train_steps"][s]["metrics"] == steps0[s]["metrics"]
               for res in ranks for s in range(LMP_TRAIN_STEPS))
    # loss, ce and the clip norm of the whole mean gradient, every step
    merr = {k: max(abs(steps0[s]["metrics"][k] - ms1[s][k]) / abs(ms1[s][k])
                   for s in range(LMP_TRAIN_STEPS))
            for k in ("loss", "ce", "grad_norm")}
    lerr = max(merr.values())
    want_calls = _lmp_want_collectives(model, run, LMP_TRAIN_MESH)
    launches = [[st["launches"] for st in res["train_steps"]]
                for res in ranks]
    sites = LMP_TRAIN_SITES * LMP_TRAIN_LAYERS
    coll = []
    for res in ranks:
        for st in res["train_steps"]:
            got_calls = {}
            for kind, nbytes, _ in st["calls"]:
                c = got_calls.setdefault(kind, [0, 0])
                c[0] += 1
                c[1] += nbytes
            coll.append(got_calls)
    rec["train"] = {
        "metric_rel_err": merr, "param_err": perr, "param_tol": tol,
        "held_to_plain": [res.get("train_held") for res in ranks],
        "witness_drift": drift, "metrics_equal": same,
        "launches": launches, "collectives": coll[0],
        "want_collectives": want_calls,
        "host_ms": [[st["host_ms"] for st in res["train_steps"]]
                    for res in ranks],
        "metrics": [st["metrics"] for st in steps0],
        "one_rank_metrics": ms1,
        "shard_bytes": [res["train_shard_bytes"] for res in ranks],
        "peak_bytes": [res["train_peak_bytes"] for res in ranks],
        "compress": [res["compress"] for res in ranks],
        "compress_host_ms": [res["compress_host_ms"] for res in ranks],
        "reduced": LMP_REDUCED}
    check(lerr <= LMP_LOSS_TOL and perr <= tol and same,
          f"phase 14 (b): loss, ce, grad_norm {merr} relative, params "
          f"{perr:.3e} "
          f"(tolerance {tol:.3e}), metrics equal on every rank {same}")
    check(all(n == sites for row in launches for n in row),
          f"phase 14 (b): ft_matmul launches a step a rank {launches}, not "
          f"{sites}")
    check(all(c == want_calls for c in coll),
          f"phase 14 (b): collectives a step {coll[0]}, want {want_calls}")
    held = rec["train"]["held_to_plain"]
    log(f"phase 14 (b) sharded step, {LMP_REDUCED}: losses "
        f"{[round(st['metrics']['loss'], 6) for st in steps0]}, gradient "
        f"norms {[round(st['metrics']['grad_norm'], 6) for st in steps0]}; "
        f"loss, ce, grad_norm within {merr} of the one-rank step's; the "
        f"first step's ft_matmul launches held to the plain version "
        f"{[h['launches'] for h in held]} a rank, worst "
        f"{max(h['worst'] for h in held):.3f} of tolerance at "
        f"{held[0]['shapes']}; gathered params within "
        f"{perr:.3e} (tolerance {tol:.3e}: the one-rank step's own one-ulp "
        f"drift {drift:.3e}), metrics equal on every rank; shard bytes a "
        f"rank {rec['train']['shard_bytes']}; ft_matmul launches a step a "
        f"rank {launches}; collectives a step (calls, bytes) {coll[0]}; "
        f"host ms a step {rec['train']['host_ms']}; peak GB "
        f"{[round(b / 1e9, 2) for b in rec['train']['peak_bytes']]}; "
        f"compress_allreduce_mean on a step's gradients over data: "
        f"{rec['train']['compress']} in "
        f"{[round(v) for v in rec['train']['compress_host_ms']]} host ms "
        f"({smi})")
    del p1, got
    torch.cuda.empty_cache()
    # (c)
    rec["pipe"] = [res["pipe"] for res in ranks]
    rec["elastic"] = [res.get("elastic") for res in ranks[:2]]
    log(f"phase 14 (c) pipeline_apply over 4 stages, {LMP_PIPE[1]} "
        f"microbatches of {LMP_PIPE[2]} x {LMP_PIPE[0]}: max err "
        f"{max(r['err'] for r in rec['pipe']):.3e} against the sequential "
        f"product, {rec['pipe'][0]['hops']} hops of "
        f"{rec['pipe'][0]['hop_bytes']} bytes, host ms a rank "
        f"{[round(r['host_ms'], 1) for r in rec['pipe']]}; elastic_restore "
        f"onto 2 x 1: {rec['elastic']}")
    rec["parent_seconds"] = time.perf_counter() - t0
    return rec


def analysis_start():
    """``python -m repro_torch.analysis --strict --min-specs 84`` started in
    the background: the repo lint and the plan audit over the 84-spec
    lattice on a fake process group of 8 ranks, on the CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "--min-specs", str(ANALYSIS_SPECS)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def analysis_finish(proc, t0):
    """Wait for ``analysis_start``'s process: it must exit 0 with the
    reference's summary lines, no new lint finding and no audit
    finding."""
    try:
        text, _ = proc.communicate(timeout=ANALYSIS_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        text, _ = proc.communicate()
    lines = text.strip().splitlines()
    for line in lines[-2:]:
        log(f"analysis: {line}")
    check(proc.returncode == 0 and any(
        ln.startswith(f"audit: {ANALYSIS_SPECS} specs") and
        ln.endswith(", 0 finding(s)") for ln in lines),
          f"python -m repro_torch.analysis --strict: exit {proc.returncode}"
          f"\n{text[-3000:]}")
    log(f"analysis: exit 0 ({time.perf_counter() - t0:.1f} s after its "
        f"start)")


def cuda_ms(fn, iters=20, warmup=3):
    """Device ms a call of ``fn``: CUDA events around ``iters`` calls after
    ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=20):
    """Host time per call of ``fn``: the Python dispatch and the
    launches, without waiting for the device (the queue stays short)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def device_kernels(fn, want=None, attempts=3):
    """(name, device ms) of every CUDA kernel one call of ``fn`` runs,
    from torch.profiler after a warm-up call. Each trace starts with
    ``trace_age.prime`` (left out of the kernels): in a process that
    has run for a while the tracer drops the first kernels of a trace
    (ROADMAP queue 3). With ``want``, up to ``attempts`` calls are
    traced until one shows ``want`` kernels (the tracer can drop an
    event; an extra kernel shows every time)."""
    import torch

    from repro_torch.kernels.trace_age import PRIMER, prime

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            prime()
            fn()
            torch.cuda.synchronize()
        kern = [(e.name, e.time_range.elapsed_us() / 1e3)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and PRIMER not in e.name]
        if want is None or len(kern) == want:
            break
        log(f"torch.profiler traced {len(kern)} kernels, not {want}: "
            f"{[k for k, _ in kern]}")
    return kern


def trace_call(fn, want, attempts=3, split=None):
    """One call of ``fn`` under torch.profiler after a warm-up:
    ``(kernels, window_ms, idle)``: its CUDA kernels as (name, device
    ms) in launch order, the window from the call's start on the host
    to its last kernel's end, and the share of that window in which no
    kernel ran. ``want(names)`` says whether a trace is whole (the
    tracer can drop an event); up to ``attempts`` calls are traced,
    each after ``trace_age.prime``. With ``split``, a fourth element:
    ``split(events, mark)`` of the trace's events and the call's
    ``record_function`` event."""
    import torch

    from repro_torch.kernels.trace_age import PRIMER, prime

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda_dev = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            prime()
            with torch.profiler.record_function("traced_call"):
                fn()
            torch.cuda.synchronize()
        evs = prof.events()
        mark = [e for e in evs if e.name == "traced_call"
                and e.device_type != cuda_dev]
        kern = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in evs if e.device_type == cuda_dev
                      and e.name != "traced_call"
                      and PRIMER not in e.name)
        if mark and kern and want([k for _, _, k in kern]):
            break
        log(f"torch.profiler trace incomplete: {[k for _, _, k in kern]}")
    t0 = mark[0].time_range.start
    t1 = max(mark[0].time_range.end, kern[-1][1])
    busy, lo, hi = 0.0, kern[0][0], kern[0][1]
    for a, b_, _ in kern[1:]:           # the union of the kernels' spans
        if a > hi:
            busy += hi - lo
            lo, hi = a, b_
        else:
            hi = max(hi, b_)
    busy += hi - lo
    out = ([(k, (b_ - a) / 1e3) for a, b_, k in kern], (t1 - t0) / 1e3,
           1.0 - busy / (t1 - t0))
    return out if split is None else out + (split(evs, mark[0]),)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.core.fft import FFTSpec, FTConfig, plan
    from repro_torch.core.fft.plan import axis_layout, pass_layouts
    from repro_torch.core.ft import poisson_schedule
    from repro_torch.kernels import _build
    from repro_torch.kernels import ft_matmul as ftmm
    from repro_torch.kernels.ft_matmul import ft_matmul
    from repro_torch.kernels.stockham import (_tile_signals, block_fft,
                                              block_fft_plain)
    from repro_torch.kernels.stockham_abft import (abft_fft, abft_fft_plain,
                                                   launch_geometry,
                                                   max_active_clusters)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} x{count} | {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build every kernel from the checkout's sources, while
    # the static analysis (lint + plan audit, host-only, on this machine's
    # torch and its fake process group) runs beside in a process of its own
    t0 = time.perf_counter()
    analysis = analysis_start()
    try:
        times = _build.build()
    except BaseException:
        analysis.kill()
        analysis.wait()
        raise
    log(f"nvcc: {json.dumps({k: round(v, 1) for k, v in times.items()})} "
        f"({time.perf_counter() - t0:.1f} s wall)")
    analysis_finish(analysis, t0)
    build_log = _build.library_path("block_fft").with_suffix(".log")
    for line in build_log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas block_fft: {line.strip()}")
    # every abft_fft_kernel instance; the fast (register-codelet) ones must
    # not spill
    abft_instances = abft_ptxas(_build.library_path("abft_fft")
                                .with_suffix(".log").read_text())
    for row in abft_instances:
        spill = row["spill_stores"] + row["spill_loads"]
        log(f"  ptxas abft_fft_kernel<{row['dtype']}, "
            f"{'fast' if row['fast'] else 'generic'}>: {row['registers']} "
            f"registers, {spill} spill bytes, stack {row['stack']}")
        check(not row["fast"] or spill == 0,
              f"abft_fft_kernel {row}: a fast instance spills")
    check(len(abft_instances) == 4,
          f"{len(abft_instances)} abft_fft_kernel instances in the build log")
    # every ft_matmul_tile instance: registers and spill bytes (ptxas) and
    # the CTAs an SM runs (occupancy query); no spills, and two CTAs a SM
    # of the float32 128 x 128 instance
    ftmm_instances = []
    build_log = _build.library_path("ft_matmul").with_suffix(".log")
    for row in ft_matmul_ptxas(build_log.read_text()):
        blocks = ftmm.blocks_per_sm(getattr(torch, row["x"]),
                                    getattr(torch, row["w"]), *row["tile"],
                                    dev)
        spill = row["spill_stores"] + row["spill_loads"]
        ftmm_instances.append(dict(row, blocks_per_sm=blocks))
        log(f"  ptxas ft_matmul_tile<{row['x']}, {row['w']}, "
            f"{row['tile'][0]}x{row['tile'][1]}>: {row['registers']} "
            f"registers, {spill} spill bytes, stack {row['stack']}; "
            f"{blocks} blocks per SM")
        check(spill == 0, f"ft_matmul_tile {row}: spills")
        if row["x"] == row["w"] == "float32" and row["tile"] == [128, 128]:
            check(blocks >= 2, f"ft_matmul_tile {row}: {blocks} per SM")
    check(len(ftmm_instances) == 16,
          f"{len(ftmm_instances)} ft_matmul_tile instances in the build log")

    gen = torch.Generator(device=dev)

    def randn(shape, dtype_name):
        gen.manual_seed(SEED + sum(shape))
        return torch.randn(shape, dtype=getattr(torch, dtype_name),
                           device=dev, generator=gen)

    def max_err(got, want):
        return (got - want).abs().max().item()

    # ---- phases 2 and 3: the FFT path, launch counts from this run only
    block_fft.launches = 0
    abft_fft.launches = 0
    ft_matmul.launches = 0
    path_rows = []
    per_call = {"block_fft": {}, "abft_fft": {}}   # launches of one call

    def count_call(label, fn):
        before = (block_fft.launches, abft_fft.launches)
        out = fn()
        per_call["block_fft"][label] = block_fft.launches - before[0]
        per_call["abft_fft"][label] = abft_fft.launches - before[1]
        return out

    for dtype, logn, b in FFT_CASES:
        n = 1 << logn
        x = randn((b, n), dtype)
        p = plan(FFTSpec(shape=(b, n), dtype=dtype))
        label = f"plan.fft {dtype} 2^{logn}x{b}"
        y = count_call(label, lambda: p.fft(x))
        check(per_call["block_fft"][label] == p.local_plan.num_passes,
              f"{label}: {per_call['block_fft'][label]} block_fft launches "
              f"for {p.local_plan.num_passes} passes")
        ref = torch.fft.fft(x)
        err, tol = max_err(y, ref), ATOL[dtype] * ref.abs().max().item()
        check(err <= tol, f"fft {dtype} N=2^{logn} B={b}: {err} > {tol}")
        del y, ref
        yi = p.ifft(x)
        ref = torch.fft.ifft(x)
        erri, toli = max_err(yi, ref), ATOL[dtype] * ref.abs().max().item()
        check(erri <= toli,
              f"ifft {dtype} N=2^{logn} B={b}: {erri} > {toli}")
        del yi, ref
        log(f"fft/ifft {dtype} N=2^{logn} B={b} passes="
            f"{p.local_plan.num_passes} ({p.local_plan.describe()}): "
            f"err {err:.3e}/{erri:.3e} tol {tol:.3e}/{toli:.3e}")
        path_rows.append((dtype, logn, b, p, x))

    seu = {"injected": 0, "detected": 0, "located": 0, "corrected": 0,
           "false_alarms": 0}
    rng = np.random.default_rng(SEED)
    for dtype, logn, b in FT_CASES:
        n = 1 << logn
        x = randn((b, n), dtype)
        p = plan(FFTSpec(shape=(b, n), dtype=dtype,
                         ft=FTConfig(transactions=FT_TRANSACTIONS)))
        ref = torch.fft.fft(x)
        tol = ATOL[dtype] * ref.abs().max().item()
        label = f"plan.ft_fft {dtype} 2^{logn}x{b}"
        res = count_call(label, lambda: p.ft_fft(x))
        check(per_call["abft_fft"][label] == 1
              and per_call["block_fft"][label] == 1,
              f"{label}: launches {per_call}")
        clean_err = max_err(res.y, ref)
        check(clean_err <= tol, f"ft_fft clean {dtype}: {clean_err} > {tol}")
        check(int(res.flagged.sum()) == 0, f"ft_fft clean {dtype}: flagged")
        bs = min(p.local_plan.bs, b)
        sched = poisson_schedule(rng, steps=SEU_STEPS, rate_per_step=0.8,
                                 tiles=b // bs, bs=bs, n=n)
        for step in range(SEU_STEPS):
            inj = sched.for_step(step)
            res = p.ft_fft(x, inject=inj)
            flagged = res.flagged.cpu().numpy()
            if float(inj[3]) > 0:
                seu["injected"] += 1
                seu["detected"] += int(flagged.sum() == 1)
                want_sig = int(inj[0]) * bs + int(inj[1])
                seu["located"] += int(flagged.sum() == 1 and int(
                    res.location.cpu().numpy()[flagged][0]) == want_sig)
                seu["corrected"] += int(res.corrected)
            else:
                seu["false_alarms"] += int(flagged.sum())
            err = max_err(res.y, ref)
            check(err <= tol, f"ft_fft {dtype} step {step}: post-correction "
                              f"error {err} > {tol}")
        log(f"ft_fft {dtype} N=2^{logn} B={b} T={FT_TRANSACTIONS} bs={bs} "
            f"G={b // (bs * FT_TRANSACTIONS)}: clean err {clean_err:.3e} tol "
            f"{tol:.3e}; schedule {sched.num_faults} faults")
        del ref, res
        path_rows.append((dtype, logn, b, p, x))
    torch.cuda.synchronize()
    launches = {"block_fft": block_fft.launches,
                "abft_fft": abft_fft.launches,
                "ft_matmul": ft_matmul.launches}
    log(f"FFT path launches per call: {json.dumps(per_call)}")
    log(f"FFT path launches, whole run: {json.dumps(launches)}; SEU "
        f"campaign {json.dumps(seu)}")
    check(launches["block_fft"] > 0 and launches["abft_fft"] > 0,
          f"a kernel of the path was never launched: {launches}")
    check(seu["injected"] > 0 and seu["injected"] == seu["detected"]
          == seu["located"] == seu["corrected"] and seu["false_alarms"] == 0,
          f"SEU campaign: {seu}")

    # ---- phases 2b and 3b: the checked-GEMM path, counts from this run only
    block_fft.launches = 0
    abft_fft.launches = 0
    ft_matmul.launches = 0
    gemm_seu = gemm_plan_phase(dev)
    mlp_seu, mlp_per_call, mlp_blocks = mlp_phase(dev)
    torch.cuda.synchronize()
    gemm_launches = {"block_fft": block_fft.launches,
                     "abft_fft": abft_fft.launches,
                     "ft_matmul": ft_matmul.launches}
    log(f"GEMM path launches, whole run: {json.dumps(gemm_launches)}")
    check(gemm_launches["ft_matmul"] > 0,
          f"a kernel of the path was never launched: {gemm_launches}")

    # ---- phases 2c and 3c: the local extensions, counts from this run only
    ext_cases = extension_cases(dev)
    block_fft.launches = 0
    abft_fft.launches = 0
    ft_matmul.launches = 0
    ext_rows = extensions_drive(ext_cases)
    ft_ifft_seu = ft_ifft_campaign(dev)
    torch.cuda.synchronize()
    ext_launches = {"block_fft": block_fft.launches,
                    "abft_fft": abft_fft.launches,
                    "ft_matmul": ft_matmul.launches}
    log(f"extensions path launches, whole run: {json.dumps(ext_launches)}")
    check(ext_launches["block_fft"] > 0 and ext_launches["abft_fft"] > 0,
          f"a kernel of the path was never launched: {ext_launches}")

    # ---- phase 4: each kernel against its plain version on the card, with
    # the plan's own stages and device tables: every pass of every FFT case
    # in its real layout and with its pass twiddle, and the checksum FFT of
    # the FT cases on its (2G, N) rows [X.e2; X.e3]
    kerr = {"block_fft": 0.0, "abft_fft": 0.0}
    kratio = {"block_fft": 0.0, "abft_fft": 0.0}   # worst err / tolerance
    for dtype, logn, b, p, _ in path_rows:
        pl = p.local_plan
        if p.spec.ft is not None:     # the checksum FFT on (G, N)
            rows = 2 * b // (min(pl.bs, b) * FT_TRANSACTIONS)
            checks = [(0, False, rows, None)]
        else:
            checks = [(i, inverse, b, lay)
                         for i, lay in enumerate(pass_layouts(
                             b, pl.kernel_factors))
                         for inverse in (False, True)]
        for i, inverse, rows, lay in checks:
            stages = pl.stages[i]
            last = i == pl.num_passes - 1
            kw = dict(inverse=inverse, tables=p.tables[inverse][i],
                      scale=1.0 / pl.n if inverse and i == 0 else 1.0,
                      layout=lay,
                      twiddle=None if last else p.twiddles[inverse][i])
            n = pl.n if lay is not None else pl.kernel_factors[i]
            x = randn((rows, n), dtype)
            got = block_fft(x, stages, out=torch.empty_like(x), **kw)
            kw.pop("tables")
            want = block_fft_plain(x, stages, out=torch.empty_like(x), **kw)
            err = max_err(got, want)
            tol = ATOL[dtype] * want.abs().max().item()
            what = (f"block_fft pass {i}/{pl.num_passes} {dtype} "
                    f"2^{logn}x{b} inverse={inverse} "
                    f"{lay if lay is not None else (rows, n)}")
            check(err <= tol, f"{what} vs plain: {err} > {tol}")
            kerr["block_fft"] = max(kerr["block_fft"], err)
            kratio["block_fft"] = max(kratio["block_fft"], err / tol)
            del got, want
            kw["tables"] = p.tables[inverse][i]
            out = torch.empty_like(x)
            ms = cuda_ms(lambda: block_fft(x, stages, out=out, **kw),
                         iters=5, warmup=1)
            gbps = 2 * x.numel() * x.element_size() / ms / 1e6
            log(f"{what}: {ms:.4f} ms, {gbps:.1f} GB/s; err {err:.3e} tol "
                f"{tol:.3e}")
            del x, out
    abft_parts = dict.fromkeys(ABFT_PARTS, 0.0)
    axis_rows = []
    for dtype, logn, b in FT_CASES:
        n = 1 << logn
        p = plan(FFTSpec(shape=(b, n), dtype=dtype,
                         ft=FTConfig(transactions=FT_TRANSACTIONS)))
        stages, bs = p.local_plan.stages[0], min(p.local_plan.bs, b)
        tables = p.tables[False][0]
        x = randn((b, n), dtype)
        inj = torch.tensor([b // bs - 1, bs - 1, n // 3, 1, 25.0, -40.0])
        for per_signal in (False, True):
            kw = dict(bs=bs, transactions=FT_TRANSACTIONS,
                      per_signal=per_signal)
            noise = None
            for inject in (None, inj):
                got = abft_fft(x, stages, inject=inject, tables=tables, **kw)
                want = abft_fft_plain(x, stages, inject=inject, **kw)
                if noise is None:     # the clean call comes first
                    noise = delta_noise(want[1])
                what = (f"abft_fft vs plain {dtype} per_signal={per_signal} "
                        f"inject={inject is not None}")
                parts = abft_vs_plain(got, want, dtype, noise, what)
                for part, (err, ratio) in parts.items():
                    abft_parts[part] = max(abft_parts[part], err)
                    kratio["abft_fft"] = max(kratio["abft_fft"], ratio)
                log(f"{what}: " + ", ".join(
                    f"{k} {e:.3e} ({r:.2f} of tol)"
                    for k, (e, r) in parts.items()))
            again = abft_fft(x, stages, inject=inj, tables=tables, **kw)
            for part, u, v in zip(("y", "delta", "cs"), got, again):
                check(torch.equal(u, v), f"abft_fft {dtype} per_signal="
                                         f"{per_signal}: two calls differ "
                                         f"in {part}")
            ms = cuda_ms(lambda: abft_fft(x, stages, tables=tables, **kw),
                         iters=5, warmup=1)
            log(f"abft_fft {dtype} ({b}, {n}) bs={bs} T={FT_TRANSACTIONS} "
                f"per_signal={per_signal}: {ms:.4f} ms")
        del x, got, want
    # block_fft in the extensions' strided column layouts, in place as the
    # path runs them: every non-last axis of the grids above (C/2+1 = 2049
    # columns: one signal a tile, the scalar path)
    for dtype, shape, axis in AXIS_LAYOUTS:
        n = shape[axis]
        lay = axis_layout(math.prod(shape[:axis]), n,
                          math.prod(shape[axis + 1:]))
        stages = plan(FFTSpec(shape=(1, n), dtype=dtype)).local_plan.stages[0]
        x = randn(shape, dtype)
        for inverse in (False, True):
            kw = dict(inverse=inverse, scale=1.0 / n if inverse else 1.0,
                      layout=lay)
            got = x.clone()
            block_fft(got, stages, out=got, **kw)
            want = block_fft_plain(x, stages, **kw)
            err = max_err(got, want)
            tol = ATOL[dtype] * want.abs().max().item()
            what = f"block_fft {dtype} {shape} axis {axis} inverse={inverse}"
            check(err <= tol, f"{what} vs plain: {err} > {tol}")
            kerr["block_fft"] = max(kerr["block_fft"], err)
            kratio["block_fft"] = max(kratio["block_fft"], err / tol)
            del got, want
        ms = cuda_ms(lambda: block_fft(x, stages, out=x, layout=lay),
                     iters=5, warmup=1)
        gbps = 2 * x.numel() * x.element_size() / ms / 1e6
        log(f"block_fft {dtype} {shape} axis {axis} {lay}: {ms:.4f} ms, "
            f"{gbps:.1f} GB/s in place (bound "
            f"{2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3:.4f}"
            f" ms); err {err:.3e} tol {tol:.3e}")
        axis_rows.append({"dtype": dtype, "shape": list(shape), "axis": axis,
                          "ms": ms, "gb_per_s": gbps,
                          "signals_per_tile": _tile_signals(n, lay)})
        del x
    kerr["abft_fft"] = max(abft_parts.values())
    log(f"kernel vs plain max abs err: {json.dumps(kerr)}; abft_fft by "
        f"part: {json.dumps(abft_parts)}; worst err/tol: "
        f"{json.dumps(kratio)}")

    # ---- phase 5: times by CUDA events at the single-pass main-path shape
    log(f"phase 5 starts {time.perf_counter() - t_start:.1f} s into the run")
    dtype, logn, b = FFT_CASES[0]
    n = 1 << logn
    x = randn((b, n), dtype)
    itemsize = x.element_size()
    p_fft = plan(FFTSpec(shape=(b, n), dtype=dtype))
    p_ft = plan(FFTSpec(shape=(b, n), dtype=dtype,
                        ft=FTConfig(transactions=FT_TRANSACTIONS)))
    stages, tables = p_ft.local_plan.stages[0], p_ft.tables[False][0]
    bs = min(p_ft.local_plan.bs, b)
    groups = b // (bs * FT_TRANSACTIONS)
    fft_bytes = 2 * b * n * itemsize
    fft_flops = 5 * n * logn * b

    def bound(nbytes, flops):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = flops / PEAK_FLOPS[dtype] * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    blk_ms = cuda_ms(lambda: block_fft(x, stages, tables=tables))
    blk_dev = [ms for _, ms in device_kernels(
        lambda: [block_fft(x, stages, tables=tables) for _ in range(10)])]
    blk_dev_ms = sum(blk_dev) / len(blk_dev)
    blk_host_ms = host_ms(lambda: block_fft(x, stages, tables=tables))
    blk_plain = cuda_ms(lambda: block_fft_plain(x, stages), iters=5)
    lib_ms = cuda_ms(lambda: torch.fft.fft(x))
    abft_kw = dict(bs=bs, transactions=FT_TRANSACTIONS, per_signal=False)
    abft_ms = cuda_ms(lambda: abft_fft(x, stages, tables=tables, **abft_kw))
    abft_plain = cuda_ms(lambda: abft_fft_plain(x, stages, **abft_kw),
                         iters=5)
    blk_bound = bound(fft_bytes, fft_flops)
    abft_bound = bound(fft_bytes + 4 * groups * n * itemsize
                       + b * itemsize // 2, fft_flops + 12 * b * n)
    path_fft_ms = cuda_ms(lambda: p_fft.fft(x))
    path_ft_ms = cuda_ms(lambda: p_ft.ft_fft(x))
    # abft_fft on the device, its launch geometry, per_signal and complex128
    abft_dev = [ms for kname, ms in device_kernels(
        lambda: [abft_fft(x, stages, tables=tables, **abft_kw)
                 for _ in range(10)]) if "abft_fft" in kname]
    abft_dev_ms = sum(abft_dev) / len(abft_dev)
    abft_geo = launch_geometry(stages, x.dtype, bs, FT_TRANSACTIONS)
    abft_clusters = max_active_clusters(abft_geo, dev)
    abft_ps_ms = cuda_ms(lambda: abft_fft(x, stages, tables=tables, bs=bs,
                                          transactions=FT_TRANSACTIONS,
                                          per_signal=True))
    x128 = randn((b, n), "complex128")
    tables128 = plan(FFTSpec(shape=(b, n), dtype="complex128",
                             ft=FTConfig(transactions=FT_TRANSACTIONS))
                     ).tables[False][0]
    abft128_ms = cuda_ms(lambda: abft_fft(x128, stages, tables=tables128,
                                          **abft_kw))
    abft128_bound = (2 * b * n + 4 * groups * n) * 16 / HBM_BYTES_PER_S \
        * 1e3 + b * 8 / HBM_BYTES_PER_S * 1e3
    del x128
    # one plan.ft_fft call under torch.profiler: one abft_fft, one
    # block_fft (the checksum FFT), then the decode's torch kernels
    ft_kern, ft_window, ft_idle = trace_call(
        lambda: p_ft.ft_fft(x),
        lambda names: (sum("abft_fft" in k for k in names),
                       sum("block_fft" in k for k in names)) == (1, 1))
    check((sum("abft_fft" in k for k, _ in ft_kern),
           sum("block_fft" in k for k, _ in ft_kern)) == (1, 1),
          f"plan.ft_fft under torch.profiler: {[k for k, _ in ft_kern]}")
    ft_host = host_ms(lambda: p_ft.ft_fft(x))
    ft_trace = {"kernels": [[k[:80], ms] for k, ms in ft_kern],
                "device_ms": sum(ms for _, ms in ft_kern),
                "window_ms": ft_window, "idle_share": ft_idle,
                "host_ms": ft_host, "events_ms": path_ft_ms}
    log(f"abft_fft {dtype} ({b}, {n}): {abft_ms:.4f} ms by events, device "
        f"{abft_dev_ms:.4f} ms, {abft_bound[0] / abft_ms:.1%} of its "
        f"{abft_bound[0]:.4f} ms bound; per_signal {abft_ps_ms:.4f} ms; "
        f"complex128 {abft128_ms:.4f} ms ({abft128_bound / abft128_ms:.1%} "
        f"of {abft128_bound:.4f} ms); geometry {abft_geo} "
        f"({abft_geo.accumulators} sums), {abft_clusters} clusters at once")
    log(f"plan.ft_fft trace: {len(ft_kern)} kernels, "
        f"{ft_trace['device_ms']:.4f} ms on the device in a "
        f"{ft_window:.4f} ms window (idle {ft_idle:.1%}); host "
        f"{ft_host:.4f} ms a call; " + ", ".join(
            f"{k[:48]} {ms:.4f}" for k, ms in ft_kern))
    log(f"times at {dtype} N=2^{logn} B={b} (bs={bs}, T={FT_TRANSACTIONS}, "
        f"G={groups}): block_fft {blk_ms:.4f} ms (device {blk_dev_ms:.4f} "
        f"ms over {len(blk_dev)} kernels, host {blk_host_ms:.4f} ms a "
        f"call), abft_fft {abft_ms:.4f} ms "
        f"(kernel overhead {abft_ms / blk_ms - 1:+.1%}), torch.fft "
        f"{lib_ms:.4f} ms; plan.fft {path_fft_ms:.4f} ms, plan.ft_fft "
        f"{path_ft_ms:.4f} ms (end-to-end overhead "
        f"{path_ft_ms / path_fft_ms - 1:+.1%})")
    del x
    # every FFT case: plan.fft by CUDA events and under torch.profiler (it
    # must run exactly one CUDA kernel per pass, all block_fft), beside
    # torch.fft and the bound of its passes (each reads and writes every
    # point once)
    fft_shapes = []
    for dtype_c, logn_c, b_c, p, xc in path_rows[:len(FFT_CASES)]:
        pl = p.local_plan
        nbytes = 2 * xc.numel() * xc.element_size()
        port = cuda_ms(lambda: p.fft(xc), iters=5, warmup=1)
        lib = cuda_ms(lambda: torch.fft.fft(xc), iters=5, warmup=1)
        kern = device_kernels(lambda: p.fft(xc), want=pl.num_passes)
        host = host_ms(lambda: p.fft(xc))
        label = f"plan.fft {dtype_c} 2^{logn_c}x{b_c}"
        check(len(kern) == pl.num_passes
              and all("block_fft" in k for k, _ in kern),
              f"{label} under torch.profiler: {len(kern)} CUDA kernels for "
              f"{pl.num_passes} passes: {[k for k, _ in kern]}")
        tb = pl.num_passes * nbytes / HBM_BYTES_PER_S * 1e3
        tf = sum(5 * b_c * pl.n * (f.bit_length() - 1)
                 for f in pl.kernel_factors) / PEAK_FLOPS[dtype_c] * 1e3
        row = {"dtype": dtype_c, "shape": [b_c, pl.n],
               "passes": pl.num_passes, "plan_fft_ms": port,
               "torch_fft_ms": lib, "kernel_ms": [ms for _, ms in kern],
               "host_ms": host,
               "bound_ms": max(tb, tf),
               "bound_by": "bytes" if tb >= tf else "operations",
               "one_trip_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        fft_shapes.append(row)
        log(f"path {label}: plan.fft {port:.4f} ms (bound of its "
            f"{pl.num_passes} passes {row['bound_ms']:.4f} ms; host "
            f"{host:.4f} ms a call), torch.fft.fft {lib:.4f} ms; "
            f"torch.profiler: " + ", ".join(
                f"{k[:72]} {ms:.4f} ms" for k, ms in kern))
    del path_rows

    # ---- phase 5c: the extensions' kernels under torch.profiler, and times
    extensions_measure(ext_cases, ext_rows, cuda_ms, device_kernels)
    del ext_cases

    # ---- phases 4b and 5b: ft_matmul against its plain version; times
    gemm_parts, gemm_ratio = gemm_kernel_phase(dev)
    gemm_rows = gemm_time_phase(dev, cuda_ms, device_kernels)
    main_row = gemm_rows[0]
    mlp_ms = {"protected_ms": cuda_ms(mlp_blocks[0], iters=5, warmup=1),
              "unprotected_ms": cuda_ms(mlp_blocks[1], iters=5, warmup=1)}
    log(f"MLP block ({MLP_BATCH} x {MLP_TOKENS} tokens) times: protected "
        f"{mlp_ms['protected_ms']:.4f} ms (3 ft_matmul launches), "
        f"unprotected {mlp_ms['unprotected_ms']:.4f} ms (overhead "
        f"{mlp_ms['protected_ms'] / mlp_ms['unprotected_ms'] - 1:+.1%})")
    del mlp_blocks

    # ---- phase 6: the serving runtime, counts from its run only. It runs
    # after the traces, so that it adds nothing to the process's age at
    # them (the tracer drops more of a trace's first kernels in an older
    # process, ROADMAP queue 3)
    log(f"phase 6 starts {time.perf_counter() - t_start:.1f} s into the run")
    serve = serve_phase(dev)
    check(serve["launches"]["block_fft"] > 0
          and serve["launches"]["abft_fft"] > 0,
          f"a kernel of the path was never launched: {serve['launches']}")

    # ---- phase 7: the LM path, counts from its run only; every protected
    # product must launch ft_matmul (the eager ABFT path is counted too)
    t7 = time.perf_counter()
    log(f"phase 7 starts {t7 - t_start:.1f} s into the run")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for torch.matmul")
    from repro_torch.core.abft import gemm as abft_gemm
    eager_ft_matmul = abft_gemm.ft_matmul
    eager_calls = []

    def counted_eager(*args, **kwargs):
        eager_calls.append(1)
        return eager_ft_matmul(*args, **kwargs)

    abft_gemm.ft_matmul = counted_eager
    try:
        block_fft.launches = 0
        abft_fft.launches = 0
        ft_matmul.launches = 0
        lm, lm_models, lm_params, lm_tokens, lm_prompts = lm_drive(dev)
        torch.cuda.synchronize()
        lm_launches = {"block_fft": block_fft.launches,
                       "abft_fft": abft_fft.launches,
                       "ft_matmul": ft_matmul.launches}
    finally:
        abft_gemm.ft_matmul = eager_ft_matmul
    log(f"LM path launches, whole run: {json.dumps(lm_launches)}; eager "
        f"ABFT calls {len(eager_calls)}")
    check(lm_launches["ft_matmul"] > 0 and not eager_calls,
          f"LM path: {lm_launches}, {len(eager_calls)} eager ABFT calls")
    lm["launches"] = lm_launches
    lm.update(lm_measure(dev, lm_models, lm_params, lm_tokens, lm_prompts,
                         cuda_ms, host_ms, trace_call))
    del lm_models, lm_params, lm_tokens, lm_prompts
    lm["seconds"] = time.perf_counter() - t7
    log(f"phase 7 took {lm['seconds']:.1f} s; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- phase 8: the recurrent LM path, counts from its drives only (each
    # config's counts set to 0 just before its drive, read just after, and
    # summed); every protected product must launch ft_matmul
    t8 = time.perf_counter()
    log(f"phase 8 starts {t8 - t_start:.1f} s into the run")
    ssm = {}
    ssm_launches = {"block_fft": 0, "abft_fft": 0, "ft_matmul": 0}
    eager_calls.clear()
    abft_gemm.ft_matmul = counted_eager
    try:
        for arch in SSM_ARCHS:
            block_fft.launches = 0
            abft_fft.launches = 0
            ft_matmul.launches = 0
            res, models, params, tokens, prompts4 = ssm_drive(dev, arch)
            torch.cuda.synchronize()
            res["launches"] = {"block_fft": block_fft.launches,
                               "abft_fft": abft_fft.launches,
                               "ft_matmul": ft_matmul.launches}
            for key, n in res["launches"].items():
                ssm_launches[key] += n
            res.update(ssm_measure(dev, arch, res["sites_per_step"], models,
                                   params, tokens, prompts4, cuda_ms,
                                   host_ms, trace_call))
            del models, params, tokens, prompts4
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            ssm[arch] = res
    finally:
        abft_gemm.ft_matmul = eager_ft_matmul
    log(f"SSM path launches, whole run: {json.dumps(ssm_launches)}; eager "
        f"ABFT calls {len(eager_calls)}")
    check(ssm_launches["ft_matmul"] > 0 and not eager_calls,
          f"SSM path: {ssm_launches}, {len(eager_calls)} eager ABFT calls")
    ssm["launches"] = ssm_launches
    ssm["seconds"] = time.perf_counter() - t8
    log(f"phase 8 took {ssm['seconds']:.1f} s; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- phase 9: the MoE path, counts from its drives only (each config's
    # counts set to 0 just before its drive, read just after, and summed);
    # every protected product of a layer launches ft_matmul, the routed
    # experts' three checked products are the eager batched ones (counted
    # in the drive), and the eager 2-D path is never called
    t9 = time.perf_counter()
    log(f"phase 9 starts {t9 - t_start:.1f} s into the run")
    torch.cuda.empty_cache()
    moe_res = {}
    moe_launches = {"block_fft": 0, "abft_fft": 0, "ft_matmul": 0}
    eager_calls.clear()
    abft_gemm.ft_matmul = counted_eager
    try:
        for arch in MOE_ARCHS:
            block_fft.launches = 0
            abft_fft.launches = 0
            ft_matmul.launches = 0
            res, models, params, tokens, prompts4 = moe_drive(dev, arch)
            torch.cuda.synchronize()
            res["launches"] = {"block_fft": block_fft.launches,
                               "abft_fft": abft_fft.launches,
                               "ft_matmul": ft_matmul.launches}
            for key, n in res["launches"].items():
                moe_launches[key] += n
            res.update(moe_measure(dev, arch, models, params, tokens,
                                   prompts4, cuda_ms, host_ms, trace_call))
            del models, params, tokens, prompts4
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            moe_res[arch] = res
    finally:
        abft_gemm.ft_matmul = eager_ft_matmul
    log(f"MoE path launches, whole run: {json.dumps(moe_launches)}; eager "
        f"2-D ABFT calls {len(eager_calls)}")
    check(moe_launches["ft_matmul"] > 0 and not eager_calls,
          f"MoE path: {moe_launches}, {len(eager_calls)} eager ABFT calls")
    moe_res["launches"] = moe_launches
    moe_res["seconds"] = time.perf_counter() - t9
    log(f"phase 9 took {moe_res['seconds']:.1f} s; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- phase 10: training, counts from its drive only; every protected
    # linear's forward launches ft_matmul and its backward none. Gate (a)
    # runs one step on the eager path on purpose (its calls are counted
    # there); every train step checks that it makes no eager ABFT call
    t10 = time.perf_counter()
    log(f"phase 10 starts {t10 - t_start:.1f} s into the run ({smi})")
    torch.cuda.empty_cache()
    eager_calls.clear()
    abft_gemm.ft_matmul = counted_eager
    try:
        block_fft.launches = 0
        abft_fft.launches = 0
        ft_matmul.launches = 0
        train, train_models, train_params = train_drive(dev, eager_calls)
        torch.cuda.synchronize()
        train_launches = {"block_fft": block_fft.launches,
                          "abft_fft": abft_fft.launches,
                          "ft_matmul": ft_matmul.launches}
    finally:
        abft_gemm.ft_matmul = eager_ft_matmul
    want_eager = TRAIN_SITES * train_models["protected"][0].cfg.num_layers
    log(f"train path launches, whole drive: {json.dumps(train_launches)}; "
        f"eager ABFT calls {len(eager_calls)} (gate (a)'s eager step: "
        f"{want_eager})")
    check(train_launches["ft_matmul"] > 0 and len(eager_calls) == want_eager,
          f"train path: {train_launches}, {len(eager_calls)} eager ABFT "
          f"calls")
    train["launches"] = train_launches
    train.update(train_measure(dev, train_models, train_params, cuda_ms,
                               host_ms, trace_call))
    del train_models, train_params
    torch.cuda.empty_cache()
    train["device"] = smi
    train["ft_overhead_per_step"] = (train["protected"]["ms_per_step"]
                                     / train["unprotected"]["ms_per_step"]
                                     - 1)
    train["seconds"] = time.perf_counter() - t10
    log(f"train: protected step {train['protected']['ms_per_step']:.2f} ms "
        f"({train['protected']['tokens_per_s']:.0f} tokens/s), unprotected "
        f"{train['unprotected']['ms_per_step']:.2f} ms "
        f"({train['unprotected']['tokens_per_s']:.0f} tokens/s): FT overhead "
        f"{train['ft_overhead_per_step']:+.1%} a step ({smi})")
    log(f"phase 10 took {train['seconds']:.1f} s; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- phase 11: the encoder-decoder and the VLM, counts from each
    # config's drive only (set to 0 just before it, read just after, and
    # summed); every protected product launches ft_matmul, and the eager
    # ABFT path runs only in each training gate's eager step (counted there)
    t11 = time.perf_counter()
    log(f"phase 11 starts {t11 - t_start:.1f} s into the run ({smi})")
    torch.cuda.empty_cache()
    encdec = {}
    encdec_launches = {"block_fft": 0, "abft_fft": 0, "ft_matmul": 0}
    eager_calls.clear()
    abft_gemm.ft_matmul = counted_eager
    try:
        for arch in ENCDEC_ARCHS:
            block_fft.launches = 0
            abft_fft.launches = 0
            ft_matmul.launches = 0
            res, models, params, batch, prompts4 = encdec_drive(
                dev, arch, eager_calls)
            torch.cuda.synchronize()
            res["launches"] = {"block_fft": block_fft.launches,
                               "abft_fft": abft_fft.launches,
                               "ft_matmul": ft_matmul.launches}
            for key, n in res["launches"].items():
                encdec_launches[key] += n
            res.update(encdec_measure(dev, arch, models, params, batch,
                                      prompts4, cuda_ms, host_ms,
                                      trace_call))
            del models, params, batch, prompts4
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            encdec[arch] = res
    finally:
        abft_gemm.ft_matmul = eager_ft_matmul
    want_eager = sum(ENCDEC_SITES[arch][0] for arch in ENCDEC_ARCHS)
    log(f"encoder-decoder and VLM launches, their drives: "
        f"{json.dumps(encdec_launches)}; eager ABFT calls "
        f"{len(eager_calls)} (the training gates' eager steps: "
        f"{want_eager})")
    check(encdec_launches["ft_matmul"] > 0
          and len(eager_calls) == want_eager,
          f"encoder-decoder and VLM paths: {encdec_launches}, "
          f"{len(eager_calls)} eager ABFT calls")
    encdec["launches"] = encdec_launches
    encdec["device"] = smi
    encdec["seconds"] = time.perf_counter() - t11
    log(f"phase 11 took {encdec['seconds']:.1f} s; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- phase 12: training the recurrent and MoE models, counts from each
    # config's drive only (set to 0 just before it, read just after, and
    # summed); every protected linear's forward launches ft_matmul, the
    # routed experts' three checked products are the eager batched ones
    # (counted a step in the drive), and the eager 2-D path runs only in
    # each gate (a)'s eager step (counted there)
    t12 = time.perf_counter()
    log(f"phase 12 starts {t12 - t_start:.1f} s into the run ({smi})")
    torch.cuda.empty_cache()
    rm = {}
    rm_launches = {"block_fft": 0, "abft_fft": 0, "ft_matmul": 0}
    eager_calls.clear()
    batched = {"calls": 0}
    batched_fn = abft_gemm.ft_matmul_batched

    def counted_batched(*args, **kwargs):
        batched["calls"] += 1
        return batched_fn(*args, **kwargs)

    want_eager = 0
    abft_gemm.ft_matmul = counted_eager
    abft_gemm.ft_matmul_batched = counted_batched
    try:
        for arch in RM_ARCHS:
            block_fft.launches = 0
            abft_fft.launches = 0
            ft_matmul.launches = 0
            t_arch = time.perf_counter()
            res, prot, gate_sites = rm_drive(dev, arch, eager_calls,
                                             batched)
            torch.cuda.synchronize()
            res["launches"] = {"block_fft": block_fft.launches,
                               "abft_fft": abft_fft.launches,
                               "ft_matmul": ft_matmul.launches}
            for key, n in res["launches"].items():
                rm_launches[key] += n
            want_eager += gate_sites
            res.update(rm_measure(dev, arch, prot, trace_call))
            del prot
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            res["seconds"] = time.perf_counter() - t_arch
            rm[arch] = res
            log(f"{arch} train took {res['seconds']:.1f} s")
    finally:
        abft_gemm.ft_matmul = eager_ft_matmul
        abft_gemm.ft_matmul_batched = batched_fn
    log(f"recurrent and MoE training launches, their drives: "
        f"{json.dumps(rm_launches)}; eager ABFT calls {len(eager_calls)} "
        f"(the gates (a)' eager steps: {want_eager}); eager batched expert "
        f"products {batched['calls']}")
    check(rm_launches["ft_matmul"] > 0 and len(eager_calls) == want_eager,
          f"recurrent and MoE training: {rm_launches}, {len(eager_calls)} "
          f"eager ABFT calls")
    rm["launches"] = rm_launches
    rm["device"] = smi
    rm["models_seconds"] = time.perf_counter() - t12
    log(f"phase 12's four models took {rm['models_seconds']:.1f} s")

    # the script ends with the CLIs, started together, each a host-bound
    # process of its own: phase 12's `launch.train` at xLSTM-350M's
    # published widths, and the `--mode lm` CLIs of phases 7-9 and 11, each
    # with its own ledger, 2 faults a layer (the demo schedule's two
    # entries fire in every block), none for Whisper, whose blocks take no
    # fault descriptor
    from repro_torch.configs import get_config, get_smoke_config
    proc, out, t_cli = rm_cli_start()
    try:
        clis = lm_clis([
            (LM_CLI, 2 * get_config(LM_SMALL_ARCH).num_layers),
            (SSM_CLI, 2 * get_config("xlstm_350m").num_layers),
            (MOE_CLI, 2 * get_smoke_config("deepseek_v3_671b").num_layers),
            *(ENCDEC_CLI[arch] for arch in ENCDEC_ARCHS)])
    except BaseException:
        proc.kill()
        proc.wait()
        out.close()
        raise
    rm["cli"] = rm_cli_finish(proc, out, t_cli)
    lm["cli"], ssm["xlstm_350m"]["cli"], moe_res["deepseek_v3_671b"][
        "cli"] = clis[:3]
    encdec["cli"] = clis[3:]
    rm["cli_seconds"] = time.perf_counter() - t_cli
    rm["seconds"] = time.perf_counter() - t12
    log(f"phase 12 took {rm['seconds']:.1f} s, its six CLIs "
        f"{rm['cli_seconds']:.1f} s of it; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- phase 13: the sharded 1-D FFT, counts from its drives only: each
    # of the four ranks sets its count to 0 before its drive and reports it
    # after; the one NCCL rank here likewise
    t13 = time.perf_counter()
    log(f"phase 13 starts {t13 - t_start:.1f} s into the run ({smi})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"  before its ranks start: {free / 1e9:.2f} of {total / 1e9:.2f} GB "
        f"free on the card, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"held by this process")
    sharded = sharded_phase(dev, cuda_ms, smi)
    sharded["device"] = smi
    sharded["seconds"] = time.perf_counter() - t13
    one = sharded["one_rank"]
    log(f"sharded FFT: four gloo ranks on one card took "
        f"{sharded['four_ranks_seconds']:.1f} s ({sharded['launches']} "
        f"block_fft launches in all, {sharded['launches_ft']} of the ABFT, "
        f"{sharded['launches_spectral']} of the spectral consumers and "
        f"{sharded['launches_nd']} of the n-D drive in "
        f"{sharded['nd_seconds']:.1f} s, {sharded['launches_serve']} of "
        f"serving over the meshes in {sharded['serve_seconds']:.1f} s); "
        f"one NCCL rank, make_fft_mesh(1), "
        f"{one['case']}: plan.fft on the mesh {one['mesh_ms']:.4f} ms, "
        f"plan.fft {one['plan_ms']:.4f} ms, torch.fft "
        f"{one['torch_fft_ms']:.4f} ms ({smi})")
    lm_ranks = []
    for r in range(SHARD_RANKS):
        path = os.path.join(sharded["out_dir"], f"rank{r}-lm.json")
        check(os.path.exists(path), f"phase 14: rank {r} wrote no record")
        with open(path) as f:
            lm_ranks.append(json.load(f))
    lm_rank_s = max(res.get("seconds", 0.0) for res in lm_ranks)
    log(f"phase 13 took {sharded['seconds']:.1f} s, of which phase 14's "
        f"drives in its four ranks {lm_rank_s:.1f} s; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- phase 14: LM parallelism, in phase 13's four ranks (above, their
    # ft_matmul counts set to 0 before its drives), then checked here
    t14 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lmp = lmp_phase(dev, sharded["out_dir"], lm_ranks, smi)
    lmp["device"] = smi
    lmp["seconds"] = lm_rank_s + time.perf_counter() - t14
    log(f"phase 14 took {lmp['seconds']:.1f} s ({lm_rank_s:.1f} s in the "
        f"ranks, {lmp['parent_seconds']:.1f} s here; {lmp['launches']} "
        f"ft_matmul launches over the ranks); the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    kernels = [
        {"name": "block_fft", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/block_fft.cu",
         "replaces": "src/repro/kernels/stockham.py:114",
         "launches": launches["block_fft"],
         "launches_per_call": per_call["block_fft"],
         "max_abs_err": kerr["block_fft"],
         "max_err_over_tol": kratio["block_fft"], "ms": blk_ms,
         "device_ms": blk_dev_ms, "host_ms": blk_host_ms,
         "plain_ms": blk_plain, "bound_ms": blk_bound[0],
         "bound_by": blk_bound[1], "library_ms": lib_ms,
         "launches_by_path": {"fft": launches["block_fft"],
                              "extensions": ext_launches["block_fft"],
                              "serve": serve["launches"]["block_fft"],
                              "sharded": sharded["launches"],
                              "sharded_ft": sharded["launches_ft"],
                              "sharded_spectral":
                                  sharded["launches_spectral"],
                              "sharded_nd": sharded["launches_nd"],
                              "sharded_serve": sharded["launches_serve"]},
         "shapes": fft_shapes, "extensions": ext_rows,
         "axis_layouts": axis_rows, "serve": serve, "sharded": sharded},
        {"name": "abft_fft", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/abft_fft.cu",
         "replaces": "src/repro/kernels/stockham_abft.py:119",
         "launches": launches["abft_fft"],
         "launches_by_path": {"fft": launches["abft_fft"],
                              "extensions": ext_launches["abft_fft"],
                              "serve": serve["launches"]["abft_fft"],
                              "sharded_one_rank": sharded["abft_launches"]},
         "launches_per_call": per_call["abft_fft"],
         "max_abs_err": kerr["abft_fft"], "max_abs_err_parts": abft_parts,
         "max_err_over_tol": kratio["abft_fft"], "ms": abft_ms,
         "device_ms": abft_dev_ms, "bound_share": abft_bound[0] / abft_ms,
         "per_signal_ms": abft_ps_ms, "complex128_ms": abft128_ms,
         "complex128_bound_ms": abft128_bound,
         "cluster": abft_geo.cluster,
         "geometry": dataclasses.asdict(abft_geo),
         "max_active_clusters": abft_clusters,
         "instances": abft_instances, "plan_ft_fft_trace": ft_trace,
         "ft_ifft_seu": ft_ifft_seu,
         "plain_ms": abft_plain, "bound_ms": abft_bound[0],
         "bound_by": abft_bound[1], "library_ms": None,
         "torch_fft_ms": lib_ms, "overhead_vs_block_fft":
             abft_ms / blk_ms - 1},
        {"name": "ft_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ft_matmul.cu",
         "replaces": "src/repro/kernels/ft_matmul.py:149",
         "launches": gemm_launches["ft_matmul"],
         "launches_by_path": {"gemm": gemm_launches["ft_matmul"],
                              "lm": lm_launches["ft_matmul"],
                              "ssm": ssm_launches["ft_matmul"],
                              "moe": moe_launches["ft_matmul"],
                              "train": train_launches["ft_matmul"],
                              "encdec": encdec_launches["ft_matmul"],
                              "rm_train": rm_launches["ft_matmul"],
                              "lm_parallel": lmp["launches"]},
         "launches_per_call": {"plan.ft_matmul": 1,
                               "protected MLP block": mlp_per_call,
                               "protected prefill":
                                   lm["prefill"]["ft_matmul_launches"],
                               "protected decode step":
                                   lm["decode"][0]["protected"][
                                       "launches_per_step"],
                               **{f"{arch} protected decode step":
                                  ssm[arch]["decode"][0]["protected"][
                                      "launches_per_step"]
                                  for arch in SSM_ARCHS},
                               **{f"{arch} protected decode step":
                                  moe_res[arch]["decode"][0]["protected"][
                                      "launches_per_step"]
                                  for arch in MOE_ARCHS},
                               "protected train step": train["protected"][
                                   "ft_matmul_launches_per_step"],
                               **{f"{arch} protected prefill":
                                  encdec[arch]["prefill"]["bfloat16"][
                                      "ft_matmul_launches"]
                                  for arch in ENCDEC_ARCHS},
                               **{f"{arch} protected decode step":
                                  encdec[arch]["decode"][0]["protected"][
                                      "launches_per_step"]
                                  for arch in ENCDEC_ARCHS},
                               **{f"{arch} protected train step":
                                  encdec[arch]["train"]["protected"][
                                      "ft_matmul_launches_per_step"]
                                  for arch in ENCDEC_ARCHS},
                               **{f"{arch} protected train step":
                                  rm[arch]["protected"][
                                      "ft_matmul_launches_per_step"]
                                  for arch in RM_ARCHS},
                               "protected EP call a rank":
                                   lmp["ep"]["float32/ft"]["launches"][0],
                               "protected sharded train step a rank":
                                   lmp["train"]["launches"][0][0]},
         "max_abs_err": max(gemm_parts.values()),
         "max_abs_err_parts": gemm_parts, "max_err_over_tol": gemm_ratio,
         "max_abs_err_by_path": {
             "gemm": max(gemm_parts.values()),
             "lm": max(lm["decode_shape"]["max_abs_err"].values()),
             "ssm": max(e for arch in SSM_ARCHS
                        for row in ssm[arch]["ftmm_shapes"]
                        for e in row["max_abs_err"].values()),
             "moe": max(e for arch in MOE_ARCHS
                        for row in moe_res[arch]["ftmm_shapes"]
                        for e in row["max_abs_err"].values()),
             "train": max(e for row in train["ftmm_shapes"]
                          for e in row["max_abs_err"].values()),
             "encdec": max(e for arch in ENCDEC_ARCHS
                           for row in encdec[arch]["ftmm_shapes"]
                           for e in row["max_abs_err"].values())},
         "ssm_shapes": [dict(row, arch=arch) for arch in SSM_ARCHS
                        for row in ssm[arch]["ftmm_shapes"]],
         "moe_shapes": [dict(row, arch=arch) for arch in MOE_ARCHS
                        for row in moe_res[arch]["ftmm_shapes"]],
         "encdec_shapes": [dict(row, arch=arch) for arch in ENCDEC_ARCHS
                           for row in encdec[arch]["ftmm_shapes"]],
         "shape": main_row["shape"], "ms": main_row["ms"],
         "device_ms": main_row["device_ms"],
         "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
         "bound_by": main_row["bound_by"],
         "library_ms": main_row["library_ms"],
         "blocks_per_sm": next(r["blocks_per_sm"] for r in ftmm_instances
                               if r["x"] == r["w"] == "float32"
                               and r["tile"] == [128, 128]),
         "instances": ftmm_instances, "shapes": gemm_rows,
         "mlp_block": mlp_ms, "seu": {"plan": gemm_seu, "mlp": mlp_seu},
         "lm": lm, "ssm": ssm, "moe": moe_res, "train": train,
         "encdec": encdec, "rm_train": rm, "lm_parallel": lmp},
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
