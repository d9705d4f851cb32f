"""Serving entry point: batched greedy decode against the KV cache, the
batched FFT endpoint and the multi-tenant serving worker, on one card.

    # greedy decode of a model (the SMOKE config at --preset tiny, the
    # published widths at --preset full); --ft protects every linear with
    # the checked GEMM and injects a demo FaultSchedule of two SEUs (any
    # --arch of the reference: whisper-base and internvl2-1b too, whose
    # decode, as the reference's, sees no audio or patches, and Whisper's
    # no fault: ROADMAP queue 3, "In the reference itself", items 8, 9)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --preset tiny --batch 4 --prompt-len 16 --gen 32 --ft

    # one plan, built at startup from a consolidated spec string
    PYTHONPATH=src python -m repro_torch.launch.serve --mode fft \
        --fft-spec "n=1048576,batch=16"

    # the multi-tenant serving runtime (repro_torch.serve): spec bucketing
    # + deadline batching over the plan cache, one string describing plan
    # geometry AND scheduler policy
    PYTHONPATH=src python -m repro_torch.launch.serve --mode serve \
        --fft-spec "n=8192,workers=2,max_batch=16,deadline_ms=2"

    # the same over a mesh of 4 ranks (torchrun starts them; rank 0 leads
    # and prints), and the sharded FFT endpoint on a 2 x 2 data x fft mesh
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --device cpu \
        --mode serve --fft-shards 4 --fft-n 4096 --serve-requests 64
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --device cpu \
        --mode fft --fft-n 65536 --batch 8 --fft-shards 2 --fft-data 2 --ft

All of them run on the card; ``--device cpu`` runs the kernels' plain
versions instead. Under ``torchrun`` (``WORLD_SIZE`` > 1) the CLI starts
the process group from its environment unless one is running: NCCL when
every rank has a card of its own, else gloo (ranks share the cards, or
run on the CPU). ``--mode serve`` builds its mesh with ``data=1``, as the
reference's does: it ignores ``--fft-data``. On one process the mesh has
one device and the plans are local, as the reference's are on one device.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.ft import FaultSchedule, FTStats
from repro_torch.models import Model
from repro_torch.serve.bucketing import mesh_shards
from repro_torch.serve.specs import (SPEC_KEYS, _parse_chunks,
                                     apply_fft_spec_arg, build_fft_spec,
                                     serve_plan)
from repro_torch.train import make_serve_step

__all__ = ["decode", "demo_schedule", "serve_fft", "fft_mesh", "main",
           "SPEC_KEYS"]


def decode(model: Model, params, prompts: torch.Tensor, gen: int,
           max_len: int | None = None, schedule=None):
    """Prefill via repeated decode steps, then generate ``gen`` tokens.

    ``prompts`` is a (B, P) integer tensor on the params' device.
    ``schedule`` is an optional :class:`~repro_torch.core.ft.FaultSchedule`:
    each step arms its GEMM fault descriptor
    (:meth:`~repro_torch.core.ft.FaultSchedule.for_step_gemm`, copied to
    the device once a step) in every protected block. Returns ``(tokens,
    FTStats)`` when a schedule is given (online ABFT telemetry summed over
    steps), else just ``tokens``.
    """
    cfg = model.cfg
    b, p = prompts.shape
    dev = prompts.device
    max_len = max_len or (p + gen)
    step_fn = make_serve_step(model, RunConfig(model=cfg))
    cache = model.init_cache(batch=b, max_len=max_len, device=dev)
    stats = FTStats.zeros(dev)

    def inj(step):
        return (None if schedule is None
                else schedule.for_step_gemm(step).to(dev))

    def fold(aux):
        return stats.merge(FTStats(
            detected=aux["ft_flagged"], corrected=aux["ft_corrected"],
            max_score=aux["ft_max_score"],
            skipped_updates=torch.zeros((), device=dev)))

    # teacher-forced prefill (decode-path; exercises the cache end-to-end)
    nxt = prompts[:, :1]
    for i in range(p):
        tok = prompts[:, i:i + 1]
        nxt, cache, aux = step_fn(params, cache, tok, i, inj(i))
        stats = fold(aux)
    out = [nxt]
    for j in range(gen - 1):
        nxt, cache, aux = step_fn(params, cache, nxt, p + j, inj(p + j))
        stats = fold(aux)
        out.append(nxt)
    toks = torch.cat(out, dim=1)
    return toks if schedule is None else (toks, stats)


def demo_schedule(batch: int, prompt_len: int) -> FaultSchedule:
    """The CLI's two SEUs, which the online ABFT must catch: one
    mid-prefill, one mid-generation — (step, site, row < batch, col,
    eps_re, eps_im). Each block builds its own fault context, so an entry
    faults its site in every block: the ledger counts entries x layers."""
    return FaultSchedule(entries=(
        (min(2, prompt_len - 1), 0, batch - 1, 3, 275.0, 0.0),
        (prompt_len + 1, 1, 0, 11, -310.0, 0.0),
    ))


def _start_group(device) -> None:
    """Start the process group from ``torchrun``'s environment: NCCL when
    every rank of this node has a card of its own, else gloo (the ranks
    share the cards, or run on the CPU). Logs the backend."""
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 0
    if cards:
        torch.cuda.set_device(local % cards)
    backend = "nccl" if cards and cards >= per_node else "gloo"
    kw = {"device_id": torch.device("cuda", local)} if backend == "nccl" \
        else {}
    dist.init_process_group(backend, **kw)
    if dist.get_rank() == 0:
        print(f"# process group: {backend}, {world} ranks, {cards} cards "
              f"on rank 0's node", file=sys.stderr, flush=True)


def fft_mesh(shards: int | None = None, data: int = 1, *,
             device: str = "cuda"):
    """The mesh the serving entry points plan on: ``make_fft_mesh(shards,
    data)`` over the running process group, started from ``torchrun``'s
    environment when ``WORLD_SIZE`` > 1 and none runs yet (an initialised
    group is reused). On a single process, None: the plan is the local
    one, as the reference's plan on a one-device mesh is."""
    from repro_torch.launch.mesh import make_fft_mesh

    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        _start_group(device)
    return make_fft_mesh(shards, data, device=torch.device(device).type)


def serve_fft(x, *, shards: int | None = None, data: int = 1,
              ft: bool = False, threshold: float = 1e-4,
              op: str = "fft", kernel=None, mode: str = "same",
              natural_order: bool | None = None,
              groups: int | None = None, group_size: int | None = None,
              recompute_uncorrectable: bool = True,
              dims: int = 1, decomp: str = "auto", real: bool = False,
              chunks: int = 1, device: str = "cuda"):
    """Batched FFT endpoint: one request = one (B, N) batch (``dims=2``:
    one (B, R, C) grid batch), served on ``device``.

    Compat sugar over the plan API: resolves the request into an
    :class:`~repro_torch.core.fft.api.FFTSpec` via :func:`build_fft_spec`,
    LRU-hits the plan, and serves through :func:`serve_plan`. A
    production worker should build the plan ONCE at startup (what
    ``--mode fft`` does) instead of re-describing it per request; the
    behavior is identical either way thanks to the plan cache.

    Every rank of the process group calls it together: the mesh is
    :func:`fft_mesh` (``shards`` ranks along ``fft``, a ``data`` dimension
    when ``data > 1``; the local plan on one process), and ``x`` the
    global batch, the same on every rank. With ``ft=True`` the ABFT runs
    online: the fused two-side kernel locally, the sharded grouped
    pipeline on a mesh (one tolerated SEU per checksum group; multi-fault
    groups are recomputed when ``recompute_uncorrectable``) with the
    per-group verdict counts in the telemetry. Spectral requests on a mesh
    stay in the transposed digit order end to end. Returns ``(y, info)``:
    ``y`` on ``device``, a ``DTensor`` of the global result on a mesh.
    """
    from repro_torch.core.fft import api

    x = torch.as_tensor(x)
    if dims not in (1, 2):
        raise ValueError(f"dims must be 1 or 2, got {dims}")
    if dims == 2 and x.dim() != 3:
        raise ValueError(f"dims=2 expects (B, R, C) batches, "
                         f"got {tuple(x.shape)}")
    mesh = fft_mesh(shards, data, device=device)
    kshape = tuple(torch.as_tensor(kernel).shape) if kernel is not None \
        else None
    if real and x.is_complex():
        raise ValueError(f"real=True serves real-valued traffic, "
                         f"got {x.dtype}")
    if x.is_complex():
        dt = x.dtype
    else:
        dt = torch.complex128 if (real and x.dtype == torch.float64) \
            else torch.complex64
    spec = build_fft_spec(
        tuple(x.shape), mesh=mesh, op=op, kernel_shape=kshape, dims=dims,
        decomp=decomp, ft=ft, threshold=threshold, groups=groups,
        group_size=group_size,
        recompute_uncorrectable=recompute_uncorrectable,
        natural_order=natural_order, dtype=dt, real=real, chunks=chunks,
        device=device)
    return serve_plan(api.plan(spec), x, op=op, kernel=kernel, mode=mode)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _leads(mesh) -> bool:
    """Whether this process prints: the only one, or the mesh's first
    rank."""
    return mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])


def _main_fft(args):
    """One plan, built at startup from the worker description, timed over
    ``--fft-iters`` calls of the same request batch and checked against
    numpy (``rel_err``). On a mesh every rank runs it and the leader
    prints."""
    from repro_torch.core.fft import api
    from repro_torch.serve.mesh import Channel

    if args.fft_spec:
        apply_fft_spec_arg(args, args.fft_spec)
    rng = np.random.default_rng(0)
    kernel = kshape = None
    if args.fft_dims == 2:
        shape = (args.batch, args.fft_rows, args.fft_cols)
        size_tag = f"{args.fft_rows}x{args.fft_cols}"
    else:
        shape = (args.batch, args.fft_n)
        size_tag = f"{args.fft_n}"
    if args.fft_op in ("convolve", "correlate"):
        x = rng.standard_normal(shape).astype(np.float32)
        kshape = ((args.fft_kernel_n, args.fft_kernel_n)
                  if args.fft_dims == 2 else (args.fft_kernel_n,))
        kernel = rng.standard_normal(kshape).astype(np.float32)
    elif args.fft_real:
        x = rng.standard_normal(shape).astype(np.float32)
    else:
        x = (rng.standard_normal(shape) +
             1j * rng.standard_normal(shape)).astype(np.complex64)
    mesh = fft_mesh(args.fft_shards, args.fft_data, device=args.device)
    channel = Channel(mesh) if mesh_shards(mesh) > 1 else None
    if channel is not None and not channel.member:
        return
    # the channel's groups go with the call (the caller's group stays)
    with contextlib.closing(channel) if channel is not None \
            else contextlib.nullcontext():
        # ONE plan per worker, built at startup: every request dispatches
        # through its cached executors (the cuFFT plan-once/exec-hot
        # contract)
        spec = build_fft_spec(
            shape, mesh=mesh, op=args.fft_op, kernel_shape=kshape,
            dims=args.fft_dims, decomp=args.fft_decomp, ft=args.ft,
            threshold=args.fft_threshold, groups=args.fft_groups,
            natural_order=False if args.transposed else None,
            real=args.fft_real, chunks=args.fft_chunks, device=args.device)
        p = api.plan(spec)
        leads = _leads(mesh)
        if leads:
            print(f"# {p}")
        # the request batch is uploaded once: the timed calls are the plan's
        xd = torch.from_numpy(x).to(p.device)
        kd = None if kernel is None else torch.from_numpy(kernel).to(p.device)

        def call():
            return serve_plan(p, xd, op=args.fft_op, kernel=kd)

        y, info = call()  # warmup
        _sync(p.device)
        t0 = time.perf_counter()
        for _ in range(args.fft_iters):
            y, info = call()
        _sync(p.device)
        dt = (time.perf_counter() - t0) / args.fft_iters
        if channel is not None:
            y = channel.assemble(y)
        if not leads:
            return
        y = y.cpu().numpy()
        ref = _fft_mode_ref(args, x, kernel, shape, kshape)
        if args.fft_op == "spectrum" and info.get("order") == "transposed":
            # order-agnostic comparison over the flattened bins
            ref = np.sort(ref.reshape(ref.shape[0], -1), axis=-1)
            y = np.sort(y.reshape(y.shape[0], -1), axis=-1)
        elif args.transposed and info.get("order") == "transposed":
            ref = y   # digit-permuted; the test suite holds the order itself
        err = np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30)
        print(f"{args.fft_op} batch={args.batch} N={size_tag} {info} "
              f"{dt*1e3:.2f}ms/req rel_err={err:.2e}")


def _fft_mode_ref(args, x, kernel, shape, kshape) -> np.ndarray:
    """numpy's result for ``--mode fft``'s request batch, in natural
    order."""
    nfft = int(np.prod(shape[1:]))
    if args.fft_real:
        fwd = np.fft.rfft2 if args.fft_dims == 2 else np.fft.rfft
    else:
        fwd = np.fft.fft2 if args.fft_dims == 2 else np.fft.fft
    if args.fft_op == "convolve":
        if args.fft_dims == 2:
            rr = shape[1] + kshape[0] - 1
            cc = shape[2] + kshape[1] - 1
            full = np.real(np.fft.ifft2(np.fft.fft2(x, s=(rr, cc)) *
                                        np.fft.fft2(kernel, s=(rr, cc))))
            r0 = (min(shape[1], kshape[0]) - 1) // 2
            c0 = (min(shape[2], kshape[1]) - 1) // 2
            return full[:, r0:r0 + max(shape[1], kshape[0]),
                        c0:c0 + max(shape[2], kshape[1])]
        return np.stack([np.convolve(r, kernel, "same") for r in x])
    if args.fft_op == "correlate":
        return np.stack([np.correlate(r, kernel, "same") for r in x])
    if args.fft_op == "spectrum":
        return np.abs(fwd(x)) ** 2 / nfft
    return fwd(x)


def _request_ref(x: np.ndarray, kw: dict, nfft: int) -> np.ndarray:
    """What the runtime must return for a self-test request: the
    transform of ``x`` zero-padded to its bucket's ``nfft`` points."""
    if kw.get("real"):
        return np.fft.rfft(x, nfft)
    y = np.fft.fft(x, nfft)
    return np.abs(y) ** 2 / nfft if kw["op"] == "spectrum" else y


def _main_serve(args):
    """Multi-tenant serving worker (``--mode serve``): stand up a
    :class:`~repro_torch.serve.ServeRuntime` on the device (over the mesh
    of ``--fft-shards`` ranks: the leader drives it, the other ranks
    follow), drive it with a short mixed-tenant self-test workload, check
    every result against numpy's transform of its zero-padded request
    (``rel_err``: the worst max|y - ref| / max|ref|; a spectrum in the
    mesh's transposed digit order over its sorted bins) and print the
    per-bucket telemetry."""
    import json

    from repro_torch.serve import RuntimeConfig, ServeRuntime

    if args.fft_spec:
        apply_fft_spec_arg(args, args.fft_spec)
    cfg = RuntimeConfig(
        max_batch=args.serve_max_batch, deadline_ms=args.serve_deadline_ms,
        queue_depth=args.serve_queue_depth, workers=args.serve_workers,
        timeout_ms=args.serve_timeout_ms, chunks=max(args.fft_chunks, 1),
        device=args.device)
    # the reference's worker plans on a mesh of fft shards alone
    mesh = fft_mesh(args.fft_shards, 1, device=args.device)
    mesh = mesh if mesh_shards(mesh) > 1 else None
    rng = np.random.default_rng(0)
    n = args.fft_n
    t0 = time.time()
    with ServeRuntime(cfg, mesh=mesh) as rt:
        if not _leads(mesh):
            return
        sent = []
        for i in range(args.serve_requests):
            # mixed tenants: off-grid sizes, four request kinds
            sz = (n, max(2, n - n // 4), max(2, n // 2 + 1))[i % 3]
            x = rng.standard_normal(sz).astype(np.float32)
            kind = i % 4
            kw = ({"op": "fft"}, {"op": "spectrum"},
                  {"op": "fft", "real": True},
                  {"op": "fft", "ft": True})[kind if not args.ft else 3]
            sent.append((x, kw, rt.submit(x, **kw)))
        err = 0.0
        for x, kw, h in sent:
            y = h.result(timeout=300.0)
            ref = _request_ref(x, kw, h.info["nfft"][0])
            if h.info.get("order") == "transposed":
                y, ref = np.sort(y), np.sort(ref)
            err = max(err, float(np.abs(y - ref).max()
                                 / (np.abs(ref).max() + 1e-30)))
        stats = rt.stats()
    dt = time.time() - t0
    where = rt.device if mesh is None else \
        f"a mesh of {rt.bucketer.shards} fft ranks on {rt.device}"
    print(f"# served {len(sent)} requests in {dt:.2f}s "
          f"({len(sent) / dt:.0f} rps) on {where}")
    print(json.dumps(stats["buckets"], indent=2, sort_keys=True))
    print(f"# plan cache: {stats['plan_cache']}")
    print(f"serve requests={len(sent)} rel_err={err:.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="lm", choices=["lm", "fft", "serve"])
    ap.add_argument("--device", default="cuda",
                    help="where the plans run: cuda (the kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--fft-n", type=int, default=1 << 16)
    ap.add_argument("--fft-shards", type=int, default=None)
    ap.add_argument("--fft-data", type=int, default=1,
                    help="batch-parallel mesh axis size (2-D data x fft mesh)")
    ap.add_argument("--fft-op", default="fft",
                    choices=["fft", "convolve", "correlate", "spectrum"])
    ap.add_argument("--fft-dims", type=int, default=1, choices=[1, 2],
                    help="2 serves (batch, rows, cols) grids through the "
                         "multidim subsystem (core.fft.multidim)")
    ap.add_argument("--fft-decomp", default="auto",
                    choices=["auto", "slab", "pencil"],
                    help="multidim decomposition; auto = the "
                         "collective-volume heuristic (choose_decomp)")
    ap.add_argument("--fft-rows", type=int, default=256,
                    help="grid rows for --fft-dims 2")
    ap.add_argument("--fft-cols", type=int, default=256,
                    help="grid cols for --fft-dims 2")
    ap.add_argument("--fft-kernel-n", type=int, default=63,
                    help="kernel length for convolve/correlate")
    ap.add_argument("--fft-groups", type=int, default=None,
                    help="ABFT checksum groups (one tolerated SEU per "
                         "group); default: one group per data shard")
    ap.add_argument("--fft-threshold", type=float, default=1e-4,
                    help="ABFT detection threshold")
    ap.add_argument("--fft-chunks", type=_parse_chunks, default=1,
                    help="multi-transaction overlap: split the batch into "
                         "this many chunked all-to-all transactions; "
                         "'auto' lets the plan pick from the "
                         "collective-volume model (one device: 1)")
    ap.add_argument("--fft-spec", default=None,
                    help="consolidated plan description, e.g. "
                         "'n=65536,batch=8,ft=1' (keys: "
                         + ", ".join(sorted(SPEC_KEYS)) + "); overrides "
                         "the individual --fft-* flags — the worker builds "
                         "ONE FFTPlan from it at startup")
    ap.add_argument("--fft-iters", type=int, default=5)
    ap.add_argument("--serve-workers", type=int, default=2,
                    help="serve mode: executor worker threads, each on its "
                         "own CUDA stream (over a mesh: one dispatch thread "
                         "a rank)")
    ap.add_argument("--serve-max-batch", type=int, default=8,
                    help="serve mode: coalescing limit = the bucket plans' "
                         "batch dimension")
    ap.add_argument("--serve-deadline-ms", type=float, default=2.0,
                    help="serve mode: max time a request waits for batch "
                         "companions before its partial batch closes")
    ap.add_argument("--serve-queue-depth", type=int, default=64,
                    help="serve mode: bounded pending-request queue "
                         "(backpressure: overflow is rejected, not "
                         "buffered)")
    ap.add_argument("--serve-timeout-ms", type=float, default=None,
                    help="serve mode: fail requests unbatched past this "
                         "age (default: never)")
    ap.add_argument("--serve-requests", type=int, default=64,
                    help="serve mode: self-test workload size")
    ap.add_argument("--transposed", action="store_true",
                    help="keep fft/spectrum output in the transposed digit "
                         "order of a mesh")
    ap.add_argument("--fft-real", action="store_true",
                    help="serve real-valued traffic through the packed "
                         "half-spectrum pipelines (rfft/rfft2, one-sided "
                         "spectrum, packed convolve)")
    ap.add_argument("--ft", action="store_true",
                    help="FFT mode: run the two-side ABFT online (the "
                         "fused kernel; the grouped sharded ABFT on a "
                         "mesh). "
                         "LM mode: protect every linear with the checked "
                         "GEMM plan (core.gemm) and inject a demo "
                         "FaultSchedule of SEUs that the decode must "
                         "detect and correct online")
    ap.add_argument("--ft-threshold", type=float, default=1e-3,
                    help="LM-mode ABFT detection threshold (relative "
                         "per-column checksum divergence)")
    args = ap.parse_args(argv)

    if args.mode == "lm":
        _main_lm(args)
        return
    started = not dist.is_initialized()
    try:
        (_main_fft if args.mode == "fft" else _main_serve)(args)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _main_lm(args):
    """Greedy decode of ``--arch`` with weights drawn from seed 0 on the
    device and prompts from numpy's seed 0, as the reference CLI."""
    import dataclasses

    cfg = (get_config if args.preset == "full" else get_smoke_config)(
        args.arch)
    schedule = None
    if args.ft:
        cfg = dataclasses.replace(cfg, ft=dataclasses.replace(
            cfg.ft, protect_linears=True, threshold=args.ft_threshold))
        schedule = demo_schedule(args.batch, args.prompt_len)
    dev = torch.device(args.device)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    t0 = time.time()
    res = decode(model, params, prompts, args.gen, schedule=schedule)
    toks, stats = res if args.ft else (res, None)
    _sync(dev)
    dt = time.time() - t0
    rate = args.batch * args.gen / dt
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s ({rate:.1f} tok/s)")
    if stats is not None:
        print(f"ft: injected={schedule.num_faults} "
              f"detected={float(stats.detected):.0f} "
              f"corrected={float(stats.corrected):.0f} "
              f"max_score={float(stats.max_score):.3f} "
              f"backend={cfg.ft.gemm_backend}")
    print(toks[:, :16].cpu().numpy())


if __name__ == "__main__":
    main()
