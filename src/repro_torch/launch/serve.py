"""Serving entry point: the batched FFT endpoint and the multi-tenant serving
worker, on one card.

    # one plan, built at startup from a consolidated spec string
    PYTHONPATH=src python -m repro_torch.launch.serve --mode fft \
        --fft-spec "n=1048576,batch=16"

    # the multi-tenant serving runtime (repro_torch.serve): spec bucketing
    # + deadline batching over the plan cache, one string describing plan
    # geometry AND scheduler policy
    PYTHONPATH=src python -m repro_torch.launch.serve --mode serve \
        --fft-spec "n=8192,workers=2,max_batch=16,deadline_ms=2"

Both run on the card; ``--device cpu`` runs the kernels' plain versions
instead. The LM decode mode (``--mode lm``) waits for the model stack
(ROADMAP queue 1 item 9); meshes (``--fft-shards``/``--fft-data`` > 1)
and chunked transactions for the sharded FFT (item 10).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.serve.bucketing import ITEM_10
from repro_torch.serve.specs import (SPEC_KEYS, _parse_chunks,
                                     apply_fft_spec_arg, build_fft_spec,
                                     serve_plan)

__all__ = ["serve_fft", "main", "SPEC_KEYS"]

ITEM_9 = "ROADMAP queue 1 item 9 (the model stack)"


def _local_mesh(shards: int | None, data: int) -> None:
    """The port serves on one device: a mesh of more than one device
    raises, naming the ROADMAP item that ports it."""
    if (shards or 1) > 1 or data > 1:
        raise NotImplementedError(
            f"serving over a mesh (shards={shards}, data={data}) is not "
            f"ported yet: {ITEM_10}")


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
    behavior is identical either way thanks to the plan cache. With
    ``ft=True`` the fused two-side ABFT runs online. ``shards``/``data``
    above 1 (a mesh) raise ``NotImplementedError`` (ROADMAP queue 1 item
    10). Returns ``(y, info)``, ``y`` on ``device``.
    """
    from repro_torch.core.fft import api

    x = torch.as_tensor(x)
    if dims not in (1, 2):
        raise ValueError(f"dims must be 1 or 2, got {dims}")
    if dims == 2 and x.dim() != 3:
        raise ValueError(f"dims=2 expects (B, R, C) batches, "
                         f"got {tuple(x.shape)}")
    _local_mesh(shards, data)
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
        tuple(x.shape), op=op, kernel_shape=kshape, dims=dims,
        decomp=decomp, ft=ft, threshold=threshold, groups=groups,
        group_size=group_size,
        recompute_uncorrectable=recompute_uncorrectable,
        natural_order=natural_order, dtype=dt, real=real, chunks=chunks,
        device=device)
    return serve_plan(api.plan(spec), x, op=op, kernel=kernel, mode=mode)


def _local_args(args) -> None:
    _local_mesh(args.fft_shards, args.fft_data)
    if args.fft_chunks != 1:
        raise NotImplementedError(
            f"--fft-chunks {args.fft_chunks} splits the batch into the "
            f"sharded FFT's all-to-all transactions: {ITEM_10}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _main_fft(args):
    from repro_torch.core.fft import api

    if args.fft_spec:
        apply_fft_spec_arg(args, args.fft_spec)
    _local_args(args)
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
    # ONE plan per worker, built at startup: every request dispatches
    # through its cached executors (the cuFFT plan-once/exec-hot contract)
    spec = build_fft_spec(
        shape, op=args.fft_op, kernel_shape=kshape, dims=args.fft_dims,
        decomp=args.fft_decomp, ft=args.ft, threshold=args.fft_threshold,
        groups=args.fft_groups,
        natural_order=False if args.transposed else None,
        real=args.fft_real, chunks=args.fft_chunks, device=args.device)
    p = api.plan(spec)
    print(f"# {p}")
    # the request batch is uploaded once: the timed calls are the plan's
    xd = torch.from_numpy(x).to(p.device)
    kd = None if kernel is None else torch.from_numpy(kernel).to(p.device)
    call = lambda: serve_plan(p, xd, op=args.fft_op, kernel=kd)  # noqa: E731
    y, info = call()  # warmup
    _sync(p.device)
    t0 = time.perf_counter()
    for _ in range(args.fft_iters):
        y, info = call()
    _sync(p.device)
    dt = (time.perf_counter() - t0) / args.fft_iters
    y = y.cpu().numpy()
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
            ref = full[:, r0:r0 + max(shape[1], kshape[0]),
                       c0:c0 + max(shape[2], kshape[1])]
        else:
            ref = np.stack([np.convolve(r, kernel, "same") for r in x])
    elif args.fft_op == "correlate":
        ref = np.stack([np.correlate(r, kernel, "same") for r in x])
    elif args.fft_op == "spectrum":
        ref = np.abs(fwd(x)) ** 2 / nfft
    else:
        ref = fwd(x)
    err = np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30)
    print(f"{args.fft_op} batch={args.batch} N={size_tag} {info} "
          f"{dt*1e3:.2f}ms/req rel_err={err:.2e}")


def _request_ref(x: np.ndarray, kw: dict, nfft: int) -> np.ndarray:
    """What the runtime must return for a self-test request: the
    transform of ``x`` zero-padded to its bucket's ``nfft`` points."""
    if kw.get("real"):
        return np.fft.rfft(x, nfft)
    y = np.fft.fft(x, nfft)
    return np.abs(y) ** 2 / nfft if kw["op"] == "spectrum" else y


def _main_serve(args):
    """Multi-tenant serving worker (``--mode serve``): stand up a
    :class:`~repro_torch.serve.ServeRuntime` on the device, drive it with a
    short mixed-tenant self-test workload, check every result against
    numpy's transform of its zero-padded request (``rel_err``: the worst
    max|y - ref| / max|ref|) and print the per-bucket telemetry."""
    import json

    from repro_torch.serve import RuntimeConfig, ServeRuntime

    if args.fft_spec:
        apply_fft_spec_arg(args, args.fft_spec)
    _local_args(args)
    cfg = RuntimeConfig(
        max_batch=args.serve_max_batch, deadline_ms=args.serve_deadline_ms,
        queue_depth=args.serve_queue_depth, workers=args.serve_workers,
        timeout_ms=args.serve_timeout_ms, device=args.device)
    rng = np.random.default_rng(0)
    n = args.fft_n
    t0 = time.time()
    with ServeRuntime(cfg) as rt:
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
            err = max(err, float(np.abs(y - ref).max()
                                 / (np.abs(ref).max() + 1e-30)))
        stats = rt.stats()
    dt = time.time() - t0
    print(f"# served {len(sent)} requests in {dt:.2f}s "
          f"({len(sent) / dt:.0f} rps) on {rt.device}")
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
                    help="multidim mesh decomposition (auto on one device)")
    ap.add_argument("--fft-rows", type=int, default=256,
                    help="grid rows for --fft-dims 2")
    ap.add_argument("--fft-cols", type=int, default=256,
                    help="grid cols for --fft-dims 2")
    ap.add_argument("--fft-kernel-n", type=int, default=63,
                    help="kernel length for convolve/correlate")
    ap.add_argument("--fft-groups", type=int, default=None,
                    help="ABFT checksum groups of the mesh path")
    ap.add_argument("--fft-threshold", type=float, default=1e-4,
                    help="ABFT detection threshold")
    ap.add_argument("--fft-chunks", type=_parse_chunks, default=1,
                    help="multi-transaction overlap of the sharded FFT's "
                         "all-to-alls (one device: 1)")
    ap.add_argument("--fft-spec", default=None,
                    help="consolidated plan description, e.g. "
                         "'n=65536,batch=8,ft=1' (keys: "
                         + ", ".join(sorted(SPEC_KEYS)) + "); overrides "
                         "the individual --fft-* flags — the worker builds "
                         "ONE FFTPlan from it at startup")
    ap.add_argument("--fft-iters", type=int, default=5)
    ap.add_argument("--serve-workers", type=int, default=2,
                    help="serve mode: executor worker threads, each on its "
                         "own CUDA stream")
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
                    help="FFT mode: run the fused two-side ABFT online")
    ap.add_argument("--ft-threshold", type=float, default=1e-3,
                    help="LM-mode ABFT detection threshold")
    args = ap.parse_args(argv)

    if args.mode == "fft":
        _main_fft(args)
        return
    if args.mode == "serve":
        _main_serve(args)
        return
    raise NotImplementedError(
        f"--mode lm (batched decode of {args.arch}) needs attention, the "
        f"transformer and the model: {ITEM_9}")


if __name__ == "__main__":
    main()
