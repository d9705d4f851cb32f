"""Request-description front of the serving stack: one request geometry ->
the :class:`~repro_torch.core.fft.api.FFTSpec` its plan is built from, plus
the single-batch executor (:func:`serve_plan`) and the consolidated
``--fft-spec`` string parser.

This is the layer ``launch.serve`` (the CLI) and ``repro_torch.serve.runtime``
(the multi-tenant scheduler) share: the CLI builds ONE plan per worker from
it; the runtime builds one plan per *bucket* from it.

On a mesh (a ``DeviceMesh`` with an ``fft`` dimension of more than one
rank) the spec is the sharded one: the pencil's digit order, ``chunks``
transactions, the rank-2 ``decomp``, the grouped ABFT. Every rank of the
mesh builds the same spec and calls :func:`serve_plan` together, since its
executors run collectives; a sharded result is the plan's ``DTensor``
(:func:`repro_torch.serve.mesh.assemble` brings its global value to one
rank). A local plan's telemetry reports ``shards`` and ``data`` 1, as the
reference's local plans do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plan import dtype_name
from repro_torch.serve.bucketing import mesh_shards

__all__ = ["build_fft_spec", "serve_plan", "apply_fft_spec_arg",
           "SPEC_KEYS"]


def build_fft_spec(shape, *, mesh=None, op: str = "fft",
                   kernel_shape=None, dims: int | None = None,
                   decomp: str = "auto", ft: bool = False,
                   threshold: float = 1e-4, groups: int | None = None,
                   group_size: int | None = None,
                   recompute_uncorrectable: bool = True,
                   natural_order: bool | None = None,
                   dtype="complex64", real: bool = False,
                   chunks: int = 1, device: str = "cuda"):
    """Resolve one serving request description into the
    :class:`~repro_torch.core.fft.api.FFTSpec` its plan is built from, on
    ``device``.

    ``shape`` is the request batch shape — ``(B, N)`` for 1-D, ``(B, R,
    C)`` for 2-D. For ``op="convolve"``/``"correlate"`` the spec describes
    the PADDED transform the spectral pipeline actually runs (last axes
    padded to a power of two covering the linear result, and on a mesh to
    the least pencil size), so one plan serves every request of that
    operand geometry. ``natural_order=None`` resolves the per-op default:
    the order-agnostic periodogram stays transposed on a mesh (the digit
    restore is pure waste for ``|X|^2``), everything else is natural.

    ``real=True`` declares real-valued request traffic: ``op="fft"``
    serves the half-spectrum ``rfft``/``rfft2`` executors, ``op="spectrum"``
    the one-sided periodogram, and convolve/correlate ride the packed real
    pipelines. Real plans are natural-order only. ``chunks`` (0 = auto) is
    the sharded FFT's transaction count; a local plan runs one.
    """
    from repro_torch.core.fft import api, multidim, spectral

    dims = dims if dims is not None else max(1, len(shape) - 1)
    if dims not in (1, 2):
        raise ValueError(f"dims must be 1 or 2, got {dims}")
    if op not in ("fft", "convolve", "correlate", "spectrum"):
        raise ValueError(f"op must be fft|convolve|correlate|spectrum, "
                         f"got {op!r}")
    if op == "correlate" and dims == 2:
        raise ValueError("op='correlate' is 1-D only; dims=2 serves "
                         "fft|convolve|spectrum")
    if len(shape) != dims + 1:
        raise ValueError(f"dims={dims} expects a (batch, ...) shape with "
                         f"{dims} transform axes, got {tuple(shape)}")
    if real and natural_order is False:
        raise ValueError("real serve traffic is natural-order only — the "
                         "half spectrum indexes bins by k (drop "
                         "transposed=1 or real=1)")
    shards = mesh_shards(mesh)
    sharded = shards > 1
    ft_cfg = None
    if ft and op == "fft":
        ft_cfg = api.FTConfig(threshold=threshold, groups=groups,
                              group_size=group_size,
                              recompute_uncorrectable=recompute_uncorrectable)
    if op in ("convolve", "correlate"):
        if kernel_shape is None:
            raise ValueError(f"op={op!r} needs a kernel")
        if dims == 1:
            nfft = spectral._conv_nfft(shape[-1], kernel_shape[-1], shards)
            shape = tuple(shape[:-1]) + (nfft,)
        else:
            nr = max(spectral._next_pow2(shape[-2] + kernel_shape[-2] - 1),
                     shards)
            nc = max(spectral._next_pow2(shape[-1] + kernel_shape[-1] - 1),
                     shards)
            shape = tuple(shape[:-2]) + (nr, nc)
            if real and sharded \
                    and not multidim.rslab_feasible((nr, nc), shards):
                decomp = "auto"   # the composed real path covers the rest
            else:
                decomp = "slab" if sharded else "auto"
        natural_order = True
    elif natural_order is None:
        # the per-op order default of the legacy endpoint; real spectra
        # are one-sided (bins indexed by k) and so always natural
        natural_order = real or not (sharded and op == "spectrum")
    return api.FFTSpec(shape=tuple(int(s) for s in shape),
                       dtype=np.dtype(dtype_name(dtype)).name, rank=dims,
                       mesh=mesh, axis="fft",
                       decomp="auto" if dims == 1 else decomp,
                       natural_order=bool(natural_order), ft=ft_cfg,
                       real=bool(real), chunks=int(chunks),
                       device=str(device))


def _ft_verdict(res) -> dict:
    """The local fused-kernel ABFT telemetry of one ``ft_fft`` result:
    the worst group score, whether any group flagged, the located signal
    of the first flagged group (-1 if none) and the corrections applied.
    The verdict tensors come to the host in ONE copy (one wait for the
    device), not one per field."""
    g = res.flagged.numel()
    packed = torch.cat([res.group_score.double(), res.flagged.double(),
                        res.location.double(),
                        res.corrected.double().reshape(1)]).cpu().numpy()
    score, flagged, loc = packed[:g], packed[g:2 * g] > 0, packed[2 * g:3 * g]
    first = int(np.argmax(flagged)) if flagged.any() else -1
    return {"ft": True, "score": float(score.max()),
            "flagged": bool(flagged.any()),
            "location": int(loc[first]) if first >= 0 else -1,
            "corrected": int(packed[-1])}


def _ft_telemetry(plan, res) -> dict:
    """The sharded grouped ABFT's telemetry of one
    :class:`~repro_torch.core.fft.distributed.DistFFTResult` (the same on
    every rank): the group geometry, the worst score, the flagged group
    count, the located signal of each correctable group (a checksum-row
    or multi-fault verdict's location is no signal, and is left out), the
    corrections, the uncorrectable, checksum-fault and recomputed group
    counts and the worst left-check residual. The verdict comes to the
    host in ONE copy."""
    g = res.flagged.numel()
    parts = (res.group_score, res.flagged, res.location, res.correctable,
             res.checksum_fault, res.uncorrectable)
    packed = torch.cat([t.double().reshape(-1) for t in parts] + [
        res.shard_delta.double().reshape(-1).amax().reshape(1),
        res.corrected.double().reshape(1),
        res.recomputed.double().reshape(1)]).cpu().numpy()
    score, flagged, loc, ok, cs, unc = (packed[i * g:(i + 1) * g]
                                        for i in range(6))
    return {"ft": True, "groups": plan.groups,
            "group_size": plan.batch // plan.groups,
            "score": float(score.max()), "flagged": int((flagged > 0).sum()),
            "locations": [int(lo) for lo, c in zip(loc, ok) if c > 0],
            "corrected": int(packed[-2]),
            "uncorrectable": int((unc > 0).sum()),
            "checksum_faults": int((cs > 0).sum()),
            "recomputed": int(packed[-1]),
            "shard_delta_max": float(packed[6 * g])}


def serve_plan(plan, x, *, op: str = "fft", kernel=None, mode: str = "same",
               inject=None, bs: int | None = None):
    """Serve one batched request through a pre-built
    :class:`~repro_torch.core.fft.api.FFTPlan` — the hot path: every
    dispatch decision (mesh, decomposition, ABFT groups, digit order) was
    resolved when the plan was built, so this is a straight executor call
    plus telemetry assembly. ``inject`` (ft plans only, tests/benchmarks)
    is forwarded to the ABFT pipeline's SEU descriptor: the fused kernel's
    one 6-field row locally (``bs`` its tile size), the grouped ABFT's
    7-field rows on a mesh. Returns ``(y, info)``; ``y`` lies on the
    plan's device, a ``DTensor`` of the global result on a mesh.

    On a mesh every rank calls this with the same batch. A plain tensor
    ``x`` is the global batch, the same on every rank: each rank reads its
    own rows and columns of it with no collective, so only the plan's
    modelled collectives run (``plan.shard`` 's block layout would add the
    ingest all-to-all). A ``DTensor`` goes to the executors as placed."""
    info = {"shards": plan.shards, "data": plan.dsize, "op": op}
    if plan.chunks > 1:
        info["chunks"] = plan.chunks
    if plan.rank == 2:
        info["dims"] = 2
        info["decomp"] = plan.decomp
    if plan.spec.real:
        info["real"] = True
    transposed = (plan.sharded and not plan.spec.natural_order
                  and (plan.rank == 1 or plan.decomp == "pencil"))
    if op in ("convolve", "correlate"):
        if kernel is None:
            raise ValueError(f"op={op!r} needs a kernel")
        fn = plan.convolve if op == "convolve" else plan.correlate
        y = fn(x, kernel, mode=mode)
        info.update(order="natural",
                    collectives="2 a2a" if plan.sharded else "local")
        return y, info
    if op == "spectrum":
        y = plan.power_spectrum(x)
        info["order"] = "transposed" if transposed else "natural"
        return y, info
    if op != "fft":
        raise ValueError(f"op must be fft|convolve|correlate|spectrum, "
                         f"got {op!r}")
    if plan.spec.ft is not None:
        if not plan.sharded:
            res = plan.ft_fft(x, inject=inject, bs=bs)
            info.update(_ft_verdict(res))
            return res.y, info
        res = plan.ft_fft(x, inject=inject)
        info.update(_ft_telemetry(plan, res))
        return res.y, info
    y = plan.rfft(x) if plan.spec.real else plan.fft(x)
    info.update(ft=False)
    if plan.sharded:
        info["order"] = "transposed" if transposed else "natural"
    return y, info


def _parse_chunks(v: str) -> int:
    """``chunks=`` values: a transaction count, or ``auto`` (-> 0, the
    plan-resolved choice from the collective-volume model)."""
    if v.strip().lower() == "auto":
        return 0
    c = int(v)
    if c < 0:
        raise ValueError(f"chunks must be >= 0 (0 = auto), got {c}")
    return c


SPEC_KEYS = {
    # --fft-spec "k=v,..." keys -> (argparse dest, parser)
    "n": ("fft_n", int), "batch": ("batch", int),
    "shards": ("fft_shards", int), "data": ("fft_data", int),
    "dims": ("fft_dims", int), "rows": ("fft_rows", int),
    "cols": ("fft_cols", int), "op": ("fft_op", str),
    "decomp": ("fft_decomp", str), "ft": ("ft", None),
    "groups": ("fft_groups", int), "kernel_n": ("fft_kernel_n", int),
    "transposed": ("transposed", None), "threshold": ("fft_threshold", float),
    "real": ("fft_real", None), "chunks": ("fft_chunks", _parse_chunks),
    # serving-runtime keys (--serve-* flag dests): one string describes the
    # whole multi-tenant worker — plan geometry AND scheduler policy
    "workers": ("serve_workers", int),
    "max_batch": ("serve_max_batch", int),
    "deadline_ms": ("serve_deadline_ms", float),
    "queue": ("serve_queue_depth", int),
    "timeout_ms": ("serve_timeout_ms", float),
}


def _parse_bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "on", ""):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"expected a boolean, got {v!r}")


def apply_fft_spec_arg(args, s: str):
    """Apply a consolidated ``--fft-spec "n=65536,batch=8,shards=4,ft=1"``
    string onto the parsed args — one flag describing the whole worker
    plan (and, with the ``workers``/``max_batch``/``deadline_ms``/
    ``queue``/``timeout_ms`` keys, the serving runtime's scheduler policy);
    the individual ``--fft-*`` / ``--serve-*`` flags remain as sugar and
    provide the defaults the spec string overrides.

    The string is validated strictly: an empty segment (a stray comma, as
    in ``"n=8,,n=16"``) and a repeated key both raise ``ValueError`` naming
    the offending segment — a worker must not start from a plan description
    that silently dropped or last-won half of what the operator wrote."""
    seen: set[str] = set()
    for pos, item in enumerate(s.split(","), 1):
        item = item.strip()
        if not item:
            raise ValueError(
                f"--fft-spec: empty segment at position {pos} of {s!r} — "
                f"drop the stray comma")
        k, _, v = item.partition("=")
        k = k.strip()
        if k not in SPEC_KEYS:
            raise SystemExit(
                f"--fft-spec: unknown key {k!r} (valid: "
                f"{', '.join(sorted(SPEC_KEYS))})")
        if k in seen:
            raise ValueError(
                f"--fft-spec: duplicate key {k!r} (segment {pos}: {item!r} "
                f"in {s!r}) — each key may appear once; last-wins would "
                f"silently mask which value the worker plans with")
        seen.add(k)
        dest, parse = SPEC_KEYS[k]
        setattr(args, dest, _parse_bool(v) if parse is None else parse(v))
    return args
