"""Request-description front of the serving stack: one request geometry ->
the :class:`~repro_torch.core.fft.api.FFTSpec` its plan is built from, plus
the single-batch executor (:func:`serve_plan`) and the consolidated
``--fft-spec`` string parser.

This is the layer ``launch.serve`` (the CLI) and ``repro_torch.serve.runtime``
(the multi-tenant scheduler) share: the CLI builds ONE plan per worker from
it; the runtime builds one plan per *bucket* from it.

The port's plans are local: a mesh with more than one shard, ``chunks >
1``, a ``decomp`` other than ``auto`` and ``natural_order=False`` (the
transposed digit order of the pencil) raise ``NotImplementedError`` naming
ROADMAP queue 1 item 10.4 (serving over a mesh). A local plan's telemetry
reports ``shards`` and ``data`` 1, as the reference's local plans do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plan import dtype_name
from repro_torch.serve.bucketing import ITEM_10_4, mesh_shards

__all__ = ["build_fft_spec", "serve_plan", "apply_fft_spec_arg",
           "SPEC_KEYS"]

# a local plan: one shard on the fft axis, one on the data axis
_LOCAL = {"shards": 1, "data": 1}


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
    padded to a power of two covering the linear result), so one plan
    serves every request of that operand geometry. ``real=True`` declares
    real-valued request traffic: ``op="fft"`` serves the half-spectrum
    ``rfft``/``rfft2`` executors, ``op="spectrum"`` the one-sided
    periodogram, and convolve/correlate ride the packed real pipelines.
    ``chunks`` 0 (auto) and 1 both resolve to one transaction locally.
    """
    from repro_torch.core.fft import api, spectral

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
    mesh_shards(mesh)
    if chunks > 1:
        raise NotImplementedError(
            f"chunks={chunks} splits the batch into all-to-all "
            f"transactions of the sharded FFT: {ITEM_10_4}")
    if decomp != "auto":
        raise NotImplementedError(
            f"decomp={decomp!r} chooses a mesh decomposition: {ITEM_10_4}")
    if natural_order is False:
        raise NotImplementedError(
            f"natural_order=False (the pencil's transposed digit order) is "
            f"a mesh layout: {ITEM_10_4}")
    ft_cfg = None
    if ft and op == "fft":
        ft_cfg = api.FTConfig(threshold=threshold, groups=groups,
                              group_size=group_size,
                              recompute_uncorrectable=recompute_uncorrectable)
    if op in ("convolve", "correlate"):
        if kernel_shape is None:
            raise ValueError(f"op={op!r} needs a kernel")
        if dims == 1:
            nfft = spectral._conv_nfft(shape[-1], kernel_shape[-1])
            shape = tuple(shape[:-1]) + (nfft,)
        else:
            nr = spectral._next_pow2(shape[-2] + kernel_shape[-2] - 1)
            nc = spectral._next_pow2(shape[-1] + kernel_shape[-1] - 1)
            shape = tuple(shape[:-2]) + (nr, nc)
    return api.FFTSpec(shape=tuple(int(s) for s in shape),
                       dtype=np.dtype(dtype_name(dtype)).name, rank=dims,
                       ft=ft_cfg, real=bool(real), device=str(device))


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


def serve_plan(plan, x, *, op: str = "fft", kernel=None, mode: str = "same",
               inject=None, bs: int | None = None):
    """Serve one batched request through a pre-built
    :class:`~repro_torch.core.fft.api.FFTPlan` — the hot path: every
    dispatch decision (decomposition, ABFT geometry) was resolved when the
    plan was built, so this is a straight executor call plus telemetry
    assembly. ``inject`` (ft plans only, tests/benchmarks) is forwarded to
    the fused ABFT kernel's SEU descriptor, and ``bs`` to its tile size.
    Returns ``(y, info)``; ``y`` lies on the plan's device."""
    info = {**_LOCAL, "op": op}
    if plan.rank == 2:
        info["dims"] = 2
        info["decomp"] = plan.decomp
    if plan.spec.real:
        info["real"] = True
    if op in ("convolve", "correlate"):
        if kernel is None:
            raise ValueError(f"op={op!r} needs a kernel")
        fn = plan.convolve if op == "convolve" else plan.correlate
        y = fn(x, kernel, mode=mode)
        info.update(order="natural", collectives="local")
        return y, info
    if op == "spectrum":
        y = plan.power_spectrum(x)
        info["order"] = "natural"
        return y, info
    if op != "fft":
        raise ValueError(f"op must be fft|convolve|correlate|spectrum, "
                         f"got {op!r}")
    if plan.spec.ft is not None:
        res = plan.ft_fft(x, inject=inject, bs=bs)
        info.update(_ft_verdict(res))
        return res.y, info
    y = plan.rfft(x) if plan.spec.real else plan.fft(x)
    info.update(ft=False)
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
    """Apply a consolidated ``--fft-spec "n=65536,batch=8,ft=1"`` string
    onto the parsed args — one flag describing the whole worker plan (and,
    with the ``workers``/``max_batch``/``deadline_ms``/``queue``/
    ``timeout_ms`` keys, the serving runtime's scheduler policy); the
    individual ``--fft-*`` / ``--serve-*`` flags remain as sugar and
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
