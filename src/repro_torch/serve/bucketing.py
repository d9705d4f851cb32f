"""Spec bucketer: map incoming request geometries onto a small set of
padded canonical :class:`~repro_torch.core.fft.api.FFTSpec` buckets.

Plans are shape-specialized (``cufftPlanMany`` semantics), so serving raw
request sizes would build one plan per distinct ``n`` and thrash the shared
plan LRU. The bucketer instead rounds every transform axis up to the next
power of two and then applies the same round-up trick the real slab uses
for its ``C/2 + D`` half-spectrum transpose: pad until the mesh divides the
axis (pencil feasibility ``n >= shards^2``; ``n/2 >= shards^2`` for packed
real pencils), so every bucket's plan is mesh-feasible by construction.
A handful of buckets then absorbs the whole request distribution and the
plan cache stays hot.

Padded serving semantics: a request of ``n_req`` points served from an
``n``-point bucket receives the ``n``-point transform of its zero-padded
signal (``np.fft.fft(x, n)`` — trailing-zero extension, the standard
spectral-interpolation contract). Power-of-two requests on a feasible mesh
map to themselves (zero padding). The per-bucket padded-element waste is
recorded in telemetry (``pad_waste``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.fft.spectral import _next_pow2 as next_pow2
from repro_torch.core.plan import dtype_name

__all__ = ["BucketKey", "SpecBucketer", "pad_transform_shape", "next_pow2",
           "BATCHABLE_OPS"]

# ops the scheduler can coalesce: every request in a batch runs the same
# executor with no per-request operands beyond the signal itself.
# convolve/correlate carry per-request kernels and are served unbatched
# through serve_plan (admission rejects them with a pointer there).
BATCHABLE_OPS = ("fft", "spectrum")


def mesh_shards(mesh) -> int:
    """Ranks along a mesh's ``fft`` dimension (1 without a mesh or
    without that dimension): a ``DeviceMesh``, or any object with a
    ``shape`` mapping of dimension names to sizes."""
    if mesh is None:
        return 1
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "fft" in names:
        return int(mesh.size(names.index("fft")))
    return int(dict(getattr(mesh, "shape", {})).get("fft", 1))


def pad_transform_shape(tshape, *, shards: int = 1,
                        real: bool = False) -> tuple[int, ...]:
    """Canonical (padded) transform shape for a requested ``tshape``.

    Every axis rounds up to the next power of two; the last axis is
    additionally rounded up until the pencil digit split is feasible over
    ``shards`` devices (``n >= shards**2``; packed real pencils transform
    the half-length signal, so ``n/2 >= shards**2``) — the same
    round-up-until-the-mesh-divides logic as the half-spectrum ``C/2 + D``
    column padding. Power-of-two shard counts keep divisibility implied by
    the power-of-two rounding.
    """
    if not tshape or any(int(s) <= 0 for s in tshape):
        raise ValueError(f"transform shape must be positive, got {tshape!r}")
    padded = [next_pow2(int(s)) for s in tshape]
    if shards > 1:
        floor = shards * shards * (2 if real and len(tshape) == 1 else 1)
        padded[-1] = max(padded[-1], next_pow2(floor))
        if len(tshape) >= 2:
            # slab feasibility: shards must divide the first grid axis too
            padded[0] = max(padded[0], shards)
    return tuple(padded)


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Hashable identity of one serving bucket: the canonical transform
    the bucket's plan is built for. Two requests with the same key share a
    plan, a batch queue, and a telemetry row."""

    tshape: tuple[int, ...]      # canonical (padded) transform axes
    rank: int
    dtype: str                   # canonical complex dtype of the plan
    op: str                      # "fft" | "spectrum"
    real: bool
    ft: bool

    @property
    def label(self) -> str:
        """Short stable name for telemetry tables / logs."""
        size = "x".join(str(s) for s in self.tshape)
        tags = [self.op, size, self.dtype.replace("complex", "c")]
        if self.real:
            tags.append("real")
        if self.ft:
            tags.append("ft")
        return ":".join(tags)


class SpecBucketer:
    """Maps request geometries to :class:`BucketKey`\\ s and builds each
    bucket's :class:`~repro_torch.core.fft.api.FFTSpec` on ``device``.

    The bucketer is pure policy — it holds no queues and no plans (the
    runtime owns those); it only decides *which* canonical transform a
    request is served from and how much padding that costs.
    """

    def __init__(self, *, mesh=None, max_batch: int = 8, chunks: int = 1,
                 device: str = "cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.mesh = mesh
        self.max_batch = int(max_batch)
        self.chunks = int(chunks)
        self.shards = mesh_shards(mesh)
        self.device = device

    # -- request -> bucket -------------------------------------------------

    def key_for(self, shape, dtype, *, op: str = "fft",
                real: bool = False, ft: bool = False) -> BucketKey:
        """Bucket for one request signal of ``shape`` (a single signal —
        ``(n,)`` or ``(r, c)`` — not a batch) and ``dtype`` (a numpy or
        torch dtype)."""
        if op not in BATCHABLE_OPS:
            raise ValueError(
                f"the scheduler buckets op in {BATCHABLE_OPS} (shared "
                f"executor, no per-request operands); got {op!r} — serve "
                f"convolve/correlate unbatched through serve_plan")
        if ft and op != "fft":
            raise ValueError(
                f"ABFT protection covers op='fft' (the grouped two-side "
                f"pipeline); got ft=True with op={op!r}")
        rank = len(tuple(shape))
        if rank not in (1, 2):
            raise ValueError(f"requests are single signals — (n,) or "
                             f"(r, c) — got shape {tuple(shape)}")
        dt = np.dtype(dtype_name(dtype))
        if real and np.issubdtype(dt, np.complexfloating):
            raise ValueError(f"real=True buckets take real signals, "
                             f"got {dt.name}")
        # canonical complex dtype of the plan (spec_for's coercion rules:
        # real f64 keeps complex128, everything narrow plans complex64)
        if np.issubdtype(dt, np.complexfloating):
            cdt = dt.name
        else:
            cdt = "complex128" if (real and dt == np.float64) \
                else "complex64"
        tshape = pad_transform_shape(tuple(shape), shards=self.shards,
                                     real=real)
        return BucketKey(tshape=tshape, rank=rank, dtype=cdt, op=op,
                         real=bool(real), ft=bool(ft))

    def pad_elems(self, key: BucketKey, shape) -> int:
        """Padded elements this request wastes in its bucket slot."""
        return int(np.prod(key.tshape, dtype=np.int64)
                   - np.prod(tuple(shape), dtype=np.int64))

    # -- bucket -> spec ----------------------------------------------------

    def spec_for(self, key: BucketKey, *, ft_config=None):
        """The bucket's batched :class:`~repro_torch.core.fft.api.FFTSpec`:
        ``(max_batch, *tshape)``, one plan per bucket. ``ft_config`` (an
        :class:`~repro_torch.core.plan.FTConfig`) attaches the ABFT
        pipeline to ``ft=True`` buckets; non-ft buckets ignore it."""
        from repro_torch.serve.specs import build_fft_spec

        if key.ft and ft_config is None:
            raise ValueError(f"bucket {key.label} is ft=True — the runtime "
                             f"must supply its FTConfig at admission")
        kw = {}
        if key.ft:
            kw = dict(ft=True, threshold=ft_config.threshold,
                      groups=ft_config.groups,
                      group_size=ft_config.group_size,
                      recompute_uncorrectable=
                      ft_config.recompute_uncorrectable)
        return build_fft_spec(
            (self.max_batch,) + key.tshape, mesh=self.mesh, op=key.op,
            dims=key.rank, dtype=key.dtype, real=key.real,
            chunks=self.chunks, device=self.device, **kw)
