"""Mesh-sharded 1-D FFT on ``torch.distributed``: the paper's kernel-level
N1 x N2 decomposition lifted from one device to a device mesh (the pencil
decomposition).

The port of ``repro.core.fft.distributed``'s plain transform. A
``torch.distributed.device_mesh.DeviceMesh`` with an ``fft`` dimension
(and optionally a ``data`` one) takes the place of the JAX mesh; every rank
runs the pipeline on plain local tensors and the collectives are explicit
``dist.all_to_all_single`` / ``dist.all_gather_into_tensor`` calls on the
mesh's ``fft`` process group. Results come back as ``DTensor`` s with the
placements of ``repro_torch.parallel.fft_sharding``.

Forward, ``x`` (B, N) viewed as (B, N1, N2), n = N2*n1 + n2, each rank
holding the columns n2 of its block (a pencil):

    pass 1  : block FFT over n1 of the shard's N2/D columns — ONE launch
              that reads the columns strided, applies the twiddle
              w_N^(k1 * n2) of each global column on the way out and
              writes straight into the all-to-all's send buffer
    exchange: ONE all-to-all splitting k1, gathering n2
    pass 2  : block FFT over n2 (one launch, or the local multi-pass
              transform when N2 > 8192) after a receive-side relayout
    output  : Z[k1, k2] = X[k1 + N1*k2], sharded over k1

``natural_order=True`` all-gathers Z over ``fft`` and permutes it to
natural order (replicated over ``fft``); ``natural_order=False`` returns
the FFTW-MPI transposed order ``y[k1*N2 + k2] = X[k1 + N1*k2]``, block
sharded over ``fft`` at no extra collective. The TRANSPOSED_IN inverse
consumes that order: pass A (inverse over k2 with the conjugate twiddle of
the shard's global k1 rows, written into the send buffer), ONE all-to-all
that splits the BATCH, pass B (inverse over k1) — natural-order output,
each signal whole on one rank, so a round trip needs no all-gather.

The per-shard steps (:class:`Pencil`, each pass a :class:`Launch` that a
check can also run on the kernel's plain version) touch no collective, and
the pipelines reach the collectives only through the rank's exchange
(``_Mesh``), so the same loops run D shards in one process with a tensor
permute in place of the collectives. The volume models (:func:`collective_volume`,
:func:`spectral_volume`) and the split rule (:func:`make_dist_plan`) are
the reference's arithmetic, copied.

Input contract of the mesh entry points: a ``DTensor`` is brought to the
pencil layout — a block-sharded one (``Shard(-1)`` over ``fft``, the
:func:`~repro_torch.parallel.fft_sharding.shard_signals` layout) costs ONE
ingest all-to-all, which :func:`collective_volume` does not count, and any
other placement is redistributed first; a plain tensor is the global
value, the same on every rank, and each rank reads its pencil straight
from it with no collective.
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.fft.plan import PassLayout, axis_layout, make_plan

__all__ = [
    "DistPlan", "make_dist_plan", "distributed_fft", "distributed_ifft",
    "resolve_abft_groups", "resolve_chunks", "choose_chunks",
    "collective_volume", "spectral_volume", "FFT_AXIS", "DATA_AXIS",
    "Pencil", "Launch",
]

# Same guard value as the reference's core.abft.encoding.EPS.
EPS = 1e-30

# Canonical mesh-dimension name of the signal (pencil) dimension; see
# launch.mesh.make_fft_mesh and kernels.ops auto-dispatch.
FFT_AXIS = "fft"

# Canonical mesh-dimension name of the batch dimension of a 2-D
# batch x pencil mesh (make_fft_mesh(shards, data)); auto-detected.
DATA_AXIS = "data"

# Sentinel: auto-detect DATA_AXIS on the mesh. Pass ``data_axis=None`` to
# force batch replication even when the mesh carries a data dimension.
_AUTO = "auto"

# Correctability gate on the two-side id decode of the sharded ABFT (ROADMAP
# queue 1 item 10.2): a single fault sits at the noise floor, two faults
# with distinct ids in one group at >= 0.04.
ID_VAR_TOL = 0.04

_ITEM_10_2 = ("ROADMAP queue 1 item 10.2 (the sharded two-side ABFT on "
              "torch.distributed)")
_ITEM_10_3 = ("ROADMAP queue 1 item 10.3 (the slab and pencil n-D mesh "
              "paths, the spectral consumers and serving over a mesh)")


def mesh_size(mesh, axis: str) -> int:
    """The size of ``mesh`` along its dimension named ``axis``."""
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def mesh_axes(mesh) -> tuple[str, ...]:
    """The dimension names of ``mesh`` (empty when it has none)."""
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def _resolve_data_axis(mesh, data_axis):
    """The batch mesh dimension to use, or None (batch replicated).

    ``_AUTO`` picks ``DATA_AXIS`` iff the mesh carries it with size > 1; an
    explicit name is validated; ``None`` disables batch sharding.
    """
    if data_axis is None:
        return None
    if data_axis == _AUTO:
        if DATA_AXIS in mesh_axes(mesh) and mesh_size(mesh, DATA_AXIS) > 1:
            return DATA_AXIS
        return None
    if data_axis not in mesh_axes(mesh):
        raise ValueError(f"mesh {mesh_axes(mesh)} has no '{data_axis}' axis")
    return data_axis if mesh_size(mesh, data_axis) > 1 else None


def _resolve_mesh(mesh, axis: str):
    if mesh is None:
        return None
    if axis not in mesh_axes(mesh):
        raise ValueError(f"mesh {mesh_axes(mesh)} has no '{axis}' axis")
    return mesh


def resolve_chunks(rows: int, chunks: int, *, granule: int = 1) -> int:
    """The largest feasible transaction count <= ``chunks`` for ``rows``.

    A chunked pipeline splits its per-shard rows into ``chunks`` equal
    transactions so transaction i's all-to-all overlaps transaction i+1's
    local passes — the mesh-level analogue of the paper's
    multi-transaction threadblock design. Every transaction carries the
    same whole number of rows, a multiple of ``granule``.
    """
    c = max(1, min(int(chunks), int(rows) if rows else 1))
    while c > 1 and (rows % c or (rows // c) % max(granule, 1)):
        c -= 1
    return c


# Per-transaction fixed cost of one all-to-all, in payload-equivalent bytes:
# splitting into C chunks exposes ~ C*L + bytes/C of communication,
# minimized at C* = sqrt(bytes / L).
CHUNK_LATENCY_BYTES = 1 << 16


def choose_chunks(a2a_bytes: float, rows: int, *, granule: int = 1,
                  max_chunks: int = 8) -> int:
    """Auto transaction count from the collective-volume model: the power
    of two nearest below ``C* = sqrt(a2a_bytes / CHUNK_LATENCY_BYTES)``,
    capped at ``max_chunks``, clamped to what ``rows`` can carry."""
    c_star = int(np.sqrt(max(float(a2a_bytes), 0.0) / CHUNK_LATENCY_BYTES))
    c = 1
    while c * 2 <= min(c_star, max_chunks):
        c *= 2
    return resolve_chunks(rows, c, granule=granule)


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Distributed split of an N-point FFT over ``shards`` devices.

    ``n1`` is the distributed (pass-1) factor — FFT'd while columns are
    locally resident; ``n2 = N / n1`` is the tail executed after the
    all-to-all (itself multi-pass locally when n2 > 8192).
    """

    n: int
    n1: int
    n2: int
    shards: int
    axis: str = FFT_AXIS

    @property
    def local_in(self) -> tuple[int, int]:
        return (self.n1, self.n2 // self.shards)

    @property
    def local_out(self) -> tuple[int, int]:
        return (self.n1 // self.shards, self.n2)


def make_dist_plan(n: int, shards: int, axis: str = FFT_AXIS) -> DistPlan:
    """Choose the (n1, n2) pencil split for ``shards`` devices.

    Starts from ``make_plan(n).kernel_factors`` (the paper's HBM-pass split)
    and shifts powers of two between the sides until both are divisible by
    ``shards`` — the all-to-all needs shards | n1 and the input sharding
    needs shards | n2.
    """
    if n <= 0 or n & (n - 1):
        raise ValueError(f"N must be a power of two, got {n}")
    if shards & (shards - 1):
        raise ValueError(f"shard count must be a power of two, got {shards}")
    if n < shards * shards:
        raise ValueError(
            f"N={n} too small for a {shards}-way pencil split "
            f"(need N >= shards^2)")
    facs = make_plan(n).kernel_factors
    if len(facs) > 1:
        n1 = facs[0]
    else:
        n1 = 1 << ((n.bit_length() - 1 + 1) // 2)  # balanced split
    n2 = n // n1
    while n1 % shards and n2 > shards:
        n1 *= 2
        n2 //= 2
    while n2 % shards and n1 > shards:
        n1 //= 2
        n2 *= 2
    if n1 % shards or n2 % shards:
        raise ValueError(f"n={n} has no n1*n2 split with both factors "
                         f"divisible by shards={shards} "
                         f"(closest: {n1}x{n2})")
    return DistPlan(n=n, n1=n1, n2=n2, shards=shards, axis=axis)


def resolve_abft_groups(batch: int, *, groups: int | None = None,
                        group_size: int | None = None,
                        data_shards: int = 1) -> int:
    """The checksum group count G for a ``batch``-signal ft transform.

    Explicit ``groups`` wins, else ``group_size`` (G = batch/group_size),
    else auto: one group per data shard when the batch divides, 1
    otherwise. G must divide the batch; on a sharded batch ``data_shards``
    must divide G. A batch that does not divide over ``data_shards``
    replicates, so the data-axis constraint is waived.
    """
    if data_shards > 1 and batch % data_shards:
        data_shards = 1  # batch replicates; groups owe the axis nothing
    if groups is not None and group_size is not None \
            and groups * group_size != batch:
        raise ValueError(f"groups={groups} x group_size={group_size} "
                         f"!= batch={batch}")
    if groups is None:
        if group_size is not None:
            if group_size <= 0 or batch % group_size:
                raise ValueError(
                    f"group_size={group_size} must divide batch={batch}")
            groups = batch // group_size
        else:
            groups = data_shards if (
                data_shards > 1 and batch % data_shards == 0) else 1
    if groups <= 0 or batch % groups:
        raise ValueError(f"groups={groups} must divide batch={batch}")
    if data_shards > 1 and groups % data_shards:
        raise ValueError(
            f"groups={groups} must be a multiple of the data-axis size "
            f"{data_shards} so each data shard owns whole groups "
            f"(or disable batch sharding with data_axis=None)")
    return groups


# ---------------------------------------------------------------------------
# the per-shard steps (no collective)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Source:
    """Where a pass reads its rows: ``flat[base + row*row_stride +
    point*point_stride + col]`` for the rows, points and (stride-1)
    columns of its signals, ``flat`` a contiguous 1-D view."""

    flat: torch.Tensor
    base: int
    row_stride: int
    point_stride: int

    def at(self, row0: int) -> "Source":
        return dataclasses.replace(self, base=self.base
                                   + row0 * self.row_stride)


@dataclasses.dataclass(frozen=True, eq=False)
class Launch:
    """One :func:`~repro_torch.kernels.stockham.block_fft` launch of a
    pencil step, every argument but the tensors. ``launch(x, out)`` runs
    the kernel (its plain version on a CPU tensor); ``launch(x, out,
    plain=True)`` runs the plain version on the same arguments, which is
    what a check on the card holds the kernel to."""

    stages: tuple
    tables: torch.Tensor
    layout: PassLayout
    inverse: bool
    scale: float = 1.0
    twiddle: torch.Tensor | None = None
    m: int | None = None
    offset: int = 0
    mid_step: int = 0

    def __call__(self, x: torch.Tensor, out: torch.Tensor, *,
                 plain: bool = False) -> torch.Tensor:
        from repro_torch.kernels.stockham import block_fft, block_fft_plain

        kw = dict(inverse=self.inverse, scale=self.scale, layout=self.layout,
                  twiddle=self.twiddle, m=self.m, offset=self.offset,
                  mid_step=self.mid_step, out=out)
        if plain:
            return block_fft_plain(x, self.stages, **kw)
        return block_fft(x, self.stages, tables=self.tables, **kw)


class Pencil:
    """The per-shard steps of one N-point transform pencil-split over
    ``shards`` ranks, with its stage and twiddle tables on ``device``.

    Each step is one :class:`Launch` a pass (its ``*_launch(es)`` method
    gives them) and at most a torch copy; none is a collective.
    ``launches`` is the launch count of one transaction in either
    direction: pass 1 (pass B) and a launch a pass of the N2 tail
    (``ax2``, the local transform over n2).
    """

    def __init__(self, n: int, shards: int, dtype: torch.dtype, device):
        from repro_torch.kernels.ops import axis_fft
        from repro_torch.kernels.stockham import (pass_twiddle_table,
                                                  stage_tables)

        split = make_dist_plan(n, shards)
        self.n, self.shards = n, shards
        self.dtype, self.device = dtype, device
        self.n1, self.n2 = split.n1, split.n2
        self.n1l, self.n2l = self.n1 // shards, self.n2 // shards
        p1 = make_plan(self.n1)
        if p1.num_passes != 1:
            raise ValueError(f"pass 1 over n1={self.n1} is not one launch")
        self.stages1 = p1.stages[0]
        self.tables1 = {inv: stage_tables(self.stages1, dtype, inverse=inv,
                                          device=device)
                        for inv in (False, True)}
        self.ax2 = axis_fft(self.n2, dtype, device)
        self.twiddle = {inv: pass_twiddle_table(n, dtype, inverse=inv,
                                                device=device)
                        for inv in (False, True)}

    @property
    def launches(self) -> int:
        return 1 + self.ax2.plan.num_passes

    # -- forward (and natural-order inverse) ------------------------------

    def pass1_launch(self, src: Source, rows: int, rank: int, *,
                     inverse: bool) -> Launch:
        """Pass 1 of ``rows`` signals on shard ``rank``: the FFT over n1 of
        its N2/D columns read from ``src`` (from ``src.flat[src.base:]``),
        times the twiddle w_N^(k1 * (rank*N2/D + column)) (and 1/N on the
        inverse), written in the all-to-all's (D, N1/D, rows, N2/D)
        order."""
        n2l = self.n2l
        layout = PassLayout(((rows, src.row_stride, n2l), (n2l, 1, 1)),
                            src.point_stride, rows * n2l)
        return Launch(self.stages1, self.tables1[inverse], layout, inverse,
                      1.0 / self.n if inverse else 1.0,
                      self.twiddle[inverse], self.n, rank * n2l)

    def pass1(self, src: Source, rows: int, rank: int, *, inverse: bool,
              send: torch.Tensor) -> torch.Tensor:
        """:meth:`pass1_launch` into ``send``. One launch."""
        return self.pass1_launch(src, rows, rank, inverse=inverse)(
            src.flat[src.base:], send)

    def pass2(self, recv: torch.Tensor, rows: int, *, inverse: bool,
              out: torch.Tensor) -> torch.Tensor:
        """Pass 2 of ``rows`` signals: ``recv`` (D, N1/D, rows, N2/D), what
        the all-to-all brought, relaid as (rows, N1/D, N2) (a torch copy),
        then the FFT over n2 into ``out`` (rows, N1/D, N2)."""
        from repro_torch.kernels.ops import _fft_impl

        z = recv.permute(2, 1, 0, 3).reshape(rows, self.n1l, self.n2)
        ax = self.ax2
        return _fft_impl(z, ax.plan, ax.tables[inverse], ax.twiddles[inverse],
                         inverse=inverse, scale=1.0, out=out)

    def natural(self, gathered: torch.Tensor, rows: int) -> torch.Tensor:
        """The all-gathered (D, rows, N1/D, N2) pass-2 outputs in natural
        order, (rows, N): y[k1 + N1*k2] = Z[k1, k2] (a torch copy)."""
        return gathered.permute(1, 3, 0, 2).reshape(rows, self.n)

    # -- TRANSPOSED_IN inverse --------------------------------------------

    def pass_a_launches(self, blocks: int, block_stride: int, rows: int,
                        row_stride: int, rank: int) -> list[Launch]:
        """Pass A of the TRANSPOSED_IN inverse on shard ``rank``: the
        inverse FFT over k2 of the N1/D rows of ``blocks`` x ``rows``
        signals, signal (blk, r) at ``blk*block_stride + r*row_stride``
        (its N1/D rows of N2 points contiguous), times the conjugate
        twiddle w_N^-(k1 * n2) of the global k1 rows and 1/N, in the
        (blocks, rows, N1/D, N2) order of the send buffer. One launch a
        pass of the N2 tail (at most two; two read contiguous signals, the
        first writes a scratch buffer like the send buffer, the second
        reads it)."""
        from repro_torch.kernels.stockham import pass_twiddle_table

        n, n1l, n2 = self.n, self.n1l, self.n2
        ax = self.ax2
        facs = ax.plan.kernel_factors
        row_out = n1l * n2
        tw = self.twiddle[True]
        if len(facs) == 1:
            layout = PassLayout(((blocks, block_stride, rows * row_out),
                                 (rows, row_stride, row_out),
                                 (n1l, n2, n2)), 1, 1)
            return [Launch(ax.plan.stages[0], ax.tables[True][0], layout,
                           True, 1.0 / n, tw, n, rank * n1l)]
        if len(facs) != 2:
            raise NotImplementedError(
                f"the TRANSPOSED_IN inverse takes N2 in at most two local "
                f"passes, got N2={n2} in {len(facs)}")
        if row_stride != row_out or block_stride != rows * row_out:
            raise ValueError("pass A over two passes reads contiguous "
                             "signals")
        f0, f1 = facs
        sigs = blocks * rows
        # pass 0 over f0 (points f1 apart) of columns c, the fastest axis
        # the global row K: w_N2^(k0*c) * w_N^(K*k0) = w_N^(k0*(n1*c + K))
        lay0 = PassLayout(((sigs, row_out, row_out), (f1, 1, 1),
                           (n1l, n2, n2)), f1, f1)
        # pass 1 over f1 (contiguous) written transposed to k0 + f0*k1',
        # the fastest axis K again: w_(N/f0)^(K * k1')
        lay1 = PassLayout(((sigs, row_out, row_out), (f0, f1, 1),
                           (n1l, n2, n2)), 1, f0)
        tw_last = pass_twiddle_table(n // f0, self.dtype, inverse=True,
                                     device=self.device)
        return [Launch(ax.plan.stages[0], ax.tables[True][0], lay0, True,
                       1.0 / n, tw, n, rank * n1l, self.n1),
                Launch(ax.plan.stages[1], ax.tables[True][1], lay1, True,
                       1.0, tw_last, n // f0, rank * n1l)]

    def pass_a(self, flat: torch.Tensor, base: int, blocks: int,
               block_stride: int, rows: int, row_stride: int, rank: int, *,
               send: torch.Tensor) -> torch.Tensor:
        """:meth:`pass_a_launches` on ``flat[base:]``, into ``send``."""
        launches = self.pass_a_launches(blocks, block_stride, rows,
                                        row_stride, rank)
        x = flat[base:]
        for launch in launches[:-1]:
            x = launch(x, torch.empty_like(send))
        return launches[-1](x, send)

    def pass_b_launch(self, rows: int) -> Launch:
        """Pass B of the TRANSPOSED_IN inverse: the inverse FFT over k1 of
        the strided columns of (rows, N1, N2), in place of natural
        order."""
        return Launch(self.stages1, self.tables1[True],
                      axis_layout(rows, self.n1, self.n2), True)

    def pass_b(self, recv: torch.Tensor, rows: int, *,
               out: torch.Tensor) -> torch.Tensor:
        """Pass B: ``recv`` (D, rows, N1/D, N2) relaid as (rows, N1, N2) (a
        torch copy), then :meth:`pass_b_launch` into ``out`` (rows, N):
        natural order. One launch."""
        z = recv.transpose(0, 1).reshape(rows, self.n1, self.n2)
        return self.pass_b_launch(rows)(z, out.view(rows, self.n1, self.n2))


@functools.lru_cache(maxsize=64)
def pencil(n: int, shards: int, dtype: torch.dtype, device: str) -> Pencil:
    """The :class:`Pencil` of (n, shards, dtype, device), built once."""
    return Pencil(n, shards, dtype, device)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(-1)


def _pad_batch_rows(x2d: torch.Tensor, dsize: int, shards: int):
    """Pad the batch of a (B, N) tensor with zero rows to a multiple of
    ``dsize * shards``. Returns (padded, B)."""
    b = x2d.shape[0]
    pad = (-b) % (dsize * shards)
    if pad:
        x2d = torch.cat([x2d, x2d.new_zeros((pad,) + tuple(x2d.shape[1:]))])
    return x2d, b


# ---------------------------------------------------------------------------
# the mesh pipelines
# ---------------------------------------------------------------------------


def _all_to_all(recv, send, *, group, async_op=False):
    return dist.all_to_all_single(recv, send, group=group, async_op=async_op)


def _all_gather(out, inp, *, group):
    return dist.all_gather_into_tensor(out, inp, group=group)


@dataclasses.dataclass(frozen=True)
class _Mesh:
    """One rank's view of the mesh a transform runs on, and its exchange
    over the ``axis`` dimension: ``all_to_all(recv, send, async_op=...)``
    (equal splits along the buffers' first dimension; a handle to wait
    on when asynchronous) and ``all_gather(out, inp)``, by :meth:`of`
    ``dist``'s collectives on the mesh's group. The pipelines call
    nothing else of the mesh, so D shards in one process can run them with
    a permute of their tensors in place of the collectives (``mesh``
    None)."""

    mesh: object
    axis: str
    daxis: str | None
    shards: int
    dsize: int
    rank: int          # coordinate along ``axis``
    drank: int         # coordinate along ``daxis`` (0 without one)
    all_to_all: Callable
    all_gather: Callable

    @classmethod
    def of(cls, mesh, axis, daxis) -> "_Mesh":
        if mesh.get_coordinate() is None:
            raise RuntimeError(
                f"rank {dist.get_rank()} is not on the mesh {mesh}: only "
                f"its ranks run the sharded transform")
        group = mesh.get_group(axis)
        return cls(mesh, axis, daxis, mesh_size(mesh, axis),
                   mesh_size(mesh, daxis) if daxis else 1,
                   mesh.get_local_rank(axis),
                   mesh.get_local_rank(daxis) if daxis else 0,
                   functools.partial(_all_to_all, group=group),
                   functools.partial(_all_gather, group=group))


def _rows_of(b: int, m: _Mesh) -> tuple[int, int, bool]:
    """(first row, rows, sharded) of this rank's data shard of a ``b``-row
    batch: the batch shards over the data dimension when it divides."""
    if m.daxis and b % m.dsize == 0:
        bl = b // m.dsize
        return m.drank * bl, bl, True
    return 0, b, False


def _local_input(x, m: _Mesh):
    """This rank's rows of ``x`` (B, N) and how it holds them.

    Returns ``(local, row0, rows, bsharded, block)``: ``local`` a tensor
    whose rows ``row0 .. row0+rows`` are this data shard's, every point of
    them, or with ``block`` this rank's contiguous 1/D of each
    (``Shard(-1)`` over ``fft``). A DTensor in another placement is
    redistributed to one of these first.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    b = x.shape[0]
    row0, rows, bsharded = _rows_of(b, m)
    if not isinstance(x, DTensor):
        return x, row0, rows, bsharded, False
    if x.device_mesh != m.mesh:
        raise ValueError(f"the operand lives on {x.device_mesh}, the plan "
                         f"on {m.mesh}")
    keep = {m.axis: (Replicate(), Shard(x.dim() - 1)),
            m.daxis: (Replicate(), Shard(0)) if bsharded else (Replicate(),)}
    want = [pl if pl in keep.get(name, (Replicate(),))
            else Shard(0) if name == m.daxis and bsharded else Replicate()
            for name, pl in zip(mesh_axes(x.device_mesh), x.placements)]
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    placed = dict(zip(mesh_axes(x.device_mesh), want))
    if m.daxis and placed[m.daxis] == Shard(0):
        row0 = 0                     # the local rows are the shard's
    return x.to_local(), row0, rows, bsharded, placed[m.axis] != Replicate()


def _ingest(local: torch.Tensor, row0: int, rows: int, p: Pencil,
            m: _Mesh) -> Source:
    """Block-sharded rows to pencils: ONE all-to-all. Rank d holds the
    N1/D rows i1 of its block; each sends rank e its columns of block e,
    in (D, N1/D, rows, N2/D) order, so what arrives is pass 1's input as
    it stands: point i1 = (source, i1l) at i1 * rows * N2/D."""
    blk = local[row0:row0 + rows].reshape(rows, p.n1l, p.shards, p.n2l)
    send = blk.permute(2, 1, 0, 3).contiguous()
    recv = torch.empty_like(send)
    m.all_to_all(recv, send)
    return Source(recv.view(-1), 0, p.n2l, rows * p.n2l)


def _dtensor(local, spec: dict, m: _Mesh, shape):
    """A DTensor of this rank's ``local`` result: ``spec`` one of
    :func:`~repro_torch.parallel.fft_sharding.signal_specs`' layouts."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.fft_sharding import placements

    return DTensor.from_local(local, m.mesh, placements(m.mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.Size(_contiguous_strides(shape)))


def _contiguous_strides(shape) -> tuple[int, ...]:
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def _dist_fft(x, p: Pencil, m: _Mesh, *, inverse: bool, natural_order: bool,
              chunks: int):
    """The forward (or natural-order inverse) pencil pipeline on this
    rank: pass 1 of chunk i, then its all-to-all (asynchronous, issued
    before chunk i+1's pass 1), then — once it has arrived — its pass 2;
    the natural-order all-gather last. Returns this rank's result and its
    :func:`~repro_torch.parallel.fft_sharding.signal_specs` layout."""
    from repro_torch.parallel.fft_sharding import signal_specs

    b, n = x.shape
    local, row0, rows, bsharded, block = _local_input(x, m)
    if block:
        src = _ingest(local, row0, rows, p, m)
    else:
        src = Source(_flat(local), row0 * n + m.rank * p.n2l, n, p.n2)
    ce = resolve_chunks(rows, chunks)
    bc = rows // ce
    dev, dt = local.device, local.dtype
    z = torch.empty((rows, p.n1l, p.n2), dtype=dt, device=dev)
    pending = None
    for i in range(ce + 1):
        if i < ce:
            send = torch.empty((p.shards, p.n1l, bc, p.n2l), dtype=dt,
                               device=dev)
            p.pass1(src.at(i * bc), bc, m.rank, inverse=inverse, send=send)
            recv = torch.empty_like(send)
            work = m.all_to_all(recv, send, async_op=True)
        if pending is not None:
            pw, precv, pi = pending
            pw.wait()
            p.pass2(precv, bc, inverse=inverse,
                    out=z[pi * bc:(pi + 1) * bc])
        pending = (work, recv, i) if i < ce else None
    spec = signal_specs(m.axis, m.daxis if bsharded else None,
                        natural_order=natural_order)["forward"]
    if natural_order:
        g = torch.empty((p.shards,) + tuple(z.shape), dtype=dt, device=dev)
        m.all_gather(g.view(-1), z.view(-1))
        return p.natural(g, rows), spec
    return z.view(rows, n // p.shards), spec


def _dist_ifft_t(x, p: Pencil, m: _Mesh, *, chunks: int):
    """The TRANSPOSED_IN inverse on this rank: this data shard's rows (in
    ``torch.chunk``'s split of the batch, as DTensor's ``Shard(0)``)
    padded with zero rows to a multiple of D; per chunk, pass A into the
    send buffer, ONE all-to-all that splits the batch, pass B. Chunk i
    takes rows i of every destination block, so the rows land as the bulk
    path's. Returns this rank's rows and their layout, ``Shard(0)`` over
    data, then over fft: each signal whole on one rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.parallel.fft_sharding import signal_specs

    b, n = x.shape
    d = m.shards
    row_len = p.n1l * p.n2
    # this data shard's rows: torch.chunk's split, as DTensor's Shard(0)
    per = -(-b // m.dsize)
    row0 = min(m.drank * per, b)
    rows = max(0, min(per, b - row0))
    if isinstance(x, DTensor):
        # keep a batch already split over data (the forward's transposed
        # output): only the fft dimension must hold this rank's k1 block
        want = [Shard(1) if name == m.axis
                else pl if name == m.daxis and pl == Shard(0)
                else Replicate()
                for name, pl in zip(mesh_axes(x.device_mesh), x.placements)]
        if list(x.placements) != want:
            x = x.redistribute(x.device_mesh, want)
        if m.daxis and Shard(0) in want:
            row0 = 0                      # the local rows are the shard's
        local, col0, stride = x.to_local(), 0, row_len   # (rows, N/D)
    else:
        local, col0, stride = x, m.rank * row_len, n
    w = -(-rows // d)
    dev, dt = local.device, local.dtype
    out = torch.empty((w, n), dtype=dt, device=dev)
    if w:
        if rows != w * d:
            mine = local[row0:row0 + rows].view(rows, -1)[
                :, col0:col0 + row_len]
            local, _ = _pad_batch_rows(mine, 1, d)
            row0, col0, stride = 0, 0, row_len
        flat = _flat(local)
        base = row0 * stride + col0
        ce = resolve_chunks(w, chunks)
        wc = w // ce
        two_pass = p.ax2.plan.num_passes == 2
        pending = None
        for i in range(ce + 1):
            if i < ce:
                send = torch.empty((d, wc, p.n1l, p.n2), dtype=dt,
                                   device=dev)
                args = (flat, base + i * wc * stride, d, w * stride, wc,
                        stride)
                if two_pass and (ce > 1 or stride != row_len):
                    # two passes read contiguous signals: copy the chunk's
                    view = torch.as_strided(flat, (d, wc, row_len),
                                            (w * stride, stride, 1),
                                            args[1])
                    args = (_flat(view), 0, d, wc * row_len, wc, row_len)
                p.pass_a(*args, m.rank, send=send)
                recv = torch.empty_like(send)
                work = m.all_to_all(recv, send, async_op=True)
            if pending is not None:
                pw, precv, pi = pending
                pw.wait()
                p.pass_b(precv, wc, out=out[pi * wc:(pi + 1) * wc])
            pending = (work, recv, i) if i < ce else None
    mine_rows = max(0, min(w, rows - m.rank * w))
    spec = signal_specs(m.axis, m.daxis, natural_order=False)["inverse"]
    return out[:mine_rows], spec


def sharded(x, p: Pencil, m: _Mesh, *, inverse: bool, natural_order: bool,
            chunks: int):
    """One sharded transform of (B, N) ``x`` on this rank of ``m``: the
    TRANSPOSED_IN inverse (``inverse`` and not ``natural_order``) or the
    pencil pipeline, its result a DTensor of the global (B, N) value."""
    if inverse and not natural_order:
        local, spec = _dist_ifft_t(x, p, m, chunks=chunks)
    else:
        local, spec = _dist_fft(x, p, m, inverse=inverse,
                                natural_order=natural_order, chunks=chunks)
    return _dtensor(local, spec, m, x.shape)


def distributed_fft(x, mesh=None, *, axis: str = FFT_AXIS,
                    inverse: bool = False, natural_order: bool = True,
                    data_axis: str | None = _AUTO, chunks: int = 1,
                    device=None):
    """FFT over the last axis of (B, N) ``x``, pencil-sharded over
    ``mesh``'s ``axis`` dimension: the plan of ``FFTSpec(x.shape,
    mesh=mesh, ...)`` and its executor. Matches ``torch.fft.fft``
    conventions; the batch shards over ``data_axis`` when the mesh carries
    one that divides it (auto-detected ``"data"``; ``data_axis=None``
    replicates it).

    ``natural_order=False`` is the FFTW-MPI transposed pairing: the forward
    returns ``y[.., k1*N2 + k2] = X[k1 + N1*k2]`` block-sharded over
    ``fft``; the inverse declares its input in that order (TRANSPOSED_IN)
    and returns natural-order time domain, batch-sharded.

    With ``mesh=None`` or a 1-sized axis this is exactly the local
    transform (on ``device``, ``"cuda"`` by default). ``chunks > 1``
    splits the batch into that many overlapped transactions; results are
    bitwise-identical to the bulk-synchronous default.
    """
    from repro_torch.kernels.ops import _as_complex

    from . import api

    x = _as_complex(x)
    if device is None:
        device = mesh.device_type if mesh is not None else "cuda"
    spec = api.spec_for(x, mesh=mesh, axis=axis, data_axis=data_axis,
                        natural_order=natural_order, chunks=int(chunks),
                        device=device)
    p = api.plan(spec)
    return p.ifft(x) if inverse else p.fft(x)


def distributed_ifft(x, mesh=None, *, axis: str = FFT_AXIS,
                     natural_order: bool = True,
                     data_axis: str | None = _AUTO, chunks: int = 1,
                     device=None):
    """Inverse of :func:`distributed_fft` (normalized by 1/N).
    ``natural_order=False`` consumes TRANSPOSED-order input with no
    up-front redistribution; the result is natural-order time domain,
    batch-sharded over the mesh."""
    return distributed_fft(x, mesh, axis=axis, inverse=True,
                           natural_order=natural_order, data_axis=data_axis,
                           chunks=chunks, device=device)


# ---------------------------------------------------------------------------
# communication model
# ---------------------------------------------------------------------------


def collective_volume(n: int, batch: int, shards: int, *, itemsize: int = 8,
                      ft: bool = False, natural_order: bool = True,
                      groups: int = 1, data_shards: int = 1,
                      real: bool = False, chunks: int = 1) -> dict:
    """Analytic per-device communication model of one distributed
    transform (the reference's, copied).

    * the inter-pass transpose: ONE all-to-all over the ``rows * N / D``
      locally-resident elements, of which ``(D-1)/D`` cross a link; on a
      2-D batch x pencil mesh each device carries ``1/data_shards`` of the
      rows;
    * the natural-order redistribution: gathering this device's
      ``batch/data_shards * N`` result rows (none with
      ``natural_order=False``);
    * the grouped ABFT verdict (``ft``, item 10.2): one reduction of 3
      scalars per locally-owned group plus one energy scalar per
      transaction, in the input's real dtype, and the stats extraction.

    ``chunks`` splits the payload into that many all-to-alls (same total
    bytes), ``1/chunks`` of it exposed. ``real=True`` models the packed
    rfft: every collective runs at the half length ``n // 2``. The ingest
    all-to-all of a block-sharded input is not counted.
    """
    if ft and groups % data_shards:
        raise ValueError(f"groups={groups} must divide over "
                         f"data_shards={data_shards}")
    if real:
        if ft:
            raise ValueError(
                "the 1-D real path has no ft pipeline — grouped ABFT on "
                "real input rides the 2-D slab (collective_volume_nd with "
                "real=True)")
        n = n // 2   # the packed half-length C2C is the whole collective cost
    chunks = max(1, int(chunks))
    rows = (batch + (2 * groups if ft else 0)) / data_shards
    a2a_local = rows * n * itemsize / shards
    a2a_wire = a2a_local * (shards - 1) / shards
    gather_hlo = batch / data_shards * n * itemsize if natural_order else 0.0
    gather_wire = gather_hlo * (shards - 1) / shards
    verdict = (3 * groups // data_shards + chunks) * (itemsize // 2)
    stats = (5 * groups // data_shards * (itemsize // 2) if groups > 1
             else 3 + (itemsize // 2) + 4)
    psum_hlo = 2.0 * (verdict + stats) if ft else 0.0
    psum_wire = psum_hlo * (shards - 1) / shards
    permute_hlo = (5 * groups // data_shards * (itemsize // 2)
                   if ft and data_shards > 1 else 0.0)
    return {
        "shards": shards,
        "data_shards": data_shards,
        "groups": groups,
        "real": real,
        "chunks": chunks,
        "passes": 2,  # one distributed split -> exactly one transpose
        "all_to_all_count": chunks,
        "all_gather_count": 1 if natural_order else 0,
        "all_to_all_bytes": a2a_local,
        "all_to_all_wire": a2a_wire,
        "gather_hlo": gather_hlo,
        "gather_wire": gather_wire,
        "psum_hlo": psum_hlo,
        "psum_wire": psum_wire,
        "permute_hlo": permute_hlo,
        "total_wire": a2a_wire + gather_wire + psum_wire + permute_hlo,
        "hlo_bytes": a2a_local + gather_hlo + psum_hlo + permute_hlo,
        "abft_overhead": 2.0 * groups / batch if (ft and batch) else 0.0,
        "exposed_fraction": 1.0 / chunks,
        "overlap_efficiency": 1.0 - 1.0 / chunks,
    }


def spectral_volume(n: int, batch: int, shards: int, *, kernel_batch: int = 0,
                    itemsize: int = 8, data_shards: int = 1,
                    real: bool = False, chunks: int = 1) -> dict:
    """Analytic per-device model of one transposed-order spectral round
    trip (forward -> pointwise -> inverse; the reference's, copied):
    exactly TWO all-to-alls (``2 * chunks`` with chunking) and ZERO
    all-gathers — the forward transpose over ``batch / data_shards +
    kernel_batch`` rows, the inverse batch-split transpose over ``batch /
    data_shards``. ``real=True`` models the packed real convolution (the
    kernel rides the imaginary part: ``kernel_batch`` is ignored)."""
    chunks = max(1, int(chunks))
    rows_fwd = batch / data_shards + (0 if real else kernel_batch)
    rows_inv = batch / data_shards
    fwd_local = rows_fwd * n * itemsize / shards
    inv_local = rows_inv * n * itemsize / shards
    wire = (fwd_local + inv_local) * (shards - 1) / shards
    return {
        "shards": shards,
        "data_shards": data_shards,
        "real": real,
        "chunks": chunks,
        "all_to_all_count": 2 * chunks,
        "all_gather_count": 0,
        "all_to_all_bytes": fwd_local + inv_local,
        "all_to_all_wire": wire,
        "gather_hlo": 0.0,
        "gather_wire": 0.0,
        "psum_hlo": 0.0,
        "psum_wire": 0.0,
        "permute_hlo": 0.0,
        "total_wire": wire,
        "hlo_bytes": fwd_local + inv_local,
        "exposed_fraction": 1.0 / chunks,
        "overlap_efficiency": 1.0 - 1.0 / chunks,
    }
