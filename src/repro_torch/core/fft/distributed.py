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
    "Pencil", "Launch", "DistFFTResult", "ft_distributed_fft",
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

# Correctability gate on the two-side id decode of the sharded ABFT: a
# single fault sits at the noise floor, two faults with distinct ids in one
# group at >= 0.04.
ID_VAR_TOL = 0.04


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
        self._left = {}

    @property
    def launches(self) -> int:
        return 1 + self.ax2.plan.num_passes

    # -- forward (and natural-order inverse) ------------------------------

    def pass1_launch(self, src: Source, rows: int, rank: int, *,
                     inverse: bool, out_rows: int | None = None,
                     blocks: tuple[int, int] | None = None) -> Launch:
        """Pass 1 of ``rows`` signals on shard ``rank``: the FFT over n1 of
        its N2/D columns read from ``src`` (from ``src.flat[src.base:]``),
        times the twiddle w_N^(k1 * (rank*N2/D + column)) (and 1/N on the
        inverse), written in the all-to-all's (D, N1/D, out_rows, N2/D)
        order, ``out_rows`` (by default the launch's signal count) the
        send buffer's rows. ``blocks = (count, stride)`` reads ``count``
        blocks of ``rows`` signals, block j at ``j * stride`` in ``src``,
        and writes them one after the other."""
        n2l = self.n2l
        cols = (n2l, 1, 1)
        if blocks is None:
            axes, sigs = ((rows, src.row_stride, n2l), cols), rows
        else:
            count, stride = blocks
            axes = ((count, stride, rows * n2l),
                    (rows, src.row_stride, n2l), cols)
            sigs = count * rows
        layout = PassLayout(axes, src.point_stride,
                            (out_rows or sigs) * n2l)
        return Launch(self.stages1, self.tables1[inverse], layout, inverse,
                      1.0 / self.n if inverse else 1.0,
                      self.twiddle[inverse], self.n, rank * n2l)

    def pass1(self, src: Source, rows: int, rank: int, *, inverse: bool,
              send: torch.Tensor, out_rows: int | None = None,
              row0: int = 0, blocks: tuple[int, int] | None = None
              ) -> torch.Tensor:
        """:meth:`pass1_launch` into ``send`` (D, N1/D, out_rows, N2/D),
        its rows from ``row0`` on: the flat view of ``send`` from there,
        whose start the wrapper checks for the kernel's 16-byte stores.
        One launch."""
        launch = self.pass1_launch(src, rows, rank, inverse=inverse,
                                   out_rows=out_rows, blocks=blocks)
        return launch(src.flat[src.base:], send.view(-1)[row0 * self.n2l:])

    def left_twiddle(self, rank: int) -> torch.Tensor:
        """conj(w_N^(k1 * (rank*N2/D + c))) as (N1, N2/D): times pass 1's
        twiddled forward output it gives the plain FFT over n1 back, whose
        sum over k1 the left check predicts. Built in float64 once per
        rank."""
        t = self._left.get(rank)
        if t is None:
            k1 = np.arange(self.n1, dtype=np.int64)[:, None]
            col = rank * self.n2l + np.arange(self.n2l, dtype=np.int64)
            w = np.exp(2j * np.pi * ((k1 * col) % self.n) / self.n)
            np_dt = np.complex64 if self.dtype == torch.complex64 \
                else np.complex128
            t = self._left[rank] = torch.from_numpy(
                w.astype(np_dt)).to(self.device)
        return t

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


def _all_to_all(recv, send, *, group, async_op=False, out_splits=None,
                in_splits=None):
    return dist.all_to_all_single(recv, send, output_split_sizes=out_splits,
                                  input_split_sizes=in_splits, group=group,
                                  async_op=async_op)


def _all_gather(out, inp, *, group):
    return dist.all_gather_into_tensor(out, inp, group=group)


def _all_reduce(t, *, group):
    return dist.all_reduce(t, group=group)


@dataclasses.dataclass(frozen=True)
class _Mesh:
    """One rank's view of the mesh a transform runs on, and its exchange
    over the ``axis`` dimension: ``all_to_all(recv, send, async_op=...)``
    (equal splits along the buffers' first dimension unless
    ``out_splits``/``in_splits`` give the element counts; a handle to wait
    on when asynchronous), ``all_gather(out, inp)`` and ``all_reduce(t)``
    (a sum in place); over the ``daxis`` dimension (None without one)
    ``data_gather(out, inp)`` and ``data_all_to_all(recv, send, ...)``,
    by :meth:`of` ``dist``'s collectives on the mesh's groups. The
    pipelines call nothing else of the mesh, so a grid of shards in one
    process can run them with a permute of their tensors in place of the
    collectives (``mesh`` None)."""

    mesh: object
    axis: str
    daxis: str | None
    shards: int
    dsize: int
    rank: int          # coordinate along ``axis``
    drank: int         # coordinate along ``daxis`` (0 without one)
    all_to_all: Callable
    all_gather: Callable
    all_reduce: Callable | None = None
    data_gather: Callable | None = None
    data_all_to_all: Callable | None = None

    @classmethod
    def of(cls, mesh, axis, daxis) -> "_Mesh":
        if mesh.get_coordinate() is None:
            raise RuntimeError(
                f"rank {dist.get_rank()} is not on the mesh {mesh}: only "
                f"its ranks run the sharded transform")
        group = mesh.get_group(axis)
        dgroup = mesh.get_group(daxis) if daxis else None
        return cls(mesh, axis, daxis, mesh_size(mesh, axis),
                   mesh_size(mesh, daxis) if daxis else 1,
                   mesh.get_local_rank(axis),
                   mesh.get_local_rank(daxis) if daxis else 0,
                   functools.partial(_all_to_all, group=group),
                   functools.partial(_all_gather, group=group),
                   functools.partial(_all_reduce, group=group),
                   functools.partial(_all_gather, group=dgroup)
                   if daxis else None,
                   functools.partial(_all_to_all, group=dgroup)
                   if daxis else None)


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
    rank (:func:`_pencil_loop` on this data shard's rows). Returns this
    rank's result and its :func:`~repro_torch.parallel.fft_sharding
    .signal_specs` layout."""
    from repro_torch.parallel.fft_sharding import signal_specs

    b, n = x.shape
    local, row0, rows, bsharded, block = _local_input(x, m)
    src = _source(local, row0, rows, block, p, m)
    spec = signal_specs(m.axis, m.daxis if bsharded else None,
                        natural_order=natural_order)["forward"]
    return _pencil_loop(src, rows, p, m, inverse=inverse,
                        natural_order=natural_order, chunks=chunks,
                        dtype=local.dtype, device=local.device), spec


def _source(local, row0: int, rows: int, block: bool, p: Pencil,
            m: _Mesh) -> Source:
    """Where pass 1 reads this rank's pencil of the data shard's rows:
    the ingest all-to-all's buffer of a block-sharded input, else the
    rank's columns of the global rows in place."""
    if block:
        return _ingest(local, row0, rows, p, m)
    return Source(_flat(local), row0 * p.n + m.rank * p.n2l, p.n, p.n2)


def _pencil_loop(src: Source, rows: int, p: Pencil, m: _Mesh, *,
                 inverse: bool, natural_order: bool, chunks: int, dtype,
                 device) -> torch.Tensor:
    """The pencil pipeline over ``rows`` signals read from ``src``: pass 1
    of chunk i, then its all-to-all (asynchronous, issued before chunk
    i+1's pass 1), then — once it has arrived — its pass 2; the
    natural-order all-gather last. This rank's (rows, N) natural-order
    result, or its (rows, N/D) block of the transposed order."""
    ce = resolve_chunks(rows, chunks)
    bc = rows // ce
    z = torch.empty((rows, p.n1l, p.n2), dtype=dtype, device=device)
    pending = None
    for i in range(ce + 1):
        if i < ce:
            send = torch.empty((p.shards, p.n1l, bc, p.n2l), dtype=dtype,
                               device=device)
            p.pass1(src.at(i * bc), bc, m.rank, inverse=inverse, send=send)
            recv = torch.empty_like(send)
            work = m.all_to_all(recv, send, async_op=True)
        if pending is not None:
            pw, precv, pi = pending
            pw.wait()
            p.pass2(precv, bc, inverse=inverse,
                    out=z[pi * bc:(pi + 1) * bc])
        pending = (work, recv, i) if i < ce else None
    if natural_order:
        g = torch.empty((p.shards,) + tuple(z.shape), dtype=dtype,
                        device=device)
        m.all_gather(g.view(-1), z.view(-1))
        return p.natural(g, rows)
    return z.view(rows, p.n // p.shards)


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
# the sharded two-side ABFT (grouped multi-transaction)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistFFTResult:
    """Corrected outputs and per-group FT telemetry of one sharded ft
    transform. The batch splits into G checksum groups; one fault a group
    is detected, located and corrected in one pass. ``y`` is a DTensor of
    the (B, N) result (this rank's local rows inside the per-rank
    pipeline); the telemetry fields are plain tensors on the rank's
    device, the same on every rank, the real ones in the input's real
    dtype."""

    y: torch.Tensor               # (B, N) corrected outputs
    shard_delta: torch.Tensor     # (devices,) per-shard left-check residual
    group_score: torch.Tensor     # (G,) relative right-checksum divergence
    flagged: torch.Tensor         # (G,) bool: the group diverged
    location: torch.Tensor        # (G,) int32 decoded global signal index
    correctable: torch.Tensor     # (G,) bool: single-fault signature
    checksum_fault: torch.Tensor  # (G,) bool: a checksum row was hit
    corrected: torch.Tensor       # int32 scalar: corrections applied
    recomputed: torch.Tensor      # int32 scalar: groups recomputed

    @property
    def uncorrectable(self) -> torch.Tensor:
        """(G,) bool: flagged, but neither a single data fault nor a
        checksum-row fault (two SEUs in one group): only the recompute
        repairs it."""
        return self.flagged & ~self.correctable & ~self.checksum_fault


def _grouped_verdict(ylg, d2, d3, cs2_out, *, all_reduce, threshold: float,
                     s: int, n: int, md: int, bl: int, gl: int,
                     correct: bool, row_offset: int = 0) -> torch.Tensor:
    """The per-group two-side decode, from the checksum divergences to the
    verdicts, operation for operation the reference's.

    ``ylg`` is the grouped local output (gl, s, ...); ``d2``/``d3`` the
    transported-minus-computed divergences (gl, ...) (-eps_y and
    -id*eps_y for a single fault); ``n`` the points of a signal. The
    payload ``[num, den, d3sq]`` of each group plus one energy scalar is
    ONE ``all_reduce`` (a sum over the ``fft`` ranks). With ``correct``
    the located signal's local slice gets ``d2`` added in place. Returns
    the (gl, 5) stats ``[score, flagged, location, correctable,
    checksum_fault]`` in the real dtype. Nothing is read back to the
    host. ``row_offset`` is the first data row of this transaction within
    its data shard, so ``location`` stays a global signal index."""
    dims = tuple(range(1, d2.dim()))
    num = torch.sum((d3 * d2.conj()).real, dim=dims)
    den = torch.sum(d2.abs().square(), dim=dims)
    d3sq = torch.sum(d3.abs().square(), dim=dims)
    energy = torch.sum(cs2_out.abs().square())
    payload = torch.cat([torch.stack([num, den, d3sq], dim=1).reshape(-1),
                         energy.reshape(1)])
    all_reduce(payload)                          # 3*gl + 1 reals
    pg = payload[:-1].view(gl, 3)
    num, den, d3sq = pg[:, 0], pg[:, 1], pg[:, 2]
    scale = torch.sqrt(payload[-1] / (gl * n)) + EPS
    score2 = torch.sqrt(den / n) / scale
    score3 = torch.sqrt(d3sq / n) / (s * scale)
    score = torch.maximum(score2, score3)
    # lam estimates the within-group id; id_var is the spread of the
    # per-element estimates: the noise floor for one fault, O(1) for two
    lam = num / (den + EPS)
    id_var = torch.clamp(d3sq / (den + EPS) - lam * lam, min=0.0)
    rid = torch.round(lam).to(torch.int32)
    flagged2 = score2 > threshold
    # lam ~ 0 with no spread: the transported cs2 row itself was hit
    cs2_fault = flagged2 & (lam < 0.5) & (id_var < ID_VAR_TOL)
    correctable = (flagged2 & ~cs2_fault & (rid >= 1) & (rid <= s)
                   & (id_var < ID_VAR_TOL))
    # d3 diverged while d2 is quiet: the cs3 row was hit
    cs3_fault = ~flagged2 & (score3 > threshold)
    checksum_fault = cs2_fault | cs3_fault
    flagged = flagged2 | cs3_fault
    loc_local = torch.clamp(rid - 1, 0, s - 1).long()
    groups = torch.arange(gl, device=d2.device)
    location = md * bl + row_offset + groups * s + loc_local
    if correct:
        # d2 is the local slice of -eps_y: the repair works whichever
        # shard holds the fault
        upd = torch.where(correctable.view((gl,) + (1,) * len(dims)), d2,
                          torch.zeros_like(d2))
        ylg.index_put_((groups, loc_local), upd, accumulate=True)
    fl = score.dtype
    return torch.stack([score, flagged.to(fl), location.to(fl),
                        correctable.to(fl), checksum_fault.to(fl)], dim=1)


def _seu(send: torch.Tensor, inject: torch.Tensor, ci: int, *, b: int,
         g: int, bl: int, gl: int, blc: int, glc: int, md: int, rank: int,
         n1: int, n2l: int) -> None:
    """Add the SEUs of ``inject`` (F, 7) rows ``[fft_device, signal, row,
    local_col, enable, eps_re, eps_im]`` that fall on this rank, data
    shard and transaction ``ci`` to pass 1's twiddled output in ``send``
    (D, N1/D, R, N2/D), R = blc + 2*glc rows: data | cs2 | cs3. ``signal``
    is global: [0, B) a data row, [B, B+G) the cs2 row of group signal-B,
    [B+G, B+2G) the cs3 row of group signal-B-G. One ``index_put_`` with
    ``accumulate``, on the device; an SEU elsewhere adds 0."""
    rows = blc + 2 * glc
    dev_, sig, row, col = (inject[:, i].long() for i in range(4))
    is_data = sig < b
    is_cs2 = (sig >= b) & (sig < b + g)
    gidx = torch.where(is_cs2, sig - b, sig - b - g)
    owner = torch.where(is_data, torch.div(sig, bl, rounding_mode="floor"),
                        torch.div(gidx, gl, rounding_mode="floor"))
    drow = sig - owner * bl          # data row, local to the data shard
    grow = gidx - owner * gl         # group, local to the data shard
    in_chunk = torch.where(
        is_data, (drow >= ci * blc) & (drow < (ci + 1) * blc),
        (grow >= ci * glc) & (grow < (ci + 1) * glc))
    crow = torch.where(is_data, drow - ci * blc,
                       blc + torch.where(is_cs2, 0, glc) + grow - ci * glc)
    hit = ((owner == md) & (dev_ == rank) & in_chunk
           & (row >= 0) & (row < n1) & (col >= 0) & (col < n2l)
           & (crow >= 0) & (crow < rows))
    amp = inject[:, 4] * hit.to(inject.dtype)
    eps = torch.complex(inject[:, 5], inject[:, 6]).to(send.dtype) * amp
    idx = torch.where(hit, (row * rows + crow) * n2l + col, 0)
    send.view(-1).index_put_((idx,), eps, accumulate=True)


def _group_sums(xg: torch.Tensor, ids: torch.Tensor,
                out: torch.Tensor) -> None:
    """The right checksums of grouped rows ``xg`` (groups, s, ...): the
    sum (e2) into ``out[:groups]`` and the id-weighted sum (e3, ``ids``
    the 1-based ids) into ``out[groups:]``. One reduction a group and a
    checksum, each over the same shape whatever the group count, so a
    transaction's sums are bitwise those of the whole batch."""
    gc = xg.shape[0]
    for j in range(gc):
        torch.sum(xg[j], dim=0, out=out[j])
        torch.sum(xg[j] * ids, dim=0, out=out[gc + j])


def _left_delta(f_sum: torch.Tensor, x0: torch.Tensor, msq: torch.Tensor,
                npts: int) -> torch.Tensor:
    """The left check's residual of a pass: ``f_sum``, each signal's sum
    over k of its plain FFT, against ``npts`` times its input's point 0,
    ``x0``, over sqrt(npts) times its input's rms (``msq`` the mean
    square; the reference's scaling). The largest, a 0-d tensor."""
    res = (f_sum - npts * x0).abs()
    scale = torch.sqrt(msq) + EPS
    return torch.max(res / (float(np.sqrt(npts)) * scale))


def _msq(x: torch.Tensor, dim) -> torch.Tensor:
    return x.abs().square().mean(dim=dim)


def _ft_dist_fft(x, p: Pencil, m: _Mesh, *, groups: int, threshold: float,
                 correct: bool, natural_order: bool, chunks: int,
                 inject: torch.Tensor | None = None,
                 recompute: bool = False):
    """The grouped two-side ABFT forward on this rank: the rank's local
    result in :class:`DistFFTResult` (``y`` this rank's rows, natural or
    transposed order), and the layout of ``y``.

    A transaction carries whole checksum groups: pass 1 of its data rows
    straight from their ``Source`` into the send buffer (D, N1/D, R,
    N2/D), R = rows + 2 * groups, then the group sums cs2 = sum x and
    cs3 = sum id * x of the same columns (torch) and pass 1 of those 2G
    rows into the same buffer at row ``rows`` (a second launch); the left
    check of pass 1 on the twiddled spectrum times the conjugate twiddle;
    the SEUs of ``inject``; ONE all-to-all (asynchronous, issued before
    the next transaction's pass 1); pass 2; its left check; the output
    group sums and the divergences d2, d3; :func:`_grouped_verdict`, with
    its ONE ``all_reduce``. Natural order all-gathers the data rows only.
    After the last transaction the telemetry goes to every rank: ONE
    all-gather over ``fft`` of each rank's left-check residual and, when
    the batch shards over ``data``, ONE all-gather over ``data`` of the
    (G/data, 5) stats and those residuals. ``recompute`` reads the
    verdict back (a device sync) and reruns the uncorrectable groups this
    data shard owns on the plain pipeline (:func:`_pencil_loop`) over its
    own ``fft`` ranks, splicing them into its rows."""
    from repro_torch.parallel.fft_sharding import signal_specs

    b, n = x.shape
    g = groups
    s = b // g
    local, row0, rows, bsharded, block = _local_input(x, m)
    dl = m.dsize if bsharded else 1
    md = m.drank if bsharded else 0
    gl = g // dl
    src = _source(local, row0, rows, block, p, m)
    dev, dt = local.device, local.dtype
    rdt = torch.float64 if dt == torch.complex128 else torch.float32
    ce = resolve_chunks(gl, chunks)
    glc, blc = gl // ce, rows // ce
    nrow = blc + 2 * glc
    ids = torch.arange(1, s + 1, dtype=rdt, device=dev).view(s, 1, 1)
    tconj = p.left_twiddle(m.rank)[:, None, :]
    rs, ps = src.row_stride, src.point_stride
    z = None if ce == 1 else torch.empty((rows, p.n1l, p.n2), dtype=dt,
                                         device=dev)
    delta = torch.zeros((), dtype=rdt, device=dev)
    stats, pending = [], None
    for i in range(ce + 1):
        if i < ce:
            send = torch.empty((p.shards, p.n1l, nrow, p.n2l), dtype=dt,
                               device=dev)
            xin = src.at(i * blc)
            p.pass1(xin, blc, m.rank, inverse=False, send=send,
                    out_rows=nrow)
            xg = torch.as_strided(xin.flat, (glc, s, p.n1, p.n2l),
                                  (s * rs, rs, ps, 1), xin.base)
            cs = torch.empty((2 * glc, p.n1, p.n2l), dtype=dt, device=dev)
            _group_sums(xg, ids, cs)
            p.pass1(Source(cs.view(-1), 0, p.n1 * p.n2l, p.n2l), 2 * glc,
                    m.rank, inverse=False, send=send, out_rows=nrow,
                    row0=blc)
            # sum_k1 W[k1, n1] = n1 * delta(n1): the plain FFT's column
            # sums predict from x[0]; the conjugate twiddle undoes pass 1's
            f_sum = torch.sum(send.view(p.n1, nrow, p.n2l) * tconj, dim=0)
            xd = xg.reshape(blc, p.n1, p.n2l)
            delta = torch.maximum(delta, torch.maximum(
                _left_delta(f_sum[:blc], xd[:, 0], _msq(xd, 1), p.n1),
                _left_delta(f_sum[blc:], cs[:, 0], _msq(cs, 1), p.n1)))
            if inject is not None:
                _seu(send, inject, i, b=b, g=g, bl=rows, gl=gl, blc=blc,
                     glc=glc, md=md, rank=m.rank, n1=p.n1, n2l=p.n2l)
            recv = torch.empty_like(send)
            work = m.all_to_all(recv, send, async_op=True)
        if pending is not None:
            pw, precv, pi = pending
            pw.wait()
            zt = torch.empty((nrow, p.n1l, p.n2), dtype=dt, device=dev)
            p.pass2(precv, nrow, inverse=False, out=zt)
            # pass 2's input z[r, k1, e*N2/D + c] is precv[e, k1, r, c]
            delta = torch.maximum(delta, _left_delta(
                zt.sum(dim=-1), precv[0, :, :, 0].t(),
                _msq(precv, (0, 3)).t(), p.n2))
            ylg = zt[:blc].view(glc, s, p.n1l, p.n2)
            cso = torch.empty((2 * glc, p.n1l, p.n2), dtype=dt, device=dev)
            _group_sums(ylg, ids, cso)
            d2 = zt[blc:blc + glc] - cso[:glc]       # == -eps_y
            d3 = zt[blc + glc:] - cso[glc:]          # == -id * eps_y
            stats.append(_grouped_verdict(
                ylg, d2, d3, cso[:glc], all_reduce=m.all_reduce,
                threshold=threshold, s=s, n=n, md=md, bl=rows, gl=glc,
                correct=correct, row_offset=pi * blc))
            if z is None:
                z = zt[:blc]
            else:
                z[pi * blc:(pi + 1) * blc].copy_(zt[:blc])
        pending = (work, recv, i) if i < ce else None
    if natural_order:
        gath = torch.empty((p.shards,) + tuple(z.shape), dtype=dt,
                           device=dev)
        m.all_gather(gath.view(-1), z.reshape(-1))
        y = p.natural(gath, rows)
    else:
        y = z.reshape(rows, n // p.shards)
    res = _ft_result(y, torch.cat(stats), delta, m, bsharded=bsharded,
                     correct=correct)
    if recompute:
        _recompute_uncorrectable(res, src, s, gl, md if bsharded else 0,
                                 p, m, natural_order=natural_order)
    spec = signal_specs(m.axis, m.daxis if bsharded else None,
                        natural_order=natural_order)["forward"]
    return res, spec


def _ft_result(y: torch.Tensor, stats: torch.Tensor, delta: torch.Tensor,
               m: _Mesh, *, bsharded: bool, correct: bool) -> DistFFTResult:
    """The :class:`DistFFTResult` of this rank's ``y`` from its data
    shard's (G/data, 5) verdict ``stats`` and its left-check residual
    ``delta``: ONE all-gather over ``fft`` of the residuals and, when the
    batch shards over ``data``, ONE all-gather over ``data`` of the stats
    and those residuals, so every rank holds the whole telemetry."""
    rdt, dev = delta.dtype, delta.device
    deltas = torch.empty(m.shards, dtype=rdt, device=dev)
    m.all_gather(deltas, delta.reshape(1))
    if bsharded:
        k = stats.numel()
        mine = torch.cat([stats.reshape(-1), deltas])
        every = torch.empty(m.dsize * mine.numel(), dtype=rdt, device=dev)
        m.data_gather(every, mine)
        every = every.view(m.dsize, -1)
        stats = every[:, :k].reshape(-1, 5)
        deltas = every[:, k:].reshape(-1)
    correctable = stats[:, 3] > 0.5
    return DistFFTResult(
        y=y, shard_delta=deltas, group_score=stats[:, 0].contiguous(),
        flagged=stats[:, 1] > 0.5, location=stats[:, 2].to(torch.int32),
        correctable=correctable, checksum_fault=stats[:, 4] > 0.5,
        corrected=torch.sum(correctable.to(torch.int32)) * int(correct),
        recomputed=torch.zeros((), dtype=torch.int32, device=dev))


def _recompute_uncorrectable(res: DistFFTResult, src: Source, s: int,
                             gl: int, md: int, p: Pencil, m: _Mesh, *,
                             natural_order: bool) -> None:
    """The policy fallback for multi-fault groups, in place on this
    rank's ``res``: read ``uncorrectable`` back (the device sync that
    makes it opt-in), rerun each such group this data shard owns (local
    groups ``md*gl .. md*gl + gl``) on the plain pipeline over its own
    ``fft`` ranks, and splice its rows in. SEUs are transient, so the
    rerun is clean. ``recomputed`` is the global count."""
    bad = res.uncorrectable.cpu()
    if not bool(bad.any()):
        return
    for gi in torch.nonzero(bad).flatten().tolist():
        lg = gi - md * gl
        if not 0 <= lg < gl:
            continue                  # another data shard's group
        res.y[lg * s:(lg + 1) * s] = _pencil_loop(
            src.at(lg * s), s, p, m, inverse=False,
            natural_order=natural_order, chunks=1, dtype=res.y.dtype,
            device=res.y.device)
    res.recomputed = torch.tensor(int(bad.sum()), dtype=torch.int32,
                                  device=res.recomputed.device)


def ft_sharded(x, p: Pencil, m: _Mesh, **kw) -> DistFFTResult:
    """One sharded ft transform of (B, N) ``x`` on this rank of ``m``
    (:func:`_ft_dist_fft`'s keywords), its ``y`` a DTensor of the global
    (B, N) result."""
    res, spec = _ft_dist_fft(x, p, m, **kw)
    res.y = _dtensor(res.y, spec, m, x.shape)
    return res


def ft_distributed_fft(x, mesh=None, *, axis: str = FFT_AXIS,
                       threshold: float = 1e-4, correct: bool = True,
                       natural_order: bool = True, inject=None,
                       groups: int | None = None,
                       group_size: int | None = None,
                       data_axis: str | None = _AUTO,
                       recompute_uncorrectable: bool = False,
                       chunks: int = 1) -> DistFFTResult:
    """Fault-tolerant sharded forward FFT (grouped two-side ABFT) of (B, N)
    ``x`` on ``mesh``'s ``axis`` dimension, every rank of the mesh
    calling it. The batch splits into G checksum groups
    (``groups``/``group_size``; auto: one group per data shard, else 1);
    each group's checksum rows ride the transpose and get their own
    verdict, so G SEUs in G distinct groups are all corrected in one
    pass. On a 2-D batch x pencil mesh the batch shards over ``data``
    (each data shard owns G/data whole groups); the verdict's all-reduce
    stays on the ``fft`` ranks.

    Verdicts (:class:`DistFFTResult`): a single data SEU is
    ``correctable`` and repaired in place; two in one group are
    ``uncorrectable`` and repaired only by ``recompute_uncorrectable=
    True`` (the affected groups rerun on the plain pipeline after a read
    of the verdict); an SEU in a checksum row is a ``checksum_fault`` and
    the data is left alone. ``inject`` is one or more 7-field rows
    ``[device, signal, row, local_col, enable, eps_re, eps_im]`` added to
    pass 1's output (``signal`` in [B, B+G) / [B+G, B+2G) hits a group's
    cs2 / cs3 row). Scores and residuals are in the input's real dtype.
    ``natural_order=False`` keeps ``y`` in the transposed digit order.
    ``chunks > 1`` splits each data shard's groups into that many
    transactions, each with its own verdict: ``y``, the flags, locations
    and ``corrected`` are bitwise the bulk path's, ``group_score``
    normalises against its transaction's energy. A mesh of one ``fft``
    rank runs the same pipeline with D = 1. Input contract as
    :func:`distributed_fft`, on the mesh's device type."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core import plan as planbase
    from repro_torch.kernels.ops import _as_complex
    from repro_torch.kernels.stockham import device_key

    x = _as_complex(x)
    if x.dim() != 2:
        raise ValueError(f"ft_distributed_fft expects (B, N), got "
                         f"{tuple(x.shape)}")
    mesh = _resolve_mesh(mesh, axis)
    if mesh is None:
        raise ValueError("ft_distributed_fft requires a mesh with an "
                         f"'{axis}' axis (see launch.mesh.make_fft_mesh)")
    daxis = _resolve_data_axis(mesh, data_axis)
    dsize = mesh_size(mesh, daxis) if daxis else 1
    g = resolve_abft_groups(x.shape[0], groups=groups, group_size=group_size,
                            data_shards=dsize)
    dev = planbase.resolve_device(mesh.device_type, "ft_distributed_fft")
    if not isinstance(x, DTensor):
        x = x.to(dev)
    p = pencil(x.shape[1], mesh_size(mesh, axis), x.dtype, device_key(dev))
    return ft_sharded(x, p, _Mesh.of(mesh, axis, daxis), groups=g,
                      threshold=float(threshold), correct=bool(correct),
                      natural_order=bool(natural_order), chunks=int(chunks),
                      inject=_inject_rows(inject, x.dtype, dev),
                      recompute=bool(recompute_uncorrectable))


def _inject_rows(inject, dtype: torch.dtype, device):
    """``inject`` as (F, 7) rows in the real dtype of ``dtype`` on
    ``device`` (None stays None: no SEU)."""
    if inject is None:
        return None
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    inj = torch.as_tensor(inject).to(device=device, dtype=rdt)
    return inj.reshape(1, -1) if inj.dim() == 1 else inj


# ---------------------------------------------------------------------------
# the spectral round trip (forward -> pointwise -> TRANSPOSED_IN inverse)
# ---------------------------------------------------------------------------


def _spectral_round_trip(a: torch.Tensor, v: torch.Tensor | None,
                         p: Pencil, m: _Mesh, *, conj_kernel: bool,
                         chunks: int):
    """This rank's rows of the circular product ``ifft(fft(a) * fft(v))``
    (``conj`` of the kernel's spectrum when ``conj_kernel``) of global
    (B, N) ``a`` and (BK, N) ``v``, BK 1 or B, or with ``v`` None the
    self-product ``ifft(fft(a)^2)`` of one packed operand: forward
    (transposed out), product, TRANSPOSED_IN inverse, natural order.

    The data shard's rows (``torch.chunk``'s split of the batch, as
    ``Shard(0)``) pad with zero rows to a multiple of D. Per transaction:
    pass 1 of its rows of ``a`` (rows within each destination block of
    the inverse's batch split, read in place) and of ``v``'s into ONE
    send buffer (two launches), ONE all-to-all, pass 2, the product (one
    elementwise op), pass A into the batch-splitting send buffer, ONE
    all-to-all, pass B. A broadcast kernel rides transaction 0's forward
    only; later transactions reuse its spectrum. Chunks take rows within
    each block, so the rows land as the bulk path's, bitwise. Returns the
    rank's rows (Shard(0) over ``data``, then over ``fft``) and their
    layout."""
    from repro_torch.parallel.fft_sharding import signal_specs

    b, n = a.shape
    d = m.shards
    per = -(-b // m.dsize)
    row0 = min(m.drank * per, b)
    rows = max(0, min(per, b - row0))
    blk = -(-rows // d)             # rows each rank ends with
    dev, dt = a.device, a.dtype
    out = torch.empty((blk, n), dtype=dt, device=dev)
    spec = signal_specs(m.axis, m.daxis, natural_order=False)["inverse"]
    if not blk:
        return out, spec
    mine = _pad_batch_rows(a[row0:row0 + rows], 1, d)[0].contiguous()
    per_signal = v is not None and v.shape[0] == b
    if per_signal:
        vm = _pad_batch_rows(v[row0:row0 + rows], 1, d)[0].contiguous()
    elif v is not None:
        vm = v.contiguous()
    ce = resolve_chunks(blk, chunks)
    wc = blk // ce
    nsig = d * wc                   # signal rows of a transaction
    row_len = p.n1l * p.n2
    col0 = m.rank * p.n2l
    yv = None
    fwd = inv = None
    for i in range(ce + 2):
        if i < ce:
            kv = wc * d if per_signal else (1 if v is not None and i == 0
                                            else 0)
            send = torch.empty((d, p.n1l, nsig + kv, p.n2l), dtype=dt,
                               device=dev)
            blocks = (d, blk * n)
            p.pass1(Source(mine.view(-1), i * wc * n + col0, n, p.n2), wc,
                    m.rank, inverse=False, send=send, out_rows=nsig + kv,
                    blocks=blocks)
            if kv:
                vsrc = Source(vm.view(-1), (i * wc * n if per_signal
                                            else 0) + col0, n, p.n2)
                p.pass1(vsrc, wc if per_signal else 1, m.rank,
                        inverse=False, send=send, out_rows=nsig + kv,
                        row0=nsig, blocks=blocks if per_signal else None)
            recv = torch.empty_like(send)
            work = m.all_to_all(recv, send, async_op=True)
            nxt_fwd = (work, recv, kv)
        else:
            nxt_fwd = None
        nxt_inv = None
        if fwd is not None:
            fw, frecv, kv = fwd
            fw.wait()
            zt = torch.empty((nsig + kv, p.n1l, p.n2), dtype=dt, device=dev)
            p.pass2(frecv, nsig + kv, inverse=False, out=zt)
            ya = zt[:nsig]
            if v is None:
                kern = ya
            else:
                if kv:
                    yv = zt[nsig:]
                kern = yv.conj() if conj_kernel else yv
            torch.mul(ya, kern, out=ya)
            send2 = torch.empty((d, wc, p.n1l, p.n2), dtype=dt, device=dev)
            p.pass_a(ya.view(-1), 0, d, wc * row_len, wc, row_len, m.rank,
                     send=send2)
            recv2 = torch.empty_like(send2)
            nxt_inv = (m.all_to_all(recv2, send2, async_op=True), recv2,
                       i - 1)
        if inv is not None:
            iw, irecv, ii = inv
            iw.wait()
            p.pass_b(irecv, wc, out=out[ii * wc:(ii + 1) * wc])
        fwd, inv = nxt_fwd, nxt_inv
    mine_rows = max(0, min(blk, rows - m.rank * blk))
    return out[:mine_rows], spec


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
    * the grouped ABFT verdict (``ft``): one reduction of 3
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
