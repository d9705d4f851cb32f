"""Sharding glue for the sharded FFT (see ``core/fft/distributed.py``).

The port of ``repro.parallel.fft_sharding``, with ``DTensor`` placements in
place of ``PartitionSpec`` s. A *spec* here is a dict from mesh-dimension
name to the :class:`~torch.distributed.tensor.Placement` of that dimension
(``{"data": Shard(0), "fft": Shard(1)}`` is the reference's ``P("data",
"fft")`` on a (B, N) array); :func:`placements` orders one for a mesh,
Replicate on every dimension it does not name. All helpers understand the
2-D batch x pencil mesh (``make_fft_mesh(shards, data)``): batch dims
shard over ``data`` while the signal pencils shard over ``fft``; the n-D
layouts (:func:`slab_specs`, :func:`pencil_nd_specs`, :func:`shard_grid`)
are those of ``core.fft.multidim``'s slab and pencil pipelines.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.fft.distributed import (DATA_AXIS,
                                              FFT_AXIS, make_dist_plan,
                                              mesh_axes, mesh_size,
                                              resolve_abft_groups,
                                              resolve_chunks)

__all__ = ["fft_mesh_axis", "infer_fft_mesh", "pencil_specs",
           "shard_signals", "data_mesh_axis", "abft_group_layout",
           "abft_group_spec", "chunk_layout", "slab_specs",
           "pencil_nd_specs", "shard_grid", "layout_specs",
           "half_spectrum_shape", "placements", "signal_specs"]


def fft_mesh_axis(mesh, axis: str = FFT_AXIS) -> str | None:
    """The FFT mesh dimension name if ``mesh`` carries one (size > 1)."""
    if mesh is None or axis not in mesh_axes(mesh):
        return None
    return axis if mesh_size(mesh, axis) > 1 else None


def data_mesh_axis(mesh, axis: str = DATA_AXIS) -> str | None:
    """The batch (data) mesh dimension name if ``mesh`` carries one (size
    > 1)."""
    if mesh is None or axis not in mesh_axes(mesh):
        return None
    return axis if mesh_size(mesh, axis) > 1 else None


def placements(mesh, spec: dict) -> list:
    """``spec`` (mesh-dimension name -> placement) as the placement list of
    ``mesh``, in its dimension order: Replicate where ``spec`` names
    nothing (or None)."""
    return [spec.get(name) or Replicate() for name in mesh_axes(mesh)]


def abft_group_layout(mesh, batch: int, *, groups: int | None = None,
                      group_size: int | None = None,
                      data_axis: str = DATA_AXIS) -> tuple[int, int]:
    """Resolve the grouped-ABFT layout for ``batch`` signals on ``mesh``:
    ``(G, S)``, the checksum group count and the signals per group, with
    every group wholly inside one data shard (``data | G``)."""
    d = data_mesh_axis(mesh, data_axis)
    dsize = mesh_size(mesh, d) if d else 1
    g = resolve_abft_groups(batch, groups=groups, group_size=group_size,
                            data_shards=dsize)
    return g, batch // g


def chunk_layout(mesh, batch: int, chunks: int, *,
                 groups: int | None = None,
                 data_axis: str = DATA_AXIS) -> tuple[int, int]:
    """Resolve the multi-transaction layout for ``batch`` signals on
    ``mesh``: ``(C, rows_per_transaction)``, as the chunked pipelines
    resolve it (``resolve_chunks`` over the per-device row count; whole
    checksum groups when ``groups`` is set)."""
    d = data_mesh_axis(mesh, data_axis)
    dsize = mesh_size(mesh, d) if d else 1
    if dsize > 1 and batch % dsize:
        dsize = 1                      # indivisible batch replicates
    rows = (groups if groups is not None else batch) // dsize
    if groups is not None and (groups % dsize or batch % groups):
        raise ValueError(
            f"groups={groups} must divide batch={batch} and spread over "
            f"data={dsize} — resolve with abft_group_layout first")
    c = resolve_chunks(rows, max(1, int(chunks))) if rows else 1
    per = (rows // c) * (batch // groups if groups is not None else 1)
    return c, per


def abft_group_spec(mesh, data_axis: str = DATA_AXIS) -> dict:
    """Spec of per-group ABFT telemetry (leading dim G): groups shard over
    the data dimension like the batch rows they checksum."""
    d = data_mesh_axis(mesh, data_axis)
    return {d: Shard(0)} if d else {}


def infer_fft_mesh(x, axis: str = FFT_AXIS):
    """The mesh to distribute over, inferred from ``x``: the mesh of a
    ``DTensor`` whose mesh has an ``axis`` dimension of size > 1 (the
    caller already laid the operand out for a sharded transform); None
    for anything else."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and fft_mesh_axis(x.device_mesh, axis):
        return x.device_mesh
    return None


def pencil_specs(axis: str = FFT_AXIS,
                 data_axis: str | None = None) -> tuple[dict, dict]:
    """(input, inter-pass) specs of the (B, N1, N2) pencil cube: columns
    (n2) sharded going in, rows (k1) sharded after the all-to-all; the
    batch dim over ``data_axis`` when given."""
    data = {data_axis: Shard(0)} if data_axis else {}
    return {**data, axis: Shard(2)}, {**data, axis: Shard(1)}


def signal_specs(axis: str = FFT_AXIS, data_axis: str | None = None, *,
                 natural_order: bool = True) -> dict:
    """Specs of the flat (B, N) operands of the 1-D pipelines, keyed
    ``"input"`` (:func:`shard_signals`: a contiguous block of N over
    ``axis``), ``"forward"`` (the forward's output: replicated over
    ``axis`` in natural order, ``Shard(1)`` in transposed order) and
    ``"inverse"`` (the inverse's output: the forward's in natural order;
    the TRANSPOSED_IN inverse's ``Shard(0)`` over ``data_axis``, then over
    ``axis``). The batch shards over ``data_axis`` when given."""
    data = {data_axis: Shard(0)} if data_axis else {}
    fwd = {**data, axis: Replicate() if natural_order else Shard(1)}
    inv = fwd if natural_order else {**({data_axis: Shard(0)} if data_axis
                                        else {}), axis: Shard(0)}
    return {"input": {**data, axis: Shard(1)}, "forward": fwd,
            "inverse": inv}


def _check_ndim(ndim: int) -> None:
    if ndim < 2 or ndim > 3:
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")


def slab_specs(ndim: int = 2, axis: str = FFT_AXIS,
               data_axis: str | None = None) -> tuple[dict, dict]:
    """(input, output) specs of the slab n-D transform of a (B, *grid)
    batch: the FIRST transform axis block-sharded going in, the LAST
    coming out, the batch over ``data_axis``. Both are true array-axis
    shardings: the slab's natural order costs nothing."""
    _check_ndim(ndim)
    data = {data_axis: Shard(0)} if data_axis else {}
    return {**data, axis: Shard(1)}, {**data, axis: Shard(ndim)}


def pencil_nd_specs(ndim: int = 2, axis: str = FFT_AXIS,
                    data_axis: str | None = DATA_AXIS) -> tuple[dict, dict]:
    """(input, transposed-output) specs of the pencil n-D cube ``(B,
    lead.., r1, r2, c1, c2)``: the fast digits (r2, c2) sharded over
    (``data_axis``, ``axis``) going in, the slow digits (r1, c1) coming
    out in the transposed digit order."""
    _check_ndim(ndim)
    nl = ndim - 2
    data_in = {data_axis: Shard(nl + 2)} if data_axis else {}
    data_out = {data_axis: Shard(nl + 1)} if data_axis else {}
    return {**data_in, axis: Shard(nl + 4)}, {**data_out, axis: Shard(nl + 3)}


def half_spectrum_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
    """The Hermitian half-spectrum shape of a real grid: the last axis
    folds to ``n//2 + 1`` bins, every other axis is unchanged."""
    if not shape:
        raise ValueError("half_spectrum_shape needs a non-empty shape")
    return tuple(shape[:-1]) + (shape[-1] // 2 + 1,)


def layout_specs(rank: int, decomp: str, *, axis: str = FFT_AXIS,
                 data_axis: str | None = None, real: bool = False
                 ) -> tuple[dict, dict]:
    """(input, output) specs of one planned transform's resident layouts.
    Rank 1 is always the pencil digit split (:func:`pencil_specs`); rank
    >= 2 dispatches on the resolved ``decomp`` (:func:`slab_specs` /
    :func:`pencil_nd_specs`). ``real=True`` (rank-2 slab only) is the
    half-spectrum pipeline: the slab's placements, the output array the
    :func:`half_spectrum_shape` of the input."""
    if rank == 1:
        return pencil_specs(axis, data_axis)
    if real:
        if rank != 2 or decomp != "slab":
            raise ValueError(
                f"the real half-spectrum layout is the rank-2 slab "
                f"(rfft2); got rank={rank}, decomp={decomp!r}")
        return slab_specs(rank, axis, data_axis)
    if decomp == "slab":
        return slab_specs(rank, axis, data_axis)
    if decomp == "pencil":
        return pencil_nd_specs(rank, axis, data_axis)
    raise ValueError(f"decomp must be slab|pencil for rank {rank}, "
                     f"got {decomp!r}")


def shard_grid(x, mesh, ndim: int = 2, *, decomp: str = "slab",
               axis: str = FFT_AXIS, data_axis: str | None = DATA_AXIS):
    """Distribute a (..., *grid) batch of n-D grids as a ``DTensor``:
    contiguous blocks of the first (slab) or of the last two (pencil)
    transform axes, the leading batch dim over ``data_axis`` when it
    divides. ``x`` is the global value, the same on every rank: each rank
    keeps its block, with no collective.

    The slab placement is the pipeline's input layout exactly; the pencil
    wants the fast digits sharded, strided in the flat axes, so the
    pipeline gathers these blocks once (the ingest)."""
    from torch.distributed.tensor import distribute_tensor

    x = torch.as_tensor(x)
    if x.dim() < ndim:
        raise ValueError(f"input rank {x.dim()} < ndim={ndim}")
    nlead = x.dim() - ndim
    daxis = data_mesh_axis(mesh, data_axis) if data_axis else None
    if decomp == "slab":
        spec = {axis: Shard(nlead)}
        if daxis and nlead >= 1 and x.shape[0] % mesh_size(mesh, daxis) == 0:
            spec[daxis] = Shard(0)
    elif decomp == "pencil":
        spec = {axis: Shard(x.dim() - 1)}
        if daxis and x.shape[-2] % mesh_size(mesh, daxis) == 0:
            spec[daxis] = Shard(x.dim() - 2)
    else:
        raise ValueError(f"decomp must be slab|pencil, got {decomp!r}")
    return distribute_tensor(x, mesh, placements(mesh, spec),
                             src_data_rank=None)


def shard_signals(x, mesh, axis: str = FFT_AXIS,
                  data_axis: str | None = DATA_AXIS):
    """Distribute a (..., N) batch as a ``DTensor``: each rank holds a
    contiguous block of the signal axis (``Shard(-1)`` over ``axis``) and,
    when the mesh has a ``data_axis`` of size > 1 that divides the leading
    dim, a slice of the batch too. ``x`` is the global value, the same on
    every rank: each rank keeps its block, with no collective.

    The transform's pencil layout (every ``n1`` row's ``n2``-columns on one
    rank) is strided in the flat axis, so the pipeline re-tiles these
    blocks into pencils with one ingest all-to-all.
    """
    from torch.distributed.tensor import distribute_tensor

    x = torch.as_tensor(x)
    make_dist_plan(x.shape[-1], mesh_size(mesh, axis), axis)  # validate
    daxis = data_mesh_axis(mesh, data_axis) if data_axis else None
    if daxis is not None and (x.dim() < 2
                              or x.shape[0] % mesh_size(mesh, daxis)):
        daxis = None   # ragged / missing batch dim: replicate it instead
    spec = {axis: Shard(x.dim() - 1)}
    if daxis:
        spec[daxis] = Shard(0)
    return distribute_tensor(x, mesh, placements(mesh, spec),
                             src_data_rank=None)
