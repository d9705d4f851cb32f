"""The port's sharded 1-D FFT (``repro_torch.core.fft.distributed``) against
the reference (``repro.core.fft.distributed``) and ``np.fft``.

Without a spawn: the split rule, the chunk and group resolution and the
volume models, value for value against the reference's over grids of
sizes; ``block_fft_plain``'s pass twiddle with an explicit M, offset and
middle-axis step against a numpy formula; and the pipeline's per-shard
pipelines driven as D shards in one process (``torch_shards.fft_on_shards``:
the mesh's loops on threads, a tensor permute in place of the
collectives) against ``np.fft``, the two-pass tail included.

With one four-process gloo spawn on the CPU (a file store under
``tmp_path``, so parallel workers never race for a port), shared by the
whole file: the plan API, ``distributed_fft``, ``extensions.rfft/irfft``,
``shard_signals`` and ``ops.fft``'s auto-dispatch on a 1-D mesh of 4 and
a 2 x 2 ``data x fft`` mesh, natural, transposed and TRANSPOSED_IN order,
``chunks=2`` bitwise against ``chunks=1``, ``make_fft_mesh``'s shrink rules
at world size 4, and a spy on ``dist.all_to_all_single`` /
``dist.all_gather_into_tensor`` holding each transform's calls and bytes
to ``plan.volume``. The reference's own outputs on a 1-D mesh of 4 come
from one JAX subprocess running at the same time (its 2-D meshes fail in
this container's JAX, so the 2 x 2 mesh is held to ``np.fft`` only).

Tolerance: ``ATOL[dtype] * max|ref|`` (4e-5 complex64, 1e-11 complex128).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ATOL, REPO

from repro_torch.core.fft import distributed as tdist
from repro_torch.core.fft.api import FFTSpec, FTConfig
from repro_torch.core.fft.plan import PassLayout, make_plan
from repro_torch.kernels.stockham import block_fft, block_fft_plain
from torch_shards import (CHUNKED, FT_GROUPS, FT_N, FT_SCENARIOS,
                          expected_verdicts, fft_on_shards, pencil)

CPU = "cpu"
SIZES = (10, 14)            # log2 N of the spawned cases
BATCH = 8
PAD_BATCH = 6               # a TRANSPOSED_IN batch that needs padding to 8
DTYPES = ("complex64", "complex128")


def _ref():
    from repro.core.fft import distributed as rdist
    return rdist


def _same(call_port, call_ref):
    """Both calls return the same value, or raise the same error words."""
    try:
        want = call_ref()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            call_port()
        assert str(got.value) == str(e)
        return
    assert call_port() == want


# ---------------------------------------------------------------------------
# the plain arithmetic, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("ln", range(4, 30))
def test_make_dist_plan_matches_reference(ln, shards):
    rd = _ref()
    n = 1 << ln

    def fields(p):
        return (p.n, p.n1, p.n2, p.shards, p.axis, p.local_in, p.local_out)

    _same(lambda: fields(tdist.make_dist_plan(n, shards)),
          lambda: fields(rd.make_dist_plan(n, shards)))


@pytest.mark.parametrize("n,shards", [(100, 2), (1 << 14, 3), (8, 4),
                                      (0, 1)])
def test_make_dist_plan_rejects_what_the_reference_rejects(n, shards):
    rd = _ref()
    with pytest.raises(ValueError) as want:
        rd.make_dist_plan(n, shards)
    with pytest.raises(ValueError) as got:
        tdist.make_dist_plan(n, shards)
    assert str(got.value) == str(want.value)


def test_constants_match_reference():
    rd = _ref()
    for name in ("FFT_AXIS", "DATA_AXIS", "_AUTO", "EPS", "ID_VAR_TOL",
                 "CHUNK_LATENCY_BYTES"):
        assert getattr(tdist, name) == getattr(rd, name), name


@pytest.mark.parametrize("rows", [0, 1, 2, 3, 6, 8, 12, 16, 24])
def test_resolve_chunks_matches_reference(rows):
    rd = _ref()
    for chunks in (0, 1, 2, 3, 4, 5, 8, 16):
        for granule in (1, 2, 4):
            assert tdist.resolve_chunks(rows, chunks, granule=granule) \
                == rd.resolve_chunks(rows, chunks, granule=granule)


@pytest.mark.parametrize("a2a_bytes", [0, 1 << 10, 1 << 16, 1 << 18,
                                       3 << 20, 1 << 22, 1 << 30])
def test_choose_chunks_matches_reference(a2a_bytes):
    rd = _ref()
    for rows in (1, 2, 3, 8, 12, 64):
        for granule in (1, 4):
            for cap in (2, 8):
                assert tdist.choose_chunks(a2a_bytes, rows, granule=granule,
                                           max_chunks=cap) \
                    == rd.choose_chunks(a2a_bytes, rows, granule=granule,
                                        max_chunks=cap)


@pytest.mark.parametrize("batch", [1, 6, 8, 12, 16])
def test_resolve_abft_groups_matches_reference(batch):
    rd = _ref()
    for groups in (None, 1, 2, 3, 4, 8):
        for group_size in (None, 2, 4, 5):
            for data_shards in (1, 2, 4):
                kw = dict(groups=groups, group_size=group_size,
                          data_shards=data_shards)
                _same(lambda: tdist.resolve_abft_groups(batch, **kw),
                      lambda: rd.resolve_abft_groups(batch, **kw))


_VOLUME_CASES = [
    dict(),
    dict(itemsize=16),
    dict(natural_order=False),
    dict(ft=True, groups=4),
    dict(ft=True, groups=4, data_shards=2),
    dict(ft=True, groups=3, data_shards=2),
    dict(ft=True, itemsize=16, groups=2, chunks=2),
    dict(data_shards=2, chunks=4),
    dict(real=True),
    dict(real=True, ft=True),
    dict(chunks=0),
]


@pytest.mark.parametrize("kw", _VOLUME_CASES,
                         ids=[",".join(f"{k}={v}" for k, v in c.items())
                              or "default" for c in _VOLUME_CASES])
@pytest.mark.parametrize("n,batch,shards", [(1 << 14, 8, 4),
                                            (1 << 17, 12, 2),
                                            (1 << 20, 256, 8)])
def test_collective_volume_matches_reference(n, batch, shards, kw):
    rd = _ref()
    _same(lambda: tdist.collective_volume(n, batch, shards, **kw),
          lambda: rd.collective_volume(n, batch, shards, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(kernel_batch=1),
                                dict(kernel_batch=4, data_shards=2),
                                dict(real=True, kernel_batch=3),
                                dict(itemsize=16, chunks=2)])
@pytest.mark.parametrize("n,batch,shards", [(1 << 14, 8, 4),
                                            (1 << 20, 16, 2)])
def test_spectral_volume_matches_reference(n, batch, shards, kw):
    rd = _ref()
    assert tdist.spectral_volume(n, batch, shards, **kw) \
        == rd.spectral_volume(n, batch, shards, **kw)


class _BothMesh:
    """A mesh as both packages read one: the reference's ``axis_names`` and
    ``shape``, the port's ``mesh_dim_names`` and ``size``."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = self.mesh_dim_names = tuple(sizes)
        self.device_type = "cpu"

    def size(self, dim=None):
        return list(self.shape.values())[dim]


_MESHES = [None, _BothMesh(fft=4), _BothMesh(data=2, fft=2),
           _BothMesh(data=4, fft=1), _BothMesh(data=1, fft=8)]


@pytest.mark.parametrize("mesh", _MESHES,
                         ids=["none", "fft4", "data2xfft2", "data4xfft1",
                              "data1xfft8"])
def test_fft_sharding_helpers_match_reference(mesh):
    """The mesh-axis queries and the ABFT-group and chunk layouts, value
    for value (or the same error words) against the reference's."""
    from repro.parallel import fft_sharding as rfs

    from repro_torch.parallel import fft_sharding as tfs

    assert tfs.fft_mesh_axis(mesh) == rfs.fft_mesh_axis(mesh)
    assert tfs.data_mesh_axis(mesh) == rfs.data_mesh_axis(mesh)
    for batch in (6, 8, 12):
        for groups in (None, 1, 2, 4):
            _same(lambda: tfs.abft_group_layout(mesh, batch, groups=groups),
                  lambda: rfs.abft_group_layout(mesh, batch, groups=groups))
            for chunks in (1, 2, 3, 4):
                _same(lambda: tfs.chunk_layout(mesh, batch, chunks,
                                               groups=groups),
                      lambda: rfs.chunk_layout(mesh, batch, chunks,
                                               groups=groups))
    want = rfs.abft_group_spec(mesh)
    got = tfs.abft_group_spec(mesh)
    assert list(got) == [a for a in want if a is not None]


def test_fft_sharding_specs_mirror_the_reference_partition_specs():
    """Each placement names the mesh dimension the reference's
    PartitionSpec puts on the same array dimension, the n-D layouts'
    (``slab_specs``, ``pencil_nd_specs``, ``layout_specs`` at rank 2)
    included; ``shard_grid`` needs a grid of the transform's rank."""
    from torch.distributed.tensor import Shard

    from repro.parallel import fft_sharding as rfs
    from repro_torch.parallel import fft_sharding as tfs

    for data in (None, "data"):
        for got, want in zip(tfs.pencil_specs("fft", data),
                             rfs.pencil_specs("fft", data)):
            assert {name: pl.dim for name, pl in got.items()} == {
                name: dim for dim, name in enumerate(want) if name}
        assert tfs.layout_specs(1, "pencil", data_axis=data) \
            == tfs.pencil_specs("fft", data)
    specs = tfs.signal_specs("fft", "data", natural_order=False)
    assert specs["input"] == {"data": Shard(0), "fft": Shard(1)}
    assert specs["inverse"] == {"data": Shard(0), "fft": Shard(0)}
    for shape in ((8, 64), (2, 16, 33)):
        assert tfs.half_spectrum_shape(shape) == rfs.half_spectrum_shape(
            shape)
    for got, want in ((tfs.layout_specs(2, "slab"),
                       rfs.layout_specs(2, "slab")),
                      (tfs.slab_specs(), rfs.slab_specs()),
                      (tfs.pencil_nd_specs(), rfs.pencil_nd_specs())):
        for g, w in zip(got, want):
            assert {name: pl.dim for name, pl in g.items()} == {
                name: dim for dim, name in enumerate(w) if name}
    with pytest.raises(ValueError, match="input rank 2 < ndim=3"):
        tfs.shard_grid(torch.zeros(8, 8), None, 3)


# ---------------------------------------------------------------------------
# block_fft_plain's pass twiddle of a global column
# ---------------------------------------------------------------------------


def _stages(n):
    return make_plan(n).stages[0]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m,offset,mid_step", [(1 << 12, 0, 0),
                                               (1 << 12, 48, 0),
                                               (1 << 14, 96, 0),
                                               (1 << 14, 40, 64)])
def test_block_fft_plain_twiddle_with_m_offset_and_mid_step(
        dtype, inverse, m, offset, mid_step):
    """Point k of signal (b, j, i) times w_M^(k * (offset + i + mid_step*j))
    (the sign of the direction), against numpy in float64."""
    from repro_torch.kernels.stockham import pass_twiddle_table

    n, rows, mid, fast = 16, 2, 3, 8
    rng = np.random.default_rng(m + offset + mid_step)
    x = (rng.standard_normal((rows, mid, fast, n))
         + 1j * rng.standard_normal((rows, mid, fast, n)))
    # the signals' points n apart... stored point-major: (rows, mid, n, fast)
    xs = np.ascontiguousarray(x.transpose(0, 1, 3, 2))
    layout = PassLayout(((rows, mid * n * fast, mid * n * fast),
                         (mid, n * fast, n * fast), (fast, 1, 1)),
                        fast, fast)
    tw = pass_twiddle_table(m, dtype, inverse=inverse)
    got = block_fft_plain(torch.from_numpy(xs).to(dtype), _stages(n),
                          inverse=inverse, layout=layout, twiddle=tw, m=m,
                          offset=offset, mid_step=mid_step)
    f = np.fft.ifft(x, axis=-1) * n if inverse else np.fft.fft(x, axis=-1)
    i = (offset + np.arange(fast)[None, :, None]
         + mid_step * np.arange(mid)[:, None, None])
    k = np.arange(n)[None, None, :]
    sign = 1.0 if inverse else -1.0
    want = f * np.exp(sign * 2j * np.pi * ((i * k) % m) / m)[None]
    got = got.numpy().reshape(rows, mid, n, fast).transpose(0, 1, 3, 2)
    tol = ATOL[np.dtype(str(dtype).split(".")[-1])] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_block_fft_default_twiddle_is_unchanged(dtype):
    """The defaults (M = N * the fastest count, offset and step 0) give the
    same bits as stating them, on both the wrapper and the plain version."""
    from repro_torch.kernels.stockham import pass_twiddle_table

    n, fast = 32, 16
    layout = PassLayout(((4, n * fast, n * fast), (fast, 1, 1)), fast, fast)
    x = torch.randn((4, n * fast), dtype=dtype,
                    generator=torch.Generator().manual_seed(3))
    tw = pass_twiddle_table(n * fast, dtype)
    a = block_fft(x, _stages(n), layout=layout, twiddle=tw)
    b = block_fft_plain(x, _stages(n), layout=layout, twiddle=tw,
                        m=n * fast, offset=0, mid_step=0)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the per-shard steps in one process
# ---------------------------------------------------------------------------


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _close(got, want, dtype, factor=1.0):
    got, want = np.asarray(got), np.asarray(want)
    tol = factor * ATOL[np.dtype(dtype)] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _transposed(y, n, shards):
    """The transposed digit order of natural-order ``y``:
    ``t[k1*N2 + k2] = y[k1 + N1*k2]``."""
    p = tdist.make_dist_plan(n, shards)
    return y.reshape(-1, p.n2, p.n1).transpose(0, 2, 1).reshape(-1, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ln,shards,batch,tail", [
    (8, 2, 5, None), (10, 4, 8, None), (14, 4, 3, None),
    (12, 4, 6, (8, 8)), (12, 4, 8, (8, 8)), (14, 2, 3, (16, 8))],
    ids=["2^8/2", "2^10/4", "2^14/4", "2^12/4-two-pass",
         "2^12/4-two-pass-even", "2^14/2-two-pass"])
def test_fft_on_shards_matches_numpy(dtype, ln, shards, batch, tail):
    """The mesh pipelines on ``shards`` in-process shards, each reading
    the plain global input: natural forward, natural inverse, transposed
    forward and the TRANSPOSED_IN inverse (padded where the batch does not
    divide; with a two-pass tail it copies each chunk's signals
    contiguous), with ``chunks=2`` bitwise ``chunks=1``; ``tail`` splits
    N2 into two local passes, as N >= 2^23 does."""
    n = 1 << ln
    x = _rand((batch, n), dtype, ln + shards)
    xt = torch.from_numpy(x)
    ref = np.fft.fft(x)
    kw = dict(tail=tail)
    _close(fft_on_shards(xt, shards, **kw).numpy(), ref, dtype)
    _close(fft_on_shards(torch.from_numpy(ref.astype(dtype)), shards,
                         inverse=True, **kw).numpy(), x, dtype)
    yt = fft_on_shards(xt, shards, natural_order=False, **kw)
    _close(yt.numpy(), _transposed(ref, n, shards), dtype)
    back = fft_on_shards(yt, shards, inverse=True, natural_order=False, **kw)
    _close(back.numpy(), x, dtype)
    assert torch.equal(
        fft_on_shards(yt, shards, inverse=True, natural_order=False,
                      chunks=2, **kw), back)
    assert torch.equal(fft_on_shards(xt, shards, chunks=2, **kw),
                       fft_on_shards(xt, shards, **kw))


def test_pencil_launches_one_pass1_and_the_tail(monkeypatch):
    """A transaction launches block_fft once for pass 1 and once a pass
    of the n2 tail; the TRANSPOSED_IN inverse once a pass of pass A and
    once for pass B."""
    from repro_torch.kernels import stockham

    n, shards = 1 << 12, 4
    x = torch.from_numpy(_rand((4, n), "complex64", 0))
    for tail, want in ((None, 2), ((8, 8), 3)):
        p = pencil(n, shards, torch.complex64, CPU, tail)
        assert p.launches == want
        before = stockham.block_fft.launches
        calls = []
        real = stockham.block_fft_plain

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)

        monkeypatch.setattr(stockham, "block_fft_plain", counted)
        yt = fft_on_shards(x, shards, natural_order=False, p=p)
        assert len(calls) == shards * want
        calls.clear()
        fft_on_shards(yt, shards, inverse=True, natural_order=False, p=p)
        assert len(calls) == shards * want
        monkeypatch.setattr(stockham, "block_fft_plain", real)
        assert stockham.block_fft.launches == before   # the CPU launches none


# ---------------------------------------------------------------------------
# the n-D specs plan; what stays to port (serving over a mesh) raises,
# naming its item
# ---------------------------------------------------------------------------


class _FakeMesh:
    """A mesh of four fft ranks as the spec validates it (names, sizes,
    device type), for the raises that need no process group."""

    mesh_dim_names = ("fft",)
    device_type = "cpu"

    def size(self, dim=None):
        return 4


@pytest.mark.parametrize("kw,decomp", [
    (dict(rank=2, shape=(8, 64, 64), ft=FTConfig()), "slab"),
    (dict(rank=2, shape=(8, 64, 64)), "slab"),
    (dict(rank=3, shape=(2, 8, 8, 8)), "slab"),
    (dict(rank=2, real=True, shape=(8, 64, 64)), "slab")],
    ids=["ft", "rank2", "rank3", "real-rank2"])
def test_unported_mesh_paths_name_their_item(kw, decomp):
    """The n-D specs on a mesh of four fft ranks plan (the n-D half of the
    sharded library is ported: tests/test_torch_distributed_nd.py runs
    them), each on the decomposition the reference picks."""
    from repro_torch.core.fft import api

    kw = dict(dict(shape=(8, 64)), **kw)
    p = api.plan(FFTSpec(mesh=_FakeMesh(), device=CPU, **kw))
    assert p.sharded and p.decomp == decomp and p.volume is not None


def test_spectral_consumers_and_serving_on_a_mesh_name_item_10_3():
    """The 2-D convolution plans on a mesh; serving over a mesh (item
    10.4) resolves the mesh's specs: the bucketer pads for its four fft
    ranks, the spectrum's spec stays transposed there, and ``serve_fft``
    asked for four shards on one process (no process group) serves the
    local plan, as the reference's does on one device (the mesh paths run
    in ``tests/test_torch_serve_mesh.py``'s spawn)."""
    from repro_torch.core.fft import api, multidim
    from repro_torch.launch import serve as launch
    from repro_torch.serve import SpecBucketer, build_fft_spec
    from repro_torch.serve.bucketing import mesh_shards

    a = torch.zeros((2, 64))
    grid = multidim._conv2_shape((20, 24), (5, 7), 4)
    p = api.plan(FFTSpec(shape=(2,) + grid, rank=2, real=True,
                         mesh=_FakeMesh(), device=CPU))
    assert (p.tshape, p.decomp) == ((32, 32), "slab")
    assert mesh_shards(_FakeMesh()) == 4
    key = SpecBucketer(mesh=_FakeMesh()).key_for((60, 100), np.complex64)
    assert key.tshape == (64, 128)
    spec = build_fft_spec((8, 64), mesh=_FakeMesh(), op="spectrum",
                          device=CPU)
    assert spec.natural_order is False and spec.mesh is not None
    y, info = launch.serve_fft(a, shards=4, device=CPU)
    assert info == {"shards": 1, "data": 1, "op": "fft", "ft": False}
    assert torch.equal(y, torch.zeros((2, 64), dtype=torch.complex64))


def test_spec_mesh_validation():
    with pytest.raises(ValueError, match="DeviceMesh"):
        FFTSpec(shape=(8, 64), mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        FFTSpec(shape=(8, 64), mesh=_FakeMesh(), axis="x", device=CPU)
    with pytest.raises(ValueError, match="device type"):
        FFTSpec(shape=(8, 64), mesh=_FakeMesh(), device="cuda")
    with pytest.raises(ValueError, match="chunks"):
        FFTSpec(shape=(8, 64), chunks=-1, device=CPU)
    with pytest.raises(ValueError, match="decomp"):
        FFTSpec(shape=(8, 64), decomp="slab", device=CPU)
    with pytest.raises(ValueError, match="natural-order only"):
        FFTSpec(shape=(8, 64), real=True, natural_order=False, device=CPU)
    with pytest.raises(ValueError, match=r"\(B, N\) operands"):
        FFTSpec(shape=(2, 4, 64), mesh=_FakeMesh(), device=CPU)


@pytest.mark.parametrize("mesh", [_BothMesh(fft=4), _BothMesh(data=2, fft=2)],
                         ids=["fft4", "data2xfft2"])
@pytest.mark.parametrize("shape,dtype,chunks,natural", [
    ((8, 1 << 14), "complex64", 1, True),
    ((8, 1 << 14), "complex64", 2, True),
    ((8, 1 << 14), "complex128", 0, False),
    ((256, 1 << 20), "complex64", 0, True),
    ((6, 1 << 12), "complex64", 4, False)],
    ids=["c64-bulk", "c64-2", "c128-auto", "c64-2^20-auto", "ragged-4"])
def test_plan_resolves_the_pencil_as_the_reference(mesh, shape, dtype,
                                                   chunks, natural):
    """A sharded rank-1 plan's split, data dimension, transaction count
    (``chunks=0``: ``choose_chunks`` on the modelled all-to-all bytes) and
    ``volume`` are the reference plan's resolution. A real plan with the
    same ``chunks`` models the packed half length in one transaction, the
    one its rfft/irfft run, and resolves ``chunks`` apart for the spectral
    consumers, as the reference's ``_build_1d_real`` does; nothing here
    needs a process group."""
    from repro_torch.core.fft import api

    rd = _ref()
    b, n = shape
    shards = mesh.shape["fft"]
    dsize = mesh.shape.get("data", 1)
    dsz = dsize if b % dsize == 0 else 1
    item = np.dtype(dtype).itemsize
    p = api.plan(FFTSpec(shape, dtype=dtype, mesh=mesh, chunks=chunks,
                         natural_order=natural, device=CPU))
    assert (p.decomp, p.shards, p.dsize) == ("pencil", shards, dsize)
    assert p.daxis == ("data" if dsize > 1 else None)
    want = rd.make_dist_plan(n, shards)
    assert (p.dist_plan.n1, p.dist_plan.n2) == (want.n1, want.n2)
    kw = dict(itemsize=item, natural_order=natural, data_shards=dsz)
    rows = b // dsz
    ask = chunks or rd.choose_chunks(
        rd.collective_volume(n, b, shards, **kw)["all_to_all_bytes"], rows)
    assert p.chunks == rd.resolve_chunks(rows, ask)
    assert p.volume == rd.collective_volume(n, b, shards, chunks=p.chunks,
                                            **kw)
    r = api.plan(FFTSpec(shape, dtype=dtype, mesh=mesh, real=True,
                         chunks=chunks, device=CPU))
    assert r.decomp == "pencil"
    rvol = rd.collective_volume(n, b, shards, real=True, itemsize=item,
                                data_shards=dsz)
    assert r.volume == rvol
    ask = chunks or rd.choose_chunks(rvol["all_to_all_bytes"], rows)
    assert r.chunks == rd.resolve_chunks(rows, max(1, ask))


@pytest.mark.parametrize("devices,shards,data,want", [
    (4, None, 1, (1, 4)), (4, 3, 1, (1, 2)), (4, 8, 2, (1, 4)),
    (4, 2, 2, (2, 2)), (4, None, 2, (2, 2)), (8, 4, 4, (2, 4)),
    (6, None, 1, (1, 4)), (1, None, 1, (1, 1))])
def test_fft_mesh_shape_shrinks_as_the_reference(devices, shards, data,
                                                 want):
    from repro_torch.launch.mesh import fft_mesh_shape

    assert fft_mesh_shape(devices, shards, data) == want


def test_make_fft_mesh_raises_without_a_card_or_a_group(monkeypatch):
    from repro_torch.launch.mesh import make_fft_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fft_mesh(4)
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_fft_mesh(4, device=CPU)


# ---------------------------------------------------------------------------
# four gloo ranks on the CPU, one spawn for the file
# ---------------------------------------------------------------------------

_REF_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro.core.fft.distributed import distributed_fft, distributed_ifft
try:        # GSPMD's automatic sharding, which the reference is written for
    from jax.sharding import AxisType
    mesh = jax.make_mesh((4,), ("fft",), axis_types=(AxisType.Auto,))
except ImportError:
    mesh = jax.make_mesh((4,), ("fft",))
inp = np.load(sys.argv[1])
out = {}
for key in inp.files:
    if "/" in key:
        continue
    x = inp[key]
    out[key + "/fwd"] = np.asarray(distributed_fft(x, mesh))
    out[key + "/inv"] = np.asarray(distributed_ifft(np.fft.fft(x).astype(
        x.dtype), mesh))
    yt = distributed_fft(x, mesh, natural_order=False)
    out[key + "/fwd_t"] = np.asarray(yt)
    out[key + "/inv_t"] = np.asarray(distributed_ifft(yt, mesh,
                                                      natural_order=False))
# the grouped ABFT's scenario catalogue (the reference runs it on its 1-D
# mesh only) and the spectral consumers on the mesh
import json, os
import jax.numpy as jnp
from repro.core.fft.distributed import ft_distributed_fft
from repro.core.fft import spectral
scen = json.load(open(os.path.join(os.path.dirname(sys.argv[1]),
                                   "scenarios.json")))
for key in inp.files:
    if not key.startswith("ft/"):
        continue
    x = inp[key]
    dt = key.split("/")[1]
    thr, mag = scen["threshold"][dt], scen["mag"][dt]
    rdt = jnp.float64 if dt == "complex128" else jnp.float32
    for sc in scen["cases"]:
        if not sc["ref"]:
            continue
        # every case's rows padded to four with disabled ones: one compile
        # serves them all
        rows = [r[:5] + [r[5] * mag, r[6] * mag] for r in sc["inject"] or []]
        inj = jnp.asarray(rows + [[0.0] * 7] * (4 - len(rows)), rdt)
        res = ft_distributed_fft(x, mesh, threshold=thr, groups=4,
                                 inject=inj, **sc["kw"])
        name = key + "/" + sc["name"]
        out[name + "/y"] = np.asarray(res.y)
        for f in ("shard_delta", "group_score", "flagged", "location",
                  "correctable", "checksum_fault", "corrected",
                  "recomputed"):
            out[name + "/" + f] = np.asarray(getattr(res, f))
for key in inp.files:
    # one complex and one real operand type (numpy holds all four)
    if key not in ("sp/complex64/a", "sp/float64/a"):
        continue
    base = key[:-2]
    a = inp[key]
    for vn in ("v1", "vb"):
        v = inp[base + "/" + vn]
        out[base + "/conv_" + vn] = np.asarray(spectral.fft_convolve(a, v,
                                                                     mesh))
        out[base + "/corr_" + vn] = np.asarray(spectral.correlate(a, v, mesh))
    out[base + "/ragged"] = np.asarray(spectral.fft_convolve(
        a[:6], inp[base + "/v1"], mesh))
for key in inp.files:
    if key.startswith("ps/"):
        out[key + "/t"] = np.asarray(spectral.power_spectrum(inp[key], mesh))
        out[key + "/n"] = np.asarray(spectral.power_spectrum(
            inp[key], mesh, natural_order=True))
np.savez(sys.argv[2], **out)
"""

_WORKER_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, inputs, outdir):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=4)
    from repro_torch.core.fft import api, distributed as tdist, extensions
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_fft_mesh
    from repro_torch.parallel import infer_fft_mesh, shard_signals

    calls = []
    a2a, gather = dist.all_to_all_single, dist.all_gather_into_tensor
    reduce_ = dist.all_reduce

    def spy_a2a(out, inp, *a, **k):
        calls.append(["all_to_all", inp.numel() * inp.element_size()])
        return a2a(out, inp, *a, **k)

    def spy_gather(out, inp, *a, **k):
        # the ABFT's telemetry gathers are the real-valued ones
        kind = "all_gather" if out.is_complex() else "telemetry_gather"
        calls.append([kind, out.numel() * out.element_size()])
        return gather(out, inp, *a, **k)

    def spy_reduce(t, *a, **k):
        calls.append(["all_reduce", t.numel()])
        return reduce_(t, *a, **k)

    dist.all_to_all_single = spy_a2a
    dist.all_gather_into_tensor = spy_gather
    dist.all_reduce = spy_reduce
    res, spy, vol, arrays = {}, {}, {}, {}

    def traced(name, fn):
        calls.clear()
        y = fn()
        spy[name] = [list(c) for c in calls]
        calls.clear()
        return y

    def full(y):
        return y.full_tensor().numpy()

    mesh1 = make_fft_mesh(4, device="cpu")
    mesh2 = make_fft_mesh(2, data=2, device="cpu")
    data = np.load(inputs)
    for key in data.files:
        if "/" in key:
            continue
        x = torch.from_numpy(data[key])
        dt = key.split("_")[0]
        b, n = x.shape
        spec = dict(dtype=dt, device="cpu")
        p = api.plan(api.FFTSpec((b, n), mesh=mesh1, **spec))
        vol[key] = dict(p.volume, chunks_resolved=p.chunks)
        y = traced(key + "/fwd", lambda: p.fft(x))
        arrays[key + "/fwd"] = full(y)
        arrays[key + "/fwd_placements"] = np.array([repr(q) for q in
                                                    y.placements])
        X = torch.from_numpy(np.fft.fft(data[key]).astype(data[key].dtype))
        arrays[key + "/inv"] = full(traced(key + "/inv",
                                           lambda: p.ifft(X)))
        arrays[key + "/roundtrip"] = full(p.ifft(p.fft(x)))
        pt = api.plan(api.FFTSpec((b, n), mesh=mesh1, natural_order=False,
                                  **spec))
        vol[key + "/t"] = dict(pt.volume)
        yt = traced(key + "/fwd_t", lambda: pt.fft(x))
        arrays[key + "/fwd_t"] = full(yt)
        arrays[key + "/fwd_t_local"] = yt.to_local().numpy()
        xi = traced(key + "/inv_t", lambda: pt.ifft(yt))
        arrays[key + "/inv_t"] = full(xi)
        arrays[key + "/inv_t_local_rows"] = np.array(xi.to_local().shape[0])
        pc = api.plan(api.FFTSpec((b, n), mesh=mesh1, natural_order=False,
                                  chunks=2, **spec))
        vol[key + "/t2"] = dict(pc.volume, chunks_resolved=pc.chunks)
        yt2 = traced(key + "/fwd_t2", lambda: pc.fft(x))
        res[key + "/chunks_fwd_t_bitwise"] = bool(
            torch.equal(yt2.to_local(), yt.to_local()))
        xi2 = traced(key + "/inv_t2", lambda: pc.ifft(yt2))
        res[key + "/chunks_inv_t_bitwise"] = bool(
            torch.equal(xi2.to_local(), xi.to_local()))
        pn2 = api.plan(api.FFTSpec((b, n), mesh=mesh1, chunks=2, **spec))
        res[key + "/chunks_fwd_bitwise"] = bool(
            torch.equal(pn2.fft(x).to_local(), y.to_local()))
        # a batch the TRANSPOSED_IN inverse pads (6 rows over 4 ranks)
        xp = x[:6]
        pp = api.plan(api.FFTSpec((6, n), mesh=mesh1, natural_order=False,
                                  chunks=2, **spec))
        xb = pp.ifft(pp.fft(xp))
        arrays[key + "/pad_roundtrip"] = full(xb)
        res[key + "/pad_local_rows"] = int(xb.to_local().shape[0])
        # the 2 x 2 data x fft mesh
        q = api.plan(api.FFTSpec((b, n), mesh=mesh2, **spec))
        vol[key + "/mesh2"] = dict(q.volume)
        y2 = traced(key + "/mesh2_fwd", lambda: q.fft(x))
        arrays[key + "/mesh2_fwd"] = full(y2)
        res[key + "/mesh2_placements"] = [repr(v) for v in y2.placements]
        arrays[key + "/mesh2_inv"] = full(q.ifft(X))
        qt = api.plan(api.FFTSpec((b, n), mesh=mesh2, natural_order=False,
                                  **spec))
        y2t = qt.fft(x)
        arrays[key + "/mesh2_fwd_t"] = full(y2t)
        arrays[key + "/mesh2_inv_t"] = full(qt.ifft(y2t))
        res[key + "/mesh2_inv_t_placements"] = [
            repr(v) for v in qt.ifft(y2t).placements]
        # distributed_fft / distributed_ifft
        arrays[key + "/dist_fwd"] = full(tdist.distributed_fft(x, mesh1))
        arrays[key + "/dist_inv_t"] = full(tdist.distributed_ifft(
            tdist.distributed_fft(x, mesh1, natural_order=False), mesh1,
            natural_order=False))
        # shard_signals -> spec_for / infer_fft_mesh -> ops.fft
        xs = p.shard(x)
        res[key + "/infer_is_mesh"] = infer_fft_mesh(xs) is mesh1
        res[key + "/spec_for_mesh"] = api.spec_for(xs, device="cpu").mesh \
            is mesh1
        res[key + "/shard_placements"] = [repr(v) for v in xs.placements]
        arrays[key + "/ops_fft"] = full(traced(
            key + "/ops_fft", lambda: ops.fft(xs, device="cpu")))
        arrays[key + "/ops_ifft"] = full(ops.ifft(ops.fft(xs, device="cpu"),
                                                  device="cpu"))
        xs2 = shard_signals(x, mesh2)
        arrays[key + "/mesh2_ops_fft"] = full(traced(
            key + "/mesh2_ops_fft", lambda: ops.fft(xs2, device="cpu")))
        # the packed real transform on the mesh
        xr = x.real.contiguous()
        yr = extensions.rfft(xr, mesh=mesh1, device="cpu")
        arrays[key + "/rfft"] = full(yr)
        arrays[key + "/irfft"] = full(extensions.irfft(yr, mesh=mesh1,
                                                       device="cpu"))
        pr = api.plan(api.FFTSpec((b, n), dtype=dt, real=True, mesh=mesh1,
                                  device="cpu"))
        vol[key + "/real"] = dict(pr.volume)
        res[key + "/real_decomp"] = pr.decomp
        # chunks=2 on a real plan: its rfft/irfft still run one transaction
        pr2 = api.plan(api.FFTSpec((b, n), dtype=dt, real=True, mesh=mesh1,
                                   chunks=2, device="cpu"))
        vol[key + "/real2"] = dict(pr2.volume, chunks_resolved=pr2.chunks)
        yr2 = traced(key + "/rfft2", lambda: pr2.rfft(xr))
        res[key + "/rfft2_bitwise"] = bool(torch.equal(yr2.to_local(),
                                                       yr.to_local()))
        traced(key + "/irfft2", lambda: pr2.irfft(yr2))
    # the grouped two-side ABFT: the scenario catalogue on both meshes
    from repro_torch.core.fft import spectral
    scen = json.load(open(os.path.join(os.path.dirname(inputs),
                                       "scenarios.json")))
    tele = {}

    def keep(name, res):
        arrays[name + "/y"] = full(res.y)
        tele[name] = {f: getattr(res, f).tolist() for f in (
            "shard_delta", "group_score", "flagged", "location",
            "correctable", "checksum_fault", "corrected", "recomputed")}
        tele[name]["uncorrectable"] = res.uncorrectable.tolist()
        tele[name]["placements"] = [repr(q) for q in res.y.placements]

    for key in data.files:
        if not key.startswith("ft/"):
            continue
        x = torch.from_numpy(data[key])
        dt = key.split("/")[1]
        b, n = x.shape
        thr, mag = scen["threshold"][dt], scen["mag"][dt]

        def rows(inj):
            return None if inj is None else [
                r[:5] + [r[5] * mag, r[6] * mag] for r in inj]

        for mname, mesh in (("mesh1", mesh1), ("mesh2", mesh2)):
            for sc in scen["cases"]:
                name = f"{key}/{mname}/{sc['name']}"
                keep(name, traced(name, lambda: tdist.ft_distributed_fft(
                    x, mesh, threshold=thr, groups=4,
                    inject=rows(sc["inject"]), **sc["kw"])))
            ft = api.FTConfig(threshold=thr, groups=4)
            for chunks in (4, 2, 1):
                p = api.plan(api.FFTSpec((b, n), dtype=dt, mesh=mesh, ft=ft,
                                         chunks=chunks, device="cpu"))
                vol[f"{key}/{mname}/ft{chunks}"] = dict(
                    p.volume, chunks_resolved=p.chunks, plan_groups=p.groups)
            inj4 = rows(scen["cases"][1]["inject"])
            name = f"{key}/{mname}/plan"
            keep(name, traced(name, lambda: p.ft_fft(x, inject=inj4)))
            xs = shard_signals(x, mesh)
            name = f"{key}/{mname}/ops"
            keep(name, traced(name, lambda: ops.ft_fft(
                xs, threshold=thr, groups=4, inject=inj4, device="cpu")))
        # the threshold edge: the score itself unflags, 0.99 of it flags
        edge = rows([[0, 5, 3, 7, 1, 1.0, -0.4]])
        r0 = tdist.ft_distributed_fft(x, mesh1, threshold=thr, groups=4,
                                      inject=edge)
        score = float(r0.group_score.max())
        res[key + "/edge"] = [
            r0.flagged.tolist(),
            tdist.ft_distributed_fft(x, mesh1, threshold=score, groups=4,
                                     inject=edge).flagged.tolist(),
            tdist.ft_distributed_fft(x, mesh1, threshold=0.99 * score,
                                     groups=4, inject=edge).flagged.tolist()]
    # the rank-1 spectral consumers on both meshes
    for key in data.files:
        if not key.startswith("sp/") or not key.endswith("/a"):
            continue
        base = key[:-2]
        a = torch.from_numpy(data[key])
        for mname, mesh in (("mesh1", mesh1), ("mesh2", mesh2)):
            for vn in ("v1", "vb"):
                v = torch.from_numpy(data[base + "/" + vn])
                for op, fn in (("conv", spectral.fft_convolve),
                               ("corr", spectral.correlate)):
                    name = f"{base}/{mname}/{op}_{vn}"
                    y = traced(name, lambda: fn(a, v, mesh))
                    arrays[name] = full(y)
                    res[name + "/placements"] = [repr(q)
                                                 for q in y.placements]
                    res[name + "/local_rows"] = y.to_local().shape[0]
            v = torch.from_numpy(data[base + "/v1"])
            p2 = api.plan(spectral.conv_spec(a, v, mesh, chunks=2))
            vol[f"{base}/{mname}/chunks2"] = dict(chunks_resolved=p2.chunks)
            name = f"{base}/{mname}/conv_v1_chunks2"
            y2 = traced(name, lambda: p2.convolve(a, v))
            res[name] = bool(torch.equal(
                y2.to_local(), spectral.fft_convolve(a, v, mesh).to_local()))
        name = f"{base}/mesh1/ragged"
        arrays[name] = full(traced(name, lambda: spectral.fft_convolve(
            a[:6], torch.from_numpy(data[base + "/v1"]), mesh1)))
    for key in data.files:
        if not key.startswith("ps/"):
            continue
        x = torch.from_numpy(data[key])
        for mname, mesh in (("mesh1", mesh1), ("mesh2", mesh2)):
            for order, kw in (("t", {}), ("n", dict(natural_order=True))):
                name = f"{key}/{mname}/{order}"
                arrays[name] = full(traced(
                    name, lambda: spectral.power_spectrum(x, mesh, **kw)))
    res["tele"] = tele
    # make_fft_mesh's shrink rules at world size 4
    shrink = {}
    for name, args, kw in (("3", (3,), {}), ("8x2", (8,), dict(data=2)),
                           ("2x2", (2,), dict(data=2)),
                           ("default", (), {}), ("data4", (), dict(data=4))):
        m = make_fft_mesh(*args, device="cpu", **kw)
        shrink[name] = [list(m.mesh_dim_names), list(m.mesh.shape),
                        m.get_coordinate() is not None]
    res["shrink"] = shrink
    res["one_rank_mesh_is_local"] = api.plan(api.FFTSpec(
        (8, 1 << 10), mesh=make_fft_mesh(1, device="cpu"),
        device="cpu")).decomp
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"res": res, "spy": spy, "vol": vol}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    store, inputs, outdir = sys.argv[1:4]
    mp.spawn(run, args=(store, inputs, outdir), nprocs=4)
"""


SPECTRAL_DTYPES = ("complex64", "complex128", "float32", "float64")
SPECTRAL_REF = ("complex64", "float64")   # the reference runs these too
SP_LA, SP_LV = 3000, 1000            # nfft 4096


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Run the four gloo ranks and the reference's subprocess together;
    each rank's arrays and records, the reference's outputs and the
    inputs."""
    tmp = tmp_path_factory.mktemp("dist_fft")
    inputs = {}
    for dt in DTYPES:
        for ln in SIZES:
            inputs[f"{dt}_{ln}"] = _rand((BATCH, 1 << ln), dt, ln)
        inputs[f"ft/{dt}"] = _rand((BATCH, FT_N), dt, 3)
        inputs[f"ps/{dt}"] = _rand((BATCH, FT_N), dt, 5)
    for i, dt in enumerate(SPECTRAL_DTYPES):
        cplx = dt.startswith("complex")
        rng = np.random.default_rng(11 + i)

        def draw(*shape):
            x = rng.standard_normal(shape)
            if cplx:
                x = x + 1j * rng.standard_normal(shape)
            return x.astype(dt)

        inputs[f"sp/{dt}/a"] = draw(BATCH, SP_LA)
        inputs[f"sp/{dt}/v1"] = draw(SP_LV)
        inputs[f"sp/{dt}/vb"] = draw(BATCH, SP_LV)
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "scenarios.json").write_text(json.dumps(FT_SCENARIOS))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    (tmp / "ref.py").write_text(_REF_SCRIPT)
    (tmp / "worker.py").write_text(_WORKER_SCRIPT)
    ref = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "inputs.npz"),
         str(tmp / "ref.npz")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    work = subprocess.run(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "store"),
         str(tmp / "inputs.npz"), str(tmp)], env=env,
        capture_output=True, text=True, timeout=300)
    ref_out, _ = ref.communicate(timeout=300)
    assert work.returncode == 0, work.stdout + work.stderr
    assert ref.returncode == 0, ref_out
    ranks = []
    for r in range(4):
        rec = json.loads((tmp / f"rank{r}.json").read_text())
        rec["arrays"] = dict(np.load(tmp / f"rank{r}.npz"))
        ranks.append(rec)
    return dict(ranks=ranks, ref=dict(np.load(tmp / "ref.npz")),
                inputs=inputs)


def _keys():
    return [f"{dt}_{ln}" for dt in DTYPES for ln in SIZES]


@pytest.mark.parametrize("key", _keys())
def test_mesh_natural_forward_inverse_round_trip(spawned, key):
    x = spawned["inputs"][key]
    dt = key.split("_")[0]
    ref = np.fft.fft(x)
    for rec in spawned["ranks"]:
        a = rec["arrays"]
        _close(a[key + "/fwd"], ref, dt)
        _close(a[key + "/fwd"], spawned["ref"][key + "/fwd"], dt)
        _close(a[key + "/inv"], x, dt)
        _close(a[key + "/inv"], spawned["ref"][key + "/inv"], dt)
        _close(a[key + "/roundtrip"], x, dt)
        assert list(a[key + "/fwd_placements"]) == ["Replicate()"]


@pytest.mark.parametrize("key", _keys())
def test_mesh_transposed_forward_and_transposed_in_inverse(spawned, key):
    x = spawned["inputs"][key]
    dt = key.split("_")[0]
    n = x.shape[-1]
    want = _transposed(np.fft.fft(x), n, 4)
    for r, rec in enumerate(spawned["ranks"]):
        a = rec["arrays"]
        _close(a[key + "/fwd_t"], want, dt)
        _close(a[key + "/fwd_t"], spawned["ref"][key + "/fwd_t"], dt)
        # rank r holds the contiguous r-th block of each transposed row
        np.testing.assert_array_equal(
            a[key + "/fwd_t_local"],
            a[key + "/fwd_t"][:, r * n // 4:(r + 1) * n // 4])
        _close(a[key + "/inv_t"], x, dt)
        _close(a[key + "/inv_t"], spawned["ref"][key + "/inv_t"], dt)
        assert int(a[key + "/inv_t_local_rows"]) == BATCH // 4
        _close(a[key + "/dist_inv_t"], x, dt)
        _close(a[key + "/dist_fwd"], np.fft.fft(x), dt)


@pytest.mark.parametrize("key", _keys())
def test_mesh_transposed_in_pads_a_ragged_batch(spawned, key):
    x = spawned["inputs"][key][:PAD_BATCH]
    dt = key.split("_")[0]
    rows = [rec["res"][key + "/pad_local_rows"] for rec in spawned["ranks"]]
    assert rows == [2, 2, 2, 0]          # torch.chunk's split of 6 over 4
    for rec in spawned["ranks"]:
        _close(rec["arrays"][key + "/pad_roundtrip"], x, dt)


@pytest.mark.parametrize("key", _keys())
def test_mesh_chunks_are_bitwise_the_bulk_path(spawned, key):
    for rec in spawned["ranks"]:
        assert rec["vol"][key + "/t2"]["chunks_resolved"] == 2
        for what in ("chunks_fwd_t_bitwise", "chunks_inv_t_bitwise",
                     "chunks_fwd_bitwise"):
            assert rec["res"][f"{key}/{what}"] is True, what


@pytest.mark.parametrize("key", _keys())
def test_mesh_data_x_fft_matches_numpy(spawned, key):
    x = spawned["inputs"][key]
    dt = key.split("_")[0]
    n = x.shape[-1]
    ref = np.fft.fft(x)
    for rec in spawned["ranks"]:
        a = rec["arrays"]
        _close(a[key + "/mesh2_fwd"], ref, dt)
        _close(a[key + "/mesh2_inv"], x, dt)
        _close(a[key + "/mesh2_fwd_t"], _transposed(ref, n, 2), dt)
        _close(a[key + "/mesh2_inv_t"], x, dt)
        _close(a[key + "/mesh2_ops_fft"], ref, dt)
        assert rec["res"][key + "/mesh2_placements"] == [
            "Shard(dim=0)", "Replicate()"]
        assert rec["res"][key + "/mesh2_inv_t_placements"] == [
            "Shard(dim=0)", "Shard(dim=0)"]


@pytest.mark.parametrize("key", _keys())
def test_mesh_plan_volume_is_the_reference_model(spawned, key):
    rd = _ref()
    x = spawned["inputs"][key]
    b, n = x.shape
    item = x.dtype.itemsize
    rec = spawned["ranks"][0]
    vol = dict(rec["vol"][key])
    assert vol.pop("chunks_resolved") == 1
    assert vol == rd.collective_volume(n, b, 4, itemsize=item)
    assert rec["vol"][key + "/t"] == rd.collective_volume(
        n, b, 4, itemsize=item, natural_order=False)
    vol2 = dict(rec["vol"][key + "/t2"])
    vol2.pop("chunks_resolved")
    assert vol2 == rd.collective_volume(n, b, 4, itemsize=item,
                                        natural_order=False, chunks=2)
    assert rec["vol"][key + "/mesh2"] == rd.collective_volume(
        n, b, 2, itemsize=item, data_shards=2)
    assert rec["vol"][key + "/real"] == rd.collective_volume(
        n, b, 4, itemsize=x.real.dtype.itemsize * 2, real=True)
    vr2 = dict(rec["vol"][key + "/real2"])
    assert vr2.pop("chunks_resolved") == 2
    assert vr2 == rec["vol"][key + "/real"]


@pytest.mark.parametrize("key", _keys())
def test_mesh_collectives_are_the_modelled_ones(spawned, key):
    """Each transform's all-to-all and all-gather calls and bytes on
    every rank equal ``plan.volume``'s; an input from ``shard_signals``
    adds one ingest all-to-all of the rank's block, counted apart; the
    transposed round trip is ``spectral_volume``'s two all-to-alls and no
    all-gather."""
    x = spawned["inputs"][key]
    b, n = x.shape
    item = x.dtype.itemsize
    for rec in spawned["ranks"]:
        spy, vol = rec["spy"], rec["vol"]
        for name, v in ((key + "/fwd", vol[key]), (key + "/inv", vol[key]),
                        (key + "/fwd_t", vol[key + "/t"]),
                        (key + "/fwd_t2", vol[key + "/t2"]),
                        (key + "/mesh2_fwd", vol[key + "/mesh2"])):
            t = _totals(spy[name])
            assert t["all_to_all"] == [v["all_to_all_count"],
                                       v["all_to_all_bytes"]], name
            assert t["all_gather"] == [v["all_gather_count"],
                                       v["gather_hlo"]], name
        rt = tdist.spectral_volume(n, b, 4, itemsize=item)
        t = _totals(spy[key + "/fwd_t"] + spy[key + "/inv_t"])
        assert t["all_to_all"] == [rt["all_to_all_count"],
                                   rt["all_to_all_bytes"]]
        assert t["all_gather"] == [0, 0]
        # a real plan with chunks=2: one transaction a transform, as its
        # volume says
        vr = vol[key + "/real2"]
        assert vr["all_to_all_count"] == 1
        for name in (key + "/rfft2", key + "/irfft2"):
            t = _totals(spy[name])
            assert t["all_to_all"] == [vr["all_to_all_count"],
                                       vr["all_to_all_bytes"]], name
            assert t["all_gather"] == [vr["all_gather_count"],
                                       vr["gather_hlo"]], name
        t2 = _totals(spy[key + "/fwd_t2"] + spy[key + "/inv_t2"])
        rt2 = tdist.spectral_volume(n, b, 4, itemsize=item, chunks=2)
        assert t2["all_to_all"] == [rt2["all_to_all_count"],
                                    rt2["all_to_all_bytes"]]
        # shard_signals' block layout: one ingest all-to-all of the rank's
        # (B, N/4) block first, then the modelled transform
        for name, shards, rows in ((key + "/ops_fft", 4, b),
                                   (key + "/mesh2_ops_fft", 2, b // 2)):
            calls = spy[name]
            assert calls[0] == ["all_to_all", rows * n // shards * item]
            v = tdist.collective_volume(n, b, shards, itemsize=item,
                                        data_shards=4 // shards)
            t = _totals(calls[1:])
            assert t["all_to_all"] == [v["all_to_all_count"],
                                       v["all_to_all_bytes"]], name
            assert t["all_gather"] == [1, v["gather_hlo"]], name


@pytest.mark.parametrize("key", _keys())
def test_mesh_shard_signals_and_auto_dispatch(spawned, key):
    x = spawned["inputs"][key]
    dt = key.split("_")[0]
    for rec in spawned["ranks"]:
        assert rec["res"][key + "/infer_is_mesh"] is True
        assert rec["res"][key + "/spec_for_mesh"] is True
        assert rec["res"][key + "/shard_placements"] == ["Shard(dim=1)"]
        _close(rec["arrays"][key + "/ops_fft"], np.fft.fft(x), dt)
        _close(rec["arrays"][key + "/ops_ifft"], x, dt)


@pytest.mark.parametrize("key", _keys())
def test_mesh_rfft_irfft(spawned, key):
    x = spawned["inputs"][key].real
    dt = key.split("_")[0]
    for rec in spawned["ranks"]:
        assert rec["res"][key + "/real_decomp"] == "pencil"
        assert rec["res"][key + "/rfft2_bitwise"] is True
        _close(rec["arrays"][key + "/rfft"], np.fft.rfft(x), dt)
        _close(rec["arrays"][key + "/irfft"], x, dt, factor=2)


def test_make_fft_mesh_shrink_rules_at_world_size_4(spawned):
    for r, rec in enumerate(spawned["ranks"]):
        shrink = rec["res"]["shrink"]
        assert shrink["3"] == [["fft"], [2], r < 2]
        assert shrink["8x2"] == [["fft"], [4], True]
        assert shrink["2x2"] == [["data", "fft"], [2, 2], True]
        assert shrink["default"] == [["fft"], [4], True]
        assert shrink["data4"] == [["data", "fft"], [4, 1], True]
        assert rec["res"]["one_rank_mesh_is_local"] == "local"


# ---------------------------------------------------------------------------
# the grouped two-side ABFT on the mesh (the same spawn)
# ---------------------------------------------------------------------------

_MESHES_SPAWNED = {"mesh1": (4, 1), "mesh2": (2, 2)}   # (fft, data)
_SHARD_DELTA_BOUND = {"complex64": 1e-4, "complex128": 1e-12}


def _natural(y, name, n, shards):
    """``y`` in natural order (the transposed cases come back permuted)."""
    if "_t" in name.split("/")[-1]:
        p = tdist.make_dist_plan(n, shards)
        return y.reshape(-1, p.n1, p.n2).transpose(0, 2, 1).reshape(-1, n)
    return y


@pytest.mark.parametrize("mname", list(_MESHES_SPAWNED))
@pytest.mark.parametrize("dt", DTYPES)
def test_mesh_ft_scenario_catalogue(spawned, dt, mname):
    """Every case of the catalogue, on every rank: the expected verdicts,
    ``y`` within ``ATOL * max`` of ``np.fft`` after correction, the same
    telemetry on each rank, ``shard_delta`` under the reference's bound;
    on the 1-D mesh the reference's own verdicts, flagged groups' scores
    within 5% of its and its corrected ``y`` (its 2-D meshes fail in this
    container, so the 2 x 2 mesh is held to the catalogue alone)."""
    key = f"ft/{dt}"
    x = spawned["inputs"][key]
    n = x.shape[1]
    ref = np.fft.fft(x)
    shards, data = _MESHES_SPAWNED[mname]
    thr = FT_SCENARIOS["threshold"][dt]
    ranks = spawned["ranks"]
    for sc in FT_SCENARIOS["cases"]:
        name = f"{key}/{mname}/{sc['name']}"
        tele = ranks[0]["res"]["tele"][name]
        for rec in ranks[1:]:
            assert rec["res"]["tele"][name] == tele, name
        assert len(tele["shard_delta"]) == shards * data
        assert max(tele["shard_delta"]) < _SHARD_DELTA_BOUND[dt], name
        y = _natural(ranks[0]["arrays"][name + "/y"], name, n, shards)
        expected_verdicts(sc["name"], tele, y, ref, ATOL[np.dtype(dt)])
        if sc["inject"] is None:
            assert max(tele["group_score"]) < thr
        if mname != "mesh1" or not sc["ref"]:
            continue
        r = {f: spawned["ref"][f"{key}/{sc['name']}/{f}"] for f in (
            "flagged", "location", "correctable", "checksum_fault",
            "corrected", "recomputed", "group_score", "y")}
        flagged = np.asarray(tele["flagged"])
        np.testing.assert_array_equal(flagged, r["flagged"])
        for f in ("correctable", "checksum_fault"):
            np.testing.assert_array_equal(tele[f], r[f])
        np.testing.assert_array_equal(np.asarray(tele["location"])[flagged],
                                      r["location"][flagged])
        assert tele["corrected"] == int(r["corrected"])
        assert tele["recomputed"] == int(r["recomputed"])
        np.testing.assert_allclose(
            np.asarray(tele["group_score"])[flagged],
            r["group_score"][flagged], rtol=0.05)
        if sc["name"] not in ("nocorrect", "double"):
            _close(ranks[0]["arrays"][name + "/y"], r["y"], dt)


@pytest.mark.parametrize("mname", list(_MESHES_SPAWNED))
@pytest.mark.parametrize("dt", DTYPES)
def test_mesh_ft_chunks_are_bitwise_the_bulk_path(spawned, dt, mname):
    """chunks 2 and 4 (4 resolves to 2 on the 2 x 2 mesh's two local
    groups): ``y``, the flags, locations, correctable and ``corrected``
    bitwise the bulk path's; ``group_score`` within rtol 0.05 (its energy
    normalises per transaction)."""
    key = f"ft/{dt}"
    for rec in spawned["ranks"]:
        tele, arr = rec["res"]["tele"], rec["arrays"]
        for base in CHUNKED:
            bulk = f"{key}/{mname}/{base}"
            for c in (2, 4):
                name = f"{bulk}_c{c}"
                np.testing.assert_array_equal(arr[name + "/y"],
                                              arr[bulk + "/y"])
                for f in ("flagged", "location", "correctable",
                          "checksum_fault", "corrected"):
                    assert tele[name][f] == tele[bulk][f], (name, f)
                np.testing.assert_allclose(tele[name]["group_score"],
                                           tele[bulk]["group_score"],
                                           rtol=0.05)


@pytest.mark.parametrize("mname", list(_MESHES_SPAWNED))
@pytest.mark.parametrize("dt", DTYPES)
def test_mesh_ft_plan_and_ops_dispatch(spawned, dt, mname):
    """``plan(FFTSpec(ft=..., mesh=...)).ft_fft`` and ``ops.ft_fft`` on a
    ``shard_signals`` DTensor give the four-SEU case's verdicts and its
    ``y``; the plan resolves its groups, its chunks (whole groups; 0 would
    mean ``ft.transactions``) and the reference's ``collective_volume``."""
    rd = _ref()
    key = f"ft/{dt}"
    x = spawned["inputs"][key]
    b, n = x.shape
    shards, data = _MESHES_SPAWNED[mname]
    rec = spawned["ranks"][0]
    four = rec["res"]["tele"][f"{key}/{mname}/four"]
    for how in ("plan", "ops"):
        name = f"{key}/{mname}/{how}"
        tele = rec["res"]["tele"][name]
        for f in ("flagged", "location", "correctable", "checksum_fault",
                  "corrected"):
            assert tele[f] == four[f], (how, f)
        _close(rec["arrays"][name + "/y"],
               rec["arrays"][f"{key}/{mname}/four/y"], dt)
        want = ["Shard(dim=0)", "Replicate()"] if data > 1 \
            else ["Replicate()"]
        assert tele["placements"] == want
    for chunks in (1, 2, 4):
        vol = dict(rec["vol"][f"{key}/{mname}/ft{chunks}"])
        assert vol.pop("plan_groups") == FT_GROUPS
        ce = vol.pop("chunks_resolved")
        assert ce == rd.resolve_chunks(FT_GROUPS // data, chunks)
        assert vol == rd.collective_volume(
            n, b, shards, itemsize=x.dtype.itemsize, ft=True,
            groups=FT_GROUPS, data_shards=data, chunks=ce)


def _totals(calls):
    out = {k: [0, 0] for k in ("all_to_all", "all_gather", "all_reduce",
                               "telemetry_gather")}
    for kind, size in calls:
        out[kind][0] += 1
        out[kind][1] += size
    return out


@pytest.mark.parametrize("mname", list(_MESHES_SPAWNED))
@pytest.mark.parametrize("dt", DTYPES)
def test_mesh_ft_collectives_are_the_modelled_ones(spawned, dt, mname):
    """Each ft call's all-to-alls (the 2G checksum rows included) and its
    all-gathers of data rows equal ``collective_volume(ft=True)``'s; its
    verdict all-reduces are one a transaction, their payload summed over
    the call (3*G/data + chunks) reals; the telemetry gathers, counted
    apart, are one over ``fft`` of the D residuals and, with the batch on
    ``data``, one over ``data`` of the stats and residuals. Through
    ``shard_signals`` one ingest all-to-all comes first."""
    key = f"ft/{dt}"
    x = spawned["inputs"][key]
    b, n = x.shape
    shards, data = _MESHES_SPAWNED[mname]
    item, real = x.dtype.itemsize, x.dtype.itemsize // 2
    gl = FT_GROUPS // data
    tel = [1, shards * real] if data == 1 else \
        [2, shards * real + data * (gl * 5 + shards) * real]
    for rec in spawned["ranks"]:
        spy = rec["spy"]
        for sc in FT_SCENARIOS["cases"]:
            kw = sc["kw"]
            if kw.get("recompute_uncorrectable"):
                continue
            ce = tdist.resolve_chunks(gl, kw.get("chunks", 1))
            nat = kw.get("natural_order", True)
            v = tdist.collective_volume(n, b, shards, itemsize=item, ft=True,
                                        groups=FT_GROUPS, data_shards=data,
                                        chunks=ce, natural_order=nat)
            name = f"{key}/{mname}/{sc['name']}"
            t = _totals(spy[name])
            assert t["all_to_all"] == [v["all_to_all_count"],
                                       v["all_to_all_bytes"]], name
            assert t["all_gather"] == [v["all_gather_count"],
                                       v["gather_hlo"]], name
            assert t["all_reduce"] == [ce, 3 * gl + ce], name
            assert v["psum_hlo"] >= 2 * (3 * gl + ce) * real
            assert t["telemetry_gather"] == tel, name
        calls = spy[f"{key}/{mname}/ops"]
        assert calls[0] == ["all_to_all", b // data * n // shards * item]
        v = tdist.collective_volume(n, b, shards, itemsize=item, ft=True,
                                    groups=FT_GROUPS, data_shards=data)
        t = _totals(calls[1:])
        assert t["all_to_all"] == [1, v["all_to_all_bytes"]]
        assert t["all_reduce"] == [1, 3 * gl + 1]


@pytest.mark.parametrize("dt", DTYPES)
def test_mesh_ft_threshold_edge(spawned, dt):
    """tests/test_ft_injection_policy.py:171-190 on the 1-D mesh: the
    SEU's group flags; a threshold of exactly its score unflags (the test
    is strict), 0.99 of it flags again."""
    for rec in spawned["ranks"]:
        base, at, under = rec["res"][f"ft/{dt}/edge"]
        assert base[2] and under[2]
        assert not any(at)


# ---------------------------------------------------------------------------
# the rank-1 spectral consumers on the mesh (the same spawn)
# ---------------------------------------------------------------------------


def _np_conv(a, v, op):
    a = a.astype(np.complex128)
    v = np.broadcast_to(v, (a.shape[0], v.shape[-1])).astype(np.complex128)
    fn = np.convolve if op == "conv" else np.correlate
    return np.stack([fn(ai, vi, "full") for ai, vi in zip(a, v)])


@pytest.mark.parametrize("dt", SPECTRAL_DTYPES)
def test_mesh_spectral_consumers(spawned, dt):
    """``fft_convolve`` and ``correlate`` with a broadcast and a
    per-signal kernel on both meshes, against numpy and (on the 1-D mesh,
    ``SPECTRAL_REF``) the reference's outputs, each signal whole on one
    rank (Shard(0) over
    data, then fft); a ragged batch of 6 padded over 4 ranks; a
    ``chunks=2`` plan bitwise the bulk one. Real operands give a real
    result (the packed path)."""
    base = f"sp/{dt}"
    inp = spawned["inputs"]
    a = inp[base + "/a"]
    ctol = "complex128" if dt in ("complex128", "float64") else "complex64"
    for r, rec in enumerate(spawned["ranks"]):
        for mname, (shards, data) in _MESHES_SPAWNED.items():
            for vn in ("v1", "vb"):
                v = inp[f"{base}/{vn}"]
                for op in ("conv", "corr"):
                    name = f"{base}/{mname}/{op}_{vn}"
                    got = rec["arrays"][name]
                    assert np.iscomplexobj(got) == dt.startswith("complex")
                    _close(got, _np_conv(a, v, op), ctol)
                    if mname == "mesh1" and dt in SPECTRAL_REF:
                        _close(got, spawned["ref"][f"{base}/{op}_{vn}"],
                               ctol)
                    assert rec["res"][name + "/placements"] == (
                        ["Shard(dim=0)", "Shard(dim=0)"] if data > 1
                        else ["Shard(dim=0)"])
                    assert rec["res"][name + "/local_rows"] == \
                        BATCH // (shards * data)
            assert rec["vol"][f"{base}/{mname}/chunks2"][
                "chunks_resolved"] == 2
            assert rec["res"][f"{base}/{mname}/conv_v1_chunks2"] is True
        got = rec["arrays"][f"{base}/mesh1/ragged"]
        _close(got, _np_conv(a[:6], inp[base + "/v1"], "conv"), ctol)
        if dt in SPECTRAL_REF:
            _close(got, spawned["ref"][f"{base}/ragged"], ctol)


@pytest.mark.parametrize("dt", SPECTRAL_DTYPES)
def test_mesh_spectral_collectives_are_the_modelled_ones(spawned, dt):
    """Each spectral call's collectives are ``spectral_volume``'s: two
    all-to-alls a transaction (the kernel's rows riding the forward's, a
    broadcast kernel once; none for the packed real pair) and no
    all-gather; ``chunks=2`` four all-to-alls of the same bytes."""
    base = f"sp/{dt}"
    item = np.dtype("complex128" if dt in ("complex128", "float64")
                    else "complex64").itemsize
    real = not dt.startswith("complex")
    for rec in spawned["ranks"]:
        for mname, (shards, data) in _MESHES_SPAWNED.items():
            for vn, kb in (("v1", 1), ("vb", BATCH // data)):
                for op in ("conv", "corr"):
                    v = tdist.spectral_volume(
                        4096, BATCH, shards, kernel_batch=kb, itemsize=item,
                        data_shards=data, real=real)
                    t = _totals(rec["spy"][f"{base}/{mname}/{op}_{vn}"])
                    assert t["all_to_all"] == [v["all_to_all_count"],
                                               v["all_to_all_bytes"]]
                    assert t["all_gather"] == [0, 0]
                    assert t["all_reduce"] == [0, 0]
            v = tdist.spectral_volume(4096, BATCH, shards, kernel_batch=1,
                                      itemsize=item, data_shards=data,
                                      real=real, chunks=2)
            t = _totals(rec["spy"][f"{base}/{mname}/conv_v1_chunks2"])
            assert t["all_to_all"] == [v["all_to_all_count"],
                                       v["all_to_all_bytes"]]


@pytest.mark.parametrize("dt", DTYPES)
def test_mesh_power_spectrum_orders(spawned, dt):
    """``power_spectrum`` on a mesh: transposed bin order by default (one
    all-to-all, no all-gather), natural order on request (one all-gather
    more), against numpy and the reference on the 1-D mesh."""
    key = f"ps/{dt}"
    x = spawned["inputs"][key]
    b, n = x.shape
    want = np.abs(np.fft.fft(x)) ** 2 / n
    for rec in spawned["ranks"]:
        for mname, (shards, data) in _MESHES_SPAWNED.items():
            t = rec["arrays"][f"{key}/{mname}/t"]
            _close(t, _transposed(want, n, shards), dt)
            _close(rec["arrays"][f"{key}/{mname}/n"], want, dt)
            if mname == "mesh1":
                _close(t, spawned["ref"][key + "/t"], dt)
                _close(rec["arrays"][f"{key}/{mname}/n"],
                       spawned["ref"][key + "/n"], dt)
            for order, gathers in (("t", 0), ("n", 1)):
                v = tdist.collective_volume(n, b, shards,
                                            itemsize=x.dtype.itemsize,
                                            data_shards=data,
                                            natural_order=order == "n")
                tt = _totals(rec["spy"][f"{key}/{mname}/{order}"])
                assert tt["all_to_all"] == [1, v["all_to_all_bytes"]]
                assert tt["all_gather"] == [gathers, v["gather_hlo"]]
