"""The port's n-D FFT on a mesh (``repro_torch.core.fft.multidim``: slab,
pencil, real slab, the 2-D grouped ABFT and ``fft_convolve2``;
``repro_torch.parallel.fft_sharding``'s n-D layouts) without a process
group.

* The feasibility rules, ``collective_volume_nd`` and ``choose_decomp``
  value for value (or the same error words) against the reference's over
  a grid of shapes, shards, data shards, decompositions, ``real``, ``ft``,
  ``groups``, ``natural_order`` and ``chunks``; a sharded n-D plan's
  resolution (decomp, chunks, volume) against the reference plan's, on
  meshes the specs validate without a group.
* The slab and pencil layouts against the reference's ``PartitionSpec`` s.
* The mesh loops on a ``data x fft`` grid of threads
  (``torch_shards.grid_on_shards``: the ranks' own steps, a tensor
  permute in place of the collectives) against ``np.fft``: slab fftn and
  its inverse (a multi-pass last axis and a multi-pass first axis among
  them), pencil natural, transposed and TRANSPOSED_IN order, ``chunks=2``
  bitwise ``chunks=1`` (on the batch and on the leading axis of one
  rank-3 grid), the real slab, the convolution in every mode; each call's
  ``block_fft`` launches counted.
* The 2-D fault matrix (``torch_shards.FT2_SCENARIOS``) on threads, C2C and
  real, complex64 and complex128, on a mesh of 4 and on 2 x 2: every
  verdict equal to the reference's and the output to its, the
  reference's computed once for the file by one JAX subprocess on both
  meshes (built with ``AxisType.Auto``).

Tolerance: ``ATOL[dtype] * max|ref|`` (4e-5 complex64, 1e-11 complex128).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import ATOL, REPO

from repro_torch.core.fft import multidim as tmd
from repro_torch.core.fft.api import FFTSpec, FTConfig, plan
from repro_torch.kernels import stockham
from repro_torch.kernels.ops import axis_fft
from repro_torch.parallel import fft_sharding as tfs
from torch_shards import (FT2_GROUPS, FT2_SCENARIOS, FT2_SHAPE, VERDICTS,
                          ft2_on_shards, grid_on_shards)

CPU = "cpu"
DTYPES = ("complex64", "complex128")
MESHES = {"mesh1": (4, 1), "mesh2": (2, 2)}     # (fft, data)


def _ref():
    from repro.core.fft import multidim as rmd
    return rmd


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


class _BothMesh:
    """A mesh as both packages read one: the reference's ``axis_names`` and
    ``shape``, the port's ``mesh_dim_names`` and ``size``."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = self.mesh_dim_names = tuple(sizes)
        self.device_type = "cpu"

    def size(self, dim=None):
        return list(self.shape.values())[dim]


def _crand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _close(got, want, dtype, factor=1.0):
    got, want = np.asarray(got), np.asarray(want)
    tol = factor * ATOL[np.dtype(dtype)] * np.abs(want).max()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max() / tol


# ---------------------------------------------------------------------------
# the plain arithmetic, against the reference
# ---------------------------------------------------------------------------

SHAPES = [(8, 8), (16, 32), (64, 64), (4, 256), (256, 4), (6, 8), (8, 12),
          (2, 2), (1024, 16), (8, 16, 32), (32, 32, 32), (4, 2, 64), (64,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_feasibility_matches_reference(shape):
    rmd = _ref()
    for d in (1, 2, 3, 4, 8):
        assert tmd.slab_feasible(shape, d) == rmd.slab_feasible(shape, d)
        assert tmd.rslab_feasible(shape, d) == rmd.rslab_feasible(shape, d)
        for dd in (1, 2, 3, 4):
            assert tmd.pencil_feasible(shape, d, dd) \
                == rmd.pencil_feasible(shape, d, dd)


_VOLUME_CASES = [
    dict(), dict(itemsize=16), dict(decomp="pencil"),
    dict(decomp="pencil", natural_order=False),
    dict(decomp="pencil", data_shards=2),
    dict(decomp="pencil", data_shards=2, natural_order=False, chunks=4),
    dict(ft=True, groups=4), dict(ft=True, groups=4, data_shards=2),
    dict(ft=True, groups=3, data_shards=2), dict(ft=True, groups=1),
    dict(real=True), dict(real=True, ft=True, groups=2, itemsize=16),
    dict(decomp="pencil", real=True), dict(decomp="pencil", ft=True),
    dict(chunks=2), dict(decomp="other"), dict(data_shards=2)]


@pytest.mark.parametrize("kw", _VOLUME_CASES,
                         ids=[",".join(f"{k}={v}" for k, v in c.items())
                              or "default" for c in _VOLUME_CASES])
@pytest.mark.parametrize("shape,batch,shards", [((64, 64), 8, 4),
                                                ((32, 16, 128), 1, 2),
                                                ((8192, 8192), 1, 2)])
def test_collective_volume_nd_matches_reference(shape, batch, shards, kw):
    rmd = _ref()
    _same(lambda: tmd.collective_volume_nd(shape, batch, shards, **kw),
          lambda: rmd.collective_volume_nd(shape, batch, shards, **kw))


_CHOOSER_MESHES = [None, _BothMesh(fft=1), _BothMesh(fft=4),
                   _BothMesh(data=2, fft=2), _BothMesh(data=4, fft=2),
                   _BothMesh(fft=8), _BothMesh(data=2, fft=4)]


@pytest.mark.parametrize("mesh", _CHOOSER_MESHES,
                         ids=["none", "fft1", "fft4", "data2xfft2",
                              "data4xfft2", "fft8", "data2xfft4"])
def test_choose_decomp_matches_reference(mesh):
    rmd = _ref()
    for shape in ((64, 64), (8, 8), (4, 256), (512, 4), (16, 8, 8),
                  (4096, 4096), (2, 2), (8, 16, 32)):
        for batch in (1, 3, 8):
            for ft in (False, True):
                for natural in (False, True):
                    for data_axis in ("auto", None):
                        kw = dict(batch=batch, ft=ft, natural_order=natural,
                                  data_axis=data_axis)
                        _same(lambda: tmd.choose_decomp(shape, mesh, **kw),
                              lambda: rmd.choose_decomp(shape, mesh, **kw))


def test_nd_layouts_mirror_the_reference_partition_specs():
    """Each placement names the mesh dimension the reference's
    PartitionSpec puts on the same array dimension (the pencil's on the
    (B, lead, r1, r2, c1, c2) cube); the errors are the reference's."""
    from repro.parallel import fft_sharding as rfs

    def dims(spec):
        return {name: pl.dim for name, pl in spec.items()}

    def want(pspec):
        return {name: dim for dim, name in enumerate(pspec) if name}

    for ndim in (2, 3):
        for data in (None, "data"):
            for fn in ("slab_specs", "pencil_nd_specs"):
                got = getattr(tfs, fn)(ndim, "fft", data)
                ref = getattr(rfs, fn)(ndim, "fft", data)
                assert [dims(g) for g in got] == [want(r) for r in ref]
            for decomp in ("slab", "pencil"):
                got = tfs.layout_specs(ndim, decomp, data_axis=data)
                ref = rfs.layout_specs(ndim, decomp, data_axis=data)
                assert [dims(g) for g in got] == [want(r) for r in ref]
        got = tfs.layout_specs(2, "slab", data_axis="data", real=True)
        ref = rfs.layout_specs(2, "slab", data_axis="data", real=True)
        assert [dims(g) for g in got] == [want(r) for r in ref]
    for call in ((lambda m: m.layout_specs(2, "pencil", real=True)),
                 (lambda m: m.layout_specs(3, "slab", real=True)),
                 (lambda m: m.layout_specs(2, "other")),
                 (lambda m: m.slab_specs(4)),
                 (lambda m: m.pencil_nd_specs(1))):
        _same(lambda: call(tfs), lambda: call(rfs))


_PLAN_CASES = [
    ((4, 16, 32), 2, {}), ((4, 16, 32), 2, dict(decomp="pencil")),
    ((1, 64, 64), 2, {}), ((64, 64), 2, dict(natural_order=False)),
    ((2, 8, 16, 32), 3, dict(decomp="pencil", chunks=2)),
    ((8, 16, 32), 3, dict(decomp="pencil", chunks=0)),
    ((8, 16, 32), 3, dict(decomp="pencil", chunks=4, natural_order=False)),
    ((3, 16, 32), 2, dict(decomp="pencil", chunks=2)),
    ((8, 32, 64), 2, dict(ft=FTConfig(groups=4))),
    ((8, 32, 64), 2, dict(ft=FTConfig(groups=4), dtype="complex128")),
    ((4, 16, 32), 2, dict(real=True)),
    ((4, 16, 32), 2, dict(real=True, ft=FTConfig(groups=2))),
    ((4, 6, 32), 2, dict(decomp="slab")),
    ((4, 16, 2), 2, dict(decomp="pencil")),
    ((8, 32, 64), 2, dict(ft=FTConfig(), decomp="pencil")),
    ((4, 16, 6), 2, dict(real=True, decomp="slab")),
    ((4, 16, 32), 2, dict(real=True, ft=FTConfig(), decomp="pencil"))]


@pytest.mark.parametrize("mesh", [_BothMesh(fft=4), _BothMesh(data=2, fft=2)],
                         ids=["fft4", "data2xfft2"])
@pytest.mark.parametrize("shape,rank,kw", _PLAN_CASES,
                         ids=[f"{s}-r{r}-" + ",".join(kw) for s, r, kw in
                              _PLAN_CASES])
def test_nd_plan_resolves_as_the_reference(mesh, shape, rank, kw):
    """A sharded rank-2/3 plan's decomp, chunks and volume are the
    reference plan's (the errors its words); nothing needs a group."""
    from repro.core.fft import api as rapi

    def port():
        p = plan(FFTSpec(shape, rank=rank, mesh=mesh, device=CPU, **kw))
        return p.decomp, p.chunks, p.volume

    def ref():
        p = rapi.plan(rapi.FFTSpec(shape, rank=rank, mesh=mesh,
                                   **_ref_kw(kw)))
        return p.decomp, p.chunks, p.volume

    _same(port, ref)


def _ref_kw(kw):
    """``kw`` with the port's FTConfig as the reference's."""
    import dataclasses

    from repro.core.plan import FTConfig as RefFTConfig

    if kw.get("ft") is None:
        return kw
    return dict(kw, ft=RefFTConfig(**dataclasses.asdict(kw["ft"])))


def test_ft_rank2_needs_a_sharded_mesh():
    """The reference's words, for the C2C and the real spec; a one-rank
    mesh and ``decomp="local"`` are no sharded mesh."""
    from repro.core.fft import api as rapi

    for kw in (dict(), dict(real=True), dict(mesh=_BothMesh(fft=1)),
               dict(mesh=_BothMesh(fft=4), decomp="local")):
        _same(lambda: plan(FFTSpec((8, 32, 64), rank=2, ft=FTConfig(),
                                   device=CPU, **kw)),
              lambda: rapi.plan(rapi.FFTSpec((8, 32, 64), rank=2,
                                             **_ref_kw(dict(kw,
                                                            ft=FTConfig())))))


# ---------------------------------------------------------------------------
# the mesh loops on a data x fft grid of threads
# ---------------------------------------------------------------------------


class _Launches:
    """Counts ``block_fft`` launches (the plain version's calls on the
    CPU) across the threads."""

    def __init__(self, monkeypatch):
        self.n = 0
        lock = threading.Lock()
        plain = stockham.block_fft_plain

        def count(*a, **k):
            with lock:
                self.n += 1
            return plain(*a, **k)

        monkeypatch.setattr(stockham, "block_fft_plain", count)

    def take(self) -> int:
        n, self.n = self.n, 0
        return n


def _axes(shape, dtype):
    dt = getattr(torch, dtype)
    return tuple(axis_fft(n, dt, CPU) for n in shape)


_SLAB_CASES = [((4, 16, 32), 1, 1), ((4, 16, 32), 2, 1), ((4, 16, 32), 4, 1),
               ((4, 16, 32), 2, 2), ((3, 16, 32), 2, 2), ((16, 32), 4, 1),
               ((2, 8, 16, 32), 4, 1), ((2, 8, 16, 32), 2, 2),
               ((1, 8, 16384), 2, 1), ((1, 16384, 4), 2, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,d,dd", _SLAB_CASES,
                         ids=[f"{s}-{d}x{dd}" for s, d, dd in _SLAB_CASES])
def test_slab_on_threads_matches_numpy(shape, d, dd, dtype, monkeypatch):
    """Forward against np.fft.fftn, the mirrored inverse back to the input;
    each a launch an axis pass (a multi-pass axis: its passes)."""
    nd = 3 if len(shape) == 4 else 2
    x = torch.from_numpy(_crand(shape, dtype, sum(shape) + d))
    axes = _axes(shape[-nd:], dtype)
    count = _Launches(monkeypatch)
    y = grid_on_shards(lambda r, m: tmd.slab_local(x, axes, m,
                                                   inverse=False), d, dd)
    per = sum(ax.plan.num_passes for ax in axes)
    assert count.take() == per * d * dd
    _close(y, np.fft.fftn(x.numpy(), axes=tuple(range(-nd, 0))), dtype)
    xb = grid_on_shards(lambda r, m: tmd.slab_local(y, axes, m,
                                                    inverse=True), d, dd)
    assert count.take() == per * d * dd
    _close(xb, x, dtype, factor=2)


def _transposed(ref, gp):
    """The transposed digit order of ``ref`` (..., R, C) of ``gp``'s
    split: y[.., kr1*r2 + kr2, kc1*c2 + kc2] = X[.., kr1 + r1*kr2, kc1 +
    c1*kc2]."""
    shape = ref.shape
    nl = len(shape) - 2
    z = ref.reshape(shape[:-2] + (gp.r2, gp.r1, gp.pc.n2, gp.pc.n1))
    perm = list(range(nl)) + [nl + 1, nl, nl + 3, nl + 2]
    return z.transpose(perm).reshape(shape)


# (shape, rank, fft, data, chunks): a rank-3 single grid chunks its
# leading axis
_PENCIL_CASES = [((4, 16, 32), 2, 4, 1, 2), ((4, 16, 32), 2, 2, 2, 2),
                 ((16, 32), 2, 4, 1, 1), ((2, 8, 16, 32), 3, 2, 2, 2),
                 ((8, 16, 32), 3, 2, 2, 4), ((1, 8, 256), 2, 2, 2, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,nd,d,dd,chunks", _PENCIL_CASES,
                         ids=[f"{s}-r{n}-{d}x{dd}-c{c}"
                              for s, n, d, dd, c in _PENCIL_CASES])
def test_pencil_on_threads_matches_numpy(shape, nd, d, dd, chunks, dtype,
                                         monkeypatch):
    """Natural and transposed order against np.fft.fftn; ``chunks``
    transactions bitwise one; the TRANSPOSED_IN inverse and the
    natural-order inverse back to the input; launches as
    ``GridPencil.launches`` counts them."""
    x = torch.from_numpy(_crand(shape, dtype, sum(shape) + 7 * d))
    gp = tmd.GridPencil(tuple(shape[-nd:]), d, dd, x.dtype, CPU)
    ref = np.fft.fftn(x.numpy(), axes=tuple(range(-nd, 0)))
    count = _Launches(monkeypatch)

    def run(y, **kw):
        return grid_on_shards(lambda r, m: tmd.pencil_local(y, gp, m, **kw),
                              d, dd)

    yn = run(x, inverse=False, natural_order=True, chunks=1)
    assert count.take() == gp.launches(1) * d * dd
    _close(yn, ref, dtype)
    yt1 = run(x, inverse=False, natural_order=False, chunks=1)
    _close(yt1, _transposed(ref, gp), dtype)
    count.take()
    yt = run(x, inverse=False, natural_order=False, chunks=chunks)
    assert count.take() == gp.launches(chunks) * d * dd
    assert torch.equal(yt, yt1)
    xi = run(yt, inverse=True, natural_order=False, chunks=chunks)
    assert count.take() == gp.launches(chunks, transposed_in=True) * d * dd
    _close(xi.reshape(shape), x, dtype, factor=2)
    xn = run(torch.from_numpy(ref.astype(dtype)), inverse=True,
             natural_order=True, chunks=1)
    _close(xn, x, dtype, factor=2)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("shape,d,dd", [((4, 16, 32), 4, 1),
                                        ((4, 16, 32), 2, 2),
                                        ((16, 32), 2, 1), ((2, 8, 16), 4, 1)],
                         ids=["4x1", "2x2", "grid-2x1", "C=2D-4x1"])
def test_real_slab_on_threads_matches_numpy(shape, d, dd, dtype,
                                            monkeypatch):
    """rfft2 against np.fft.rfft2 (the bins in torch.chunk's blocks of
    C/2+1, each rank's padded Cp/D cut to its live ones), irfft2 back;
    two launches each."""
    x = torch.from_numpy(_crand(shape, dtype, sum(shape)))
    cdt = "complex128" if dtype == "float64" else "complex64"
    rows, half = _axes((shape[-2], shape[-1] // 2), cdt)
    count = _Launches(monkeypatch)
    y = grid_on_shards(lambda r, m: tmd.rslab_local(
        x, rows, half, m, inverse=False, cc=shape[-1]), d, dd)
    assert count.take() == 2 * d * dd
    _close(y, np.fft.rfft2(x.numpy()), cdt)
    xb = grid_on_shards(lambda r, m: tmd.rslab_local(
        y, rows, half, m, inverse=True, cc=shape[-1]), d, dd)
    assert count.take() == 2 * d * dd
    _close(xb, x, dtype, factor=2)


def _np_conv2(a, v, mode):
    sa, sv = a.shape[-2:], v.shape[-2:]
    s = (sa[0] + sv[0] - 1, sa[1] + sv[1] - 1)
    full = np.fft.ifft2(np.fft.fft2(a, s=s) * np.fft.fft2(v, s=s))
    if not (np.iscomplexobj(a) or np.iscomplexobj(v)):
        full = full.real
    for ax, la, lv in ((-2, sa[0], sv[0]), (-1, sa[1], sv[1])):
        lo, n = tmd._crop_range(la, lv, mode)
        full = np.take(full, np.arange(lo, lo + n), axis=ax)
    return full


@pytest.mark.parametrize("mode", ("full", "same", "valid"))
@pytest.mark.parametrize("dtype", ("float32", "complex64", "complex128"))
@pytest.mark.parametrize("d,dd", [(4, 1), (2, 2)])
def test_convolution_on_threads_matches_numpy(d, dd, dtype, mode,
                                              monkeypatch):
    """Shared and per-signal kernels; two launches forward (the operands
    into one buffer), one over R, one over R inverse, one over C inverse;
    the inverse's all-to-all moves only the cropped rows."""
    a = _crand((4, 20, 24), dtype, 5)
    real = dtype == "float32"
    cdt = "complex64" if real else dtype
    nr, nc = tmd._conv2_shape((20, 24), (5, 7), d)
    axes = _axes((nr, nc // 2 if real else nc), cdt)
    count = _Launches(monkeypatch)
    for v in (_crand((5, 7), dtype, 6), _crand((4, 5, 7), dtype, 7)):
        ap = tmd._pad2(torch.from_numpy(a), nr, nc)
        vp = tmd._pad2(torch.from_numpy(v), nr, nc)
        got = grid_on_shards(lambda r, m: tmd.conv2_local(
            ap, vp, axes, m, sa=(20, 24), sv=(5, 7), mode=mode, real=real),
            d, dd)
        assert count.take() <= 5 * d * dd
        _close(got, _np_conv2(a, v, mode), cdt)


# ---------------------------------------------------------------------------
# the 2-D fault matrix, against the reference's verdicts
# ---------------------------------------------------------------------------

_FT_REF_SCRIPT = r"""
import json, os, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.core.fft import multidim as md
inp = np.load(sys.argv[1])
scen = json.load(open(sys.argv[3]))
meshes = {"mesh1": jax.make_mesh((4,), ("fft",), axis_types=(AxisType.Auto,)),
          "mesh2": jax.make_mesh((2, 2), ("data", "fft"),
                                 axis_types=(AxisType.Auto,) * 2)}
out = {}
for mname, mesh in meshes.items():
    for key in inp.files:
        real, dt = key.split("/")
        x = inp[key]
        cdt = {"float32": "complex64", "float64": "complex128"}.get(dt, dt)
        thr, mag = scen["threshold"][cdt], scen["mag"][cdt]
        rdt = jnp.float64 if cdt == "complex128" else jnp.float32
        fn = md.ft_distributed_rfft2 if real == "real" \
            else md.ft_distributed_fft2
        for sc in scen["cases"]:
            # rows padded to four disabled ones: one compile a scenario kind
            rows = [r[:5] + [r[5] * mag, r[6] * mag]
                    for r in sc["inject"] or []]
            inj = jnp.asarray(rows + [[0.0] * 7] * (4 - len(rows)), rdt)
            res = fn(x, mesh, threshold=thr, groups=4, inject=inj, **sc["kw"])
            name = f"{key}/{mname}/{sc['name']}"
            out[name + "/y"] = np.asarray(res.y)
            for f in ("flagged", "location", "correctable", "checksum_fault",
                      "corrected", "recomputed", "uncorrectable"):
                out[name + "/" + f] = np.asarray(getattr(res, f))
np.savez(sys.argv[2], **out)
"""


def _ft_inputs():
    out = {}
    for i, dt in enumerate(DTYPES):
        out[f"c2c/{dt}"] = _crand(FT2_SHAPE, dt, 90 + i)
    for i, dt in enumerate(("float32", "float64")):
        out[f"real/{dt}"] = _crand(FT2_SHAPE, dt, 92 + i)
    return out


@pytest.fixture(scope="module", autouse=True)
def _ft_reference_run(tmp_path_factory):
    """The reference's fault matrix on a mesh of 4 and on 2 x 2: one JAX
    subprocess for the file, started with the file's first test so that
    it runs beside the others."""
    tmp = tmp_path_factory.mktemp("ft2_ref")
    np.savez(tmp / "inputs.npz", **_ft_inputs())
    (tmp / "scenarios.json").write_text(json.dumps(FT2_SCENARIOS))
    (tmp / "ref.py").write_text(_FT_REF_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "inputs.npz"),
         str(tmp / "ref.npz"), str(tmp / "scenarios.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, tmp / "ref.npz"
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ft_reference(_ft_reference_run):
    proc, path = _ft_reference_run
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    return dict(np.load(path))


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("key", list(_ft_inputs()))
def test_ft_fault_matrix_on_threads_matches_reference(ft_reference, key,
                                                      mname):
    """Every scenario's verdicts equal the reference's (``location`` where
    a group is correctable: elsewhere the id decode reads noise); its
    output is the reference's within tolerance, an uncorrected one
    included, and a clean or corrected one the FFT's."""
    real, dt = key.split("/")
    real = real == "real"
    x = torch.from_numpy(_ft_inputs()[key])
    cdt = {"float32": "complex64", "float64": "complex128"}.get(dt, dt)
    thr = FT2_SCENARIOS["threshold"][cdt]
    mag = FT2_SCENARIOS["mag"][cdt]
    d, dd = MESHES[mname]
    ref_fft = (np.fft.rfft2 if real else np.fft.fft2)(x.numpy())
    for sc in FT2_SCENARIOS["cases"]:
        inj = None if sc["inject"] is None else [
            r[:5] + [r[5] * mag, r[6] * mag] for r in sc["inject"]]
        kw = dict(sc["kw"])
        res = ft2_on_shards(
            x, d, dd, groups=FT2_GROUPS, threshold=thr, real=real,
            correct=kw.get("correct", True), inject=inj,
            recompute=kw.get("recompute_uncorrectable", False))
        name = f"{key}/{mname}/{sc['name']}"
        fix = ft_reference[f"{name}/correctable"]
        for f in VERDICTS:
            got = np.asarray(getattr(res, f))
            want = ft_reference[f"{name}/{f}"]
            if f == "location":
                # a located grid where the decode is a single fault; in any
                # other group the id estimate is the noise's
                got, want = got[fix], want[fix]
            assert got.tolist() == want.tolist(), (name, f, got, want)
        _close(res.y, ft_reference[name + "/y"], cdt)
        if sc["name"] not in ("nocorrect", "double"):
            _close(res.y, ref_fft, cdt)
        assert float(res.shard_delta.max()) < max(1e-4, 10 * thr)
