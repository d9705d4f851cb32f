"""The port's n-D FFT on a ``torch.distributed`` mesh
(``repro_torch.core.fft.multidim`` through ``plan(FFTSpec(rank=2|3,
mesh=...))``) on four gloo ranks on the CPU, against the reference
(``repro.core.fft.multidim``) and ``np.fft``.

One four-process spawn shared by the whole file (a file store under
``tmp_path``, so parallel workers never race for a port), on a 1-D mesh of
4 and a 2 x 2 ``data x fft`` mesh: slab and pencil fft/ifft at rank 2 and
3 (natural, transposed and TRANSPOSED_IN order, ``chunks=2`` bitwise
``chunks=1`` on the batch and on the leading axis of one rank-3 grid),
``decomp="auto"``, the real slab and the composed pencil rfft2/irfft2,
``ft_fft`` at rank 2 (C2C and real, the 2-D fault matrix), ``convolve``
(``fft_convolve2`` on the mesh), ``shard_grid``,
``extensions.fft2/rfft2(mesh=)`` and ``ops.fft2`` on a DTensor; a
one-rank mesh's rank-2 plan is the local one. A spy on
``dist.all_to_all_single``, ``all_gather_into_tensor`` and ``all_reduce``
holds every call's count and bytes to ``plan.volume``
(``collective_volume_nd``) where the model counts the same thing: the
slab one all-to-all and no all-gather, the pencil one all-to-all a mesh
dimension a transaction plus the natural order's gathers, the verdict's
one all-reduce of ``3 * G/data + 1`` reals (the model's ``psum_hlo`` and
``permute_hlo`` are terms of the reference's compiled program, left
out), the convolution two all-to-alls. Each call's ``block_fft`` launches
(the plain version's calls) are held to ``plan.launches``.

The reference's own outputs on both meshes (built with ``AxisType.Auto``,
with which its 2-D meshes run in this container) come from one JAX
subprocess running at the same time: the complex64 slab and pencil
forwards, the pencil's transposed order and its TRANSPOSED_IN inverse,
the real slab, the composed real path and the convolution. Everything
else is held to ``np.fft``; the fault matrix's verdicts to the catalogue,
which ``test_torch_multidim_mesh.py`` holds to the reference's.

Tolerance: ``ATOL[dtype] * max|ref|`` (4e-5 complex64, 1e-11 complex128).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import ATOL, REPO

from torch_shards import FT2_GROUPS, FT2_SCENARIOS, FT2_SHAPE

DTYPES = ("complex64", "complex128")
MESHES = {"mesh1": (4, 1), "mesh2": (2, 2)}     # (fft, data)
GRIDS = {"c2": ((4, 16, 32), 2), "c3": ((2, 8, 16, 32), 3)}
ONE_GRID = (8, 16, 32)                           # one rank-3 grid
CONV = ((4, 20, 24), (5, 7))

_REF_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from jax.sharding import AxisType
from repro.core.fft import multidim as md
meshes = {"mesh1": jax.make_mesh((4,), ("fft",), axis_types=(AxisType.Auto,)),
          "mesh2": jax.make_mesh((2, 2), ("data", "fft"),
                                 axis_types=(AxisType.Auto,) * 2)}
inp = np.load(sys.argv[1])
out = {}
for mname, mesh in meshes.items():
    for key in ("c2/complex64", "c3/complex64"):
        x = inp[key]
        nd = 2 if key.startswith("c2") else 3
        for dec in ("slab", "pencil"):
            out[f"{key}/{mname}/{dec}/fwd"] = np.asarray(
                md.distributed_fftn(x, mesh, ndim=nd, decomp=dec))
        yt = md.distributed_fftn(x, mesh, ndim=nd, decomp="pencil",
                                 natural_order=False)
        out[f"{key}/{mname}/pencil/fwd_t"] = np.asarray(yt)
        out[f"{key}/{mname}/pencil/inv_t"] = np.asarray(md.distributed_ifftn(
            yt, mesh, ndim=nd, decomp="pencil", natural_order=False))
    x = inp["r2/float32"]
    y = md.distributed_rfft2(x, mesh)
    out[f"r2/float32/{mname}/rfft2"] = np.asarray(y)
    out[f"r2/float32/{mname}/irfft2"] = np.asarray(md.distributed_irfft2(
        y, mesh))
    out[f"r2/float32/{mname}/composed"] = np.asarray(md._composed_rfft2(
        x, mesh=mesh))
    for dt in ("float32", "complex64"):
        for vn in ("v1", "vb"):
            out[f"cv/{dt}/{mname}/{vn}"] = np.asarray(md.fft_convolve2(
                inp[f"cv/{dt}/a"], inp[f"cv/{dt}/{vn}"], mesh, mode="same"))
np.savez(sys.argv[2], **out)
"""

_WORKER_SCRIPT = r"""
import json, os, sys, threading
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, inputs, outdir):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=4)
    from repro_torch.core.fft import api, extensions, multidim
    from repro_torch.kernels import ops, stockham
    from repro_torch.launch.mesh import make_fft_mesh
    from repro_torch.parallel import shard_grid

    calls, launches = [], [0]
    a2a, gather = dist.all_to_all_single, dist.all_gather_into_tensor
    reduce_, plain = dist.all_reduce, stockham.block_fft_plain

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

    def count(*a, **k):
        launches[0] += 1
        return plain(*a, **k)

    dist.all_to_all_single = spy_a2a
    dist.all_gather_into_tensor = spy_gather
    dist.all_reduce = spy_reduce
    stockham.block_fft_plain = count
    res, spy, vol, arrays = {}, {}, {}, {}

    def traced(name, fn):
        calls.clear()
        launches[0] = 0
        y = fn()
        spy[name] = [list(c) for c in calls]
        res[name + "/launches"] = launches[0]
        calls.clear()
        return y

    def full(y):
        return y.full_tensor().numpy()

    def place(y):
        return [repr(q) for q in y.placements]

    meshes = {"mesh1": make_fft_mesh(4, device="cpu"),
              "mesh2": make_fft_mesh(2, data=2, device="cpu")}
    data = np.load(inputs)
    for mname, mesh in meshes.items():
        # the C2C slab and pencil at rank 2 and 3
        for key in data.files:
            if not key.startswith(("c2/", "c3/")):
                continue
            x = torch.from_numpy(data[key])
            dt = key.split("/")[1]
            nd = 2 if key.startswith("c2") else 3
            spec = dict(rank=nd, mesh=mesh, dtype=dt, device="cpu")
            base = f"{key}/{mname}"
            for dec in ("slab", "pencil"):
                p = api.plan(api.FFTSpec(x.shape, decomp=dec, **spec))
                vol[f"{base}/{dec}"] = dict(p.volume, launches=p.launches)
                y = traced(f"{base}/{dec}/fwd", lambda: p.fft(x))
                arrays[f"{base}/{dec}/fwd"] = full(y)
                res[f"{base}/{dec}/fwd_placements"] = place(y)
                xb = traced(f"{base}/{dec}/inv", lambda: p.ifft(y))
                arrays[f"{base}/{dec}/inv"] = full(xb)
                res[f"{base}/{dec}/inv_placements"] = place(xb)
                # the operand in the plan's input layout
                xs = p.shard(x)
                res[f"{base}/{dec}/shard_placements"] = place(xs)
                arrays[f"{base}/{dec}/sharded"] = full(traced(
                    f"{base}/{dec}/sharded", lambda: p.fft(xs)))
            for chunks in (1, 2):
                pt = api.plan(api.FFTSpec(x.shape, decomp="pencil",
                                          natural_order=False,
                                          chunks=chunks, **spec))
                vol[f"{base}/pencil_t{chunks}"] = dict(
                    pt.volume, launches=pt.launches, chunks=pt.chunks)
                yt = traced(f"{base}/pencil/fwd_t{chunks}",
                            lambda: pt.fft(x))
                xi = traced(f"{base}/pencil/inv_t{chunks}",
                            lambda: pt.ifft(yt))
                if chunks == 1:
                    yt1, xi1 = yt, xi
                    arrays[f"{base}/pencil/fwd_t"] = full(yt)
                    res[f"{base}/pencil/fwd_t_placements"] = place(yt)
                    arrays[f"{base}/pencil/inv_t"] = full(xi)
                    res[f"{base}/pencil/inv_t_placements"] = place(xi)
                    res[f"{base}/pencil/inv_t_shape"] = list(xi.shape)
            res[f"{base}/pencil/chunks_bitwise"] = [
                bool(torch.equal(yt.to_local(), yt1.to_local())),
                bool(torch.equal(xi.to_local(), xi1.to_local()))]
            res[f"{base}/auto"] = api.plan(api.FFTSpec(x.shape,
                                                       **spec)).decomp
            if nd == 2:
                arrays[f"{base}/ext_fft2"] = full(extensions.fft2(
                    x, mesh=mesh, decomp="pencil", device="cpu"))
                xg = shard_grid(x, mesh, 2, decomp="slab")
                arrays[f"{base}/ops_fft2"] = full(traced(
                    f"{base}/ops_fft2", lambda: ops.fft2(xg, device="cpu")))
                arrays[f"{base}/ops_ifft2"] = full(ops.ifft2(
                    ops.fft2(xg, device="cpu"), device="cpu"))
        # chunks on the leading axis of one rank-3 grid
        g = torch.from_numpy(data["g3"])
        outs = []
        for chunks in (1, 2):
            p = api.plan(api.FFTSpec(g.shape, rank=3, mesh=mesh,
                                     decomp="pencil", chunks=chunks,
                                     natural_order=False, device="cpu"))
            vol[f"g3/{mname}/{chunks}"] = dict(p.volume,
                                               launches=p.launches,
                                               chunks=p.chunks)
            outs.append(traced(f"g3/{mname}/fwd_t{chunks}",
                               lambda: p.fft(g)))
        arrays[f"g3/{mname}/fwd_t"] = full(outs[0])
        res[f"g3/{mname}/chunks_bitwise"] = bool(torch.equal(
            outs[0].to_local(), outs[1].to_local()))
        # the real slab and the composed pencil path
        for key in ("r2/float32", "r2/float64"):
            x = torch.from_numpy(data[key])
            cdt = "complex128" if key.endswith("64") else "complex64"
            base = f"{key}/{mname}"
            for dec in ("slab", "pencil"):
                p = api.plan(api.FFTSpec(x.shape, rank=2, real=True,
                                         decomp=dec, mesh=mesh, dtype=cdt,
                                         device="cpu"))
                vol[f"{base}/{dec}"] = dict(p.volume or {},
                                            launches=p.launches,
                                            decomp=p.decomp)
                y = traced(f"{base}/{dec}/rfft2", lambda: p.rfft2(x))
                arrays[f"{base}/{dec}/rfft2"] = full(y)
                res[f"{base}/{dec}/rfft2_placements"] = place(y)
                arrays[f"{base}/{dec}/irfft2"] = full(traced(
                    f"{base}/{dec}/irfft2", lambda: p.irfft2(y)))
            y = extensions.rfft2(x, mesh=mesh, device="cpu")
            arrays[f"{base}/ext_rfft2"] = full(y)
            arrays[f"{base}/ext_irfft2"] = full(extensions.irfft2(
                y, mesh=mesh, device="cpu"))
        # the 2-D grouped ABFT: the fault matrix, C2C and real
        scen = json.load(open(os.path.join(os.path.dirname(inputs),
                                           "scenarios.json")))
        for key in data.files:
            if not key.startswith("ft/"):
                continue
            real, dt = key.split("/")[1:]
            real = real == "real"
            x = torch.from_numpy(data[key])
            cdt = {"float32": "complex64", "float64": "complex128"}.get(dt, dt)
            thr, mag = scen["threshold"][cdt], scen["mag"][cdt]
            for sc in scen["cases"]:
                kw = sc["kw"]
                ft = api.FTConfig(
                    threshold=thr, groups=4,
                    correct=kw.get("correct", True),
                    recompute_uncorrectable=kw.get(
                        "recompute_uncorrectable", False))
                p = api.plan(api.FFTSpec(x.shape, rank=2, real=real, ft=ft,
                                         mesh=mesh, dtype=cdt, device="cpu"))
                inj = None if sc["inject"] is None else [
                    r[:5] + [r[5] * mag, r[6] * mag] for r in sc["inject"]]
                name = f"{key}/{mname}/{sc['name']}"
                out = traced(name, lambda: p.ft_fft(x, inject=inj))
                arrays[name + "/y"] = full(out.y)
                res[name] = {f: getattr(out, f).tolist() for f in (
                    "flagged", "location", "correctable", "checksum_fault",
                    "corrected", "recomputed", "uncorrectable",
                    "shard_delta")}
                res[name]["placements"] = place(out.y)
                vol[name] = dict(p.volume, launches=p.launches,
                                 groups=p.groups)
            fn = multidim.ft_distributed_rfft2 if real \
                else multidim.ft_distributed_fft2
            inj = [r[:5] + [r[5] * mag, r[6] * mag]
                   for r in scen["cases"][1]["inject"]]
            out = fn(x, mesh, threshold=thr, groups=4, inject=inj)
            arrays[f"{key}/{mname}/function/y"] = full(out.y)
            res[f"{key}/{mname}/function"] = out.corrected.tolist()
        # the 2-D convolution on the mesh
        for dt in ("float32", "complex64"):
            a = torch.from_numpy(data[f"cv/{dt}/a"])
            for vn in ("v1", "vb"):
                v = torch.from_numpy(data[f"cv/{dt}/{vn}"])
                for mode in ("full", "same", "valid"):
                    name = f"cv/{dt}/{mname}/{vn}/{mode}"
                    y = traced(name, lambda: multidim.fft_convolve2(
                        a, v, mesh, mode=mode))
                    arrays[name] = full(y)
                    vol[name] = {"launches": api.plan(multidim.conv2_spec(
                        a, v, mesh, device="cpu")).launches}
                    res[name + "/placements"] = place(y)
    # a one-rank mesh's rank-2 plan is the local one
    x = torch.from_numpy(data["c2/complex64"])
    p1 = api.plan(api.FFTSpec(x.shape, rank=2, mesh=make_fft_mesh(
        1, device="cpu"), device="cpu"))
    p0 = api.plan(api.FFTSpec(x.shape, rank=2, device="cpu"))
    res["one_rank"] = [p1.decomp, bool(torch.equal(p1.fft(x), p0.fft(x)))]
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "res": res, "spy": spy, "vol": vol}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    store, inputs, outdir = sys.argv[1:4]
    mp.spawn(run, args=(store, inputs, outdir), nprocs=4)
"""


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _inputs():
    inp = {}
    for i, dt in enumerate(DTYPES):
        for j, (key, (shape, _)) in enumerate(GRIDS.items()):
            inp[f"{key}/{dt}"] = _rand(shape, dt, 10 * i + j)
        inp[f"ft/c2c/{dt}"] = _rand(FT2_SHAPE, dt, 20 + i)
    for i, dt in enumerate(("float32", "float64")):
        inp[f"r2/{dt}"] = _rand(GRIDS["c2"][0], dt, 30 + i)
        inp[f"ft/real/{dt}"] = _rand(FT2_SHAPE, dt, 40 + i)
    inp["g3"] = _rand(ONE_GRID, "complex64", 50)
    for i, dt in enumerate(("float32", "complex64")):
        inp[f"cv/{dt}/a"] = _rand(CONV[0], dt, 60 + i)
        inp[f"cv/{dt}/v1"] = _rand(CONV[1], dt, 62 + i)
        inp[f"cv/{dt}/vb"] = _rand((CONV[0][0],) + CONV[1], dt, 64 + i)
    return inp


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Run the four gloo ranks and the reference's subprocess together;
    each rank's arrays and records, the reference's outputs and the
    inputs."""
    tmp = tmp_path_factory.mktemp("dist_nd")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "scenarios.json").write_text(json.dumps(FT2_SCENARIOS))
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


def _close(got, want, dtype, factor=1.0):
    got, want = np.asarray(got), np.asarray(want)
    tol = factor * ATOL[np.dtype(dtype)] * np.abs(want).max()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max() / tol


def _totals(calls):
    out = {k: [0, 0] for k in ("all_to_all", "all_gather", "all_reduce",
                               "telemetry_gather")}
    for kind, size in calls:
        out[kind][0] += 1
        out[kind][1] += size
    return out


def _split(n, shards):
    from repro_torch.core.fft.distributed import make_dist_plan
    p = make_dist_plan(n, shards)
    return p.n1, p.n2


def _transposed(ref, mname):
    """The pencil's transposed digit order of ``ref`` (..., R, C) on
    ``mname``: each axis split over its mesh dimension (R whole with one
    data rank)."""
    d, dd = MESHES[mname]
    shape = ref.shape
    r1, r2 = _split(shape[-2], dd) if dd > 1 else (shape[-2], 1)
    c1, c2 = _split(shape[-1], d)
    nl = len(shape) - 2
    z = ref.reshape(shape[:-2] + (r2, r1, c2, c1))
    perm = list(range(nl)) + [nl + 1, nl, nl + 3, nl + 2]
    return z.transpose(perm).reshape(shape)


def _keys():
    return [f"{g}/{dt}" for g in GRIDS for dt in DTYPES]


# ---------------------------------------------------------------------------
# slab and pencil fft/ifft
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("key", _keys())
def test_mesh_nd_slab_and_pencil_match_reference_and_numpy(spawned, key,
                                                           mname):
    """Forward (natural order) against np.fft.fftn and the reference's;
    the inverse back to the input; the operand placed by ``plan.shard``
    (``shard_grid``) gives the same spectrum."""
    x = spawned["inputs"][key]
    dt = key.split("/")[1]
    nd = GRIDS[key.split("/")[0]][1]
    want = np.fft.fftn(x, axes=tuple(range(-nd, 0)))
    ref = spawned["ref"]
    for rec in spawned["ranks"]:
        a = rec["arrays"]
        for dec in ("slab", "pencil"):
            base = f"{key}/{mname}/{dec}"
            _close(a[base + "/fwd"], want, dt)
            _close(a[base + "/sharded"], want, dt)
            _close(a[base + "/inv"], x, dt, factor=2)
            if dt == "complex64":
                _close(a[base + "/fwd"], ref[base + "/fwd"], dt)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("key", _keys())
def test_mesh_nd_pencil_transposed_and_transposed_in(spawned, key, mname):
    """The transposed digit order against the reference's and numpy's;
    the TRANSPOSED_IN inverse (the (B, *lead, r1, r2, c1, c2) cube, fast
    digits sharded) back to the input; chunks=2 bitwise chunks=1."""
    x = spawned["inputs"][key]
    dt = key.split("/")[1]
    nd = GRIDS[key.split("/")[0]][1]
    want = _transposed(np.fft.fftn(x, axes=tuple(range(-nd, 0))), mname)
    base = f"{key}/{mname}/pencil"
    for rec in spawned["ranks"]:
        a, res = rec["arrays"], rec["res"]
        _close(a[base + "/fwd_t"], want, dt)
        _close(a[base + "/inv_t"].reshape(x.shape), x, dt, factor=2)
        assert res[base + "/chunks_bitwise"] == [True, True]
        if dt == "complex64":
            ref = spawned["ref"]
            _close(a[base + "/fwd_t"], ref[base + "/fwd_t"], dt)
            _close(a[base + "/inv_t"].reshape(x.shape), ref[base + "/inv_t"],
                   dt, factor=2)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("key", _keys())
def test_mesh_nd_placements(spawned, key, mname):
    """Slab: the first transform axis over fft going in, the last coming
    out (the batch over data on 2 x 2); pencil: natural order replicated,
    transposed order the last axis over fft and the second-to-last over
    data, TRANSPOSED_IN the cube's fast digits."""
    d, dd = MESHES[mname]
    nd = GRIDS[key.split("/")[0]][1]
    x = spawned["inputs"][key]
    last, first = f"Shard(dim={x.ndim - 1})", f"Shard(dim={x.ndim - nd})"
    for rec in spawned["ranks"]:
        res = rec["res"]
        base = f"{key}/{mname}"
        if dd == 1:
            assert res[base + "/slab/fwd_placements"] == [last]
            assert res[base + "/slab/inv_placements"] == [first]
            assert res[base + "/slab/shard_placements"] == [first]
            assert res[base + "/pencil/fwd_placements"] == ["Replicate()"]
            assert res[base + "/pencil/fwd_t_placements"] == [last]
            assert res[base + "/pencil/inv_t_placements"] == [
                f"Shard(dim={nd + 2})"]
        else:
            assert res[base + "/slab/fwd_placements"] == ["Shard(dim=0)",
                                                          last]
            assert res[base + "/pencil/fwd_t_placements"] == [
                f"Shard(dim={x.ndim - 2})", last]
            assert res[base + "/pencil/inv_t_placements"] == [
                f"Shard(dim={nd})", f"Shard(dim={nd + 2})"]
            assert res[base + "/pencil/shard_placements"] == [
                f"Shard(dim={x.ndim - 2})", last]
        lead = x.shape[1:-2] if len(x.shape) > nd else ()
        assert len(res[base + "/pencil/inv_t_shape"]) == 5 + len(lead)


def test_mesh_one_grid_chunks_ride_the_leading_axis(spawned):
    g = spawned["inputs"]["g3"]
    for mname in MESHES:
        want = _transposed(np.fft.fftn(g), mname)
        for rec in spawned["ranks"]:
            assert rec["vol"][f"g3/{mname}/2"]["chunks"] == 2
            assert rec["res"][f"g3/{mname}/chunks_bitwise"] is True
            _close(rec["arrays"][f"g3/{mname}/fwd_t"], want, "complex64")


@pytest.mark.parametrize("mname", list(MESHES))
def test_mesh_nd_auto_decomp_and_dispatch(spawned, mname):
    """``decomp="auto"`` is the reference's choice; ``extensions.fft2
    (mesh=)`` and ``ops.fft2``/``ops.ifft2`` on a DTensor placed by
    ``shard_grid`` run the mesh plan."""
    from repro.core.fft import multidim as rmd

    from repro_torch.core.fft import multidim as tmd

    class _M:
        def __init__(self, d, dd):
            self.shape = {"fft": d} if dd == 1 else {"data": dd, "fft": d}
            self.axis_names = tuple(self.shape)

    d, dd = MESHES[mname]
    for key in _keys():
        x = spawned["inputs"][key]
        nd = GRIDS[key.split("/")[0]][1]
        batch = x.shape[0] if x.ndim > nd else 1
        want = rmd.choose_decomp(x.shape[-nd:], _M(d, dd), batch=batch)
        assert want == tmd.choose_decomp(x.shape[-nd:], _BothMeshLike(d, dd),
                                         batch=batch)
        dt = key.split("/")[1]
        for rec in spawned["ranks"]:
            assert rec["res"][f"{key}/{mname}/auto"] == want
            if nd == 2:
                spec = np.fft.fft2(x)
                _close(rec["arrays"][f"{key}/{mname}/ext_fft2"], spec, dt)
                _close(rec["arrays"][f"{key}/{mname}/ops_fft2"], spec, dt)
                _close(rec["arrays"][f"{key}/{mname}/ops_ifft2"], x, dt,
                       factor=2)


class _BothMeshLike:
    def __init__(self, d, dd):
        sizes = {"fft": d} if dd == 1 else {"data": dd, "fft": d}
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, dim=None):
        return self._sizes[dim]


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("key", _keys())
def test_mesh_nd_volume_is_the_reference_model(spawned, key, mname):
    from repro.core.fft import multidim as rmd

    x = spawned["inputs"][key]
    nd = GRIDS[key.split("/")[0]][1]
    d, dd = MESHES[mname]
    b = x.shape[0] if x.ndim > nd else 1
    kw = dict(itemsize=x.dtype.itemsize)
    rec = spawned["ranks"][0]
    for name, want in (
            ("slab", rmd.collective_volume_nd(
                x.shape[-nd:], b, d, data_shards=dd if b % dd == 0 else 1,
                **kw)),
            ("pencil", rmd.collective_volume_nd(
                x.shape[-nd:], b, d, decomp="pencil", data_shards=dd, **kw)),
            ("pencil_t2", rmd.collective_volume_nd(
                x.shape[-nd:], b, d, decomp="pencil", data_shards=dd,
                natural_order=False, chunks=2, **kw))):
        got = dict(rec["vol"][f"{key}/{mname}/{name}"])
        got.pop("launches")
        want["shape"] = list(want["shape"])
        assert got == want, name


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("key", _keys())
def test_mesh_nd_collectives_and_launches_are_the_modelled_ones(spawned, key,
                                                                mname):
    """Each call's all-to-all and all-gather calls and bytes on every rank
    are ``plan.volume``'s (the TRANSPOSED_IN inverse: the forward's
    all-to-alls, no gather), its ``block_fft`` launches
    ``plan.launches``'; an operand placed by ``shard_grid`` adds the
    pencil's ingest (one all-gather over each sharded dimension, counted
    apart) and nothing to the slab."""
    x = spawned["inputs"][key]
    d, dd = MESHES[mname]
    base = f"{key}/{mname}"
    for rec in spawned["ranks"]:
        spy, vol, res = rec["spy"], rec["vol"], rec["res"]
        for name, v, way in (
                ("slab/fwd", vol[base + "/slab"], "fft"),
                ("slab/inv", vol[base + "/slab"], "ifft"),
                ("pencil/fwd", vol[base + "/pencil"], "fft"),
                ("pencil/inv", vol[base + "/pencil"], "ifft"),
                ("pencil/fwd_t1", vol[base + "/pencil_t1"], "fft"),
                ("pencil/fwd_t2", vol[base + "/pencil_t2"], "fft"),
                ("pencil/inv_t1", vol[base + "/pencil_t1"], "ifft"),
                ("pencil/inv_t2", vol[base + "/pencil_t2"], "ifft"),
                ("slab/sharded", vol[base + "/slab"], "fft")):
            t = _totals(spy[f"{base}/{name}"])
            assert t["all_to_all"] == [v["all_to_all_count"],
                                       v["all_to_all_bytes"]], name
            assert t["all_gather"] == [v["all_gather_count"],
                                       v["gather_hlo"]], name
            assert t["all_reduce"] == [0, 0], name
            assert res[f"{base}/{name}/launches"] == v["launches"][way], name
        v = vol[base + "/pencil"]
        t = _totals(spy[base + "/pencil/sharded"])
        block = x.size * x.dtype.itemsize // (d * dd)
        ingest = [1, block * d] if dd == 1 else \
            [2, block * d + block * d * dd]
        assert t["all_gather"] == [v["all_gather_count"] + ingest[0],
                                   v["gather_hlo"] + ingest[1]]


# ---------------------------------------------------------------------------
# real rank 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("dt", ("float32", "float64"))
def test_mesh_rfft2_slab_and_composed(spawned, dt, mname):
    """The real slab and the composed pencil path against np.fft.rfft2
    and the reference's; irfft2 back; the slab's one all-to-all of the
    padded half spectrum, ``collective_volume_nd(real=True)``'s."""
    from repro.core.fft import multidim as rmd

    key = f"r2/{dt}"
    x = spawned["inputs"][key]
    cdt = "complex128" if dt == "float64" else "complex64"
    want = np.fft.rfft2(x)
    d, dd = MESHES[mname]
    base = f"{key}/{mname}"
    model = rmd.collective_volume_nd(
        x.shape[-2:], x.shape[0], d, data_shards=dd, real=True,
        itemsize=np.dtype(cdt).itemsize)
    for rec in spawned["ranks"]:
        a, spy, vol = rec["arrays"], rec["spy"], rec["vol"]
        for dec in ("slab", "pencil"):
            _close(a[f"{base}/{dec}/rfft2"], want, cdt)
            _close(a[f"{base}/{dec}/irfft2"], x, dt, factor=2)
        _close(a[base + "/ext_rfft2"], want, cdt)
        _close(a[base + "/ext_irfft2"], x, dt, factor=2)
        v = dict(vol[base + "/slab"])
        assert v.pop("launches") == {"fft": 2, "ifft": 2, "convolve": 5}
        model["shape"] = list(model["shape"])
        assert v == model
        assert vol[base + "/pencil"]["decomp"] == "pencil"
        for way in ("rfft2", "irfft2"):
            t = _totals(spy[f"{base}/slab/{way}"])
            assert t["all_to_all"] == [1, model["all_to_all_bytes"]]
            assert t["all_gather"] == [0, 0]
            assert rec["res"][f"{base}/slab/{way}/launches"] == 2
        assert rec["res"][f"{base}/slab/rfft2_placements"][-1] \
            == "Shard(dim=2)"
        if dt == "float32":
            ref = spawned["ref"]
            _close(a[f"{base}/slab/rfft2"], ref[base + "/rfft2"], cdt)
            _close(a[f"{base}/slab/irfft2"], ref[base + "/irfft2"], dt,
                   factor=2)
            _close(a[f"{base}/pencil/rfft2"], ref[base + "/composed"], cdt)


# ---------------------------------------------------------------------------
# the 2-D grouped ABFT
# ---------------------------------------------------------------------------


def _expect(name, tele, err, tol):
    """The catalogue's verdicts of scenario ``name`` (the reference's own
    assertions, tests/test_fft_multidim.py)."""
    if name == "clean":
        assert not any(tele["flagged"]) and err < tol, err
    elif name == "four":
        assert all(tele["flagged"]) and all(tele["correctable"])
        assert tele["location"] == [1, 2, 5, 6] and tele["corrected"] == 4
        assert err < tol, err
    elif name == "nocorrect":
        assert all(tele["flagged"]) and tele["corrected"] == 0
        assert err > 50 * tol, err
    elif name == "double":
        assert tele["uncorrectable"] == [False, False, True, False]
        assert not any(tele["correctable"]) and tele["corrected"] == 0
        assert err > 50 * tol, err
    elif name == "recompute":
        assert tele["recomputed"] == 1 and err < tol, err
    else:
        want = [False, True, False, False] if name == "cs2" \
            else [False, False, True, False]
        assert tele["checksum_fault"] == want and tele["flagged"] == want
        assert not any(tele["correctable"]) and err < tol, err


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("key", ["ft/c2c/complex64", "ft/c2c/complex128",
                                 "ft/real/float32", "ft/real/float64"])
def test_mesh_ft2_fault_matrix(spawned, key, mname):
    """``plan(FFTSpec(rank=2, ft=..., mesh=...)).ft_fft`` through the whole
    fault matrix: the catalogue's verdicts, the same on every rank; the
    output against np.fft; one all-to-all of data and checksum grids
    (``volume``'s), ONE all-reduce of 3 * G/data + 1 reals, the telemetry
    gathers, and the recompute's one plain slab a group; the plan's
    ``launches["ft_fft"]`` a call (three: pass 1's two, pass 2's one) and
    its ``launches["fft"]`` a recomputed group."""
    real = "/real/" in key
    x = spawned["inputs"][key]
    dt = key.split("/")[-1]
    cdt = {"float32": "complex64", "float64": "complex128"}.get(dt, dt)
    want = (np.fft.rfft2 if real else np.fft.fft2)(x)
    tol = ATOL[np.dtype(cdt)]
    d, dd = MESHES[mname]
    gl = FT2_GROUPS // dd
    rdt = np.dtype(cdt).itemsize // 2
    tele_bytes = [1, d * rdt] if dd == 1 else \
        [2, d * rdt + dd * (gl * 5 + d) * rdt]
    base = f"{key}/{mname}"
    for rec in spawned["ranks"]:
        for sc in FT2_SCENARIOS["cases"]:
            name = f"{base}/{sc['name']}"
            tele = rec["res"][name]
            assert tele == spawned["ranks"][0]["res"][name]
            y = rec["arrays"][name + "/y"]
            err = float(np.abs(y - want).max() / np.abs(want).max())
            _expect(sc["name"], tele, err, tol)
            v = rec["vol"][name]
            t = _totals(rec["spy"][name])
            # the recompute reruns the uncorrectable groups of the rank's
            # own data shard on the plain slab: one all-to-all a group
            md = rec["rank"] // d if dd > 1 else 0
            extra = sum(tele["uncorrectable"][md * gl:(md + 1) * gl]) \
                if sc["name"] == "recompute" else 0
            _, rr, cc = FT2_SHAPE
            a2a_group = FT2_SHAPE[0] // FT2_GROUPS * rr * (
                cc // 2 + d if real else cc) // d * np.dtype(cdt).itemsize
            assert t["all_to_all"] == [1 + extra, v["all_to_all_bytes"]
                                       + extra * a2a_group], sc["name"]
            assert t["all_gather"] == [0, 0]
            assert t["all_reduce"] == [1, 3 * gl + 1]
            assert t["telemetry_gather"] == tele_bytes
            assert v["launches"]["ft_fft"] == 3
            assert rec["res"][name + "/launches"] == \
                v["launches"]["ft_fft"] + extra * v["launches"]["fft"]
        _close(rec["arrays"][base + "/function/y"], want, cdt)
        assert rec["res"][base + "/function"] == 4


# ---------------------------------------------------------------------------
# the 2-D convolution and the one-rank mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("dt", ("float32", "complex64"))
def test_mesh_fft_convolve2(spawned, dt, mname):
    """Every mode, shared and per-signal kernels, against numpy and (mode
    "same") the reference; two all-to-alls (the forward's both operands'
    grids, the inverse's cropped rows) and no all-gather; the plan's
    ``launches["convolve"]`` (``conv2_spec``'s plan); the result sharded
    over its rows (and the batch over data)."""
    from repro_torch.core.fft import multidim as tmd

    a = spawned["inputs"][f"cv/{dt}/a"]
    d, dd = MESHES[mname]
    real = dt == "float32"
    cdt = "complex64"
    nr, nc = tmd._conv2_shape(CONV[0][1:], CONV[1], d)
    cw = nc // 2 + d if real else nc
    for vn in ("v1", "vb"):
        v = spawned["inputs"][f"cv/{dt}/{vn}"]
        for mode in ("full", "same", "valid"):
            name = f"cv/{dt}/{mname}/{vn}/{mode}"
            s = (a.shape[-2] + v.shape[-2] - 1, a.shape[-1] + v.shape[-1] - 1)
            full = np.fft.ifft2(np.fft.fft2(a, s=s) * np.fft.fft2(v, s=s))
            if real:
                full = full.real
            for ax, la, lv in ((-2, a.shape[-2], v.shape[-2]),
                               (-1, a.shape[-1], v.shape[-1])):
                lo, n = tmd._crop_range(la, lv, mode)
                full = np.take(full, np.arange(lo, lo + n), axis=ax)
            rows = full.shape[-2]
            ba = a.shape[0] // dd
            bk = ba if vn == "vb" else 1
            for rec in spawned["ranks"]:
                _close(rec["arrays"][name], full, cdt)
                t = _totals(rec["spy"][name])
                item = np.dtype(cdt).itemsize
                fwd = (ba + bk) * nr * cw // d * item
                inv = ba * rows * cw // d * item
                assert t["all_to_all"] == [2, fwd + inv], name
                assert t["all_gather"] == [0, 0] and t["all_reduce"] == [0, 0]
                assert rec["vol"][name]["launches"]["convolve"] == 5
                assert rec["res"][name + "/launches"] == \
                    rec["vol"][name]["launches"]["convolve"]
                assert rec["res"][name + "/placements"] == (
                    ["Shard(dim=1)"] if dd == 1
                    else ["Shard(dim=0)", "Shard(dim=1)"])
                if mode == "same":
                    _close(rec["arrays"][name],
                           spawned["ref"][f"cv/{dt}/{mname}/{vn}"], cdt)


def test_mesh_one_rank_rank2_plan_is_local(spawned):
    for rec in spawned["ranks"]:
        assert rec["res"]["one_rank"] == ["local", True]
