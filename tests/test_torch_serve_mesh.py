"""The port's serving over a mesh (``SpecBucketer``, ``build_fft_spec``,
``serve_plan``, ``ServeRuntime`` and ``launch.serve`` with a
``torch.distributed`` mesh) on four gloo ranks on the CPU, against the
reference ``repro.serve`` and ``repro.launch.serve`` on the same seeded
numpy inputs.

One four-process spawn shared by the whole file (a file store under
``tmp_path``), on a 1-D mesh of 4 and a 2 x 2 ``data x fft`` mesh, and one
JAX subprocess running the reference at the same time on meshes of 4 and
2 x 2 built with ``AxisType.Auto`` (``jax.make_mesh`` is wrapped to give
every mesh of the subprocess those axes, the CLI's own too: with the
default explicit axes the reference's natural-order reshape raises under
the installed JAX). Held to the reference:

* ``build_fft_spec`` 's resolved ``FFTSpec`` fields (or the exception's
  type) over op x dims x real x ft x order x chunks x decomp;
* ``serve_plan`` 's outputs and info dicts at ``ATOL[dtype] * max|ref|``
  (float scores and ``shard_delta_max`` are bounded, not compared);
* ``ServeRuntime`` 's per-request results, bucket labels, ``pad_waste``
  and ft ledgers under a ``Fault`` campaign (five SEUs over two batches,
  one group hit in two signals and recomputed), and the translation of a
  batch's ``Fault`` s into the grouped ABFT's rows;
* ``launch.main([... "--fft-shards", "4" ...])`` called on every rank:
  rank 0's printed line and telemetry against the reference CLI's, and
  nothing printed elsewhere.

Spies on ``dist.all_to_all_single``, ``all_gather_into_tensor`` and
``all_reduce`` and a count of ``block_fft_plain`` calls hold each served
batch to its bucket plan (``plan.launches``, ``plan.volume``, the grouped
verdict's all-reduce and telemetry gathers) and the runtime's own traffic
on its control and data groups to the sizes ``repro_torch.serve.mesh``
states. A
batch that fails on one rank fails on every rank (before the plan and
after it), the command stream stays in step, and ``close`` stops the
followers. A runtime over a one-rank mesh is the local runtime, bitwise.
"""
import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from conftest import ATOL, REPO

MESHES = {"mesh1": (4, 1), "mesh2": (2, 2)}     # (fft, data)
THRESHOLD = 1e-4
N = 256

# serve_plan's cases: name -> (input, build_fft_spec kwargs, serve kwargs)
PLAN_CASES = {
    "fft": ("c1", {}, {}),
    "fft_transposed": ("c1", {"natural_order": False}, {}),
    "fft_chunks2": ("c1", {"chunks": 2}, {}),
    "spectrum": ("c1", {"op": "spectrum"}, {"op": "spectrum"}),
    "real": ("r1", {"real": True}, {}),
    "real_spectrum": ("r1", {"real": True, "op": "spectrum"},
                      {"op": "spectrum"}),
    "ft": ("c1", {"ft": True, "groups": 4}, {"inject": True}),
    "ft_clean": ("c1", {"ft": True, "groups": 4}, {}),
    "fft2": ("c2", {"dims": 2}, {}),
    "fft2_pencil": ("c2", {"dims": 2, "decomp": "pencil"}, {}),
    "rfft2": ("r2", {"dims": 2, "real": True}, {}),
    "ft2": ("c2", {"dims": 2, "ft": True, "groups": 2}, {}),
    "convolve": ("a1", {"op": "convolve", "kernel": "k1"},
                 {"op": "convolve"}),
    "correlate": ("a1", {"op": "correlate", "kernel": "k1"},
                  {"op": "correlate"}),
    "convolve2": ("a2", {"dims": 2, "op": "convolve", "kernel": "k2"},
                  {"op": "convolve"}),
}
INPUTS = {"c1": ((8, N), "complex64"), "r1": ((8, N), "float32"),
          "c2": ((4, 16, 32), "complex64"), "r2": ((4, 16, 32), "float32"),
          "a1": ((8, 200), "float32"), "k1": ((31,), "float32"),
          "a2": ((4, 20, 24), "float32"), "k2": ((5, 7), "float32")}

# the runtime's campaign: (input shape, dtype, submit kwargs, faults as
# [col, row, eps_re, eps_im]); max_batch 4, so every bucket fills whole
# batches; ft groups of 2: batch 1 hits groups 0 and 1 once each, batch
# 2 hits group 0 in two signals (uncorrectable, recomputed)
RT_CONFIG = dict(max_batch=4, deadline_ms=60000.0, queue_depth=256)
RT_FT = dict(threshold=THRESHOLD, groups=2, correct=True,
             recompute_uncorrectable=True)
_FAULTS = {0: [[5, 1, 300.0, 0.0]], 3: [[17, 2, -250.0, 0.0]],
           4: [[3, 1, 280.0, 0.0]],
           5: [[40, 2, -260.0, 0.0], [9, 0, 220.0, 40.0]]}
RT_REQUESTS = (
    [((200 if i % 2 else N,), "complex64", {}, []) for i in range(8)]
    + [((N,), "complex128", {}, []) for _ in range(4)]
    + [((100,), "complex64", {"op": "spectrum"}, []) for _ in range(4)]
    + [((300,), "float32", {"real": True}, []) for _ in range(4)]
    + [((N,), "complex64", {"ft": True}, _FAULTS.get(i, []))
       for i in range(8)]
    + [((60, 100), "complex64", {}, []) for _ in range(4)]
    + [((30, 60), "float32", {"real": True}, []) for _ in range(4)])

# a batch's SEUs as the runtime translates them: faults of four requests
# ([col, row, eps_re, eps_im]), columns across every rank's pass-1 block
INJECT_BATCH = [[[5, 1, 300.0, 0.0], [250, 13, -20.0, 7.0]], [],
                [[17, 2, -250.0, 0.0]], [[40, 0, 220.0, 40.0],
                                         [14, 15, 1.5, -2.5]]]

CLI_FFT = {
    "fft": "n=256,batch=8,shards=4",
    "ft": "n=256,batch=8,shards=4,ft=1,groups=4",
    "spectrum": "n=256,batch=8,shards=4,op=spectrum",
    "real": "n=256,batch=8,shards=4,real=1",
    "chunks": "n=256,batch=8,shards=4,chunks=2",
    "data": "n=256,batch=8,shards=2,data=2,ft=1",
    "convolve": "n=200,batch=8,shards=4,op=convolve,kernel_n=31",
    "grid": "dims=2,rows=16,cols=32,batch=4,shards=4",
}
CLI_SERVE = ("--mode", "serve", "--serve-requests", "24", "--fft-spec",
             "n=256,shards=4,workers=2,max_batch=4,deadline_ms=2")


def _spec_matrix():
    """``build_fft_spec``'s argument combinations: name -> (batch shape,
    kwargs)."""
    out = {}
    for dims, shape in ((1, (8, N)), (2, (4, 16, 32))):
        for op in ("fft", "spectrum", "convolve", "correlate"):
            for real in (False, True):
                for ft in (False, True):
                    for order in (None, False):
                        for chunks in (1, 2, 0):
                            for dec in (("auto",) if dims == 1
                                        else ("auto", "slab", "pencil")):
                                kw = dict(op=op, dims=dims, real=real,
                                          ft=ft, natural_order=order,
                                          chunks=chunks, decomp=dec)
                                if op in ("convolve", "correlate"):
                                    kw["kernel_shape"] = (31,) if dims == 1 \
                                        else (5, 7)
                                if ft:
                                    kw["groups"] = 2
                                name = "/".join(f"{k}={v}" for k, v in
                                                sorted(kw.items()))
                                out[name] = (shape, kw)
    return out


def _seu_rows(shards):
    """Two SEUs of the ft serve_plan case (groups 0 and 3 of 4, batch 8)
    as the grouped ABFT's rows on ``shards`` ranks."""
    from repro_torch.core.fft.distributed import make_dist_plan
    p = make_dist_plan(N, shards)
    n2l = p.n2 // shards
    return [[1 % shards, 1, 2 % p.n1, 1 % n2l, 1.0, 300.0, 0.0],
            [shards - 1, 6, p.n1 - 1, n2l - 1, 1.0, -250.0, 100.0]]


_COMMON = r"""
import contextlib, io, json, sys
import numpy as np


def spec_fields(spec):
    ft = spec.ft
    mesh = spec.mesh
    if mesh is None:
        shards = None
    elif hasattr(mesh, "mesh_dim_names"):
        shards = int(mesh.size(list(mesh.mesh_dim_names).index("fft")))
    else:
        shards = int(mesh.shape["fft"])
    return {"shape": list(spec.shape), "dtype": str(spec.dtype),
            "rank": spec.rank, "axis": spec.axis, "decomp": spec.decomp,
            "natural_order": bool(spec.natural_order),
            "real": bool(spec.real), "chunks": int(spec.chunks),
            "shards": shards,
            "ft": None if ft is None else {
                "threshold": float(ft.threshold), "groups": ft.groups,
                "group_size": ft.group_size, "correct": bool(ft.correct),
                "recompute": bool(ft.recompute_uncorrectable)}}


def captured(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()
"""

_REF_SCRIPT = _COMMON + r"""
import jax
from jax.sharding import AxisType

_make_mesh = jax.make_mesh


def _auto_mesh(shape, names, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(names))
    return _make_mesh(shape, names, **kw)


jax.make_mesh = _auto_mesh

from repro.core.plan import FTConfig
from repro.core.fft import api
from repro.launch import serve as launch
from repro.serve import (Fault, RuntimeConfig, ServeRuntime, build_fft_spec,
                         serve_plan)
from repro.serve.scheduler import Batch, ServeRequest

inputs, cases_path, arrays_path, res_path = sys.argv[1:5]
inp = dict(np.load(inputs))
cases = json.load(open(cases_path))
meshes = {"mesh1": jax.make_mesh((4,), ("fft",)),
          "mesh2": jax.make_mesh((2, 2), ("data", "fft"))}
res, arrays = {}, {}
for mname, mesh in meshes.items():
    for name, (shape, kw) in cases["specs"].items():
        try:
            res[f"spec/{mname}/{name}"] = spec_fields(
                build_fft_spec(tuple(shape), mesh=mesh, **kw))
        except Exception as e:
            res[f"spec/{mname}/{name}"] = {"error": type(e).__name__}
    for name, (key, bkw, skw) in cases["plan"].items():
        bkw, skw = dict(bkw), dict(skw)
        x = inp[key]
        kernel = inp[bkw.pop("kernel")] if "kernel" in bkw else None
        spec = build_fft_spec(x.shape, mesh=mesh, threshold=cases["thr"],
                              kernel_shape=None if kernel is None
                              else kernel.shape, dtype="complex64", **bkw)
        if skw.pop("inject", False):
            skw["inject"] = np.asarray(cases["seu"][mname], np.float32)
        y, info = serve_plan(api.plan(spec), x, kernel=kernel, **skw)
        arrays[f"plan/{mname}/{name}"] = np.asarray(y)
        res[f"plan/{mname}/{name}"] = info
    rt = ServeRuntime(RuntimeConfig(ft=FTConfig(**cases["rt_ft"]),
                                    **cases["rt"]), mesh=mesh)
    hs = []
    for i, (shape, dt, kw, faults) in enumerate(cases["requests"]):
        f = [Fault(col=c, row=r, eps_re=e, eps_im=ei)
             for c, r, e, ei in faults] or None
        hs.append(rt.submit(inp[f"req/{i}"], faults=f, **kw))
    for i, h in enumerate(hs):
        arrays[f"rt/{mname}/{i}"] = np.asarray(h.result(timeout=120))
        res[f"rt/{mname}/{i}"] = h.info
    rt.close()
    res[f"rt/{mname}/buckets"] = rt.stats()["buckets"]
    key = next(k for k in rt._plans if k.ft)
    batch = Batch(key=key, t_close=0.0, requests=[
        ServeRequest(key=key, x=None, handle=None, inject=tuple(
            Fault(col=c, row=r, eps_re=e, eps_im=ei) for c, r, e, ei in f))
        for f in cases["inject_batch"]])
    res[f"inject/{mname}"] = np.asarray(
        rt._build_inject(rt._plans[key], batch)[0]).tolist()
for name, spec in cases["cli_fft"].items():
    sys.argv = ["serve", "--mode", "fft", "--fft-iters", "1", "--fft-spec",
                spec]
    res[f"cli/{name}"] = captured(launch.main)
sys.argv = ["serve"] + cases["cli_serve"]
res["cli/serve"] = captured(launch.main)
np.savez(arrays_path, **arrays)
with open(res_path, "w") as f:
    json.dump(res, f, default=repr)
"""

_WORKER_SCRIPT = _COMMON + r"""
import os, threading
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, inputs, cases_path, outdir):
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=4)
    from repro_torch.core.fft import api
    from repro_torch.core.plan import FTConfig
    from repro_torch.kernels import stockham
    from repro_torch.launch import serve as launch
    from repro_torch.launch.mesh import make_fft_mesh
    from repro_torch.serve import (Fault, RuntimeConfig, ServeRuntime,
                                   build_fft_spec, serve_plan)
    from repro_torch.serve import runtime as rtm
    from repro_torch.serve.mesh import Channel
    from repro_torch.serve.scheduler import Batch, ServeRequest

    inp = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    cases = json.load(open(cases_path))
    calls, launches = [], [0]
    a2a, gather = dist.all_to_all_single, dist.all_gather_into_tensor
    reduce_, plain = dist.all_reduce, stockham.block_fft_plain
    bcast = dist.broadcast

    def spy_a2a(out, inp_, *a, **k):
        calls.append(["all_to_all", inp_.numel() * inp_.element_size(),
                      id(k.get("group"))])
        return a2a(out, inp_, *a, **k)

    def spy_gather(out, inp_, *a, **k):
        kind = "all_gather" if out.is_complex() else "telemetry_gather"
        calls.append([kind, out.numel() * out.element_size(),
                      id(k.get("group"))])
        return gather(out, inp_, *a, **k)

    def spy_reduce(t, *a, **k):
        calls.append(["all_reduce", t.numel(), id(k.get("group"))])
        return reduce_(t, *a, **k)

    def spy_bcast(t, *a, **k):
        calls.append(["broadcast", t.numel() * t.element_size(),
                      id(k.get("group"))])
        return bcast(t, *a, **k)

    def count(*a, **k):
        launches[0] += 1
        return plain(*a, **k)

    dist.all_to_all_single = spy_a2a
    dist.all_gather_into_tensor = spy_gather
    dist.all_reduce = spy_reduce
    dist.broadcast = spy_bcast
    stockham.block_fft_plain = count
    batches = []
    run_all = ServeRuntime._run_all

    def spied_run_all(self, key, fill, inject, *rest):
        calls.clear()
        launches[0] = 0
        before = {k: list(v) for k, v in self.channel.traffic.items()}
        try:
            return run_all(self, key, fill, inject, *rest)
        finally:
            ctrl, data = id(self.channel.group), id(self.channel.data)
            plan = self._plans[key]
            batches.append({
                "label": key.label, "fill": fill, "launches": launches[0],
                "calls": [c[:2] for c in calls if c[2] not in (ctrl, data)],
                "ctrl": [c[:2] for c in calls if c[2] == ctrl],
                "data": [c[:2] for c in calls if c[2] == data],
                "traffic": {k: [v[0] - before[k][0], v[1] - before[k][1]]
                            for k, v in self.channel.traffic.items()},
                "faults": 0 if inject is None else int(inject.shape[0]),
                "plan": {"launches": plan.launches, "volume": plan.volume,
                         "groups": plan.groups, "chunks": plan.chunks,
                         "shards": plan.shards, "dsize": plan.dsize,
                         "n1": getattr(plan.pencil, "n1", None),
                         "pencil": getattr(plan.pencil, "launches", None),
                         "itemsize": self._payloads[key].itemsize}})
            calls.clear()

    ServeRuntime._run_all = spied_run_all
    res, arrays = {}, {}
    meshes = {"mesh1": make_fft_mesh(4, device="cpu"),
              "mesh2": make_fft_mesh(2, data=2, device="cpu")}
    for mname, mesh in meshes.items():
        if rank == 0:
            for name, (shape, kw) in cases["specs"].items():
                try:
                    res[f"spec/{mname}/{name}"] = spec_fields(build_fft_spec(
                        tuple(shape), mesh=mesh, device="cpu", **kw))
                except Exception as e:
                    res[f"spec/{mname}/{name}"] = {"error": type(e).__name__}
        ch = Channel(mesh)
        for name, (key, bkw, skw) in cases["plan"].items():
            bkw, skw = dict(bkw), dict(skw)
            x = inp[key]
            kernel = inp[bkw.pop("kernel")] if "kernel" in bkw else None
            spec = build_fft_spec(tuple(x.shape), mesh=mesh,
                                  threshold=cases["thr"], kernel_shape=None
                                  if kernel is None else tuple(kernel.shape),
                                  dtype="complex64", device="cpu", **bkw)
            if skw.pop("inject", False):
                skw["inject"] = cases["seu"][mname]
            y, info = serve_plan(api.plan(spec), x, kernel=kernel, **skw)
            full = ch.assemble(y)
            if rank == 0:
                arrays[f"plan/{mname}/{name}"] = full.numpy()
            res[f"plan/{mname}/{name}"] = info
        cfg = RuntimeConfig(ft=FTConfig(**cases["rt_ft"]), device="cpu",
                            **cases["rt"])
        batches.clear()
        with ServeRuntime(cfg, mesh=mesh) as rt:
            if rank == 0:
                hs = []
                for i, (shape, dt, kw, faults) in enumerate(
                        cases["requests"]):
                    f = [Fault(col=c, row=r, eps_re=e, eps_im=ei)
                         for c, r, e, ei in faults] or None
                    x = np.load(inputs)[f"req/{i}"]
                    hs.append(rt.submit(x, faults=f, **kw))
                rt.drain()
                res[f"rt/{mname}/drained"] = all(h.done() for h in hs)
                for i, h in enumerate(hs):
                    arrays[f"rt/{mname}/{i}"] = h.result(timeout=120)
                    res[f"rt/{mname}/{i}"] = h.info
        key = next(k for k in rt._plans if k.ft)
        batch = Batch(key=key, t_close=0.0, requests=[
            ServeRequest(key=key, x=None, handle=None, inject=tuple(
                Fault(col=c, row=r, eps_re=e, eps_im=ei)
                for c, r, e, ei in f)) for f in cases["inject_batch"]])
        res[f"inject/{mname}"] = rt._mesh_inject(rt._plans[key],
                                                 batch).tolist()
        res[f"rt/{mname}/batches"] = list(batches)
        res[f"rt/{mname}/commands"] = [list(c) for c in rt.commands]
        res[f"rt/{mname}/stats"] = rt.stats()
        res[f"rt/{mname}/threads"] = [t.is_alive() for t in rt._workers]
    # the CLI on every rank: rank 0 leads and prints
    for name, spec in cases["cli_fft"].items():
        res[f"cli/{name}"] = captured(lambda: launch.main(
            ["--mode", "fft", "--device", "cpu", "--fft-iters", "1",
             "--fft-spec", spec]))
    res["cli/serve"] = captured(lambda: launch.main(
        ["--device", "cpu"] + cases["cli_serve"]))
    res["cli/group_kept"] = dist.is_initialized()
    # a batch that fails on one rank fails on every rank: rank 1 after the
    # plan of its first batch, rank 2 staging its second; the third runs
    mesh = meshes["mesh1"]
    ran = [0]
    serve_plan_ = rtm.serve_plan
    stage = ServeRuntime._stage

    def failing_serve(plan, x, **kw):
        out = serve_plan_(plan, x, **kw)
        if rank == 1 and ran[0] == 1:
            raise RuntimeError("rank 1 fails after the plan")
        return out

    def failing_stage(self, *a):
        ran[0] += 1
        if rank == 2 and ran[0] == 2:
            raise RuntimeError("rank 2 fails staging")
        return stage(self, *a)

    # patched before the follower threads start, which may run the first
    # commands before this thread resumes
    rtm.serve_plan = failing_serve
    ServeRuntime._stage = failing_stage
    rt = ServeRuntime(RuntimeConfig(max_batch=4, deadline_ms=60000.0,
                                    device="cpu"), mesh=mesh)
    outcome = []
    if rank == 0:
        x = np.load(inputs)["c1"][:4]
        for b in range(3):
            hs = [rt.submit(x[i]) for i in range(4)]
            got = []
            for h in hs:
                try:
                    got.append(float(np.abs(h.result(timeout=60) - np.fft.fft(
                        x[len(got)])).max()))
                except Exception as e:
                    got.append(f"{type(e).__name__}: {e}")
            outcome.append(got)
    else:
        try:
            rt.submit(np.zeros(8, np.complex64))
        except RuntimeError as e:
            outcome.append(str(e))
    rt.close()
    rtm.serve_plan = serve_plan_
    ServeRuntime._stage = stage
    if rank == 0:
        try:
            rt.submit(np.zeros(8, np.complex64))
        except Exception as e:
            outcome.append(type(e).__name__)
    res["fail/outcome"] = outcome
    res["fail/failures"] = list(rt.failures)
    res["fail/commands"] = [list(c) for c in rt.commands]
    res["fail/threads"] = [t.is_alive() for t in rt._workers]
    res["fail/groups_closed"] = rt.channel.closed
    res["fail/stats"] = rt.stats()["buckets"]
    # a mesh of ranks 0 and 1: ranks 2 and 3 build a channel that is not
    # a member, and serve nothing
    from torch.distributed.device_mesh import DeviceMesh
    pair = Channel(DeviceMesh("cpu", [0, 1], mesh_dim_names=("fft",)))
    res["pair/member"] = pair.member
    pair.close()
    res["pair/closed"] = pair.closed
    # a runtime over a one-rank mesh is the local runtime, bitwise
    one = make_fft_mesh(1, device="cpu")
    if rank == 0:
        outs = []
        for m in (one, None):
            with ServeRuntime(RuntimeConfig(max_batch=4, deadline_ms=60000.0,
                                            device="cpu"), mesh=m) as rt1:
                hs = [rt1.submit(np.load(inputs)[f"req/{i}"],
                                 **cases["requests"][i][2])
                      for i in range(0, 32, 3)]
                rt1.drain()
                outs.append([h.result(timeout=60) for h in hs])
                res[f"one/{m is None}"] = rt1.channel is None
        res["one/bitwise"] = all(np.array_equal(a, b)
                                 for a, b in zip(*outs))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "res": res}, f, default=repr)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=tuple(sys.argv[1:5]), nprocs=4)
"""


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _inputs():
    inp = {k: _rand(s, dt, 100 + i)
           for i, (k, (s, dt)) in enumerate(INPUTS.items())}
    for i, (shape, dt, _, _) in enumerate(RT_REQUESTS):
        inp[f"req/{i}"] = _rand(shape, dt, 200 + i)
    return inp


def _cases():
    return {"specs": _spec_matrix(), "plan": PLAN_CASES, "thr": THRESHOLD,
            "seu": {m: _seu_rows(d) for m, (d, _) in MESHES.items()},
            "rt": RT_CONFIG, "rt_ft": RT_FT, "requests": RT_REQUESTS,
            "inject_batch": INJECT_BATCH,
            "cli_fft": CLI_FFT, "cli_serve": list(CLI_SERVE)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Run the four gloo ranks and the reference's subprocess together;
    each rank's records and arrays, the reference's, and the inputs."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "cases.json").write_text(json.dumps(_cases()))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    (tmp / "ref.py").write_text(_REF_SCRIPT)
    (tmp / "worker.py").write_text(_WORKER_SCRIPT)
    ref = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "inputs.npz"),
         str(tmp / "cases.json"), str(tmp / "ref.npz"),
         str(tmp / "ref.json")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"), cwd=tmp,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    work = subprocess.run(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "store"),
         str(tmp / "inputs.npz"), str(tmp / "cases.json"), str(tmp)],
        env=env, cwd=tmp, capture_output=True, text=True, timeout=300)
    ref_out, _ = ref.communicate(timeout=300)
    assert work.returncode == 0, work.stdout + work.stderr
    assert ref.returncode == 0, ref_out
    ranks = []
    for r in range(4):
        rec = json.loads((tmp / f"rank{r}.json").read_text())
        rec["arrays"] = dict(np.load(tmp / f"rank{r}.npz"))
        ranks.append(rec)
    return dict(ranks=ranks, ref=json.loads((tmp / "ref.json").read_text()),
                ref_arrays=dict(np.load(tmp / "ref.npz")), inputs=inputs)


def _close(got, want, dtype, factor=1.0):
    got, want = np.asarray(got), np.asarray(want)
    tol = factor * ATOL[np.dtype(dtype)] * np.abs(want).max()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max() / tol


def _info(d):
    """An info dict as JSON round-trips it (tuples become lists)."""
    return json.loads(json.dumps(d, default=repr))


def _bounded(info, ref, faulted):
    """Pop the float scores of both info dicts and bound them: above the
    threshold where an SEU landed, under it elsewhere; the left-check
    residual small."""
    for d in (info, ref):
        if "score" in d:
            s = d.pop("score")
            assert (s > THRESHOLD) == faulted, (s, d)
        if "shard_delta_max" in d:
            assert d.pop("shard_delta_max") < 1e-3, d


# ---------------------------------------------------------------------------
# build_fft_spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["fft", "spectrum", "convolve", "correlate"])
@pytest.mark.parametrize("mname", list(MESHES))
def test_build_fft_spec_on_a_mesh_matches_reference(spawned, mname, op):
    """Every combination's resolved spec (shape, dtype, rank, decomp,
    order, real, chunks, the FTConfig, the mesh's fft ranks) is the
    reference's, or both raise the same exception type."""
    got, want = spawned["ranks"][0]["res"], spawned["ref"]
    names = [k for k in _spec_matrix() if f"op={op}/" in k]
    assert names
    for name in names:
        key = f"spec/{mname}/{name}"
        assert got[key] == want[key], (name, got[key], want[key])


def test_spec_matrix_resolves_the_mesh_defaults(spawned):
    """Spot checks of the matrix: the spectrum stays transposed on a mesh,
    real traffic is natural, a 2-D convolution plans the slab."""
    got = spawned["ranks"][0]["res"]
    for mname, (d, _) in MESHES.items():
        base = ("chunks=1/decomp=auto/dims=1/ft=False/natural_order=None/"
                "op={op}/real={real}")
        spec = got[f"spec/{mname}/" + base.format(op="spectrum", real=False)]
        assert spec["natural_order"] is False and spec["shards"] == d
        real = got[f"spec/{mname}/" + base.format(op="spectrum", real=True)]
        assert real["natural_order"] is True
        conv = got[f"spec/{mname}/chunks=1/decomp=auto/dims=2/ft=False/"
                   f"kernel_shape=(5, 7)/natural_order=None/op=convolve/"
                   f"real=False"]
        assert conv["decomp"] == "slab" and conv["shape"] == [4, 32, 64]


# ---------------------------------------------------------------------------
# serve_plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(PLAN_CASES))
@pytest.mark.parametrize("mname", list(MESHES))
def test_serve_plan_on_a_mesh_matches_reference(spawned, mname, case):
    """The global output (assembled on rank 0) against the reference's at
    ATOL; every rank's info dict the reference's, the grouped ft verdict
    with all its keys."""
    key = f"plan/{mname}/{case}"
    want_y = spawned["ref_arrays"][key]
    ref_info = _info(spawned["ref"][key])
    y = spawned["ranks"][0]["arrays"][key]
    dt = "complex64" if np.iscomplexobj(want_y) else "float32"
    _close(y, want_y, dt)
    faulted = PLAN_CASES[case][2].get("inject", False)
    _bounded(ref_info, {}, faulted)
    for rec in spawned["ranks"]:
        info = _info(rec["res"][key])
        _bounded(info, {}, faulted)
        assert info == ref_info, (rec["rank"], info, ref_info)
    if case == "ft":
        assert ref_info["flagged"] == 2 and ref_info["corrected"] == 2
        assert ref_info["locations"] == [1, 6]
    if case.startswith("ft"):
        assert {"groups", "group_size", "flagged", "locations",
                "corrected", "uncorrectable", "checksum_faults",
                "recomputed", "shards", "data", "op", "ft"} <= set(info)


# ---------------------------------------------------------------------------
# ServeRuntime
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mname", list(MESHES))
def test_runtime_on_a_mesh_matches_reference(spawned, mname):
    """Each request's result and info (bucket label, fill, telemetry) are
    the reference runtime's on the same mesh; the bucket ledgers (counts,
    occupancy, pad_waste, the ft ledger) are equal."""
    rec = spawned["ranks"][0]
    ref = spawned["ref"]
    for i, (shape, dt, kw, faults) in enumerate(RT_REQUESTS):
        key = f"rt/{mname}/{i}"
        want = spawned["ref_arrays"][key]
        cdt = "complex128" if dt == "complex128" else "complex64"
        _close(rec["arrays"][key], want, cdt)
        info, ref_info = _info(rec["res"][key]), _info(ref[key])
        if kw.get("ft"):
            _bounded(info, ref_info, info["flagged"] > 0)
        assert info == ref_info, (i, info, ref_info)
    got = rec["res"][f"rt/{mname}/stats"]["buckets"]
    want = ref[f"rt/{mname}/buckets"]
    assert set(got) == set(want)
    keys = ("submitted", "completed", "failed", "rejected", "timeouts",
            "batches", "batch_occupancy", "pad_waste", "injected",
            "detected", "corrected", "uncorrectable", "checksum_faults",
            "recomputed")
    for label in want:
        assert {k: got[label].get(k) for k in keys} == \
            {k: want[label].get(k) for k in keys}, label
    ft = got["fft:256:c64:ft"]
    assert (ft["injected"], ft["detected"], ft["corrected"],
            ft["uncorrectable"], ft["recomputed"]) == (5, 3, 2, 1, 1)


@pytest.mark.parametrize("mname", list(MESHES))
def test_runtime_translates_faults_as_the_reference(spawned, mname):
    """A sharded ft batch's ``Fault`` s become the reference's grouped-ABFT
    rows ``[rank, batch row, row % n1, col % n2l, 1, eps_re, eps_im]``:
    every SEU of the batch, any number of them, on every rank's block."""
    got = spawned["ranks"][0]["res"][f"inject/{mname}"]
    want = spawned["ref"][f"inject/{mname}"]
    assert len(got) == sum(len(f) for f in INJECT_BATCH) == 5
    assert np.allclose(got, want, rtol=0, atol=1e-6), (got, want)
    assert {int(r[0]) for r in got} == set(range(MESHES[mname][0]))


@pytest.mark.parametrize("mname", list(MESHES))
def test_runtime_ranks_run_the_same_commands(spawned, mname):
    """The leader's ``drain`` returns with every request done; every rank
    ran the same (command, bucket, fill) sequence, ending in STOP, and its
    threads ended with the leader's close."""
    assert spawned["ranks"][0]["res"][f"rt/{mname}/drained"] is True
    seqs = [rec["res"][f"rt/{mname}/commands"] for rec in spawned["ranks"]]
    assert all(s == seqs[0] for s in seqs)
    assert seqs[0][-1] == ["stop", None, 0]
    runs = [c for c in seqs[0] if c[0] == "run"]
    assert len(runs) == len(RT_REQUESTS) // RT_CONFIG["max_batch"]
    assert all(c[2] == RT_CONFIG["max_batch"] for c in runs)
    for rec in spawned["ranks"]:
        assert not any(rec["res"][f"rt/{mname}/threads"])


def _totals(calls):
    out = {k: [0, 0] for k in ("all_to_all", "all_gather", "all_reduce",
                               "telemetry_gather")}
    for kind, size in calls:
        out[kind][0] += 1
        out[kind][1] += size
    return out


def _want_collectives(b, mine):
    """A served batch's collectives on its mesh's data groups: the plan's
    modelled all-to-alls and all-gathers, and on an ft bucket the grouped
    verdict's all-reduce and telemetry gathers and the recompute's plain
    pipeline for each of the ``mine`` uncorrectable groups this rank's
    data shard owns."""
    p = b["plan"]
    vol = p["volume"]
    want = {"all_to_all": [vol["all_to_all_count"],
                           int(vol["all_to_all_bytes"])],
            "all_gather": [vol["all_gather_count"], int(vol["gather_hlo"])],
            "all_reduce": [0, 0], "telemetry_gather": [0, 0]}
    if b["label"].endswith(":ft"):
        d, dd = p["shards"], p["dsize"]
        gl = p["groups"] // dd
        real = p["itemsize"] // 2
        want["all_reduce"] = [p["chunks"], 3 * gl + p["chunks"]]
        want["telemetry_gather"] = [1, d * real] if dd == 1 else \
            [2, d * real + dd * (gl * 5 + d) * real]
        s = RT_CONFIG["max_batch"] // p["groups"]
        want["all_to_all"][0] += mine
        want["all_to_all"][1] += mine * s * N // d * p["itemsize"]
        want["all_gather"][0] += mine
        want["all_gather"][1] += mine * s * N * p["itemsize"]
    return want


@pytest.mark.parametrize("mname", list(MESHES))
def test_runtime_batches_hold_to_their_plans(spawned, mname):
    """On every rank each served batch launched ``plan.launches`` block_fft
    (``ft_fft`` on the ft bucket, plus a transaction for each recomputed
    group its data shard owns) and ran the plan's collectives on the data
    groups; the runtime's own traffic on its control group is the stated
    one: the SEU rows (the header goes before the batch), the payload,
    two flag all-reduces of one int64; on its data group, the payload's
    one broadcast."""
    d, dd = MESHES[mname]
    ref = spawned["ref"]
    first_ft = [i for i, r in enumerate(RT_REQUESTS) if r[2].get("ft")][0]
    for rec in spawned["ranks"]:
        batches = rec["res"][f"rt/{mname}/batches"]
        assert len(batches) == len(RT_REQUESTS) // RT_CONFIG["max_batch"]
        ft_seen = 0
        for b in batches:
            p = b["plan"]
            mine, want_l = 0, p["launches"]["fft"]
            if b["label"].endswith(":ft"):
                info = ref[f"rt/{mname}/{first_ft + 4 * ft_seen}"]
                ft_seen += 1
                # the groups hit twice are group 0s: the first data shard's
                if dd == 1 or rec["rank"] // d == 0:
                    mine = info["uncorrectable"]
                want_l = p["launches"]["ft_fft"] + mine * p["pencil"]
            assert b["launches"] == want_l, (rec["rank"], b["label"])
            want = _want_collectives(b, mine)
            assert _totals(b["calls"]) == want, (rec["rank"], b["label"])
            seu = [["broadcast", 56 * b["faults"]]] if b["faults"] else []
            assert b["ctrl"] == seu + [["all_reduce", 1], ["all_reduce", 1]]
            t = b["traffic"]
            payload = RT_CONFIG["max_batch"] * p["itemsize"] * int(
                np.prod([int(v) for v in re.findall(
                    r"\d+", b["label"].split(":")[1])]))
            assert b["data"] == [["broadcast", payload]]
            assert t["payload"] == [1, payload]
            assert t["control"] == ([1, 56 * b["faults"]] if b["faults"]
                                    else [0, 0])
            assert t["flag"] == [2, 16]
        assert ft_seen == 2


@pytest.mark.parametrize("mname", list(MESHES))
def test_runtime_result_traffic_is_the_missing_blocks(spawned, mname):
    """Rank 0 receives the blocks of a result it does not hold: nothing in
    natural order on the 1-D mesh, the other data shard's rows on 2 x 2,
    the other ranks' share of the transposed spectrum and the 2-D slab;
    each other rank sends at most its own block."""
    d, dd = MESHES[mname]
    lead = spawned["ranks"][0]["res"][f"rt/{mname}/batches"]
    for b in lead:
        label = b["label"]
        tshape = [int(v) for v in re.findall(r"\d+", label.split(":")[1])]
        t = b["traffic"]["result"]
        elems = RT_CONFIG["max_batch"] * int(np.prod(tshape))
        if label.startswith("spectrum"):
            want = elems * 4 * (d * dd - 1) // (d * dd)   # real periodogram
        elif len(tshape) == 2:
            cols = tshape[1] // 2 + 1 if "real" in label else tshape[1]
            full = RT_CONFIG["max_batch"] * tshape[0] * cols * 8
            want = full - full // dd // d if "real" not in label else None
        elif "real" in label:
            want = (elems // 2 + RT_CONFIG["max_batch"]) * 8 * (dd - 1) // dd
        else:
            item = 16 if "c128" in label else 8
            want = elems * item * (dd - 1) // dd
        if want is not None:
            assert t[1] == want, (label, t, want)
        assert t[0] <= d * dd - 1


# ---------------------------------------------------------------------------
# the CLI on every rank
# ---------------------------------------------------------------------------


def _fft_line(out: str):
    line = [ln for ln in out.strip().splitlines() if "rel_err=" in ln][-1]
    info = ast.literal_eval(re.search(r"(\{.*\})", line)[1])
    return info, float(re.search(r"rel_err=(\S+)", line)[1])


@pytest.mark.parametrize("name", list(CLI_FFT))
def test_cli_fft_mode_on_a_mesh_matches_reference(spawned, name):
    """``launch.main(["--mode", "fft", ...])`` on every rank of the running
    group: rank 0 prints the reference CLI's telemetry and a rel_err
    under the complex64 tolerance; the other ranks print nothing."""
    outs = [rec["res"][f"cli/{name}"] for rec in spawned["ranks"]]
    info, err = _fft_line(outs[0])
    ref_info, ref_err = _fft_line(spawned["ref"][f"cli/{name}"])
    _bounded(info, ref_info, False)
    assert info == ref_info
    assert err < 4e-5 and ref_err < 4e-5
    assert outs[1:] == ["", "", ""]
    assert outs[0].startswith("# FFTPlan(")


def _buckets(out: str) -> dict:
    lines = out.splitlines()
    start = lines.index("{")
    return json.loads("\n".join(lines[start:lines.index("}", start) + 1]))


def test_cli_serve_mode_on_a_mesh_matches_reference(spawned):
    """``--mode serve --fft-shards 4`` on every rank: rank 0 serves the
    self-test with every request completed and checked (transposed
    spectra over their sorted bins), the reference's bucket labels and
    counts; the running group stays up for the caller."""
    outs = [rec["res"]["cli/serve"] for rec in spawned["ranks"]]
    assert outs[1:] == ["", "", ""]
    err = float(re.search(r"rel_err=(\S+)", outs[0])[1])
    assert err < 4e-5, outs[0]
    assert "a mesh of 4 fft ranks" in outs[0]
    got, want = _buckets(outs[0]), _buckets(spawned["ref"]["cli/serve"])
    assert set(got) == set(want)
    for label, st in got.items():
        assert (st["submitted"], st["completed"], st["failed"]) == \
            (want[label]["submitted"], want[label]["completed"], 0), label
    assert all(rec["res"]["cli/group_kept"] for rec in spawned["ranks"])


# ---------------------------------------------------------------------------
# failures, shutdown, the one-rank mesh
# ---------------------------------------------------------------------------


def test_a_batch_failing_on_one_rank_fails_on_every_rank(spawned):
    """Rank 1 fails after the plan of the first batch, rank 2 staging the
    second: each batch's handles raise on the leader naming that rank,
    every follower logs the same failures, the third batch is right, and
    the command stream stayed in step."""
    ranks = spawned["ranks"]
    first, second, third = ranks[0]["res"]["fail/outcome"][:3]
    assert all(o.startswith("MeshBatchError: a batch of fft:256:c64 "
                            "failed on rank 1") for o in first), first
    assert all(o.startswith("MeshBatchError: staging a batch of "
                            "fft:256:c64 failed on rank 2") for o in second)
    assert all(isinstance(o, float) and o < 1e-3 for o in third), third
    stats = ranks[0]["res"]["fail/stats"]["fft:256:c64"]
    assert (stats["failed"], stats["completed"]) == (8, 4)
    for rec in ranks[1:]:
        fails = rec["res"]["fail/failures"]
        assert len(fails) == 2 and "rank 1" in fails[0] \
            and "rank 2" in fails[1]
    seqs = [rec["res"]["fail/commands"] for rec in ranks]
    assert all(s == seqs[0] for s in seqs)
    assert [c[0] for c in seqs[0]] == ["admit", "run", "run", "run", "stop"]
    assert "rank 1 fails after the plan" in ranks[1]["res"][
        "fail/failures"][0]


def test_close_stops_the_followers(spawned):
    """The leader's close sends STOP: every rank's threads have ended and
    its channel's groups are destroyed; submitting after close raises on
    the leader, and on a follower ``submit`` raises naming the leader."""
    ranks = spawned["ranks"]
    assert ranks[0]["res"]["fail/outcome"][3] == "RuntimeClosedError"
    for rec in ranks:
        assert not any(rec["res"]["fail/threads"])
        assert rec["res"]["fail/groups_closed"] is True
        assert rec["res"]["fail/commands"][-1] == ["stop", None, 0]
    for rec in ranks[1:]:
        msg = rec["res"]["fail/outcome"][0]
        assert "only the mesh's leader (rank 0)" in msg, msg


def test_a_rank_off_the_mesh_builds_a_channel_it_is_not_a_member_of(
        spawned):
    """Every rank of the world builds the channel of a mesh of ranks 0 and
    1 (its groups are collective over the world); ranks 2 and 3 are not
    members, and every rank's close ends it."""
    got = [(rec["res"]["pair/member"], rec["res"]["pair/closed"])
           for rec in spawned["ranks"]]
    assert got == [(True, True), (True, True), (False, True), (False, True)]


def test_runtime_over_a_one_rank_mesh_is_the_local_runtime(spawned):
    res = spawned["ranks"][0]["res"]
    assert res["one/False"] is True and res["one/True"] is True
    assert res["one/bitwise"] is True
