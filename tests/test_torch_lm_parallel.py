"""The port's LM parallelism (``repro_torch.parallel.sharding``,
``collectives``, ``pipeline``, ``models.moe.moe_block_ep``, the sharded
``train.loop.make_train_step``, ``launch.elastic``, ``launch.mesh``)
against the reference's ``repro.parallel``, ``repro.models.moe``,
``repro.train`` and ``repro.launch.elastic``.

In process: the sharding rules (``param_specs``, ``batch_specs``,
``cache_specs``) against the reference's on ``jax.sharding.AbstractMesh``
es of the production and host shapes, over every leaf of all ten archs'
published and SMOKE configs (the port's ``meta`` params and caches, the
reference's ``jax.eval_shape`` ones); the production meshes; the
compressed mean's 256-rank bound; ``HeartbeatMonitor``.

One four-process gloo spawn shared by the rest of the file (a file store
under ``tmp_path``), run beside one JAX subprocess (8 forced host devices,
meshes built with ``AxisType.Auto``) for the reference's mesh outputs, on
the same seeded numpy inputs:

* EP on ``data x model`` meshes (1, 4) and (2, 2) at DeepSeek-V3 SMOKE (8
  experts, top 2) and Llama-4 SMOKE (4 experts, top 1), capacity factor
  1.25 (binding) and 8, protected and not, float32 and one bfloat16 case,
  through ``moe_block`` under ``use_mesh``: y, aux and the gradients of
  x, router, experts and shared expert against the reference's
  ``moe_block_ep`` at 2e-5 x max, and a case under 1024 tokens a rank
  that takes the portable path as the reference's ``moe_block`` does; a
  spy on ``dist`` holds each EP forward to one (T_local, d) all-reduce
  over ``model`` plus scalars;
* the sharded train step on (4, 1), (2, 2) and (1, 4): Phi-3-medium SMOKE
  three steps against the reference's single-device jitted step (the
  reference's ``test_param_specs_shard_and_run_training_step`` setup), at
  ``tests/test_torch_train.py``'s tolerances; ``microbatch=2`` against the
  reference's jitted step with ``microbatch=2``; DeepSeek SMOKE at 2 x 512
  tokens a data rank, so EP runs inside the step, against the reference's
  step on the same mesh, and a batch of 2 on 4 x 1 (replicated by
  ``batch_specs``) against the reference's step on that placement;
  every rank's storage its shards only;
* ``compress_allreduce_mean`` against the reference's on the same
  per-rank gradients, and its int32 wire;
* ``pipeline_apply`` against the reference's, S = 4 and M in {1, 6};
* ``elastic_restore`` of the (2, 2) run's checkpoint onto 2 x 1 and 1 x 1;
* ``make_host_mesh``'s names, shapes and clamp.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, PartitionSpec as P

from conftest import REPO
from repro import configs as ref_configs
from repro.launch.elastic import HeartbeatMonitor as RefHeartbeat
from repro.models import Model as RefModel
from repro.parallel import sharding as ref_sharding

from repro_torch import configs
from repro_torch import tree as ptree
from repro_torch.launch.elastic import HeartbeatMonitor
from repro_torch.launch.mesh import AbstractMesh as PortMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.parallel import collectives, sharding

ARCHS = configs.all_arch_names()
RULE_MESHES = {"16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
               "4x2": ((4, 2), ("data", "model")),
               "2x2": ((2, 2), ("data", "model")),
               "4x1": ((4, 1), ("data", "model"))}
PRESETS = ("full", "smoke")
EP_TOL = 2e-5                     # x max|ref|: the reference test's bound
THRESHOLD = 1e-3

# ---------------------------------------------------------------------------
# the sharding rules, in process
# ---------------------------------------------------------------------------


def _meshes(name):
    shape, names = RULE_MESHES[name]
    return AbstractMesh(shape, names), PortMesh(shape, names)


def _cfg(arch, preset):
    return ((configs.get_config(arch), ref_configs.get_config(arch))
            if preset == "full" else
            (configs.get_smoke_config(arch),
             ref_configs.get_smoke_config(arch)))


@functools.lru_cache(maxsize=None)
def _shapes(arch, preset):
    """The port's ``meta`` params and the reference's abstract ones."""
    pc, rc = _cfg(arch, preset)
    port = Model(pc).init(None, device="meta")
    ref = jax.eval_shape(lambda: RefModel(rc).init(jax.random.PRNGKey(0)))
    return port, ref


@functools.lru_cache(maxsize=None)
def _cache_shapes(arch, preset, batch):
    pc, rc = _cfg(arch, preset)
    port = Model(pc).init_cache(batch, 64, device="meta")
    ref = jax.eval_shape(lambda: RefModel(rc).init_cache(batch, 64))
    return port, ref


def _ref_flat(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {ref_sharding._path_str(kp): tuple(sp) for kp, sp in flat}


def _port_flat(specs):
    return {"/".join(p): sp for p, sp in sharding.flat_specs(specs)}


def _assert_same_specs(got, want):
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(RULE_MESHES))
def test_param_specs_match_reference(mesh, fsdp, arch, preset):
    rm, pm = _meshes(mesh)
    port, ref = _shapes(arch, preset)
    got = _port_flat(sharding.param_specs(port, pm, fsdp=fsdp))
    want = _ref_flat(ref_sharding.param_specs(ref, rm, fsdp=fsdp))
    _assert_same_specs(got, want)


@pytest.mark.parametrize("seq_shard", [True, False])
@pytest.mark.parametrize("mesh", list(RULE_MESHES))
def test_batch_specs_match_reference(mesh, seq_shard):
    rm, pm = _meshes(mesh)
    for b, t in ((1, 1024), (2, 64), (8, 512), (32, 4096), (512, 7)):
        shapes = {"tokens": (b, t), "labels": (b, t), "patch_embeds":
                  (b, t, 16)}
        ref = {k: jax.ShapeDtypeStruct(s, jnp.int32)
               for k, s in shapes.items()}
        port = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
        got = _port_flat(sharding.batch_specs(port, pm, seq_shard=seq_shard))
        want = _ref_flat(ref_sharding.batch_specs(ref, rm,
                                                  seq_shard=seq_shard))
        _assert_same_specs(got, want)


@pytest.mark.parametrize("seq_shard", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, seq_shard):
    for mesh in RULE_MESHES:
        rm, pm = _meshes(mesh)
        for preset, batch in (("smoke", 1), ("smoke", 32), ("full", 1)):
            port, ref = _cache_shapes(arch, preset, batch)
            got = _port_flat(sharding.cache_specs(port, pm,
                                                  seq_shard=seq_shard))
            want = _ref_flat(ref_sharding.cache_specs(ref, rm,
                                                      seq_shard=seq_shard))
            _assert_same_specs(got, want)


def test_cache_specs_seq_sharding_for_long_decode():
    """The reference's own case: batch 1, so the sequence goes over
    ``data``."""
    _, pm = _meshes("4x2")
    cache = {"scan": {"slot0": {
        "k": torch.empty((3, 1, 1024, 2, 64), device="meta"),
        "v": torch.empty((3, 1, 1024, 2, 64), device="meta")}}}
    sp = sharding.cache_specs(cache, pm, seq_shard=True)["scan"]["slot0"]
    assert sp["k"][2] == "data", sp
    assert sp["k"] == sp["v"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_reference(multi_pod):
    m = make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert m.axis_names == names
    assert tuple(m.shape.values()) == shape and m.size == np.prod(shape)
    assert sharding.dp_axes(m) == names[:-1]
    assert sharding.logical_rules(m) == ref_sharding.logical_rules(
        AbstractMesh(shape, names))


def test_compress_refuses_over_256_ranks():
    g = {"w": torch.zeros(4)}
    with pytest.raises(ValueError, match="256 ranks"):
        collectives.compress_allreduce_mean(
            g, g, PortMesh((512,), ("data",)), ("data",))


def test_heartbeat_monitor_flags_persistent_straggler():
    """The reference's case, on both monitors."""
    for mon in (HeartbeatMonitor(num_hosts=4, straggle_factor=2.0,
                                 patience=2),
                RefHeartbeat(num_hosts=4, straggle_factor=2.0, patience=2)):
        fast = np.array([1.0, 1.0, 1.0, 1.0])
        slow = np.array([1.0, 1.0, 5.0, 1.0])
        assert mon.observe(slow) == []
        assert mon.observe(slow) == [2]
        assert mon.observe(fast) == []
        assert mon.observe(slow) == []


def test_portable_moe_refuses_an_expert_slice():
    """A rank's expert-parallel slice of the routed experts reaching the
    portable path (a caller that predicted EP where ``moe_block`` took
    none) is refused, not misrouted."""
    from repro_torch.models import moe
    cfg = configs.get_smoke_config("deepseek_v3_671b")
    p = moe.make_moe_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    for k in ("wi_gate", "wi_up", "wo"):
        p[k] = p[k][:cfg.num_experts // 2]
    with pytest.raises(ValueError, match="all 8 routed experts"):
        moe.moe_block(p, torch.zeros((1, 8, cfg.d_model)), cfg)


def test_quantize_int8_matches_reference():
    from repro.parallel import collectives as ref_coll
    x = np.random.default_rng(3).standard_normal((33, 17)).astype(np.float32)
    q, s = collectives.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_coll.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(
        collectives.dequantize_int8(q, s).numpy(),
        np.asarray(ref_coll.dequantize_int8(rq, rs)))


# ---------------------------------------------------------------------------
# the spawn: four gloo ranks beside the reference's JAX subprocess
# ---------------------------------------------------------------------------

EP_X = (4, 512)                    # (batch, tokens): >= 1024 a rank on 2 x 2
EP_SMALL_X = (2, 256)              # 256 tokens a rank on 2 x 2: portable


def _ep_cases():
    """Unprotected on both archs, meshes and capacities; protected at the
    binding capacity (its gradients are held to the unprotected case's)."""
    cases = {}
    for arch in ("deepseek_v3_671b", "llama4_maverick"):
        for mesh in ((1, 4), (2, 2)):
            for cap, ft in ((1.25, False), (8.0, False), (1.25, True)):
                name = f"{arch}/{mesh[0]}x{mesh[1]}/cap{cap}/" \
                       f"{'ft' if ft else 'plain'}/float32"
                cases[name] = dict(arch=arch, mesh=mesh, cap=cap, ft=ft,
                                   dtype="float32", x=EP_X, ep=True,
                                   local=mesh == (2, 2))
    cases["deepseek_v3_671b/2x2/cap1.25/plain/bfloat16"] = dict(
        arch="deepseek_v3_671b", mesh=(2, 2), cap=1.25, ft=False,
        dtype="bfloat16", x=EP_X, ep=True, local=False)
    cases["deepseek_v3_671b/2x2/cap1.25/plain/portable"] = dict(
        arch="deepseek_v3_671b", mesh=(2, 2), cap=1.25, ft=False,
        dtype="float32", x=EP_SMALL_X, ep=False, local=False)
    return cases


EP_CASES = _ep_cases()
TRAIN_MESHES = ((4, 1), (2, 2), (1, 4))
TRAIN_RUN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
PHI3 = dict(vocab_size=128, num_layers=2, dtype="float32")
PHI3_BATCH = (8, 32)
PHI3_STEPS = 3
DEEPSEEK = dict(num_layers=2, dtype="float32")
DEEPSEEK_BATCH = (4, 512)          # 2 x 512 tokens a data rank on 2 x 2
DEEPSEEK_STEPS = 2
MICRO2_STEPS = 2
REPLICATED_ROWS = 2                # rows of DeepSeek's batch on 4 x 1
COMPRESS_SHAPE = (64, 64)
PIPE_MICRO = (1, 6)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _moe_params(arch, seed):
    cfg = configs.get_smoke_config(arch)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    rng = np.random.default_rng(seed)

    def n(shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    p = {"router": n((d, e), d), "wi_gate": n((e, d, f), d),
         "wi_up": n((e, d, f), d), "wo": n((e, f, d), f)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"wi_gate": n((d, fs), d), "wi_up": n((d, fs), d),
                       "wo": n((fs, d), fs)}
    return p


def _model_params(arch, **kw):
    rc = dataclasses.replace(ref_configs.get_smoke_config(arch), **kw)
    return jax.tree.map(np.asarray, RefModel(rc).init(jax.random.PRNGKey(0)))


def _inputs():
    from repro_torch.data import make_batch
    inp = {}
    for i, arch in enumerate(("deepseek_v3_671b", "llama4_maverick")):
        d = configs.get_smoke_config(arch).d_model
        rng = np.random.default_rng(10 + i)
        inp.update({f"moe/{arch}/{k}": v
                    for k, v in _flatten(_moe_params(arch, 20 + i)).items()})
        for tag, shape in (("x", EP_X), ("xs", EP_SMALL_X)):
            inp[f"ep/{arch}/{tag}"] = rng.standard_normal(
                shape + (d,)).astype(np.float32)
            inp[f"ep/{arch}/{tag}_w"] = rng.standard_normal(
                shape + (d,)).astype(np.float32)
    inp.update({f"phi3/{k}": v for k, v in _flatten(
        _model_params("phi3_medium_14b", **PHI3)).items()})
    inp.update({f"deepseek/{k}": v for k, v in _flatten(
        _model_params("deepseek_v3_671b", **DEEPSEEK)).items()})
    for s in range(PHI3_STEPS):
        for k, v in make_batch(0, s, batch=PHI3_BATCH[0],
                               seq_len=PHI3_BATCH[1],
                               vocab_size=PHI3["vocab_size"]).items():
            inp[f"batch/phi3/{s}/{k}"] = v
    vocab = configs.get_smoke_config("deepseek_v3_671b").vocab_size
    for s in range(DEEPSEEK_STEPS):
        for k, v in make_batch(1, s, batch=DEEPSEEK_BATCH[0],
                               seq_len=DEEPSEEK_BATCH[1],
                               vocab_size=vocab).items():
            inp[f"batch/deepseek/{s}/{k}"] = v
    rng = np.random.default_rng(30)
    inp["compress/g"] = rng.standard_normal(
        (4,) + COMPRESS_SHAPE).astype(np.float32)
    inp["compress/r"] = (0.01 * rng.standard_normal(
        (4,) + COMPRESS_SHAPE)).astype(np.float32)
    inp["pipe/w"] = (0.3 * rng.standard_normal((4, 16, 16))).astype(
        np.float32)
    inp["pipe/x"] = rng.standard_normal((6, 8, 16)).astype(np.float32)
    return inp


def _cases():
    return {"ep": EP_CASES, "threshold": THRESHOLD,
            "train_meshes": TRAIN_MESHES, "run": TRAIN_RUN, "phi3": PHI3,
            "phi3_steps": PHI3_STEPS, "deepseek": DEEPSEEK,
            "deepseek_steps": DEEPSEEK_STEPS, "pipe_micro": PIPE_MICRO,
            "micro2_steps": MICRO2_STEPS, "replicated_rows": REPLICATED_ROWS}


_COMMON = r"""
import dataclasses, json, sys
import numpy as np


def unflatten(flat, prefix):
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out
"""

_REF_SCRIPT = _COMMON + r"""
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from repro import optim
from repro.configs import get_smoke_config
from repro.configs.base import ParallelConfig, RunConfig
from repro.core.ft import FTPolicy
from repro.models import Model, moe
from repro.models.layers import FTContext
from repro.parallel import (batch_specs, compress_allreduce_mean,
                            param_specs, pipeline_apply)
from repro.train import make_train_step

inputs, cases_path, out_path, res_path = sys.argv[1:5]
inp = dict(np.load(inputs))
cases = json.load(open(cases_path))
out, res = {}, {}


def mesh_of(shape, names):
    return jax.make_mesh(tuple(shape), tuple(names),
                         axis_types=(AxisType.Auto,) * len(names))


def put(tree, mesh, spec_of):
    return jax.tree_util.tree_map_with_path(
        lambda kp, l: jax.device_put(l, NamedSharding(mesh, spec_of(kp, l))),
        tree)


def ulp_up(tree):
    return jax.tree.map(lambda a: jnp.asarray(
        np.nextafter(np.asarray(a), np.float32(np.inf))
        if a.dtype == jnp.float32 else a), tree)


ep_calls = [0]
_ep = moe.moe_block_ep


def counted_ep(*a, **k):
    ep_calls[0] += 1
    return _ep(*a, **k)


moe.moe_block_ep = counted_ep

for name, c in cases["ep"].items():
    arch = c["arch"]
    cfg = dataclasses.replace(get_smoke_config(arch),
                              capacity_factor=c["cap"])
    mesh = mesh_of(c["mesh"], ("data", "model"))
    tag = "x" if c["ep"] else "xs"
    dt = jnp.dtype(c["dtype"])
    params = jax.tree.map(jnp.asarray, unflatten(inp, f"moe/{arch}/"))
    x = jnp.asarray(inp[f"ep/{arch}/{tag}"]).astype(dt)
    w = jnp.asarray(inp[f"ep/{arch}/{tag}_w"])

    def spec_of(kp, l):
        key = str(kp[0].key)
        return P("model", None, None) if key in ("wi_gate", "wi_up", "wo") \
            else P()

    ps = put(params, mesh, spec_of)
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))

    def fwd(p, v):
        ft = (FTContext(FTPolicy(protect_linears=True,
                                 threshold=cases["threshold"]))
              if c["ft"] else None)
        y, aux = moe.moe_block(p, v, cfg, ft=ft)
        return y, aux, (ft.summary() if ft is not None else {})

    def loss(p, v):
        y, aux, _ = fwd(p, v)
        return jnp.sum(y.astype(jnp.float32) * w) + aux, (y, aux)

    before = ep_calls[0]
    stats = {}
    with mesh:
        # the protected EP path has no gradient in JAX (pmax of its
        # stats); its clean gradient is the unprotected one's
        if c["ft"]:
            y, aux, stats = jax.jit(fwd)(ps, xs)
        else:
            grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True))
            (_, (y, aux)), (gp, gx) = grad(ps, xs)
            # the witness: the same gradient at params one ulp up
            _, (wp, wx) = grad(put(ulp_up(params), mesh, spec_of), xs)
    res[f"ep/{name}"] = {"aux": float(aux), "ep": ep_calls[0] > before,
                         **{k: float(v) for k, v in stats.items()}}
    out[f"ep/{name}/y"] = np.asarray(y.astype(jnp.float32))
    if c["ft"]:
        continue
    out[f"ep/{name}/gx"] = np.asarray(gx.astype(jnp.float32))
    out[f"ep/{name}/wx"] = np.abs(np.asarray(wx.astype(jnp.float32))
                                  - out[f"ep/{name}/gx"]).max()
    for (k, v), w_ in zip(jax.tree_util.tree_flatten_with_path(gp)[0],
                          jax.tree.leaves(wp)):
        key = "/".join(str(p.key) for p in k)
        out[f"ep/{name}/g/{key}"] = np.asarray(v)
        out[f"ep/{name}/w/{key}"] = np.abs(np.asarray(w_)
                                           - np.asarray(v)).max()

run_kw = cases["run"]


def batch_of(tag, s):
    return {k: jnp.asarray(inp[f"batch/{tag}/{s}/{k}"])
            for k in ("tokens", "labels")}


def ref_step(cfg, microbatch=1):
    run = RunConfig(model=cfg, parallel=ParallelConfig(
        remat="none", microbatch=microbatch), **run_kw)
    return jax.jit(make_train_step(Model(cfg), run))


def ref_run(tag, step_fn, steps, mesh=None, params=None, rows=None):
    p = params
    if mesh is not None:
        specs = param_specs(jax.eval_shape(lambda: p), mesh)
        p = jax.tree.map(lambda l, sp: jax.device_put(
            l, NamedSharding(mesh, sp)), p, specs)
    o = optim.init_state(p)
    ms = []
    for s in range(steps):
        b = {k: v[:rows] for k, v in batch_of(tag, s).items()}
        if mesh is not None:
            b = jax.tree.map(lambda l, sp: jax.device_put(
                l, NamedSharding(mesh, sp)), b, batch_specs(b, mesh))
            with mesh:
                p, o, m = step_fn(p, o, b, jnp.int32(s))
        else:
            p, o, m = step_fn(p, o, b, jnp.int32(s))
        ms.append({k: float(v) for k, v in m.items()})
    return p, o, ms


def record(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(q.key) for q in k)] = np.asarray(v)


def drift(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


phi3 = dataclasses.replace(get_smoke_config("phi3_medium_14b"),
                           **cases["phi3"])
p0 = jax.tree.map(jnp.asarray, unflatten(inp, "phi3/"))
p, o, ms = ref_run("phi3", ref_step(phi3), cases["phi3_steps"], params=p0)
res["phi3"] = ms
record("phi3/p/", p)
record("phi3/nu/", o.nu)
p, _, ms = ref_run("phi3", ref_step(phi3, microbatch=2),
                   cases["micro2_steps"], params=p0)
res["phi3/micro2"] = ms
record("phi3/micro2/p/", p)

ds = dataclasses.replace(get_smoke_config("deepseek_v3_671b"),
                         **cases["deepseek"])
mesh = mesh_of((2, 2), ("data", "model"))
d0 = jax.tree.map(jnp.asarray, unflatten(inp, "deepseek/"))
before = ep_calls[0]
ds_step = ref_step(ds)
p, o, ms = ref_run("deepseek", ds_step, cases["deepseek_steps"], mesh, d0)
res["deepseek"] = ms
res["deepseek_ep"] = ep_calls[0] > before
pu, _, _ = ref_run("deepseek", ds_step, cases["deepseek_steps"], mesh,
                   ulp_up(d0))
res["deepseek_drift"] = drift(pu, p)
record("deepseek/p/", p)

# a batch the dp axes do not divide: batch_specs replicates it
mesh41 = mesh_of((4, 1), ("data", "model"))
rows = cases["replicated_rows"]
before = ep_calls[0]
steps = cases["deepseek_steps"]
p, _, ms = ref_run("deepseek", ds_step, steps, mesh41, d0, rows=rows)
res["replicated"] = ms
res["replicated_ep"] = ep_calls[0] > before
record("replicated/p/", p)

for shape, tag in (((4,), "mesh4"), ((2, 2), "mesh2x2")):
    names = ("data",) if len(shape) == 1 else ("data", "model")
    m = mesh_of(shape, names)
    n = shape[0]
    g = {"w": jax.device_put(jnp.asarray(inp["compress/g"][:n]),
                             NamedSharding(m, P("data")))}
    r = {"w": jax.device_put(jnp.asarray(inp["compress/r"][:n]),
                             NamedSharding(m, P("data")))}
    with m:
        mean, new_r = jax.jit(lambda a, b: compress_allreduce_mean(
            a, b, m, ("data",)))(g, r)
    out[f"compress/{tag}/mean"] = np.asarray(mean["w"])
    out[f"compress/{tag}/r"] = np.asarray(new_r["w"])

smesh = mesh_of((4,), ("stage",))
ws = jnp.asarray(inp["pipe/w"])
for mb in cases["pipe_micro"]:
    xs = jnp.asarray(inp["pipe/x"][:mb])
    out[f"pipe/{mb}"] = np.asarray(pipeline_apply(
        lambda w, v: jnp.tanh(v @ w), ws, xs, smesh, axis="stage"))

np.savez(out_path, **out)
with open(res_path, "w") as f:
    json.dump(res, f)
"""

_WORKER_SCRIPT = _COMMON + r"""
import os
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, inputs, cases_path, outdir):
    torch.set_num_threads(2)          # four ranks share the host's cores
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, RunConfig
    from repro_torch.core.ft import FTPolicy
    from repro_torch.launch.elastic import elastic_restore, save_sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model, moe
    from repro_torch.models.layers import FTContext
    from repro_torch.parallel import (collectives, compress_allreduce_mean,
                                      pipeline_apply, sharding)
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves, leaves_with_path, map_with_path

    inp = dict(np.load(inputs))
    cases = json.load(open(cases_path))
    out, res = {}, {"rank": rank}
    meshes = {tuple(s): make_host_mesh(*s, device="cpu")
              for s in ((1, 4), (2, 2), (4, 1))}
    res["meshes"] = {f"{a}x{b}": [list(m.mesh_dim_names), list(m.shape)]
                     for (a, b), m in meshes.items()}
    clamp = make_host_mesh(4, 4, device="cpu")
    res["meshes"]["4x4"] = [list(clamp.mesh_dim_names), list(clamp.shape)]
    m21 = make_host_mesh(2, 1, device="cpu")
    m11 = make_host_mesh(1, 1, device="cpu")
    flat_mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
    stage_mesh = DeviceMesh("cpu", torch.arange(4),
                            mesh_dim_names=("stage",))

    calls = []
    reduce_, gather = dist.all_reduce, dist.all_gather_into_tensor

    def spy_reduce(t, *a, **k):
        calls.append(["all_reduce", t.numel() * t.element_size(),
                      dist.get_process_group_ranks(k.get("group"))])
        return reduce_(t, *a, **k)

    def spy_gather(o, i, *a, **k):
        calls.append(["all_gather", o.numel() * o.element_size(),
                      dist.get_process_group_ranks(k.get("group"))])
        return gather(o, i, *a, **k)

    dist.all_reduce, dist.all_gather_into_tensor = spy_reduce, spy_gather

    def tensors(tree, grad=False):
        return map_with_path(lambda p, v: torch.from_numpy(np.array(v))
                             .requires_grad_(grad), tree)

    # ---- EP ----------------------------------------------------------------
    for name, c in cases["ep"].items():
        arch = c["arch"]
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  capacity_factor=c["cap"])
        mesh = meshes[tuple(c["mesh"])]
        dp = c["mesh"][0]
        rd = mesh.get_local_rank("data")
        rm = mesh.get_local_rank("model")
        e_loc = cfg.num_experts // c["mesh"][1]
        tag = "x" if c["ep"] else "xs"
        dt = getattr(torch, c["dtype"])
        x = torch.from_numpy(inp[f"ep/{arch}/{tag}"])
        w = torch.from_numpy(inp[f"ep/{arch}/{tag}_w"])
        bl = x.shape[0] // dp
        rows = slice(rd * bl, (rd + 1) * bl)
        xl = x[rows].to(dt).clone().requires_grad_(True)
        p = unflatten(inp, f"moe/{arch}/")
        if c["local"]:
            for k in ("wi_gate", "wi_up", "wo"):
                p[k] = p[k][rm * e_loc:(rm + 1) * e_loc]
        p = tensors(p, grad=True)
        ft = (FTContext(FTPolicy(protect_linears=True,
                                 threshold=cases["threshold"]))
              if c["ft"] else None)
        del calls[:]
        with sharding.use_mesh(mesh):
            y, aux = moe.moe_block(p, xl, cfg, ft=ft)
        res[f"ep/{name}/calls"] = list(calls)
        loss = torch.sum(y.float() * w[rows]) + aux / dp
        loss.backward()
        res[f"ep/{name}"] = {"aux": float(aux), **(
            {k: float(v) for k, v in ft.summary().items()} if ft else {})}
        out[f"ep/{name}/y"] = y.detach().float().numpy()
        out[f"ep/{name}/gx"] = xl.grad.float().numpy()
        for path, leaf in leaves_with_path(p):
            g = leaf.grad.clone()
            key = "/".join(path)
            if key in ("wi_gate", "wi_up", "wo") and not c["local"]:
                g = g[rm * e_loc:(rm + 1) * e_loc].contiguous()
            sharding.all_reduce_over(g, mesh, ("data",))
            out[f"ep/{name}/g/{key}"] = g.numpy()

    # ---- the sharded train step ---------------------------------------------
    run_kw = cases["run"]

    def batch(tag, s):
        return {k: torch.from_numpy(inp[f"batch/{tag}/{s}/{k}"])
                for k in ("tokens", "labels")}

    def model_params(model, prefix):
        meta = model.init(None, device="meta")
        return map_with_path(lambda path, _: torch.from_numpy(
            inp[prefix + "/".join(path)].copy()), meta)

    def one_rank(model, run, prefix, tag, steps):
        p = model_params(model, prefix)
        o = optim.init_state(p)
        step = make_train_step(model, run)
        ms = []
        for s in range(steps):
            p, o, m = step(p, o, batch(tag, s), s)
            ms.append({k: float(v) for k, v in m.items()})
        return p, o, ms

    def sharded(model, run, prefix, tag, steps, mesh):
        full = model_params(model, prefix)
        specs = sharding.param_specs(full, mesh, fsdp=run.parallel.fsdp)
        p = map_with_path(lambda _, t: t.contiguous().clone(),
                          sharding.shard_tree(full, specs, mesh))
        o = optim.init_state(p)
        step = make_train_step(model, run, mesh)
        ms, per_step = [], []
        for s in range(steps):
            del calls[:]
            p, o, m = step(p, o, batch(tag, s), s)
            per_step.append(list(calls))
            ms.append({k: float(v) for k, v in m.items()})
        return p, o, ms, specs, per_step

    def record(prefix, tree):
        for path, leaf in leaves_with_path(tree):
            out[prefix + "/".join(path)] = leaf.detach().numpy()

    phi3 = dataclasses.replace(get_smoke_config("phi3_medium_14b"),
                               **cases["phi3"])
    model = Model(phi3)
    run1 = RunConfig(model=phi3, parallel=ParallelConfig(remat="none"),
                     **run_kw)
    run2 = RunConfig(model=phi3, parallel=ParallelConfig(
        remat="none", microbatch=2), **run_kw)
    if rank == 0:
        p1, _, ms = one_rank(model, run1, "phi3/", "phi3",
                             cases["phi3_steps"])
        res["phi3/one_rank"] = ms
        record("phi3/one_rank/", p1)
    for shape in cases["train_meshes"]:
        mesh = meshes[tuple(shape)]
        tag = f"{shape[0]}x{shape[1]}"
        p, o, ms, specs, per_step = sharded(model, run1, "phi3/", "phi3",
                                            cases["phi3_steps"], mesh)
        res[f"phi3/{tag}"] = ms
        res[f"phi3/{tag}/calls"] = per_step
        res[f"phi3/{tag}/shards"] = {
            "/".join(path): list(leaf.shape)
            for path, leaf in leaves_with_path(p)}
        res[f"phi3/{tag}/moments"] = all(
            tuple(a.shape) == tuple(b.shape) == tuple(c.shape)
            for a, b, c in zip(leaves(p), leaves(o.mu), leaves(o.nu)))
        whole = sharding.gather_tree(p, specs, mesh)
        nu = sharding.gather_tree(o.nu, specs, mesh)
        mine = sharding.shard_tree(whole, specs, mesh)
        res[f"phi3/{tag}/own"] = all(
            torch.equal(a, b) for a, b in zip(leaves(mine), leaves(p)))
        if rank == 0:
            record(f"phi3/{tag}/p/", whole)
            record(f"phi3/{tag}/nu/", nu)
        if tuple(shape) == (2, 2):
            save_sharded(os.path.join(outdir, "ckpt"),
                         cases["phi3_steps"], (p, o), specs, mesh)
            dist.barrier()
            template = (model_params(model, "phi3/"),
                        optim.init_state(model_params(model, "phi3/")))
            for mtag, m in (("2x1", m21), ("1x1", m11)):
                if rank >= m.mesh.numel():
                    continue
                (rp, ro), meta = elastic_restore(
                    os.path.join(outdir, "ckpt"), template, m)
                res[f"elastic/{mtag}/step"] = meta["step"]
                res[f"elastic/{mtag}/opt_step"] = int(ro.step)
                record(f"elastic/{mtag}/p/", rp)
                record(f"elastic/{mtag}/mu/", ro.mu)
                record(f"elastic/{mtag}/nu/", ro.nu)
            dist.barrier()
    mesh = meshes[(2, 2)]
    p, o, ms, specs, _ = sharded(model, run2, "phi3/", "phi3",
                                 cases["micro2_steps"], mesh)
    res["phi3/micro2"] = ms
    whole = sharding.gather_tree(p, specs, mesh)
    if rank == 0:
        record("phi3/micro2/p/", whole)

    ds = dataclasses.replace(get_smoke_config("deepseek_v3_671b"),
                             **cases["deepseek"])
    dmodel = Model(ds)
    drun = RunConfig(model=ds, parallel=ParallelConfig(remat="none"),
                     **run_kw)
    ep_calls = [0]
    ep_fn = moe.moe_block_ep

    def counted(*a, **k):
        ep_calls[0] += 1
        return ep_fn(*a, **k)

    moe.moe_block_ep = counted
    p, o, ms, specs, _ = sharded(dmodel, drun, "deepseek/", "deepseek",
                                 cases["deepseek_steps"], mesh)
    moe.moe_block_ep = ep_fn
    res["deepseek"] = ms
    res["deepseek/ep_calls"] = ep_calls[0]
    res["deepseek/shards"] = {"/".join(path): list(leaf.shape)
                              for path, leaf in leaves_with_path(p)}
    whole = sharding.gather_tree(p, specs, mesh)
    if rank == 0:
        record("deepseek/p/", whole)

    # a batch the dp axes do not divide (2 rows over 4 data ranks): every
    # rank holds it whole, EP at 1024 tokens a rank with no mean over dp
    mesh41 = meshes[(4, 1)]
    full = model_params(dmodel, "deepseek/")
    specs = sharding.param_specs(full, mesh41)
    p = map_with_path(lambda _, t: t.contiguous().clone(),
                      sharding.shard_tree(full, specs, mesh41))
    o = optim.init_state(p)
    step = make_train_step(dmodel, drun, mesh41)
    ep_calls[0] = 0
    moe.moe_block_ep = counted
    ms = []
    for s in range(cases["deepseek_steps"]):
        half = {k: v[:cases["replicated_rows"]]
                for k, v in batch("deepseek", s).items()}
        p, o, m = step(p, o, half, s)
        ms.append({k: float(v) for k, v in m.items()})
    moe.moe_block_ep = ep_fn
    res["replicated"] = ms
    res["replicated/ep_calls"] = ep_calls[0]
    whole = sharding.gather_tree(p, specs, mesh41)
    if rank == 0:
        record("replicated/p/", whole)

    # ---- the compressed mean ------------------------------------------------
    for tag, m, idx in (("mesh4", flat_mesh, rank),
                        ("mesh2x2", meshes[(2, 2)],
                         meshes[(2, 2)].get_local_rank("data"))):
        g = {"w": torch.from_numpy(inp["compress/g"][idx])}
        r = {"w": torch.from_numpy(inp["compress/r"][idx])}
        del calls[:]
        mean, new_r = compress_allreduce_mean(g, r, m, ("data",))
        out[f"compress/{tag}/mean"] = mean["w"].numpy()
        out[f"compress/{tag}/r"] = new_r["w"].numpy()
        if tag == "mesh4":
            res["compress/int32/calls"] = list(calls)

    # ---- the pipeline -------------------------------------------------------
    ws = torch.from_numpy(inp["pipe/w"])
    for mb in cases["pipe_micro"]:
        x = torch.from_numpy(inp["pipe/x"][:mb])
        out[f"pipe/{mb}"] = pipeline_apply(
            lambda w, v: torch.tanh(v @ w), ws[rank], x, stage_mesh,
            axis="stage").numpy()

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=tuple(sys.argv[1:5]), nprocs=4)
"""


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Run the four gloo ranks and the reference's subprocess together;
    each rank's records and arrays, the reference's, and the inputs."""
    tmp = tmp_path_factory.mktemp("lm_parallel")
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
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"), cwd=tmp,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    work = subprocess.run(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "store"),
         str(tmp / "inputs.npz"), str(tmp / "cases.json"), str(tmp)],
        env=env, cwd=tmp, capture_output=True, text=True, timeout=600)
    ref_out, _ = ref.communicate(timeout=600)
    assert work.returncode == 0, work.stdout + work.stderr
    assert ref.returncode == 0, ref_out
    ranks = []
    for r in range(4):
        rec = json.loads((tmp / f"rank{r}.json").read_text())
        rec["arrays"] = dict(np.load(tmp / f"rank{r}.npz"))
        ranks.append(rec)
    return dict(ranks=ranks, ref=json.loads((tmp / "ref.json").read_text()),
                ref_arrays=dict(np.load(tmp / "ref.npz")), inputs=inputs,
                ckpt=tmp / "ckpt")


TOL = {"float32": EP_TOL, "bfloat16": 2.0 ** -7}
WITNESS_FACTOR = 4                 # tests/test_torch_train.py's
EXPERTS = ("wi_gate", "wi_up", "wo")


def _close(got, want, rel, witness=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    tol = max(rel * np.abs(want).max(), float(witness))
    assert err <= tol, (err, tol, float(witness))


def _rows(case, rank):
    dp, mp = case["mesh"]
    rd = rank // mp
    b = (EP_X if case["ep"] else EP_SMALL_X)[0] // dp
    return slice(rd * b, (rd + 1) * b), rank % mp


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_matches_reference(spawned, name):
    """y and aux of ``moe_block`` under ``use_mesh`` on every rank against
    the reference's ``moe_block`` under ``with mesh`` (its EP branch, or
    its portable path under 1024 tokens a rank); the ranks along
    ``model`` bitwise equal; protected, nothing flagged on either."""
    c = EP_CASES[name]
    ref, ra = spawned["ref"][f"ep/{name}"], spawned["ref_arrays"]
    assert ref["ep"] == c["ep"]
    y_ref = ra[f"ep/{name}/y"]
    flagged = 0.0
    for rank, rec in enumerate(spawned["ranks"]):
        rows, _ = _rows(c, rank)
        y = rec["arrays"][f"ep/{name}/y"]
        _close(y, y_ref[rows], TOL[c["dtype"]])
        np.testing.assert_allclose(rec[f"ep/{name}"]["aux"], ref["aux"],
                                   rtol=EP_TOL)
        peer = spawned["ranks"][rank - rank % c["mesh"][1]]
        np.testing.assert_array_equal(y, peer["arrays"][f"ep/{name}/y"])
        if c["ft"]:
            flagged += rec[f"ep/{name}"]["ft_flagged"]
    if c["ft"]:
        assert flagged == ref["ft_flagged"] == 0.0


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_gradients_match_reference(spawned, name):
    """The gradients of ``sum(y * w) + aux`` (each rank's ``sum(y_r *
    w_r) + aux / dp``, summed over dp): x's rows, the router, the shared
    expert, and each rank's experts, against the reference's."""
    c = EP_CASES[name]
    ra = spawned["ref_arrays"]
    e_loc = configs.get_smoke_config(c["arch"]).num_experts // c["mesh"][1]
    # each leaf within 2e-5 x max of the reference's, or within
    # WITNESS_FACTOR x the reference's own move when its params move one
    # ulp (Llama-4's top-1 gate p / (p + 1e-9) is 1 in float32: the
    # router's gradient through it is rounding noise). JAX cannot differentiate the reference's protected EP path (the pmax
    # of its stats): a clean protected run's gradient is held to the
    # unprotected reference's, which it equals (the protected products'
    # backward is the plain product's)
    ref_name = name.replace("/ft/", "/plain/")
    keys = [k[len(f"ep/{ref_name}/g/"):] for k in ra
            if k.startswith(f"ep/{ref_name}/g/")]
    assert {"router", *EXPERTS} <= set(keys)
    for rank, rec in enumerate(spawned["ranks"]):
        rows, rm = _rows(c, rank)
        arr = rec["arrays"]
        _close(arr[f"ep/{name}/gx"], ra[f"ep/{ref_name}/gx"][rows],
               TOL[c["dtype"]], WITNESS_FACTOR * ra[f"ep/{ref_name}/wx"])
        for k in keys:
            want = ra[f"ep/{ref_name}/g/{k}"]
            if k in EXPERTS:
                want = want[rm * e_loc:(rm + 1) * e_loc]
            _close(arr[f"ep/{name}/g/{k}"], want, TOL[c["dtype"]],
                   WITNESS_FACTOR * ra[f"ep/{ref_name}/w/{k}"])


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_forward_collectives(spawned, name):
    """An EP forward is one (T_local, d) all-reduce over ``model`` plus
    scalars (aux over dp; the ft counts and score); no collective is as
    large as an expert buffer (the reference's
    ``test_ep_collectives_are_one_psum_per_layer``). The portable path on
    a dp-split batch gathers the tokens over dp once."""
    c = EP_CASES[name]
    cfg = configs.get_smoke_config(c["arch"])
    dp, mp = c["mesh"]
    shape = EP_X if c["ep"] else EP_SMALL_X
    item = 2 if c["dtype"] == "bfloat16" else 4
    t_local = shape[0] // dp * shape[1]
    for rank, rec in enumerate(spawned["ranks"]):
        calls = rec[f"ep/{name}/calls"]
        model_group = [rank - rank % mp + i for i in range(mp)]
        if not c["ep"]:
            assert calls == [["all_gather", t_local * dp * cfg.d_model * 4,
                              [rank % mp + i * mp for i in range(dp)]]]
            continue
        big = [k for k in calls if k[1] > 8]
        assert big == ([["all_reduce", t_local * cfg.d_model * item,
                         model_group]] if mp > 1 else []), calls
        scalars = [k for k in calls if k[1] <= 8]
        # aux over dp; protected: the counts over model, the score over
        # model and over dp
        want = (1 if dp > 1 else 0) + ((3 if dp > 1 else 2) if c["ft"]
                                       else 0)
        assert len(scalars) == want, calls
        assert all(k[0] == "all_reduce" for k in calls)


def _phi3_specs(shape):
    model = Model(dataclasses.replace(
        configs.get_smoke_config("phi3_medium_14b"), **PHI3))
    meta = model.init(None, device="meta")
    mesh = PortMesh(shape, ("data", "model"))
    specs = dict(sharding.flat_specs(sharding.param_specs(meta, mesh)))
    return {"/".join(p): (tuple(leaf.shape), specs[p], mesh)
            for p, leaf in ptree.leaves_with_path(meta)}


def _metrics_close(got, want):
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("lr", "skipped_updates", "moe_aux", "ft_flagged"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def _tree_close(arrays, prefix, want_arrays, want_prefix, atol=None,
                rel=None):
    keys = [k[len(want_prefix):] for k in want_arrays
            if k.startswith(want_prefix)]
    assert keys
    for k in keys:
        w = want_arrays[want_prefix + k]
        g = arrays[prefix + k]
        assert g.shape == w.shape, k
        tol = atol if atol is not None else rel * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("shape", TRAIN_MESHES)
def test_sharded_train_step_matches_reference(spawned, shape):
    """Three sharded steps of Phi-3-medium SMOKE against the reference's
    single-device jitted step, at ``tests/test_torch_train.py``'s
    tolerances; every rank reports the same metrics."""
    tag = f"{shape[0]}x{shape[1]}"
    ranks = spawned["ranks"]
    for s, want in enumerate(spawned["ref"]["phi3"]):
        got = ranks[0][f"phi3/{tag}"][s]
        assert set(got) == set(want)
        _metrics_close(got, want)
        for rec in ranks[1:]:
            assert rec[f"phi3/{tag}"][s] == got
    ra = spawned["ref_arrays"]
    _tree_close(ranks[0]["arrays"], f"phi3/{tag}/p/", ra, "phi3/p/",
                atol=1e-6)
    _tree_close(ranks[0]["arrays"], f"phi3/{tag}/nu/", ra, "phi3/nu/",
                rel=1e-5)


@pytest.mark.parametrize("shape", TRAIN_MESHES)
def test_sharded_step_stores_only_its_shards(spawned, shape):
    """Each rank stores its slice of every param and moment, as
    ``param_specs`` places them, and it is the gathered leaf's slice."""
    tag = f"{shape[0]}x{shape[1]}"
    want = _phi3_specs(shape)
    per_rank = []
    for rec in spawned["ranks"]:
        got = rec[f"phi3/{tag}/shards"]
        assert set(got) == set(want)
        for k, (full, spec, mesh) in want.items():
            assert tuple(got[k]) == sharding.shard_shape(full, spec, mesh), k
        assert rec[f"phi3/{tag}/own"] and rec[f"phi3/{tag}/moments"]
        per_rank.append(sum(int(np.prod(s)) for s in got.values()) * 4)
    whole = sum(int(np.prod(full)) for full, _, _ in want.values()) * 4
    if shape == (1, 4) or shape == (4, 1):
        assert max(per_rank) < whole
    assert all(b <= whole for b in per_rank)


@pytest.mark.parametrize("shape", TRAIN_MESHES)
def test_sharded_step_collectives(spawned, shape):
    """A step's all-gathers are the param leaves' missing slices (one a
    sharded dim and axis of size > 1); its gradient all-reduces over dp
    move every leaf whole, plus the scalars of the norm and metrics."""
    tag = f"{shape[0]}x{shape[1]}"
    want = _phi3_specs(shape)
    gathered = 0
    for full, spec, mesh in want.values():
        for dim, e in enumerate(spec):
            for a in sharding.spec_axes(e):
                if mesh.shape[a] > 1:
                    gathered += 1
    whole = sum(int(np.prod(full)) for full, _, _ in want.values()) * 4
    for rec in spawned["ranks"]:
        for calls in rec[f"phi3/{tag}/calls"]:
            gathers = [k for k in calls if k[0] == "all_gather"]
            assert len(gathers) == gathered
            grads = [k for k in calls if k[0] == "all_reduce" and k[1] > 64]
            assert sum(k[1] for k in grads) == (whole if shape[0] > 1
                                                else 0)


def test_sharded_microbatch_matches_one_rank(spawned):
    """``microbatch=2`` on 2 x 2 against the reference's single-device
    jitted step with ``microbatch=2``, at the sharded step's tolerances;
    every rank reports the same metrics."""
    ranks = spawned["ranks"]
    want = spawned["ref"]["phi3/micro2"]
    assert len(want) == MICRO2_STEPS
    for s, w in enumerate(want):
        got = ranks[0]["phi3/micro2"][s]
        assert set(got) == set(w)
        _metrics_close(got, w)
        for rec in ranks[1:]:
            assert rec["phi3/micro2"][s] == got
    _tree_close(ranks[0]["arrays"], "phi3/micro2/p/",
                spawned["ref_arrays"], "phi3/micro2/p/", atol=1e-6)


def test_sharded_step_with_ep_matches_reference(spawned):
    """DeepSeek SMOKE on 2 x 2 at 2 x 512 tokens a data rank: EP runs
    inside both packages' steps; the port's params after two steps within
    4x the reference's own one-ulp drift of the reference's."""
    ref = spawned["ref"]
    assert ref["deepseek_ep"]
    for rec in spawned["ranks"]:
        assert rec["deepseek/ep_calls"] > 0
        for got, want in zip(rec["deepseek"], ref["deepseek"]):
            _metrics_close(got, want)
    assert ref["deepseek_drift"] > 0.0
    _tree_close(spawned["ranks"][0]["arrays"], "deepseek/p/",
                spawned["ref_arrays"], "deepseek/p/",
                atol=WITNESS_FACTOR * ref["deepseek_drift"])
    shards = spawned["ranks"][0]["deepseek/shards"]
    e = configs.get_smoke_config("deepseek_v3_671b").num_experts
    routed = [s for k, s in shards.items()
              if sharding.ROUTED_EXPERTS.search(k)]
    assert routed and all(e // 2 in s for s in routed)


def test_sharded_step_on_a_replicated_batch(spawned):
    """Two steps on the first 2 rows of DeepSeek's batches on 4 data
    ranks: the batch is replicated, as the reference's ``batch_specs``
    places it, and every rank runs it whole (EP with no mean over dp);
    against the reference's step on that placement on 4 x 1, at the
    sharded step's tolerances."""
    ref = spawned["ref"]
    assert ref["replicated_ep"]
    rec = spawned["ranks"][0]
    assert rec["replicated/ep_calls"] > 0
    for other in spawned["ranks"][1:]:
        assert other["replicated"] == rec["replicated"]
    assert len(ref["replicated"]) == DEEPSEEK_STEPS
    for got, want in zip(rec["replicated"], ref["replicated"]):
        _metrics_close(got, want)
    _tree_close(rec["arrays"], "replicated/p/", spawned["ref_arrays"],
                "replicated/p/", atol=1e-6)


@pytest.mark.parametrize("tag", ["mesh4", "mesh2x2"])
def test_compress_matches_reference(spawned, tag):
    """Mean and residual bitwise the reference's, on the same per-rank
    gradients."""
    ra = spawned["ref_arrays"]
    for rank, rec in enumerate(spawned["ranks"]):
        idx = rank if tag == "mesh4" else rank // 2
        for k in ("mean", "r"):
            np.testing.assert_array_equal(rec["arrays"][f"compress/{tag}/{k}"],
                                          ra[f"compress/{tag}/{k}"][idx])
        assert np.abs(rec["arrays"][f"compress/{tag}/r"]).max() > 0


def test_compress_int32_wire_is_exact(spawned):
    """The int8 values are summed on an int32 wire (4 B an element, as
    float32's: no backend reduces the reference's int16), after one 4 B
    max of the scale; the sum is exact: the mean is the dequantized mean
    of the integers summed in int64 here, bitwise."""
    n = int(np.prod(COMPRESS_SHAPE))
    inp = spawned["inputs"]
    f32 = np.float32
    gl = inp["compress/g"] + inp["compress/r"]
    scale = f32(np.abs(gl).max()) / f32(127.0) + f32(1e-12)
    q = np.clip(np.round(gl / scale), -127, 127).astype(np.int64)
    want = (q.sum(0).astype(f32) * scale / f32(4)).astype(f32)
    for rec in spawned["ranks"]:
        np.testing.assert_array_equal(rec["arrays"]["compress/mesh4/mean"],
                                      want)
        sizes = sorted(k[1] for k in rec["compress/int32/calls"])
        assert sizes == [4, 4 * n]


@pytest.mark.parametrize("micro", PIPE_MICRO)
def test_pipeline_matches_reference(spawned, micro):
    want = spawned["ref_arrays"][f"pipe/{micro}"]
    x = spawned["inputs"]["pipe/x"][:micro]
    w = spawned["inputs"]["pipe/w"]
    seq = x
    for i in range(4):
        seq = np.tanh(seq @ w[i])
    for rec in spawned["ranks"]:
        got = rec["arrays"][f"pipe/{micro}"]
        assert np.abs(got - want).max() < 1e-5
        assert np.abs(got - seq).max() < 1e-5


@pytest.mark.parametrize("mtag", ["2x1", "1x1"])
def test_elastic_restore_onto_fewer_ranks(spawned, mtag):
    """The 2 x 2 run's checkpoint (written by ``save_sharded``: its
    gathered state) restored onto 2 x 1 (ranks 0-1) and 1 x 1 (rank 0):
    every param and moment leaf is the new mesh's slice of the saved
    one, bitwise; the step counter whole."""
    step = PHI3_STEPS
    path = spawned["ckpt"] / f"step_{step:08d}" / "state.npz"
    saved = dict(np.load(path))
    ranks = spawned["ranks"]
    for k, v in ranks[0]["arrays"].items():
        if k.startswith("phi3/2x2/p/"):
            np.testing.assert_array_equal(saved["0/" + k[11:]], v)
    shape = (2, 1) if mtag == "2x1" else (1, 1)
    want = _phi3_specs(shape)
    for rank in range(shape[0]):
        rec = ranks[rank]
        assert rec[f"elastic/{mtag}/step"] == step
        assert rec[f"elastic/{mtag}/opt_step"] == step
        for part, key in (("p", "0/"), ("mu", "1/.mu/"), ("nu", "1/.nu/")):
            for k, (full, spec, mesh) in want.items():
                got = rec["arrays"][f"elastic/{mtag}/{part}/{k}"]
                whole = torch.from_numpy(saved[key + k])
                n = [whole.shape[d] // (shape[0] if "data" in
                                        sharding.spec_axes(e) else 1)
                     for d, e in enumerate(spec)]
                sl = tuple(slice(rank * n[d], (rank + 1) * n[d])
                           if "data" in sharding.spec_axes(e)
                           else slice(None) for d, e in enumerate(spec))
                np.testing.assert_array_equal(got, whole.numpy()[sl])
                assert got.shape == sharding.shard_shape(full, spec, mesh)


def test_host_mesh_names_shapes_and_clamp(spawned):
    for rec in spawned["ranks"]:
        m = rec["meshes"]
        assert m["1x4"] == [["data", "model"], [1, 4]]
        assert m["2x2"] == [["data", "model"], [2, 2]]
        assert m["4x1"] == [["data", "model"], [4, 1]]
        assert m["4x4"] == [["data", "model"], [4, 1]]
