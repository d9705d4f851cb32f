"""Multi-pod dry run: every (architecture x input shape) cell on the
production meshes, on the CPU, with no device and no allocation. Port of
``repro.launch.dryrun``. Host-only: the cells run on ``"cpu"`` fake
tensors, whatever machine runs them.

The reference lowers and compiles each cell's jitted step for the 16 x 16
(256-chip) pod mesh and the 2 x 16 x 16 (512-chip) multi-pod mesh on 512
forced host devices, and reads XLA's memory, cost and collective analyses.
The port has no compiler to ask, so a cell:

* builds the model on the ``meta`` device (``Model.init(None,
  device="meta")``) at the config's published widths and full depth:
  ``params`` is its exact count;
* computes the per-device ``argument_bytes`` exactly from
  ``parallel.param_specs`` / ``shard_shape`` on the production mesh
  (``launch.mesh.make_production_mesh``, an abstract mesh): the params,
  for a train cell AdamW's two float32 moments, the batch by
  ``batch_specs``, and for a decode cell the cache by ``cache_specs``;
* for a train cell runs one ``make_train_step(..., mesh=...)`` step on
  rank 0 of a fake process group of 256 or 512 ranks, on the rank's param
  and moment shards as fake tensors (``FakeTensorMode``: shapes and
  dtypes, no storage), under the collective recorder
  (:mod:`repro_torch.analysis.record`), ``FlopCounterMode`` and
  ``MemTracker``: the step's collectives a rank, the flops of its matrix
  products and attention, and its temporaries' peak;
* for a prefill or decode cell runs the rank's forward (its rows of the
  batch, the whole params) the same way. The port has no sharded prefill
  or decode step — only the train step takes a mesh — so those cells
  record ``"collectives": null`` and a ``"reason"`` that says so.

The step's one host read, ``bool(torch.isfinite(gnorm))`` in
``optim.apply_updates``, has no answer on a fake tensor: the traced step
runs under a dispatch mode that answers a 0-d bool's host read with
``True`` — the norm of a finite step — and refuses any other host read,
so the optimizer's update stays in the traced step and the port's code
runs unchanged.

The reference's ``_two_point_estimate`` has no counterpart. XLA's cost
model counts a ``lax.scan`` body once, so the reference extrapolates from
two unrolled probes; an eager trace runs every layer and every time step,
so nothing is undercounted. ``recurrence_flops`` (the mLSTM and sLSTM
recurrences' analytic flops) is recorded beside the counted flops, a rank's
share of it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ParallelConfig, RunConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding

__all__ = ["SKIPS", "CANONICAL", "recurrence_flops", "input_shapes",
           "argument_bytes", "trace_cell", "run_cell", "main"]

# cells skipped with documented reasons (the reference's)
SKIPS = {
    ("qwen1.5-110b", "long_500k"): "pure full attention: 512k KV/layer infeasible",
    ("phi3-medium-14b", "long_500k"): "pure full attention",
    ("phi4-mini-3.8b", "long_500k"): "pure full attention",
    ("internvl2-1b", "long_500k"): "pure full attention backbone",
    ("llama4-maverick-400b-a17b", "long_500k"): "full-attention text variant",
    ("whisper-base", "long_500k"): "decoder context architecturally <=448",
}

CANONICAL = {
    "qwen15_110b": "qwen1.5-110b",
    "phi3_medium_14b": "phi3-medium-14b",
    "phi4_mini_3p8b": "phi4-mini-3.8b",
    "gemma3_1b": "gemma3-1b",
    "internvl2_1b": "internvl2-1b",
    "xlstm_350m": "xlstm-350m",
    "deepseek_v3_671b": "deepseek-v3-671b",
    "llama4_maverick": "llama4-maverick-400b-a17b",
    "recurrentgemma_2b": "recurrentgemma-2b",
    "whisper_base": "whisper-base",
}

_NO_MESH_STEP = ("the port has no sharded {mode} step (only the train step "
                 "takes a mesh): the cell counts the forward of the rank's "
                 "batch rows on the whole params, and no collectives")


def recurrence_flops(cfg, shape) -> float:
    """Analytic FLOPs of the sequential-time recurrences (the mLSTM and
    sLSTM time steps), over all devices — the reference's formula, which
    it adds to XLA's count because a ``lax.scan`` body is counted once."""
    from repro_torch.models.transformer import effective_kinds

    kinds = [k.split("|")[0] for k in effective_kinds(cfg)]
    t = shape.seq_len if shape.mode != "decode" else 1
    tokens = shape.global_batch * t
    d = cfg.d_model
    h = cfg.num_heads
    e = cfg.expand_factor * d
    hd_m = e // h
    hd_s = d // h
    per_tok = 0.0
    for k in kinds:
        if k == "mlstm":
            per_tok += h * (5.0 * hd_m * hd_m)
        elif k == "slstm":
            per_tok += 8.0 * d * hd_s
    mult = 3.0 if shape.mode == "train" else 1.0
    return per_tok * tokens * mult


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------

def input_shapes(cfg, shape) -> dict:
    """The step's batch as ``{name: (shape, dtype)}``: tokens (and labels
    to train; (B, 1) tokens to decode) and a frontend's inputs."""
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "decode":
        return {"tokens": ((b, 1), torch.int32)}
    batch = {}
    s_text = s
    if cfg.frontend == "patch_stub":
        s_text = s - cfg.num_patches
        batch["patch_embeds"] = ((b, cfg.num_patches, cfg.frontend_dim),
                                 torch.float32)
    if cfg.is_encdec:
        batch["frames"] = ((b, cfg.max_source_positions, cfg.frontend_dim),
                           torch.float32)
    batch["tokens"] = ((b, s_text), torch.int32)
    if shape.mode == "train":
        batch["labels"] = ((b, s_text), torch.int32)
    return batch


def _seq_shard(shape, mesh, parallel) -> bool:
    dp = math.prod(sharding.mesh_shape(mesh)[a]
                   for a in sharding.dp_axes(mesh))
    return (shape.mode == "decode" and parallel.seq_shard_decode
            and shape.global_batch < dp)


def _tree_bytes(tree, specs, mesh, dtype=None) -> int:
    flat = dict(sharding.flat_specs(specs))
    from repro_torch.tree import leaves_with_path

    total = 0
    for path, leaf in leaves_with_path(tree):
        n = math.prod(sharding.shard_shape(tuple(leaf.shape), flat[path],
                                           mesh))
        total += n * (dtype or leaf.dtype).itemsize
    return total


def argument_bytes(cfg, shape, mesh, parallel: ParallelConfig) -> dict:
    """A device's argument bytes of the cell's step on ``mesh`` (a
    ``DeviceMesh`` or an abstract mesh), by the sharding rules: the
    params (``param_specs``), for training AdamW's two float32 moments on
    the same specs, the batch (``batch_specs``) and, to decode, the cache
    (``cache_specs``). ``total`` is their sum; the step's int32 scalars
    (the step counter, the decode position) are left out."""
    from repro_torch.models import Model

    model = Model(cfg)
    meta = model.init(None, device="meta")
    p_specs = sharding.param_specs(meta, mesh, fsdp=parallel.fsdp)
    out = {"params": _tree_bytes(meta, p_specs, mesh), "optimizer": 0,
           "batch": 0, "cache": 0}
    if shape.mode == "train":
        out["optimizer"] = 2 * _tree_bytes(meta, p_specs, mesh,
                                           torch.float32)
    seq_shard = _seq_shard(shape, mesh, parallel)
    batch = {k: torch.empty(s, dtype=dt, device="meta")
             for k, (s, dt) in input_shapes(cfg, shape).items()}
    out["batch"] = _tree_bytes(batch, sharding.batch_specs(batch, mesh),
                               mesh)
    if shape.mode == "decode":
        cache = model.init_cache(batch=shape.global_batch,
                                 max_len=shape.seq_len, dtype=torch.bfloat16,
                                 device="meta")
        out["cache"] = _tree_bytes(cache, sharding.cache_specs(
            cache, mesh, seq_shard=seq_shard), mesh)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# the traced step
# ---------------------------------------------------------------------------

def _finite_read_mode():
    """The dispatch mode that answers a 0-d bool tensor's host read with
    True (module docstring) and refuses any other."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _FiniteRead(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                t = args[0]
                if t.dtype == torch.bool and t.dim() == 0:
                    return True
                raise RuntimeError(
                    f"a host read of a {t.dtype} {tuple(t.shape)} tensor "
                    f"in the traced step has no answer on fake tensors")
            return func(*args, **(kwargs or {}))

    return _FiniteRead()


def _device_mesh(mesh):
    """The ``DeviceMesh`` over the process group's first ranks with the
    abstract ``mesh``'s names and sizes."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = sharding.mesh_shape(mesh)
    n = math.prod(sizes.values())
    return DeviceMesh("cpu", torch.arange(n).view(*sizes.values()),
                      mesh_dim_names=tuple(sizes))


def _empty(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="cpu")


def _local_rows(shape_, spec, mesh):
    """The rank's rows of a batch leaf: its shard along dim 0 by
    ``spec`` (the whole leaf when it is replicated)."""
    return (sharding.shard_shape(shape_[:1], spec[:1], mesh)
            + tuple(shape_[1:]))


def trace_cell(cfg, shape, mesh, parallel: ParallelConfig) -> dict:
    """Rank 0's traced step of one cell on ``mesh`` (a ``DeviceMesh`` of
    the initialised process group, a fake one by default): ``{"trace_s",
    "matmul_attention_flops", "flops_by_op", "temp_bytes",
    "output_bytes", "collectives", "reason"}`` (module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import optim
    from repro_torch.analysis.record import record, summarize, tensors
    from repro_torch.models import Model
    from repro_torch.train.loop import (make_prefill_step, make_serve_step,
                                        make_train_step)
    from repro_torch.tree import map_with_path

    model = Model(cfg)
    run = RunConfig(model=cfg, parallel=parallel)
    meta = model.init(None, device="meta")
    flat = dict(sharding.flat_specs(sharding.param_specs(
        meta, mesh, fsdp=parallel.fsdp)))
    shapes = input_shapes(cfg, shape)
    meta_batch = {k: torch.empty(s, dtype=dt, device="meta")
                  for k, (s, dt) in shapes.items()}
    bspecs = sharding.batch_specs(meta_batch, mesh)
    t0 = time.perf_counter()
    with FakeTensorMode():
        if shape.mode == "train":
            params = map_with_path(lambda path, leaf: _empty(
                sharding.shard_shape(tuple(leaf.shape), flat[path], mesh),
                leaf.dtype), meta)
            opt_state = optim.init_state(params)
            batch = {k: _empty(s, dt) for k, (s, dt) in shapes.items()}
            fn = make_train_step(model, run, mesh)
            args = (params, opt_state, batch, 0)
        else:
            params = map_with_path(
                lambda _, leaf: _empty(leaf.shape, leaf.dtype), meta)
            batch = {k: _empty(_local_rows(s, bspecs[k], mesh), dt)
                     for k, (s, dt) in shapes.items()}
            if shape.mode == "prefill":
                fn = make_prefill_step(model, run)
                args = (params, batch)
            else:
                rows = batch["tokens"].shape[0]
                cache = model.init_cache(batch=rows, max_len=shape.seq_len,
                                         dtype=torch.bfloat16, device="cpu")
                fn = make_serve_step(model, run)
                args = (params, cache, batch["tokens"], shape.seq_len - 1)
        mem = _mem_tracker()
        with FlopCounterMode(display=False) as flops, record() as ops, \
                mem, _finite_read_mode():
            out = fn(*args)
    seen = {id(t) for t in tensors(args)}
    rec = {
        "trace_s": round(time.perf_counter() - t0, 2),
        "matmul_attention_flops": float(flops.get_total_flops()),
        "flops_by_op": {str(k): float(v) for k, v in
                        flops.get_flop_counts().get("Global", {}).items()},
        "temp_bytes": _peak(mem),
        "output_bytes": sum(t.numel() * t.element_size()
                            for t in tensors(out) if id(t) not in seen),
    }
    if shape.mode == "train":
        rec["collectives"] = summarize(ops)
    else:
        rec["collectives"] = None
        rec["reason"] = _NO_MESH_STEP.format(mode=shape.mode)
    return rec


def _mem_tracker():
    from torch.distributed._tools.mem_tracker import MemTracker

    return MemTracker()


def _peak(mem) -> int:
    """The peak of the tensors the traced step allocated (its temporaries,
    activations and gradients), over devices."""
    snap = mem.get_tracker_snapshot("peak")
    return int(sum(v["Total"] for v in snap.values()))


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             parallel: ParallelConfig | None = None,
             skip_compile: bool = False, cfg=None, shape=None,
             mesh=None) -> dict:
    """One cell's record: ``arch`` at ``shape_name`` on the production
    mesh (``multi_pod``: 2 x 16 x 16, else 16 x 16), or ``cfg``, ``shape``
    and an abstract ``mesh`` in their place. The traced step runs on rank
    0 of a fake process group of the mesh's ranks (or of the caller's
    process group); ``skip_compile`` records the params and the bytes
    only. Host-only: every tensor is a ``"cpu"`` fake or ``meta``
    tensor."""
    from repro_torch.analysis.record import fake_process_group
    from repro_torch.models import count_params, model_flops_per_token

    t0 = time.time()
    canonical = CANONICAL.get(arch, arch)
    shape = shape or SHAPES[shape_name]
    rec: dict = {"arch": canonical, "shape": shape_name,
                 "multi_pod": multi_pod, "mode": shape.mode}
    if (canonical, shape_name) in SKIPS:
        rec["status"] = "skipped"
        rec["reason"] = SKIPS[(canonical, shape_name)]
        return rec
    cfg = cfg or get_config(arch)
    parallel = parallel or ParallelConfig(multi_pod=multi_pod)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_dev = math.prod(sharding.mesh_shape(mesh).values())
    n_params = count_params(cfg)
    rec["params"] = n_params
    rec["mesh"] = sharding.mesh_shape(mesh)
    args = argument_bytes(cfg, shape, mesh, parallel)
    rec["memory"] = {"argument_bytes": args["total"],
                     "argument_parts": {k: v for k, v in args.items()
                                        if k != "total"}}
    if skip_compile:
        rec["status"] = "sized"
        return rec
    with fake_process_group(n_dev):
        traced = trace_cell(cfg, shape, _device_mesh(mesh), parallel)
    rec["trace_s"] = traced["trace_s"]
    rec["memory"].update(
        temp_bytes=traced["temp_bytes"],
        output_bytes=traced["output_bytes"],
        bytes_per_device=(args["total"] + traced["temp_bytes"]
                          + traced["output_bytes"]))
    rec["cost"] = {
        "matmul_attention_flops": traced["matmul_attention_flops"],
        "flops_by_op": traced["flops_by_op"],
        "recurrence_flops": recurrence_flops(cfg, shape) / n_dev}
    rec["collectives"] = traced["collectives"]
    if "reason" in traced:
        rec["reason"] = traced["reason"]
    rec["tokens_per_step"] = shape.global_batch * (
        shape.seq_len if shape.mode != "decode" else 1)
    rec["model_flops_per_token"] = model_flops_per_token(cfg, n_params)
    rec["status"] = "ok"
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-compile", action="store_true",
                    help="record params and per-device bytes only; no "
                         "traced step")
    args = ap.parse_args(argv)

    cells = []
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))
    # smallest models first
    size_rank = {"whisper_base": 0, "xlstm_350m": 1, "gemma3_1b": 2,
                 "internvl2_1b": 3, "recurrentgemma_2b": 4,
                 "phi4_mini_3p8b": 5, "phi3_medium_14b": 6,
                 "qwen15_110b": 7, "llama4_maverick": 8,
                 "deepseek_v3_671b": 9}
    cells.sort(key=lambda c: (size_rank.get(c[0], 99), c[2], c[1]))

    os.makedirs(args.out, exist_ok=True)
    for a, s, mp in cells:
        tag = f"{CANONICAL.get(a, a)}__{s}__{'pod2' if mp else 'pod1'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip-done] {tag}")
            continue
        print(f"[run] {tag}", flush=True)
        try:
            rec = run_cell(a, s, multi_pod=mp,
                           skip_compile=args.skip_compile)
        except Exception as e:
            rec = {"arch": CANONICAL.get(a, a), "shape": s, "multi_pod": mp,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-3000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"  -> {rec['status']} (trace={rec.get('trace_s')}s)",
              flush=True)


if __name__ == "__main__":
    main()
