"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``; ``tests/test_distributed.py``'s
``test_dryrun_cell_on_host_mesh`` is the reference's own).

The counterpart of the reference's host-mesh cell: SMOKE Gemma-3 1B at
vocab 256, ``ShapeConfig("t", 64, 8, ...)``, on a 4 x 2 ``data x model``
mesh of 8 fake ranks. Its params are the reference's ``count_params``; its
per-device argument bytes the sum the reference's ``param_specs`` and
``batch_specs`` give on a ``jax.sharding.AbstractMesh`` of the same shape;
its traced train step's all-gathers, all-reduces and broadcasts a rank the
sharded step's design (``tests/test_torch_lm_parallel.py``,
``test_sharded_step_collectives``); ``recurrence_flops`` the reference's
for every architecture and shape; a skipped cell the reference's reason.

The three traced cells (train, prefill, decode) run in ONE subprocess for
the file: each sets up and tears down its fake process group.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel, count_params as ref_count_params
from repro.parallel import batch_specs as ref_batch_specs
from repro.parallel import param_specs as ref_param_specs
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

REPO = pathlib.Path(__file__).resolve().parents[1]
MESH = (4, 2)
SMOKE_SHAPE = {"seq": 64, "batch": 8}

_CELLS = textwrap.dedent("""\
    import dataclasses, json
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh

    cfg = dataclasses.replace(get_smoke_config("gemma3_1b"), vocab_size=256)
    out = {}
    for mode in ("train", "prefill", "decode"):
        out[mode] = dryrun.run_cell(
            "gemma3_1b", "t", multi_pod=False, cfg=cfg,
            shape=ShapeConfig("t", 64, 8, mode),
            mesh=AbstractMesh((4, 2), ("data", "model")))
    out["initialized_after"] = dist.is_initialized()
    print("RESULT " + json.dumps(out))
    """)


@pytest.fixture(scope="module")
def cells():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _CELLS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _ref_cfg():
    return dataclasses.replace(ref_smoke_config("gemma3_1b"), vocab_size=256)


def _ref_layout():
    """The reference's param tree shapes and specs on the abstract 4 x 2
    mesh."""
    mesh = AbstractMesh(MESH, ("data", "model"))
    shapes = jax.eval_shape(RefModel(_ref_cfg()).init, jax.random.PRNGKey(0))
    specs = ref_param_specs(shapes, mesh)
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return mesh, list(zip(leaves, spec_leaves))


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _shard_bytes(mesh, shape, spec, itemsize):
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    n = 1
    for d, e in zip(shape, spec):
        n *= d // math.prod(mesh.shape[a] for a in _axes(e))
    return n * itemsize


def test_params_are_the_reference_count(cells):
    assert cells["train"]["status"] == "ok"
    assert cells["train"]["params"] == ref_count_params(_ref_cfg())
    assert cells["initialized_after"] is False


def test_argument_bytes_are_the_reference_specs(cells):
    """Params, AdamW's two float32 moments and the batch, a device's share
    of each by the reference's ``param_specs``/``batch_specs`` on a JAX
    ``AbstractMesh`` of the same shape."""
    mesh, layout = _ref_layout()
    params = sum(_shard_bytes(mesh, l.shape, s, jnp.dtype(l.dtype).itemsize)
                 for l, s in layout)
    moments = 2 * sum(_shard_bytes(mesh, l.shape, s, 4) for l, s in layout)
    b, t = SMOKE_SHAPE["batch"], SMOKE_SHAPE["seq"]
    batch = {k: jax.ShapeDtypeStruct((b, t), jnp.int32)
             for k in ("tokens", "labels")}
    bspecs = ref_batch_specs(batch, mesh)
    batch_bytes = sum(_shard_bytes(mesh, batch[k].shape, bspecs[k], 4)
                      for k in batch)
    mem = cells["train"]["memory"]
    assert mem["argument_parts"] == {"params": params, "optimizer": moments,
                                     "batch": batch_bytes, "cache": 0}
    assert mem["argument_bytes"] == params + moments + batch_bytes
    prefill = cells["prefill"]["memory"]
    assert prefill["argument_parts"]["params"] == params
    assert prefill["argument_parts"]["optimizer"] == 0
    assert prefill["argument_parts"]["batch"] == batch_bytes // 2


def test_train_step_collectives_are_the_sharded_steps(cells):
    """A rank's step: one all-gather a param leaf's sharded dim and axis of
    size > 1 (its output the gathered size); one all-reduce a gradient leaf
    over data (the leaf whole) and two of the metrics (5 sums, the score);
    three broadcasts over model (the norm's per-leaf sums, the metrics, the
    score) — what ``test_sharded_step_collectives`` and phase 14 expect of
    the sharded step."""
    mesh, layout = _ref_layout()
    gathers = gather_bytes = whole = 0
    for leaf, spec in layout:
        shape = list(leaf.shape)
        spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        shape = [d // math.prod(mesh.shape[a] for a in _axes(e))
                 for d, e in zip(shape, spec)]
        for dim, e in enumerate(spec):
            for a in reversed(_axes(e)):
                if mesh.shape[a] > 1:
                    shape[dim] *= mesh.shape[a]
                    gathers += 1
                    gather_bytes += math.prod(shape) * 4
        whole += math.prod(leaf.shape) * 4
    n = len(layout)
    coll = cells["train"]["collectives"]
    assert coll["count"] == {"all-reduce": n + 2, "all-gather": gathers,
                             "all-to-all": 0, "broadcast": 3, "send": 0,
                             "recv": 0}
    assert coll["bytes"]["all-gather"] == gather_bytes
    # wire bytes: twice the all-reduces' payload
    assert coll["bytes"]["all-reduce"] == 2 * (whole + 5 * 4 + 4)
    assert coll["bytes"]["broadcast"] == 4 * n + 5 * 4 + 4
    ops = coll["ops"]
    assert [k for k, _ in ops[:gathers]] == ["all-gather"] * gathers
    assert ops[-1][0] == "broadcast"


def test_train_cell_counts_flops_and_temporaries(cells):
    """FlopCounterMode's products (matrix products and attention) of the
    traced step, forward, backward and remat, beside the analytic
    recurrence flops (none in Gemma); MemTracker's temporaries."""
    cost = cells["train"]["cost"]
    assert set(cost) == {"matmul_attention_flops", "flops_by_op",
                         "recurrence_flops"}
    assert cost["recurrence_flops"] == 0.0
    assert cost["matmul_attention_flops"] == sum(
        cost["flops_by_op"].values()) > 0
    # the forward's 2 flops a weight a token, at least, over the rank's
    # 2 x 64 tokens: the step (3x, plus remat) counts more
    tokens = SMOKE_SHAPE["batch"] // MESH[0] * SMOKE_SHAPE["seq"]
    assert cost["matmul_attention_flops"] > 6 * tokens * (
        cells["train"]["params"] - 256 * 64)
    mem = cells["train"]["memory"]
    assert mem["temp_bytes"] > 0
    assert mem["bytes_per_device"] == (mem["argument_bytes"]
                                       + mem["temp_bytes"]
                                       + mem["output_bytes"])
    assert cells["train"]["tokens_per_step"] == 8 * 64
    assert cells["train"]["mesh"] == {"data": 4, "model": 2}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_forward_cells_have_no_collectives_and_say_why(cells, mode):
    rec = cells[mode]
    assert rec["status"] == "ok"
    assert rec["collectives"] is None
    assert f"no sharded {mode} step" in rec["reason"]
    assert rec["cost"]["matmul_attention_flops"] > 0
    if mode == "decode":
        parts = rec["memory"]["argument_parts"]
        assert parts["cache"] > 0 and parts["batch"] == 8 // 4 * 4
        assert rec["tokens_per_step"] == 8


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_recurrence_flops_are_the_references(shape_name):
    """``recurrence_flops`` for every architecture, the reference's number
    (its module is imported with ``XLA_FLAGS`` kept as it was: it forces
    512 host devices at import)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    from repro.configs import get_config as ref_get_config

    shape = SHAPES[shape_name]
    ref_shape = ref_dryrun.SHAPES[shape_name]
    for arch in ARCHS:
        got = dryrun.recurrence_flops(get_config(arch), shape)
        want = ref_dryrun.recurrence_flops(ref_get_config(arch), ref_shape)
        assert got == want, arch
    assert dryrun.SKIPS == ref_dryrun.SKIPS
    assert dryrun.CANONICAL == ref_dryrun.CANONICAL


def test_xlstm_recurrence_flops_are_counted():
    shape = SHAPES["train_4k"]
    assert dryrun.recurrence_flops(get_config("xlstm_350m"), shape) > 0
    assert dryrun.recurrence_flops(get_config("gemma3_1b"), shape) == 0.0


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen15_110b", "long_500k"), ("whisper_base", "long_500k")])
def test_skipped_cell_carries_the_reference_reason(arch, shape_name):
    rec = dryrun.run_cell(arch, shape_name, multi_pod=False)
    key = (dryrun.CANONICAL[arch], shape_name)
    assert rec == {"arch": key[0], "shape": shape_name, "multi_pod": False,
                   "mode": "decode", "status": "skipped",
                   "reason": dryrun.SKIPS[key]}


def test_main_sizes_production_cells_without_a_trace(tmp_path):
    """``--skip-compile`` records params and a device's bytes on the
    production meshes (no process group, no trace); a second run skips the
    cells already written."""
    argv = ["--arch", "gemma3-1b", "--shape", "train_4k", "--both-meshes",
            "--skip-compile", "--out", str(tmp_path)]
    dryrun.main(argv)
    pod1 = json.loads((tmp_path / "gemma3-1b__train_4k__pod1.json")
                      .read_text())
    pod2 = json.loads((tmp_path / "gemma3-1b__train_4k__pod2.json")
                      .read_text())
    assert pod1["status"] == pod2["status"] == "sized"
    assert pod1["params"] == pod2["params"] == 999_812_736
    assert pod1["mesh"] == {"data": 16, "model": 16}
    assert pod2["mesh"] == {"pod": 2, "data": 16, "model": 16}
    # FSDP over (pod, data): the multi-pod mesh stores about half a pod's
    assert pod2["memory"]["argument_bytes"] < pod1["memory"][
        "argument_bytes"]
    dryrun.main(argv)


def test_a_host_read_other_than_the_finite_check_is_refused():
    """The traced step answers a 0-d bool's host read (the optimizer's
    finiteness check) with True and refuses any other read."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.ones(3)
        with dryrun._finite_read_mode():
            assert bool(torch.isfinite(x.sum()))
            with pytest.raises(RuntimeError, match="host read"):
                float(x.sum())


def test_input_shapes_follow_the_reference():
    for arch in ("internvl2_1b", "whisper_base", "gemma3_1b"):
        cfg = get_config(arch)
        got = dryrun.input_shapes(cfg, SHAPES["train_4k"])
        assert got["tokens"][0] == got["labels"][0]
        if cfg.frontend == "patch_stub":
            assert got["tokens"][0] == (256, 4096 - cfg.num_patches)
            assert got["patch_embeds"][1] == torch.float32
        if cfg.is_encdec:
            assert got["frames"][0] == (256, cfg.max_source_positions,
                                        cfg.frontend_dim)
    dec = dryrun.input_shapes(get_config("gemma3_1b"), SHAPES["decode_32k"])
    assert dec == {"tokens": ((128, 1), torch.int32)}
    assert np.prod(dec["tokens"][0]) == 128
