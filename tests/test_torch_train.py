"""The port's training path (``repro_torch.optim``, ``data``,
``checkpoint``, ``train.loop``, ``launch.train``) against the reference's
(``repro.optim``, ``repro.data``, ``repro.checkpoint``, ``repro.train``,
``repro.launch.train``) on the same numpy inputs, on the CPU. Loss and
gradients against ``jax.value_and_grad`` and remat are
``tests/test_torch_train_grad.py``'s.

Tolerances: one AdamW update, params and moments, 1e-6 x max|reference|
(float32 arithmetic in another order: an ulp or two); the schedule, the
global norm and the CE loss 1e-6 relative; three train steps at float32
activations, params within 1e-6 absolute (a step moves a param by at
most about lr = 1e-3; a MoE model's within 4x the reference's own drift
from params one ulp up) and loss, CE and grad norm 1e-5 relative; the
batches, the checkpoints and a skipped step bit for bit. Restart: the
loss 1e-5 relative, the reference's ``test_train_restart_determinism``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro import optim as ref_optim
from repro.checkpoint import ckpt as ref_ckpt
from repro.configs.base import ParallelConfig as RefParallel
from repro.configs.base import RunConfig as RefRun
from repro.data import synthetic as ref_synthetic
from repro.models import Model as RefModel
from repro.train import loop as ref_loop

from repro_torch import configs, optim
from repro_torch import tree as ptree
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import ParallelConfig, RunConfig
from repro_torch.data import Prefetcher, TokenPipeline, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, params_from_numpy
from repro_torch.train import loop

CPU = "cpu"
WITNESS_FACTOR = 4                 # chip_smoke.SSM_WITNESS_FACTOR


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _leaves_with_keys(tree, path=()):
    """(path, leaf) of a nested dict in the reference's (sorted) order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_trees_close(got, want, rel=None, atol=None):
    for path, w in _leaves_with_keys(jax.tree.map(np.asarray, want)):
        g = _np(_get(got, path))
        assert g.shape == w.shape, path
        tol = atol if atol is not None else rel * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=str(path))


def _tree_pair(seed=0):
    """A small param tree (a matrix, a stacked 3-D leaf, a vector) and a
    gradient tree, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (8, 6)}, "s": (3, 4, 5), "b": (6,)}

    def draw(s, scale):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return draw(shapes, 1.0), draw(shapes, 0.3)


def _cfgs(arch, dtype="float32", protect=False):
    pc = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    rc = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=dtype)
    if protect:
        pc = dataclasses.replace(pc, ft=dataclasses.replace(
            pc.ft, protect_linears=True))
        rc = dataclasses.replace(rc, ft=dataclasses.replace(
            rc.ft, protect_linears=True))
    return pc, rc


@functools.lru_cache(maxsize=None)
def _ref_params_np(arch, seed=0):
    _, rc = _cfgs(arch)
    return jax.tree.map(np.asarray, RefModel(rc).init(
        jax.random.PRNGKey(seed)))


def _batch(b):
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_reference(grad_clip):
    p_np, g_np = _tree_pair()
    rp = jax.tree.map(jnp.asarray, p_np)
    rs = ref_optim.init_state(rp)
    pp = params_from_numpy(p_np, device=CPU)
    ps = optim.init_state(pp)
    for step in range(2):       # the second update reads the moments back
        kw = dict(lr=jnp.float32(1e-2), grad_clip=grad_clip)
        rp, rs, rinfo = ref_optim.apply_updates(
            rp, jax.tree.map(jnp.asarray, g_np), rs, **kw)
        out = optim.apply_updates(pp, params_from_numpy(g_np, device=CPU),
                                  ps, lr=1e-2, grad_clip=grad_clip)
        assert out[0] is pp and out[1] is ps     # written in place
        info = out[2]
    _assert_trees_close(pp, rp, rel=1e-6)
    _assert_trees_close(ps.mu, rs.mu, rel=1e-6)
    _assert_trees_close(ps.nu, rs.nu, rel=1e-6)
    assert ps.step.dtype == torch.int32 and int(ps.step) == int(rs.step) == 2
    np.testing.assert_allclose(float(info["grad_norm"]),
                               float(rinfo["grad_norm"]), rtol=1e-6)
    assert float(info["skipped"]) == float(rinfo["skipped"]) == 0.0


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_adamw_nonfinite_step_is_skipped(bad):
    """A non-finite gradient drops the step: params, moments and step stay
    as they were, bit for bit, and ``skipped`` is 1, as the reference's."""
    p_np, g_np = _tree_pair()
    pp = params_from_numpy(p_np, device=CPU)
    ps = optim.init_state(pp)
    optim.apply_updates(pp, params_from_numpy(g_np, device=CPU), ps, lr=1e-2)
    before = jax.tree.map(lambda t: t.clone(), (pp, ps.mu, ps.nu))
    g_np["a"]["w"][1, 2] = bad
    _, _, info = optim.apply_updates(pp, params_from_numpy(g_np, device=CPU),
                                     ps, lr=1e-2)
    for got, want in zip(jax.tree.leaves((pp, ps.mu, ps.nu)),
                         jax.tree.leaves(before)):
        assert torch.equal(got, want)
    assert int(ps.step) == 1 and float(info["skipped"]) == 1.0
    rp = jax.tree.map(jnp.asarray, p_np)
    _, rs, rinfo = ref_optim.apply_updates(
        rp, jax.tree.map(jnp.asarray, g_np), ref_optim.init_state(rp),
        lr=jnp.float32(1e-2))
    assert float(rinfo["skipped"]) == 1.0 and int(rs.step) == 0


def test_adamw_nonfinite_applied_without_skip():
    """``skip_nonfinite=False`` applies the step, as the reference does."""
    p_np, g_np = _tree_pair()
    g_np["b"][0] = np.nan
    pp = params_from_numpy(p_np, device=CPU)
    ps = optim.init_state(pp)
    _, _, info = optim.apply_updates(pp, params_from_numpy(g_np, device=CPU),
                                     ps, lr=1e-2, skip_nonfinite=False)
    assert int(ps.step) == 1 and float(info["skipped"]) == 1.0
    assert bool(torch.isnan(pp["b"]).all())


def test_cosine_schedule_and_global_norm_match_reference():
    kw = dict(base_lr=3e-4, warmup_steps=5, total_steps=50)
    for step in (0, 1, 4, 5, 6, 20, 49, 50, 80):
        got = optim.cosine_schedule(step, **kw)
        want = ref_optim.cosine_schedule(jnp.int32(step), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _, g_np = _tree_pair(1)
    np.testing.assert_allclose(
        float(optim.global_norm(params_from_numpy(g_np, device=CPU))),
        float(ref_optim.global_norm(jax.tree.map(jnp.asarray, g_np))),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,shard,num_shards", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 2), (11, 123, 3, 4)])
def test_make_batch_bitwise(seed, step, shard, num_shards):
    kw = dict(batch=8, seq_len=40, vocab_size=1000, shard=shard,
              num_shards=num_shards)
    got = make_batch(seed, step, **kw)
    want = ref_synthetic.make_batch(seed, step, **kw)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert got["tokens"].shape == (8 // num_shards, 40)


def test_make_batch_uneven_shards_raise():
    with pytest.raises(ValueError, match="divisible"):
        make_batch(0, 0, batch=6, seq_len=8, vocab_size=64, num_shards=4)


def test_prefetcher_order():
    pipe = TokenPipeline(seed=2, batch=2, seq_len=16, vocab_size=128)
    pf = Prefetcher(pipe, start_step=3, depth=2)
    try:
        for step in (3, 4, 5, 6):
            b = pf.next()
            np.testing.assert_array_equal(b["tokens"], pipe(step)["tokens"])
    finally:
        pf.close()
    it = pipe.iterate(5)
    np.testing.assert_array_equal(next(it)["labels"], pipe(5)["labels"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _train_state():
    p_np, _ = _tree_pair()
    pp = params_from_numpy(p_np, device=CPU)
    pp["h"] = torch.linspace(-2, 2, 7).to(torch.bfloat16)
    ps = optim.init_state(pp)
    ps.mu["a"]["w"].fill_(0.25)
    ps.step.fill_(7)
    return pp, ps


def _zeros(tree):
    return jax.tree.map(torch.zeros_like, tree)


def test_checkpoint_roundtrip_keys_and_dtypes(tmp_path):
    pp, ps = _train_state()
    path = save_checkpoint(str(tmp_path), 7, (pp, ps), extra={"tag": "x"})
    assert os.path.basename(path) == "step_00000007"
    with np.load(os.path.join(path, "state.npz")) as z:
        assert z["0/h"].dtype == np.float32          # bf16 stored as f32
        assert sorted(z.files) == sorted(
            ["0/a/w", "0/s", "0/b", "0/h", "1/.step"]
            + [f"1/.{m}/{k}" for m in ("mu", "nu")
               for k in ("a/w", "s", "b", "h")])
    (rp, rs), meta = restore_checkpoint(str(tmp_path), _zeros((pp, ps)))
    assert meta == {"step": 7, "tag": "x"} and latest_step(str(tmp_path)) == 7
    assert isinstance(rs, optim.AdamWState)
    for got, want in zip(jax.tree.leaves((rp, rs)), jax.tree.leaves((pp, ps))):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_publish_is_atomic(tmp_path):
    pp, ps = _train_state()
    # a stale .tmp (a crash mid-write) is not a restore point
    os.makedirs(tmp_path / "step_00000009.tmp")
    save_checkpoint(str(tmp_path), 3, (pp, ps))
    assert latest_step(str(tmp_path)) == 3
    save_checkpoint(str(tmp_path), 3, (pp, ps))      # overwrite in place
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000003", "step_00000009.tmp"]
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), (pp, ps))


def test_checkpoint_manager_async_gc(tmp_path):
    pp, ps = _train_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    seen = {}
    for step in (1, 2, 3, 4):
        seen[step] = pp["b"].clone()
        mgr.save(step, (pp, ps))
        pp["b"].add_(1.0)       # the host copy was taken at save
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    (rp, _), meta = restore_checkpoint(str(tmp_path), _zeros((pp, ps)), 3)
    assert meta["step"] == 3
    assert torch.equal(rp["b"], seen[3])


def test_tree_paths_are_the_reference_checkpoint_keys():
    """The shared walker's leaf paths, joined by "/", are the keys of the
    reference's ``_flatten`` for ``(params, AdamWState)``, and the
    optimizer's moments come out in the params' leaf order."""
    tree_np = _ref_params_np("phi4_mini_3p8b")
    rp = jax.tree.map(jnp.asarray, tree_np)
    want = ref_ckpt._flatten((rp, ref_optim.init_state(rp)))
    pp = params_from_numpy(tree_np, device=CPU)
    ps = optim.init_state(pp)
    got = ["/".join(p) for p, _ in ptree.leaves_with_path((pp, ps))]
    assert len(got) == len(set(got)) and sorted(got) == sorted(want)
    assert [p.shape for p in ptree.leaves(pp)] == [
        m.shape for m in ptree.leaves(ps.mu)]


@pytest.mark.parametrize("kind", ["dict", "sequences", "namedtuple"])
def test_tree_unflatten_inverts_leaves(kind):
    pp, ps = _train_state()
    t = {"dict": pp, "sequences": [pp, (ps.step, [ps.mu])],
         "namedtuple": (pp, ps)}[kind]
    flat = ptree.leaves(t)
    back = ptree.unflatten(t, [x + 1 for x in flat])
    assert type(back) is type(t)
    for got, want in zip(ptree.leaves(back), flat):
        assert torch.equal(got, want + 1)
    assert ([p for p, _ in ptree.leaves_with_path(back)]
            == [p for p, _ in ptree.leaves_with_path(t)])
    with pytest.raises(ValueError, match="fewer"):
        ptree.unflatten(t, flat[:-1])
    with pytest.raises(ValueError, match="more"):
        ptree.unflatten(t, flat + flat[:1])


def test_reference_checkpoint_restores_into_port(tmp_path):
    """A checkpoint the reference writes of its (params, AdamWState)
    restores into the port's trees, and the port's into the reference's."""
    tree = _ref_params_np("phi4_mini_3p8b")
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_optim.init_state(rp)._replace(step=jnp.int32(5))
    rs = rs._replace(mu=jax.tree.map(lambda a: a + 0.5, rs.mu))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, (rp, rs))
    pp = params_from_numpy(tree, device=CPU)
    template = (_zeros(pp), optim.init_state(pp))
    (gp, gs), meta = restore_checkpoint(str(tmp_path / "ref"), template)
    assert meta["step"] == 5 and int(gs.step) == 5
    _assert_trees_close(gp, rp, atol=0)
    _assert_trees_close(gs.mu, rs.mu, atol=0)
    save_checkpoint(str(tmp_path / "port"), 5, (gp, gs))
    (bp, bs), _ = ref_ckpt.restore_checkpoint(
        str(tmp_path / "port"), (jax.tree.map(jnp.zeros_like, rp), rs))
    _assert_trees_close(gp, bp, atol=0)
    assert int(bs.step) == 5


# ---------------------------------------------------------------------------
# loss and steps
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 33)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    got = loop.cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    want = ref_loop.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def _runs(arch, micro=1, lr=1e-3, protect=False):
    pc, rc = _cfgs(arch, protect=protect)
    kw = dict(learning_rate=lr, warmup_steps=2, total_steps=20)
    return (Model(pc), RunConfig(model=pc, parallel=ParallelConfig(
                remat="none", microbatch=micro), **kw),
            RefModel(rc), RefRun(model=rc, parallel=RefParallel(
                remat="none", microbatch=micro), **kw))


def _ulp_drift(ref_step, tree, pipe, steps, want):
    """The reference's own drift: max |params - ``want``| after ``steps``
    of ``ref_step`` from ``tree`` with every float32 leaf one ulp up."""
    rp = jax.tree.map(lambda a: jnp.asarray(
        np.nextafter(a, np.float32(np.inf)) if a.dtype == np.float32
        else a), tree)
    rs = ref_optim.init_state(rp)
    for step in range(steps):
        _, jb = _batch(pipe(step))
        rp, rs, _ = ref_step(rp, rs, jb, jnp.int32(step))
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(want)))


@pytest.mark.parametrize("arch,micro", [("phi4_mini_3p8b", 1),
                                        ("gemma3_1b", 2),
                                        ("llama4_maverick", 2)])
def test_three_train_steps_match_reference(arch, micro):
    """Three steps, micro-batched on Gemma-3 and on Llama-4 (a MoE model:
    its capacity is computed per micro-batch in both packages). A MoE
    model's params are held to WITNESS_FACTOR x the reference's own drift
    from params one ulp up (``_ulp_drift``: 2.1e-6 on Llama-4 SMOKE, where
    the dense models' is 1.8e-7 to 2.4e-7): an expert weight that few
    tokens reach has a gradient at its rounding noise, which AdamW's
    normalised update turns into steps of lr's size (measured: the port
    1.17e-6 off the reference at one such element of 262144)."""
    model, run, rmodel, rrun = _runs(arch, micro)
    tree = _ref_params_np(arch)
    pp, rp = params_from_numpy(tree, device=CPU), jax.tree.map(jnp.asarray,
                                                               tree)
    ps, rs = optim.init_state(pp), ref_optim.init_state(rp)
    step_fn = loop.make_train_step(model, run)
    ref_step = jax.jit(ref_loop.make_train_step(rmodel, rrun))
    pipe = TokenPipeline(seed=0, batch=4, seq_len=16,
                         vocab_size=model.cfg.vocab_size)
    for step in range(3):
        tb, jb = _batch(pipe(step))
        pp, ps, m = step_fn(pp, ps, tb, step)
        rp, rs, rm = ref_step(rp, rs, jb, jnp.int32(step))
        assert set(m) == set(rm)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5)
        for k in ("lr", "skipped_updates", "moe_aux", "ft_flagged"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-6)
    atol = 1e-6
    if model.cfg.num_experts:
        drift = _ulp_drift(ref_step, tree, pipe, 3, rp)
        assert drift > 0.0
        atol = WITNESS_FACTOR * drift
    _assert_trees_close(pp, rp, atol=atol)
    _assert_trees_close(ps.nu, rs.nu, rel=1e-5)


def test_microbatch_matches_full_batch():
    """Two micro-batches average to the full batch's step (the reference's
    ``test_microbatched_matches_full_batch``)."""
    tree = _ref_params_np("phi4_mini_3p8b")
    pipe = TokenPipeline(seed=2, batch=8, seq_len=16, vocab_size=512)
    tb, _ = _batch(pipe(0))
    outs = {}
    for micro in (1, 2):
        model, run, _, _ = _runs("phi4_mini_3p8b", micro)
        pp = params_from_numpy(tree, device=CPU)
        pp, _, m = loop.make_train_step(model, run)(
            pp, optim.init_state(pp), tb, 0)
        outs[micro] = (pp, m)
    np.testing.assert_allclose(float(outs[1][1]["loss"]),
                               float(outs[2][1]["loss"]), rtol=1e-5)
    _assert_trees_close(outs[2][0], jax.tree.map(_np, outs[1][0]), atol=1e-6)


def _run_steps(step_fn, pipe, params, state, a, b):
    for s in range(a, b):
        tb, _ = _batch(pipe(s))
        params, state, m = step_fn(params, state, tb, s)
    return params, state, m


def test_train_loss_decreases_protected():
    """Twenty steps of Gemma-3 SMOKE, every linear protected: the loss
    falls, every step is finite and no clean step flags."""
    model, run, _, _ = _runs("gemma3_1b", lr=3e-3, protect=True)
    run = dataclasses.replace(run, total_steps=20)
    pp = params_from_numpy(_ref_params_np("gemma3_1b"), device=CPU)
    ps = optim.init_state(pp)
    step_fn = loop.make_train_step(model, run)
    pipe = TokenPipeline(seed=0, batch=8, seq_len=32, vocab_size=512)
    losses, flagged = [], 0.0
    for s in range(20):
        tb, _ = _batch(pipe(s))
        pp, ps, m = step_fn(pp, ps, tb, s)
        losses.append(float(m["ce"]))
        flagged += float(m["ft_flagged"])
    assert all(np.isfinite(losses)) and flagged == 0.0
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_restart_determinism(tmp_path):
    """Checkpoint at step 4 through the async manager, restore into fresh
    tensors, continue to step 9: the uninterrupted run's loss (the
    reference's ``test_train_restart_determinism``)."""
    model, run, _, _ = _runs("phi3_medium_14b")
    step_fn = loop.make_train_step(model, run)
    pipe = TokenPipeline(seed=1, batch=4, seq_len=16, vocab_size=512)
    tree = _ref_params_np("phi3_medium_14b")
    p0 = params_from_numpy(tree, device=CPU)
    _, _, m_a = _run_steps(step_fn, pipe, p0, optim.init_state(p0), 0, 10)
    p1 = params_from_numpy(tree, device=CPU)
    p_b, s_b, _ = _run_steps(step_fn, pipe, p1, optim.init_state(p1), 0, 5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, (p_b, s_b))
    mgr.wait()
    (p_r, s_r), meta = restore_checkpoint(
        str(tmp_path), (_zeros(p_b), optim.init_state(p_b)))
    assert meta["step"] == 4
    _, _, m_c = _run_steps(step_fn, pipe, p_r, s_r, 5, 10)
    np.testing.assert_allclose(float(m_a["loss"]), float(m_c["loss"]),
                               rtol=1e-5)


def test_eval_step_matches_reference():
    model, run, rmodel, rrun = _runs("phi4_mini_3p8b")
    tree = _ref_params_np("phi4_mini_3p8b")
    tb, jb = _batch(make_batch(0, 3, batch=2, seq_len=16, vocab_size=512))
    got = loop.make_eval_step(model, run)(params_from_numpy(tree, device=CPU),
                                          tb)
    want = ref_loop.make_eval_step(rmodel, rrun)(
        jax.tree.map(jnp.asarray, tree), jb)
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


@pytest.mark.parametrize("protect", [False, True])
def test_decode_after_train_step_builds_no_graph(protect):
    """A train step leaves the params as it found them for inference: no
    leaf keeps ``requires_grad``, and a later greedy decode step writes a
    cache and logits that carry no ``grad_fn``."""
    model, run, _, _ = _runs("gemma3_1b", protect=protect)
    pp = params_from_numpy(_ref_params_np("gemma3_1b"), device=CPU)
    ps = optim.init_state(pp)
    tb, _ = _batch(make_batch(0, 0, batch=2, seq_len=16,
                              vocab_size=model.cfg.vocab_size))
    pp, ps, _ = loop.make_train_step(model, run)(pp, ps, tb, 0)
    assert not any(p.requires_grad for p in ptree.leaves(pp))
    cache = model.init_cache(2, 8, dtype=torch.float32, device=CPU)
    serve = loop.make_serve_step(model, run)
    tokens = tb["tokens"][:, :1]
    for pos in range(3):
        tokens, cache, _ = serve(pp, cache, tokens, pos)
        assert tokens.grad_fn is None
    assert all(t.grad_fn is None and not t.requires_grad
               for t in ptree.leaves(cache))


def test_value_and_grad_keeps_a_callers_requires_grad():
    """A leaf that comes in with ``requires_grad`` leaves with it; the
    others leave without."""
    model, _, _, _ = _runs("phi4_mini_3p8b")
    pp = params_from_numpy(_ref_params_np("phi4_mini_3p8b"), device=CPU)
    pp["embed"]["embedding"].requires_grad_(True)
    tb, _ = _batch(make_batch(0, 1, batch=2, seq_len=16, vocab_size=512))
    loop._value_and_grad(model, pp, tb, block_q=8, remat="none")
    flags = [(path, p.requires_grad)
             for path, p in ptree.leaves_with_path(pp)]
    assert [path for path, f in flags if f] == [("embed", "embedding")]


@pytest.mark.parametrize("missing", ["tokens", "labels"])
def test_value_and_grad_restores_flags_when_the_loss_raises(missing):
    """The flags are restored also when the loss fails: in the model's
    forward (a batch without tokens) or after it (without labels)."""
    model, _, _, _ = _runs("phi4_mini_3p8b")
    pp = params_from_numpy(_ref_params_np("phi4_mini_3p8b"), device=CPU)
    tb, _ = _batch(make_batch(0, 1, batch=2, seq_len=16, vocab_size=512))
    del tb[missing]
    with pytest.raises(KeyError, match=missing):
        loop._value_and_grad(model, pp, tb, block_q=8, remat="none")
    assert not any(p.requires_grad for p in ptree.leaves(pp))


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_350m",
                                  "deepseek_v3_671b", "llama4_maverick"])
def test_recurrent_and_moe_train_step(arch):
    """``make_train_step`` builds for the recurrent and MoE models, and one
    protected step at SMOKE size returns finite metrics under the
    reference's keys, the aux loss nonzero on a MoE model only."""
    model, run, _, _ = _runs(arch, protect=True)
    pp = model.init(torch.Generator().manual_seed(0), device=CPU)
    tb, _ = _batch(make_batch(0, 0, batch=2, seq_len=16,
                              vocab_size=model.cfg.vocab_size))
    _, _, m = loop.make_train_step(model, run)(pp, optim.init_state(pp),
                                               tb, 0)
    assert set(m) == {"loss", "ce", "lr", "grad_norm", "skipped_updates",
                      "moe_aux", "ft_flagged", "ft_corrected",
                      "ft_max_score"}
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert float(m["skipped_updates"]) == float(m["ft_flagged"]) == 0.0
    assert (float(m["moe_aux"]) > 0) == (arch in ("deepseek_v3_671b",
                                                  "llama4_maverick"))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_STEP_LINE = re.compile(r"step +(\d+) loss (\S+) ce (\S+) gnorm (\S+) "
                        r"ft_flagged (\d+)")


def test_cli_trains_and_resumes(tmp_path, capsys):
    """``--device cpu --preset tiny --steps 3``, then ``--steps 5`` on the
    same directory: the second run prints the restore line and goes on
    from step 3; both print the reference CLI's step lines."""
    ck = str(tmp_path / "ck")
    out_json = str(tmp_path / "m.json")
    base = ["--device", "cpu", "--preset", "tiny", "--ckpt-dir", ck,
            "--log-every", "1", "--ft-linears"]
    log = launch_train.main(base + ["--steps", "3", "--metrics-out",
                                    out_json])
    first = capsys.readouterr().out
    assert [int(m[1]) for m in _STEP_LINE.finditer(first)] == [0, 1, 2]
    assert "[restore]" not in first
    assert json.load(open(out_json)) == log
    assert set(log[0]) == {"loss", "ce", "lr", "grad_norm",
                           "skipped_updates", "moe_aux", "ft_flagged",
                           "ft_corrected", "ft_max_score", "step", "wall_s"}
    assert latest_step(ck) == 2
    launch_train.main(base + ["--steps", "5"])
    second = capsys.readouterr().out
    assert "[restore] resumed from step 2" in second
    assert [int(m[1]) for m in _STEP_LINE.finditer(second)] == [3, 4]
    assert all(float(m[5]) == 0 for m in _STEP_LINE.finditer(first + second))
    assert latest_step(ck) == 4


def test_cli_build_matches_reference():
    from repro.launch import train as ref_launch_train
    for preset in ("tiny", "lm100m", "full"):
        cfg, run = launch_train.build("gemma3-1b", preset, steps=30, batch=8,
                                      seq=64, ft_linears=True)
        rcfg, rrun = ref_launch_train.build("gemma3-1b", preset, steps=30,
                                            batch=8, seq=64, ft_linears=True)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert (run.learning_rate, run.warmup_steps, run.total_steps,
                run.parallel.remat) == (rrun.learning_rate, rrun.warmup_steps,
                                        rrun.total_steps, rrun.parallel.remat)
    with pytest.raises(ValueError):
        launch_train.build("gemma3-1b", "huge", steps=1, batch=1, seq=1)


def test_cli_defaults_to_the_card():
    """The entry point runs on the card unless asked: without one it
    raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        launch_train.main(["--steps", "1"])
