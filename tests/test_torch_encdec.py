"""The port's encoder-decoder model (Whisper: the ``audio_stub`` frontend,
the bidirectional encoder, learned positions, cross-attention) against the
reference ``repro.models.model`` on the CPU, at Whisper SMOKE (2 + 2
layers, d_model 64), with the reference's initialised params carried
across by ``params_from_numpy`` and frames and tokens from a numpy seed:
the param tree and count, ``apply`` at float32 and bfloat16, eight decode
steps, the protected products' launches, the loss and its gradients
against ``jax.value_and_grad`` of the reference's ``_loss_fn``, a
micro-batched train step, and the three behaviours of the reference that
the port copies (ROADMAP queue 3, "In the reference itself", items 8-10).

The helpers below serve ``tests/test_torch_vlm.py`` too. The tolerances
come from ``tests/test_torch_models.py`` and ``tests/test_torch_train_grad.py``: float32 logits 1e-4 and bfloat16
activations 2e-2 of max|reference|; the loss 1e-6 relative and each
gradient leaf 1e-5 of its max at float32; a train step's params 1e-6
absolute. The reference runs Whisper's layers in a Python loop (nothing
is scanned), so its bfloat16 forward is held jitted: XLA's fusions keep
some intermediates in float32, 1.1% of max|logits| from the port's (its
operation-by-operation forward, which rounds as the port does, 0.75%,
and takes 17 s of the CPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro import optim as ref_optim
from repro.configs.base import ParallelConfig as RefParallel
from repro.configs.base import RunConfig as RefRun
from repro.launch import serve as ref_launch
from repro.launch import train as ref_launch_train
from repro.models import Model as RefModel
from repro.models import count_params as ref_count_params
from repro.train import loop as ref_loop

from repro_torch import configs, optim
from repro_torch import tree as ptree
from repro_torch.configs.base import ParallelConfig, RunConfig
from repro_torch.core.ft import FTPolicy
from repro_torch.core.gemm import api as gemm_api
from repro_torch.data import make_batch
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, count_params, params_from_numpy
from repro_torch.models.layers import FTContext, dense
from repro_torch.train import loop
from test_torch_models import CPU, TOL, _close, _np
from test_torch_train_grad import F32_GRAD, F32_LOSS, _leaf_errors

ARCH = "whisper_base"
B, T = 2, 16
FRAMES = 32            # frames a row: SMOKE's encoder takes up to 64
SITES = 6              # protected products a block: q, k, v, o, wi, wo


# ---------------------------------------------------------------------------
# helpers, shared with tests/test_torch_vlm.py
# ---------------------------------------------------------------------------

def _cfgs(arch, dtype="float32", backend=None):
    """(port, reference) SMOKE configs of ``arch``; ``backend`` protects
    every linear on that GEMM path."""
    pc = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    rc = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=dtype)
    if backend is not None:
        pc = dataclasses.replace(pc, ft=dataclasses.replace(
            pc.ft, protect_linears=True, gemm_backend=backend))
        rc = dataclasses.replace(rc, ft=dataclasses.replace(
            rc.ft, protect_linears=True))
    return pc, rc


@functools.lru_cache(maxsize=None)
def _ref_params_np(arch):
    """The reference's SMOKE params; zero-initialised q/k/v biases
    (InternVL2's) get random values, so that a bias that is dropped
    shows."""
    tree = jax.tree.map(np.asarray, jax.jit(RefModel(_cfgs(arch)[1]).init)(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def bias(kp, a):
        if kp[-1].key not in ("bq", "bk", "bv"):
            return a
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(bias, tree)


def _both_params(arch):
    tree = _ref_params_np(arch)
    return (params_from_numpy(tree, device=CPU),
            jax.tree.map(jnp.asarray, tree))


def _batch_np(cfg, b=B, seed=0, frontend=True):
    """A train batch (tokens, labels) and, with ``frontend``, the frontend
    stub's input, standard normal: Whisper's frames or InternVL2's patch
    embeddings, of the reference's ``test_models_smoke._batch_for``
    shape."""
    batch = make_batch(seed, 0, batch=b, seq_len=T,
                       vocab_size=cfg.vocab_size)
    if frontend:
        key, n = (("frames", FRAMES) if cfg.is_encdec
                  else ("patch_embeds", cfg.num_patches))
        batch[key] = np.random.default_rng(seed).standard_normal(
            (b, n, cfg.frontend_dim)).astype(np.float32)
    return batch


def _both_batches(cfg, **kw):
    batch = _batch_np(cfg, **kw)
    return ({k: torch.from_numpy(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


def _count_fused(monkeypatch):
    """Count the fused path's calls of the checked GEMM (its plain version
    on the CPU): one a protected product."""
    calls = []
    fn = gemm_api.ft_kernel.ft_matmul

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(gemm_api.ft_kernel, "ft_matmul", counted)
    return calls


@functools.lru_cache(maxsize=None)
def _reference_grads(arch):
    _, rc = _cfgs(arch)
    rp = jax.tree.map(jnp.asarray, _ref_params_np(arch))
    batch = {k: jnp.asarray(v) for k, v in _batch_np(rc).items()}
    fn = functools.partial(ref_loop._loss_fn, RefModel(rc), block_q=8,
                           remat="none")
    (total, _), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(rp, batch)
    return float(total), jax.tree.map(np.asarray, g)


def _value_and_grad_vs_reference(arch, backend):
    """The port's loss and gradients with the frontend's input in the
    batch, held against ``jax.value_and_grad`` of the reference's
    ``_loss_fn`` (the loss to F32_LOSS relative, each leaf to F32_GRAD of
    its max), nothing flagged. Returns the port's gradients."""
    pc, _ = _cfgs(arch, backend=backend)
    pp, _ = _both_params(arch)
    tb, _ = _both_batches(pc)
    (total, (_, aux)), grads = loop._value_and_grad(
        Model(pc), pp, tb, block_q=8, remat="none")
    want, rgrads = _reference_grads(arch)
    np.testing.assert_allclose(float(total), want, rtol=F32_LOSS)
    errs = _leaf_errors(jax.tree.map(_np, grads), rgrads, norm=False)
    assert max(errs.values()) <= F32_GRAD, max(errs.items(),
                                               key=lambda kv: kv[1])
    assert float(aux["ft_flagged"]) == 0.0
    assert np.abs(_np(grads["frontend"]["w"])).max() > 0
    return grads


def _microbatched_step_vs_reference(arch):
    """One ``make_train_step`` step at ``microbatch`` 2 on a batch of 4
    with the frontend's input (each key split along its first axis)
    against the reference's jitted step: the metrics and the updated
    params."""
    pc, rc = _cfgs(arch)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    run = RunConfig(model=pc, parallel=ParallelConfig(remat="none",
                                                      microbatch=2), **kw)
    rrun = RefRun(model=rc, parallel=RefParallel(remat="none",
                                                 microbatch=2), **kw)
    pp, rp = _both_params(arch)
    tb, jb = _both_batches(pc, b=4, seed=1)
    pp, _, m = loop.make_train_step(Model(pc), run)(
        pp, optim.init_state(pp), tb, 0)
    rp, _, rm = jax.jit(ref_loop.make_train_step(RefModel(rc), rrun))(
        rp, ref_optim.init_state(rp), jb, jnp.int32(0))
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5)
    for (path, g), w in zip(ptree.leaves_with_path(pp),
                            jax.tree_util.tree_leaves(rp)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg="/".join(path))


def _float32_smoke(monkeypatch, *mods):
    for mod, get in mods:
        monkeypatch.setattr(mod, "get_smoke_config",
                            lambda arch, get=get: dataclasses.replace(
                                get(arch), dtype="float32"))


def _hand_reference_params(monkeypatch):
    """Keep the params the reference CLI draws; hand them to the port's
    ``Model.init`` once the reference has run."""
    held = {}
    ref_init = RefModel.init

    def keep(self, key):
        held["params"] = ref_init(self, key)
        return held["params"]

    monkeypatch.setattr(RefModel, "init", keep)
    return lambda: monkeypatch.setattr(
        Model, "init", lambda self, gen, device="cuda": params_from_numpy(
            jax.tree.map(np.asarray, held["params"]), device=device))


def _cli_lines(text):
    """The CLI's output lines without their times."""
    return [re.sub(r" in \S+s \(\S+ tok/s\)", "", ln)
            for ln in text.strip().splitlines()]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def test_params_tree_matches_reference():
    """The reference's keys and nesting (encoder and decoder blocks keyed
    "0", "1", not stacked; a decoder block's ``cross_norm`` and
    ``cross_attn``) and shapes, built on ``meta``."""
    pc, _ = _cfgs(ARCH)
    got = jax.tree_util.tree_flatten_with_path(
        Model(pc).init(None, device="meta"))[0]
    want = jax.tree_util.tree_flatten_with_path(_ref_params_np(ARCH))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [tuple(t.shape) for _, t in got] == [a.shape for _, a in want]
    tree = Model(pc).init(None, device="meta")
    assert set(tree) == {"embed", "final_norm", "lm_head", "encoder",
                         "enc_norm", "enc_pos", "dec_pos", "frontend",
                         "decoder"}
    assert set(tree["decoder"]["0"]) == {"norm1", "attn", "norm2", "mlp",
                                         "cross_norm", "cross_attn"}


def test_count_params_matches_reference():
    cfg = configs.get_config(ARCH)
    assert count_params(cfg) == ref_count_params(
        ref_configs.get_config(ARCH)) == 114_768_896


# ---------------------------------------------------------------------------
# forward and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_reference(dtype):
    pc, rc = _cfgs(ARCH, dtype)
    pp, rp = _both_params(ARCH)
    tb, jb = _both_batches(pc)
    got, aux = Model(pc).apply(pp, tb, block_q=8)
    want, raux = jax.jit(functools.partial(RefModel(rc).apply, block_q=8))(
        rp, jb)
    assert got.dtype == torch.float32 and got.shape == (B, T, pc.vocab_size)
    _close(got, want, TOL[dtype])
    assert float(aux["ft_flagged"]) == float(raux["ft_flagged"]) == 0.0


def test_decode_steps_match_reference():
    """Eight decode steps: each step's logits and, after them, every cache
    (the self caches written in place, the cross caches untouched)."""
    pc, rc = _cfgs(ARCH)
    pp, rp = _both_params(ARCH)
    toks = np.random.default_rng(5).integers(0, pc.vocab_size, (B, 8))
    pm, rm = Model(pc), RefModel(rc)
    pcache = pm.init_cache(B, 16, dtype=torch.float32, device=CPU)
    rcache = rm.init_cache(batch=B, max_len=16, dtype=jnp.float32)
    ref_step = jax.jit(rm.decode_step)
    for i in range(8):
        lp, pcache, _ = pm.decode_step(
            pp, pcache, torch.as_tensor(toks[:, i:i + 1], dtype=torch.int32),
            i)
        lr, rcache, _ = ref_step(
            rp, rcache, jnp.asarray(toks[:, i:i + 1], jnp.int32), jnp.int32(i))
        _close(lp, lr, TOL["float32"])
    flat_p = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_np, pcache))[0]
    flat_r = jax.tree_util.tree_flatten_with_path(rcache)[0]
    assert [p for p, _ in flat_p] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_p, flat_r):
        if np.abs(np.asarray(b)).max() == 0:
            assert not np.abs(a).max(), path
        else:
            _close(a, b, TOL["float32"])


def test_protected_launch_counts(monkeypatch):
    """On the fused path every protected product is one call of the
    checked GEMM: 6 a block, the encoder's and the decoder's, in ``apply``
    (2 x 6 + 2 x 6) and the decoder's in a decode step (2 x 6); the
    frontend's, the cross-attention's and the head's products are plain.
    The logits are the unprotected ones, with nothing flagged."""
    pc, _ = _cfgs(ARCH, backend="fused")
    pp, _ = _both_params(ARCH)
    tb, _ = _both_batches(pc)
    calls = _count_fused(monkeypatch)
    got, aux = Model(pc).apply(pp, tb, block_q=0)
    assert len(calls) == SITES * (pc.encoder_layers + pc.decoder_layers)
    assert float(aux["ft_flagged"]) == 0.0
    plain, _ = Model(_cfgs(ARCH)[0]).apply(pp, tb, block_q=0)
    _close(got, plain, TOL["float32"])
    cache = Model(pc).init_cache(B, 4, dtype=torch.float32, device=CPU)
    del calls[:]
    Model(pc).decode_step(pp, cache, tb["tokens"][:, :1], 0)
    assert len(calls) == SITES * pc.decoder_layers


def test_encoder_rows_pad_to_64_row_tiles(monkeypatch):
    """The encoder's products run at M = 4 x 1500 = 6000 rows, no multiple
    of 128: the fused path takes 64-row tiles and pads M with 16 zero rows
    to 6016, and the rows it returns are the unpadded product's."""
    seen = []
    fn = gemm_api.ft_kernel.ft_matmul

    def spy(x, w, **kw):
        seen.append((tuple(x.shape), kw["bm"]))
        return fn(x, w, **kw)

    monkeypatch.setattr(gemm_api.ft_kernel, "ft_matmul", spy)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 1500, 64, generator=gen)
    w = torch.randn(64, 128, generator=gen)
    ctx = FTContext(FTPolicy(protect_linears=True, gemm_backend="fused"))
    y = dense({"w": w}, x, ft=ctx)
    assert seen == [((6016, 64), 64)]
    assert float(ctx.summary()["ft_flagged"]) == 0.0
    _close(y, x @ w, 1e-5)


@pytest.mark.parametrize("k,n", [(512, 512), (512, 2048), (2048, 512)])
def test_gemm_tiles_fit_the_products(k, n):
    """``gemm.spec_for`` gives Whisper's products 128-wide tiles in K and
    N, as at the other models' aligned widths."""
    assert gemm_api.spec_for(torch.empty(4, k), torch.empty(k, n)).tiles \
        == (128, 128, 128)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", [None, "eager", "fused"])
def test_value_and_grad_matches_reference(backend):
    """The loss and every gradient leaf (the encoder's and the frontend's
    too: the loss reaches them through the cross-attention) against
    ``jax.value_and_grad`` of the reference's ``_loss_fn``, unprotected
    and protected on both GEMM paths."""
    grads = _value_and_grad_vs_reference(ARCH, backend)
    assert np.abs(_np(grads["encoder"]["0"]["attn"]["wq"])).max() > 0


def test_remat_is_ignored_as_the_reference_does(monkeypatch):
    """``apply(remat="block")`` recomputes nothing: the reference's
    ``_apply_encdec`` takes no ``remat``, so the protected loss and
    gradients make one checked product a site, not two, and equal the
    step without remat."""
    pc, _ = _cfgs(ARCH, backend="fused")
    pp, _ = _both_params(ARCH)
    tb, _ = _both_batches(pc)
    calls = _count_fused(monkeypatch)
    (want, _), wgrads = loop._value_and_grad(Model(pc), pp, tb, block_q=8,
                                             remat="none")
    n = len(calls)
    (got, _), grads = loop._value_and_grad(Model(pc), pp, tb, block_q=8,
                                           remat="block")
    assert n == len(calls) - n == SITES * (pc.encoder_layers
                                           + pc.decoder_layers)
    assert float(got) == float(want)
    assert all(torch.equal(g, w) for g, w in zip(ptree.leaves(grads),
                                                 ptree.leaves(wgrads)))


def test_microbatched_train_step_matches_reference():
    """A step at ``microbatch`` 2 with frames in the batch, against the
    reference's."""
    _microbatched_step_vs_reference(ARCH)


# ---------------------------------------------------------------------------
# the reference's behaviours, copied (ROADMAP queue 3, items 8-10)
# ---------------------------------------------------------------------------

def test_decode_sees_no_encoder_and_no_fault():
    """Items 8 and 9: a protected decode step with a fault descriptor
    armed at every site flags nothing, in both packages (the decoder
    blocks get no descriptor), and the cross caches stay zeros (no encoder
    output reaches the decode)."""
    pc, rc = _cfgs(ARCH, backend="eager")
    pp, rp = _both_params(ARCH)
    inj = np.array([[s, 0.0, 3.0, 1.0, 50.0] for s in range(SITES)],
                   np.float32)
    pcache = Model(pc).init_cache(B, 4, dtype=torch.float32, device=CPU)
    rcache = RefModel(rc).init_cache(batch=B, max_len=4, dtype=jnp.float32)
    tok = np.array([[3], [9]], np.int32)
    ref_step = jax.jit(RefModel(rc).decode_step)
    for pos in range(3):
        _, pcache, aux = Model(pc).decode_step(
            pp, pcache, torch.from_numpy(tok), pos,
            inject=torch.from_numpy(inj))
        _, rcache, raux = ref_step(
            rp, rcache, jnp.asarray(tok), jnp.int32(pos),
            inject=jnp.asarray(inj))
        assert float(aux["ft_flagged"]) == float(raux["ft_flagged"]) == 0.0
    for i in range(pc.decoder_layers):
        for k in ("k", "v"):
            assert not pcache["decoder"][str(i)]["cross"][k].any()
            assert not np.asarray(rcache["decoder"][str(i)]["cross"][k]).any()
        assert pcache["decoder"][str(i)]["self"]["k"][:, :3].any()


def test_apply_takes_no_fault_descriptor(monkeypatch):
    """Item 9 in ``apply``: the descriptor given to ``apply`` reaches no
    block (the reference's ``_apply_encdec`` takes none), so the logits
    are the clean ones and nothing is flagged."""
    pc, _ = _cfgs(ARCH, backend="eager")
    pp, _ = _both_params(ARCH)
    tb, _ = _both_batches(pc)
    clean, _ = Model(pc).apply(pp, tb, block_q=0)
    got, aux = Model(pc).apply(pp, tb, block_q=0, inject=torch.tensor(
        [[0.0, 1.0, 2.0, 1.0, 300.0]]))
    assert torch.equal(got, clean) and float(aux["ft_flagged"]) == 0.0


def test_cli_ft_line_matches_reference(capsys, monkeypatch):
    """Item 9 at the CLI: ``--mode lm --arch whisper-base --ft`` prints the
    reference's tokens and its ledger, ``injected=2 detected=0
    corrected=0``, on the reference's params at float32 activations."""
    _float32_smoke(monkeypatch, (ref_launch, ref_configs.get_smoke_config),
                   (launch, configs.get_smoke_config))
    hand = _hand_reference_params(monkeypatch)
    argv = ["--mode", "lm", "--arch", "whisper-base", "--preset", "tiny",
            "--batch", "2", "--prompt-len", "4", "--gen", "4", "--ft"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_launch.main()
    hand()
    launch.main(["--device", "cpu", *argv])
    got = _cli_lines(capsys.readouterr().out)
    want = _cli_lines(out.getvalue())
    assert got == want
    assert got[0] == "generated (2, 4)"
    assert got[1].startswith("ft: injected=2 detected=0 corrected=0 "), got


def test_launch_train_raises_without_frames(monkeypatch):
    """Item 10: ``launch.train --arch whisper-base`` feeds token batches,
    which hold no ``frames``: the reference raises ``KeyError: 'frames'``
    and so does the port."""
    argv = ["--arch", "whisper-base", "--preset", "tiny", "--steps", "1",
            "--batch", "2", "--seq", "8"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    with pytest.raises(KeyError, match="frames"):
        ref_launch_train.main()
    with pytest.raises(KeyError, match="frames"):
        launch_train.main(["--device", "cpu", *argv])
