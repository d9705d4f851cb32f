"""The port's VLM (InternVL2: the ``patch_stub`` frontend's projected
patches before the scaled token embeddings, a Qwen2-style decoder with
``qkv_bias``) against the reference ``repro.models.model`` on the CPU, at
InternVL2 SMOKE (3 layers, d_model 112, 8 patches of 32), with the
reference's initialised params carried across by ``params_from_numpy``
and patches and tokens from a numpy seed: the param tree and count,
``apply`` with patches at float32 and bfloat16 and without them (the text
path), eight decode steps, the protected products' launches, the
text-tail loss and its gradients against ``jax.value_and_grad`` of the
reference's ``_loss_fn``, a micro-batched train step, and both CLIs.

The helpers come from ``tests/test_torch_encdec.py`` and the tolerances
from ``tests/test_torch_models.py`` and ``tests/test_torch_train_grad.py``: float32 logits 1e-4 and bfloat16
activations 2e-2 of max|reference|, decode against the forward 2e-3; the
loss 1e-6 relative and each gradient leaf 1e-5 of its max at float32; a
train step's params 1e-6 absolute. SMOKE's three layers are one repeated
super-block, which the reference scans: its bfloat16 forward is held with
the layers unrolled (``force_unroll``, ROADMAP queue 3 "In the reference
itself" item 7).
"""
from __future__ import annotations

import contextlib
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
from repro.launch import serve as ref_launch
from repro.launch import train as ref_launch_train
from repro.models import Model as RefModel
from repro.models import count_params as ref_count_params
from repro.models import transformer as ref_transformer

from repro_torch import configs
from repro_torch.core.gemm import api as gemm_api
from repro_torch.launch import serve as launch
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, count_params
from test_torch_encdec import (B, T, _both_batches, _both_params, _cfgs,
                               _cli_lines, _count_fused, _float32_smoke,
                               _hand_reference_params,
                               _microbatched_step_vs_reference,
                               _ref_params_np, _value_and_grad_vs_reference)
from test_torch_models import CPU, DECODE_TOL, TOL, _close, _np, _unrolled

ARCH = "internvl2_1b"
SITES = 7              # protected products a block: q, k, v, o, MLP's 3


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def test_params_tree_matches_reference():
    """The reference's keys, nesting and shapes: the ``frontend``
    projector beside the stacked decoder, q/k/v biases."""
    pc, _ = _cfgs(ARCH)
    tree = Model(pc).init(None, device="meta")
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = jax.tree_util.tree_flatten_with_path(_ref_params_np(ARCH))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [tuple(t.shape) for _, t in got] == [a.shape for _, a in want]
    assert tuple(tree["frontend"]["w"].shape) == (pc.frontend_dim,
                                                  pc.d_model)
    assert {"bq", "bk", "bv"} <= set(tree["stack"]["scan"]["slot0"]["attn"])


def test_count_params_matches_reference():
    cfg = configs.get_config(ARCH)
    assert count_params(cfg) == ref_count_params(
        ref_configs.get_config(ARCH)) == 630_581_376


# ---------------------------------------------------------------------------
# forward and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,patches", [("float32", True),
                                           ("bfloat16", True),
                                           ("float32", False)],
                         ids=["float32", "bfloat16", "text"])
def test_apply_matches_reference(dtype, patches):
    """The logits over the patches and the tokens (P + T positions); with
    no ``patch_embeds`` in the batch, over the tokens alone."""
    pc, rc = _cfgs(ARCH, dtype)
    pp, rp = _both_params(ARCH)
    tb, jb = _both_batches(pc, frontend=patches)
    got, aux = Model(pc).apply(pp, tb, block_q=8)
    t = T + (pc.num_patches if patches else 0)
    assert got.dtype == torch.float32 and got.shape == (B, t, pc.vocab_size)
    if dtype == "float32":
        want, _ = jax.jit(functools.partial(RefModel(rc).apply, block_q=8))(
            rp, jb)
    else:
        unrolled = _unrolled(rc, rp)
        with ref_transformer.force_unroll():
            want, _ = RefModel(rc).apply(unrolled, jb, block_q=8)
    _close(got, want, TOL[dtype])
    assert float(aux["ft_flagged"]) == 0.0


def test_patches_are_projected_unscaled_before_the_tokens():
    """The first P positions' inputs are ``patch_embeds @ frontend.w`` as
    they are (the tokens' embeddings are scaled by sqrt(d_model)), so a
    patch alone moves the logits of every later position: the logits over
    the tokens differ from the text path's."""
    pc, _ = _cfgs(ARCH)
    pp, _ = _both_params(ARCH)
    tb, _ = _both_batches(pc)
    m = Model(pc)
    x, pos = m._embed_inputs(pp, tb, torch.float32)
    want = torch.matmul(tb["patch_embeds"], pp["frontend"]["w"])
    assert torch.equal(x[:, :pc.num_patches], want)
    assert torch.equal(x[:, pc.num_patches:],
                       m._embed(pp, tb["tokens"], torch.float32))
    assert torch.equal(pos, torch.arange(pc.num_patches + T))
    text, _ = m.apply(pp, {"tokens": tb["tokens"]}, block_q=0)
    both, _ = m.apply(pp, tb, block_q=0)
    assert (both[:, pc.num_patches:] - text).abs().max() > 1e-3


def test_decode_steps_match_reference_and_forward():
    """Eight decode steps of the text path: each step's logits against the
    reference's and against the port's forward, and the caches after."""
    pc, rc = _cfgs(ARCH)
    pp, rp = _both_params(ARCH)
    toks = np.random.default_rng(5).integers(0, pc.vocab_size, (B, 8))
    pm, rm = Model(pc), RefModel(rc)
    pcache = pm.init_cache(B, 16, dtype=torch.float32, device=CPU)
    rcache = rm.init_cache(batch=B, max_len=16, dtype=jnp.float32)
    ref_step = jax.jit(rm.decode_step)
    got = []
    for i in range(8):
        lp, pcache, _ = pm.decode_step(
            pp, pcache, torch.as_tensor(toks[:, i:i + 1], dtype=torch.int32),
            i)
        lr, rcache, _ = ref_step(
            rp, rcache, jnp.asarray(toks[:, i:i + 1], jnp.int32), jnp.int32(i))
        _close(lp, lr, TOL["float32"])
        got.append(lp[:, 0])
    full, _ = pm.apply(pp, {"tokens": torch.as_tensor(toks,
                                                      dtype=torch.int32)},
                       block_q=0)
    _close(torch.stack(got, 1), full, DECODE_TOL)
    flat_p = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_np, pcache))[0]
    flat_r = jax.tree_util.tree_flatten_with_path(rcache)[0]
    assert [p for p, _ in flat_p] == [p for p, _ in flat_r]
    for (_, a), (_, b) in zip(flat_p, flat_r):
        _close(a, b, TOL["float32"])


def test_protected_launch_counts(monkeypatch):
    """On the fused path every protected product is one call of the
    checked GEMM, 7 a block, in ``apply`` with patches (the frontend's
    product and the head's are plain) and in a decode step; the logits are
    the unprotected ones, with nothing flagged."""
    pc, _ = _cfgs(ARCH, backend="fused")
    pp, _ = _both_params(ARCH)
    tb, _ = _both_batches(pc)
    calls = _count_fused(monkeypatch)
    got, aux = Model(pc).apply(pp, tb, block_q=0)
    assert len(calls) == SITES * pc.num_layers
    assert float(aux["ft_flagged"]) == 0.0
    plain, _ = Model(_cfgs(ARCH)[0]).apply(pp, tb, block_q=0)
    _close(got, plain, TOL["float32"])
    cache = Model(pc).init_cache(B, 4, dtype=torch.float32, device=CPU)
    del calls[:]
    Model(pc).decode_step(pp, cache, tb["tokens"][:, :1], 0)
    assert len(calls) == SITES * pc.num_layers


@pytest.mark.parametrize("k,n", [(896, 896), (896, 128), (896, 4864),
                                 (4864, 896)])
def test_gemm_tiles_fit_the_products(k, n):
    """``gemm.spec_for`` fits 128-wide tiles to InternVL2's products: K 896
    = 7 x 128 and 4864 = 38 x 128, k's and v's N = 2 x 64 = 128."""
    assert gemm_api.spec_for(torch.empty(4, k), torch.empty(k, n)).tiles \
        == (128, 128, 128)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", [None, "eager", "fused"])
def test_value_and_grad_matches_reference(backend):
    """The text-tail loss (the logits of the last T positions) and every
    gradient leaf, the frontend's too (the tokens attend to the patches),
    against ``jax.value_and_grad`` of the reference's ``_loss_fn``."""
    _value_and_grad_vs_reference(ARCH, backend)


def test_microbatched_train_step_matches_reference():
    """A step at ``microbatch`` 2 with patches in the batch, against the
    reference's."""
    _microbatched_step_vs_reference(ARCH)


# ---------------------------------------------------------------------------
# the CLIs, on the reference's params at float32 activations
# ---------------------------------------------------------------------------

def test_cli_serve_matches_reference(capsys, monkeypatch):
    """``--mode lm --arch internvl2-1b --preset tiny --ft`` prints the
    reference's tokens and its ledger, 2 faults x 3 layers detected and
    corrected."""
    _float32_smoke(monkeypatch, (ref_launch, ref_configs.get_smoke_config),
                   (launch, configs.get_smoke_config))
    hand = _hand_reference_params(monkeypatch)
    argv = ["--mode", "lm", "--arch", "internvl2-1b", "--preset", "tiny",
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
    assert re.search(r"detected=6 corrected=6", got[1]), got


def test_cli_train_matches_reference(monkeypatch):
    """``launch.train --arch internvl2-1b`` trains on the text path (the
    CLI's batches hold no patches), as the reference's does: the same
    logged losses from the same params."""
    _float32_smoke(monkeypatch,
                   (ref_launch_train, ref_configs.get_smoke_config),
                   (launch_train, configs.get_smoke_config))
    hand = _hand_reference_params(monkeypatch)
    argv = ["--arch", "internvl2-1b", "--preset", "tiny", "--steps", "2",
            "--batch", "2", "--seq", "16", "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    want = ref_launch_train.main()
    hand()
    got = launch_train.main(["--device", "cpu", *argv])
    assert [m["step"] for m in got] == [m["step"] for m in want] == [0, 1]
    for g, w in zip(got, want):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5)
