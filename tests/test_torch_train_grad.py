"""The port's loss and gradients (``repro_torch.train.loop._value_and_grad``)
against ``jax.value_and_grad`` of the reference's ``repro.train.loop._loss_fn``
on the same params (the reference's SMOKE init carried across by
``params_from_numpy``) and the same batch, on the CPU: Gemma-3, Phi-4-mini
and Phi-3 SMOKE (Phi's stack their layers, so their stacked leaves take
the gradient of every slot), unprotected, protected on the eager path and
protected on the fused path (the kernel's plain version, under
``core.gemm.api._FusedLinear``); an SEU under autograd; remat.

Tolerances: at float32 activations the loss within 1e-6 relative and
every gradient leaf within 1e-5 x its max (the two packages' float32 sums
in another order; measured: at most 1.9e-6). At bfloat16 activations the
reference runs op by op with its layers unrolled (``force_unroll``, ROADMAP
queue 3 item 7), and each leaf is held in norm, ``|g - ref| <= 5e-2 |ref|``,
the loss within 2e-3 relative: every operation rounds to bfloat16 in both
directions, and the reference's own scanned and unrolled forms differ by
up to 3.04e-2 in a leaf's norm and 4.7e-4 in the loss on these models.
Remat against no remat: the same operations on the same values, so 1e-6.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models import transformer as ref_transformer
from repro.train import loop as ref_loop

from repro_torch import configs
from repro_torch.core.abft import gemm as abft_gemm
from repro_torch.core.ft import FTPolicy
from repro_torch.core.gemm import api as gemm_api
from repro_torch.data import make_batch
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.layers import FTContext, dense
from repro_torch.train import loop

CPU = "cpu"
ARCHS = ["gemma3_1b", "phi4_mini_3p8b", "phi3_medium_14b"]
BACKENDS = ["none", "eager", "fused"]
F32_LOSS, F32_GRAD = 1e-6, 1e-5
BF16_LOSS, BF16_GRAD = 2e-3, 5e-2
REMAT_TOL = 1e-6
MOE_COEF = 0.01                    # _loss_fn's default weight of the aux loss
# one SEU: the MLP gate product (site 4: q, k, v, o, then gate, up, down)
# of every block, token row 5, column 7, +300
SEU = [4.0, 5.0, 7.0, 1.0, 300.0]


def _cfgs(arch, dtype, backend):
    pc = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    rc = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=dtype)
    if backend != "none":
        pc = dataclasses.replace(pc, ft=dataclasses.replace(
            pc.ft, protect_linears=True, gemm_backend=backend))
        rc = dataclasses.replace(rc, ft=dataclasses.replace(
            rc.ft, protect_linears=True))
    return pc, rc


@functools.lru_cache(maxsize=None)
def _ref_params_np(arch):
    _, rc = _cfgs(arch, "float32", "none")
    return jax.tree.map(np.asarray, RefModel(rc).init(jax.random.PRNGKey(0)))


def _batch_np(cfg):
    return make_batch(0, 0, batch=2, seq_len=16, vocab_size=cfg.vocab_size)


def _unrolled(rc, tree):
    """The reference's stacked tree as its unrolled grouping's (every layer
    a prefix block, in order); numpy or JAX leaves."""
    g = ref_transformer.layer_groups(rc)
    stack = tree["stack"]
    layers = [stack["prefix"][str(i)] for i in range(len(g.prefix))]
    layers += [jax.tree.map(lambda a, i=i: a[i], stack["scan"][f"slot{j}"])
               for i in range(g.n_super) for j in range(len(g.super_block))]
    layers += [stack["tail"][str(i)] for i in range(len(g.tail))]
    assert len(layers) == rc.num_layers
    return dict(tree, stack={"prefix": {str(i): p
                                        for i, p in enumerate(layers)}})


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, protected, inject=None):
    """``(loss, aux, grads)`` of the reference's ``_loss_fn`` as numpy; at
    bfloat16 op by op with the layers unrolled, its grads in the stacked
    layout's unrolled form."""
    _, rc = _cfgs(arch, dtype, "eager" if protected else "none")
    rp = jax.tree.map(jnp.asarray, _ref_params_np(arch))
    batch = {k: jnp.asarray(v) for k, v in _batch_np(rc).items()}
    model = RefModel(rc)
    inj = None if inject is None else jnp.asarray(inject, jnp.float32)

    def loss(p, b):
        logits, aux = model.apply(p, b, block_q=8, inject=inj)
        total, ce = ref_loop.cross_entropy(logits[:, -16:], b["labels"])
        return total + MOE_COEF * aux["moe_aux"], (ce, aux)

    # the reference's _loss_fn takes no inject; with none, it is _loss_fn's
    # (``loss`` is _loss_fn's with the fault descriptor passed on)
    fn = (loss if inject is not None else functools.partial(
        ref_loop._loss_fn, model, block_q=8, remat="none"))
    grad = jax.value_and_grad(fn, has_aux=True)
    if dtype == "float32":
        (total, (_, aux)), g = jax.jit(grad)(rp, batch)
    else:
        unrolled = _unrolled(rc, rp)
        with ref_transformer.force_unroll():
            (total, (_, aux)), g = grad(unrolled, batch)
    return (float(total), {k: float(v) for k, v in aux.items()},
            jax.tree.map(lambda a: np.asarray(a, np.float32), g))


def _port(arch, dtype, backend, inject=None, remat="none"):
    pc, _ = _cfgs(arch, dtype, backend)
    pp = params_from_numpy(_ref_params_np(arch), device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in _batch_np(pc).items()}
    inj = None if inject is None else torch.tensor(inject)
    (total, (_, aux)), grads = loop._value_and_grad(
        Model(pc), pp, batch, block_q=8, remat=remat, inject=inj)
    return (float(total), {k: float(v) for k, v in aux.items()},
            jax.tree.map(lambda t: t.numpy(), grads))


def _leaf_errors(got, want, norm):
    """{path: error} of every leaf, relative to the reference leaf's max
    (or its norm when ``norm``)."""
    out = {}
    for kp, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in kp:
            g = g[k.key]
        assert g.shape == w.shape, jax.tree_util.keystr(kp)
        if norm:
            e = np.linalg.norm(g - w) / np.linalg.norm(w)
        else:
            e = np.abs(g - w).max() / np.abs(w).max()
        out[jax.tree_util.keystr(kp)] = float(e)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch, backend):
    r_loss, r_aux, r_grads = _reference(arch, "float32", backend != "none")
    loss, aux, grads = _port(arch, "float32", backend)
    np.testing.assert_allclose(loss, r_loss, rtol=F32_LOSS)
    assert aux["ft_flagged"] == r_aux["ft_flagged"] == 0.0
    errs = _leaf_errors(grads, r_grads, norm=False)
    assert max(errs.values()) <= F32_GRAD, errs


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bf16(arch, backend):
    """Against the reference's unrolled op-by-op forward and its autodiff;
    the port's stacked leaves are compared slot by slot."""
    r_loss, _, r_grads = _reference(arch, "bfloat16", backend != "none")
    loss, _, grads = _port(arch, "bfloat16", backend)
    _, rc = _cfgs(arch, "float32", "none")
    np.testing.assert_allclose(loss, r_loss, rtol=BF16_LOSS)
    errs = _leaf_errors(_unrolled(rc, grads), r_grads, norm=True)
    assert max(errs.values()) <= BF16_GRAD, errs


def assert_seu_matches_reference(arch, backend, seu):
    """One SEU ``seu`` at a protected site of every block of ``arch``'s
    SMOKE model under autograd: detected and corrected in each block, in
    both packages, the loss and gradients those of the reference's
    faulted step and of the clean step."""
    r_loss, r_aux, r_grads = _reference(arch, "float32", True, tuple(seu))
    loss, aux, grads = _port(arch, "float32", backend, inject=seu)
    blocks = configs.get_smoke_config(arch).num_layers
    assert aux["ft_flagged"] == aux["ft_corrected"] == blocks
    assert r_aux["ft_flagged"] == r_aux["ft_corrected"] == blocks
    np.testing.assert_allclose(loss, r_loss, rtol=F32_LOSS)
    assert max(_leaf_errors(grads, r_grads, norm=False).values()) <= F32_GRAD
    c_loss, _, c_grads = _reference(arch, "float32", False)
    np.testing.assert_allclose(loss, c_loss, rtol=F32_LOSS)
    assert max(_leaf_errors(grads, c_grads, norm=False).values()) <= F32_GRAD


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_seu_under_autograd_matches_reference(backend):
    """One SEU at a protected site of every block: detected and corrected
    in each (Gemma-3 SMOKE's 7 blocks, all unrolled, one context each),
    loss and gradients those of the reference's faulted step and of the
    clean step."""
    assert_seu_matches_reference("gemma3_1b", backend, SEU)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def assert_remat_matches(monkeypatch, arch, backend, remat, seu, sites,
                         batched=0):
    """``remat`` against no remat on ``arch``'s SMOKE model: the same loss
    and gradients; the ft stats of a step faulted by ``seu`` are the first
    forward's, not doubled; each protected product's check (``sites`` a
    forward on the GEMM backend, ``batched`` eager batched expert products)
    runs twice, once in the forward and once in the recompute."""
    inject = None if backend == "none" else seu
    module, name = ((gemm_api.ft_kernel, "ft_matmul") if backend == "fused"
                    else (abft_gemm, "ft_matmul"))
    calls = _count_calls(monkeypatch, module, name)
    experts = _count_calls(monkeypatch, abft_gemm, "ft_matmul_batched")
    want = _port(arch, "float32", backend, inject=inject)
    plain_calls, plain_experts = len(calls), len(experts)
    got = _port(arch, "float32", backend, inject=inject, remat=remat)
    cfg = configs.get_smoke_config(arch)
    if backend == "none":
        sites = batched = 0
    assert plain_calls == sites and len(calls) - plain_calls == 2 * sites
    assert (plain_experts == batched
            and len(experts) - plain_experts == 2 * batched)
    np.testing.assert_allclose(got[0], want[0], rtol=REMAT_TOL)
    assert got[1] == want[1]
    if backend != "none":
        assert got[1]["ft_flagged"] == got[1]["ft_corrected"] \
            == cfg.num_layers
    assert max(_leaf_errors(got[2], want[2], norm=False).values()) \
        <= REMAT_TOL


@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("backend", ["none", "eager", "fused"])
def test_remat_matches_no_remat(monkeypatch, backend, remat):
    """Recomputing each block (Phi-4-mini SMOKE: a stacked super-block)
    gives no remat's loss and gradients; the ft stats of a faulted step
    are the first forward's, not doubled; each protected product's check
    runs twice, once in the forward and once in the recompute."""
    arch = "phi4_mini_3p8b"
    assert_remat_matches(monkeypatch, arch, backend, remat, SEU,
                         7 * configs.get_smoke_config(arch).num_layers)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_linear_backward_is_the_product_gradient(dtype):
    """``_FusedLinear``: grad_x in x's dtype, grad_w in float32, from the
    float32 product's gradient; the eager path's autograd through its
    in-place correction gives the same."""
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal((2, 32, 64)).astype(
        np.float32)).to(dtype)
    w0 = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 32, 128)).astype(
        np.float32)).to(dtype)
    out = {}
    for backend in ("fused", "eager"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        ctx = FTContext(FTPolicy(protect_linears=True, gemm_backend=backend),
                        inject=torch.tensor([[0.0, 3.0, 9.0, 1.0, 50.0]]))
        y = dense({"w": w}, x, ft=ctx)
        assert y.dtype == dtype and float(ctx.summary()["ft_corrected"]) == 1
        y.backward(g)
        assert x.grad.dtype == dtype and w.grad.dtype == torch.float32
        out[backend] = (x.grad.float(), w.grad)
    want_x = (g.float().reshape(-1, 128) @ w0.T).reshape(2, 32, 64).to(dtype)
    want_w = x0.float().reshape(-1, 64).T @ g.float().reshape(-1, 128)
    assert torch.equal(out["fused"][0], want_x.float())
    assert torch.equal(out["fused"][1], want_w)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    for got, want in zip(out["eager"], out["fused"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=tol * want.abs().max().item())
