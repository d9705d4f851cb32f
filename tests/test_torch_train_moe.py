"""Training a MoE model: the port's loss and gradients on DeepSeek-V3 SMOKE
(MLA attention, a dense first block, then MoE blocks with top-2 routing
and a shared expert: the sort-based capacity dispatch, the aux loss and
the routed experts' eager batched checked products under autograd)
against ``jax.value_and_grad`` of the reference's
``repro.train.loop._loss_fn`` (which adds ``moe_coef`` x the aux loss), on
the reference's params carried across by ``params_from_numpy``, on the
CPU: unprotected, eager and fused at float32; one SEU at site 0 of every
block under autograd; ``core.abft.gemm.ft_matmul_batched`` under autograd
with an SEU in every expert. Llama-4's float32 gradients and remat are
``tests/test_torch_train_llama4.py``'s.

The float32 reference is the reference's unprotected ``_loss_fn``, for all
three backends (``tests/test_torch_train_ssm.py`` says why). Tolerances
and helpers are ``tests/test_torch_train_grad.py``'s; the batched
product's gradient is ``torch.bmm``'s within 1e-6 x its max.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.abft import gemm as abft_gemm

from test_torch_train_grad import (BACKENDS, _reference,
                                   assert_seu_matches_reference)
from test_torch_train_ssm import SEU0, assert_f32_matches

ARCH = "deepseek_v3_671b"
BATCHED_GRAD_TOL = 1e-6


@pytest.mark.parametrize("backend", BACKENDS)
def test_loss_and_grads_match_reference_f32(backend):
    """The aux loss is part of both losses (3.7515735 in both packages
    here) and is compared on its own too."""
    assert_f32_matches(ARCH, backend, _reference(ARCH, "float32", False))


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_seu_under_autograd_matches_reference(backend):
    """Site 0 (MLA's ``wq_a``) of each of the 4 blocks: flagged =
    corrected = 4 in both packages; the loss (with its aux term) and
    gradients are the reference's faulted step's and the clean step's."""
    assert_seu_matches_reference(ARCH, backend, SEU0)


def test_ft_matmul_batched_gradient_is_bmm():
    """An SEU in each of 4 experts is flagged and corrected; autograd
    through the correction (an in-place indexed add into a view of the
    batched product) gives ``torch.bmm``'s gradients: the correction
    restores the clean product, so its terms cancel."""
    rng = np.random.default_rng(25)
    e, c, d, f = 4, 16, 48, 64
    x0 = torch.from_numpy(rng.standard_normal((e, c, d)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((e, d, f)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((e, c, f)).astype(np.float32))
    inject = torch.tensor([[3.0, 5.0, 40.0], [0.0, 63.0, -25.0],
                           [15.0, 0.0, 60.0], [7.0, 31.0, 33.0]])
    grads = {}
    for label in ("checked", "bmm"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        if label == "checked":
            y, stats = abft_gemm.ft_matmul_batched(x, w, threshold=1e-4,
                                                   inject=inject)
            assert stats["flagged"].tolist() == [1.0] * e
            assert stats["corrected"].tolist() == [1.0] * e
        else:
            y = torch.bmm(x, w)
        y.backward(g)
        grads[label] = (x.grad, w.grad)
    for got, want in zip(grads["checked"], grads["bmm"]):
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=0,
            atol=BATCHED_GRAD_TOL * want.abs().max().item())
