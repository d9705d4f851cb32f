"""Training a MoE model at bfloat16 activations: the port's loss and
gradients on Llama-4 Maverick SMOKE (top-1 routing, a shared expert, MoE
every other layer), unprotected and fused, against ``jax.value_and_grad``
of the reference's loss on its unrolled op-by-op form, each backend
against the reference's own, on the CPU (the routers agree at these
inputs: the port's bf16 SwiGLUs take ``jax.nn.silu``'s operations one by
one). Tolerances and helpers are ``tests/test_torch_train_grad.py``'s
(measured: the loss within 6e-5 relative, every leaf within 1.2e-2 in
norm).
"""
from __future__ import annotations

import pytest

from test_torch_train_ssm_bf16 import assert_bf16_matches


@pytest.mark.parametrize("backend", ["none", "fused"])
def test_loss_and_grads_match_reference_bf16(backend):
    assert_bf16_matches("llama4_maverick", backend)
