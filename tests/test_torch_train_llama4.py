"""Training Llama-4 Maverick (GQA attention, top-1 routing over 4 experts
and a shared expert, MoE every other layer): the port's float32 loss and
gradients on its SMOKE model, unprotected, eager and fused, against
``jax.value_and_grad`` of the reference's ``repro.train.loop._loss_fn``
(with its aux term), on the reference's params carried across by
``params_from_numpy``, on the CPU; remat against no remat. The reference
and tolerances are ``tests/test_torch_train_moe.py``'s.
"""
from __future__ import annotations

import pytest

from repro_torch import configs

from test_torch_train_grad import (BACKENDS, _reference,
                                   assert_remat_matches)
from test_torch_train_ssm import SEU0, assert_f32_matches

ARCH = "llama4_maverick"


@pytest.mark.parametrize("backend", BACKENDS)
def test_loss_and_grads_match_reference_f32(backend):
    assert_f32_matches(ARCH, backend, _reference(ARCH, "float32", False))


@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_remat_matches_no_remat(monkeypatch, backend, remat):
    """Each block recomputed (the router, the dispatch and the experts
    again): no remat's loss and gradients; 7 protected products a block
    and 3 batched expert products a MoE block, each checked twice."""
    cfg = configs.get_smoke_config(ARCH)
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    assert moe_layers == 2
    assert_remat_matches(monkeypatch, ARCH, backend, remat, SEU0,
                         7 * cfg.num_layers, batched=3 * moe_layers)
