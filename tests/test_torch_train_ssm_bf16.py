"""Training xLSTM at bfloat16 activations: the port's loss and gradients
on xLSTM SMOKE, unprotected and fused, against ``jax.value_and_grad`` of
the reference's loss on its unrolled op-by-op form (``force_unroll``,
whose operations round as the port's do), each backend against the
reference's own (protected, a product rounds once from its float32
accumulator), on the CPU. Tolerances and helpers are
``tests/test_torch_train_grad.py``'s (measured: the loss within 1.7e-3
relative, every leaf within 1.7e-2 in norm).
"""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_train_grad import (BF16_GRAD, BF16_LOSS, _cfgs, _leaf_errors,
                                   _port, _reference, _unrolled)


def assert_bf16_matches(arch, backend):
    r_loss, _, r_grads = _reference(arch, "bfloat16", backend != "none")
    loss, _, grads = _port(arch, "bfloat16", backend)
    _, rc = _cfgs(arch, "float32", "none")
    np.testing.assert_allclose(loss, r_loss, rtol=BF16_LOSS)
    errs = _leaf_errors(_unrolled(rc, grads), r_grads, norm=True)
    assert max(errs.values()) <= BF16_GRAD, errs


@pytest.mark.parametrize("backend", ["none", "fused"])
def test_loss_and_grads_match_reference_bf16(backend):
    assert_bf16_matches("xlstm_350m", backend)
