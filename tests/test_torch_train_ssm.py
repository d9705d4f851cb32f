"""Training a recurrent model: the port's loss and gradients
(``repro_torch.train.loop._value_and_grad``) on RecurrentGemma SMOKE
(RG-LRU and local-attention blocks: the doubling scan and the causal conv
under autograd) against ``jax.value_and_grad`` of the reference's
``repro.train.loop._loss_fn``, on the reference's params carried across by
``params_from_numpy`` and ``make_batch``'s batch, on the CPU: unprotected,
protected on the eager path and on the fused path at float32; one SEU at
site 0 of every block under autograd; remat against no remat. xLSTM's
are ``tests/test_torch_train_xlstm.py``'s.

The float32 reference is the reference's own unprotected ``_loss_fn``: it
serves all three backends, since a protected linear's gradient is the
plain product's in both packages (the reference's protected float32
gradients equal its unprotected ones on these SMOKE models: every leaf
error of the port measured the same against either). Tolerances and
helpers are ``tests/test_torch_train_grad.py``'s.
"""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_train_grad import (BACKENDS, F32_GRAD, F32_LOSS, _leaf_errors,
                                   _port, _reference,
                                   assert_remat_matches,
                                   assert_seu_matches_reference)

ARCH = "recurrentgemma_2b"
# one SEU at site 0 (the RG-LRU block's first product, the local block's
# q) of every block, token row 5, column 7, +300
SEU0 = [0.0, 5.0, 7.0, 1.0, 300.0]
# protected products of RecurrentGemma SMOKE's forward: its six blocks are
# (rglru, rglru, local) twice, 6 (RG-LRU 3 + MLP 3) and 7 (q k v o + MLP 3)
SITES = 4 * 6 + 2 * 7


def assert_f32_matches(arch, backend, reference, grad_tol=F32_GRAD):
    """The port's float32 loss, aux and gradients on ``backend`` against
    ``reference``'s ``(loss, aux, grads)``: the loss within F32_LOSS, the
    aux loss too, nothing flagged, every leaf within ``grad_tol`` of its
    max. Returns the worst leaf error."""
    r_loss, r_aux, r_grads = reference
    loss, aux, grads = _port(arch, "float32", backend)
    np.testing.assert_allclose(loss, r_loss, rtol=F32_LOSS)
    np.testing.assert_allclose(aux["moe_aux"], r_aux["moe_aux"],
                               rtol=F32_LOSS)
    assert aux["ft_flagged"] == r_aux["ft_flagged"] == 0.0
    errs = _leaf_errors(grads, r_grads, norm=False)
    assert max(errs.values()) <= grad_tol, errs
    return max(errs.values())


@pytest.mark.parametrize("backend", BACKENDS)
def test_loss_and_grads_match_reference_f32(backend):
    assert_f32_matches(ARCH, backend, _reference(ARCH, "float32", False))


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_seu_under_autograd_matches_reference(backend):
    """Flagged = corrected = 6 blocks in both packages; the loss and
    gradients are the reference's faulted step's and the clean step's."""
    assert_seu_matches_reference(ARCH, backend, SEU0)


@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_remat_matches_no_remat(monkeypatch, backend, remat):
    """Each block recomputed (the scan, the conv and the gates again):
    no remat's loss and gradients, each check run twice."""
    assert_remat_matches(monkeypatch, ARCH, backend, remat, SEU0, SITES)
