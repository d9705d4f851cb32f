"""Training xLSTM (mLSTM and sLSTM blocks: the sequential loops under
autograd): the port's loss and gradients on xLSTM SMOKE against
``jax.value_and_grad`` of the reference's ``repro.train.loop._loss_fn``, on
the reference's params carried across by ``params_from_numpy``, on the
CPU: unprotected, eager and fused at float32; unprotected and fused at
bfloat16 against the reference's unrolled op-by-op form.

The float32 gradients are held to a factor of a witness, not to
``F32_GRAD``: xLSTM's recurrence with the reference's init is chaotic
(ROADMAP queue 3, "In the reference itself", item 6), so a rounding
difference grows through the loops. The witness is the reference's own
gradient with every float32 weight moved one ulp up, against its
gradient; each of the port's backends must lie within
``WITNESS_FACTOR`` times the witness's worst leaf (each leaf's error
relative to its max). Measured: the port 1.09e-5 on every backend, the
witness 6.7e-6. The loss is held to ``F32_LOSS``, as for every model.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.models import Model as RefModel
from repro.train import loop as ref_loop

from test_torch_train_grad import (BACKENDS, _batch_np, _cfgs, _leaf_errors,
                                   _ref_params_np)
from test_torch_train_ssm import assert_f32_matches

ARCH = "xlstm_350m"
WITNESS_FACTOR = 4                 # chip_smoke.SSM_WITNESS_FACTOR


@functools.lru_cache(maxsize=None)
def _reference_and_witness(arch):
    """``((loss, aux, grads), witness)``: the reference's unprotected
    float32 ``_loss_fn`` and its gradients as numpy (what ``_reference``
    gives), and the worst leaf error of its gradients with every float32
    param one ulp up against them; one compiled function serves both."""
    _, rc = _cfgs(arch, "float32", "none")
    fn = jax.jit(jax.value_and_grad(functools.partial(
        ref_loop._loss_fn, RefModel(rc), block_q=8, remat="none"),
        has_aux=True))
    tree = _ref_params_np(arch)
    up = jax.tree.map(lambda a: np.nextafter(a, np.float32(np.inf))
                      if a.dtype == np.float32 else a, tree)
    batch = {k: jnp.asarray(v) for k, v in _batch_np(rc).items()}
    out = []
    for params in (tree, up):
        (total, (_, aux)), g = fn(jax.tree.map(jnp.asarray, params), batch)
        out.append((float(total), {k: float(v) for k, v in aux.items()},
                    jax.tree.map(lambda a: np.asarray(a, np.float32), g)))
    witness = max(_leaf_errors(out[1][2], out[0][2], norm=False).values())
    return out[0], witness


@pytest.mark.parametrize("backend", BACKENDS)
def test_loss_and_grads_match_reference_f32(backend):
    reference, witness = _reference_and_witness(ARCH)
    assert witness > 0.0
    assert_f32_matches(ARCH, backend, reference,
                       grad_tol=WITNESS_FACTOR * witness)
