"""The port's MoE FFN (``repro_torch.models.moe``) and its batched checked
product (``repro_torch.core.abft.gemm.ft_matmul_batched``) against the
reference ``repro.models.moe`` and ``jax.vmap(repro.core.abft.ft_matmul)``
on the same seeded numpy inputs, with the reference's own initialised
params carried across by ``params_from_numpy``, at the SMOKE widths of
DeepSeek-V3 (8 experts top-2, a shared expert) and Llama-4 Maverick (4
experts top-1): the portable block's output and ``moe_aux`` at float32 and
bfloat16, protected and unprotected, a batch whose choices overflow an
expert's capacity (the kept set compared), the sort-based dispatch with
expert ids outside [0, E) (the drop bucket), the load-balance loss, and
the per-expert checked products with injected faults. CPU only.

Both blocks see the same input bits, so their routers choose the same
experts. Tolerances, each relative to max|reference|: float32 1e-5
(float32 sums in another order); bfloat16 2^-7, one bf16 step of the
largest output (the products sum in float32 and round once, as XLA's
do); the checked products' counts exactly, their score to 1e-5 relative
(1e-5 absolute for a clean product's rounding noise).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.core import abft as ref_abft
from repro.core.ft import FTPolicy as RefFTPolicy
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe

from repro_torch import configs
from repro_torch.core.abft import gemm as abft_gemm
from repro_torch.core.ft import FTPolicy
from repro_torch.models import layers, moe, params_from_numpy

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
ARCHS = ("deepseek_v3_671b", "llama4_maverick")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
STATS = ("flagged", "corrected", "uncorrectable")


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _params(arch, seed=1):
    """(port params, reference params) of ``arch``'s SMOKE MoE FFN."""
    rc = ref_configs.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, ref_moe.make_moe_params(
        jax.random.PRNGKey(seed), rc))
    return params_from_numpy(tree, device="cpu"), jax.tree.map(jnp.asarray,
                                                              tree)


def _inputs(x, dtype):
    tdt, jdt = DTYPES[dtype]
    xr = jnp.asarray(x, jdt)
    return torch.from_numpy(np.asarray(xr.astype(jnp.float32))).to(tdt), xr


def _ft(protect):
    """(port FTContext, reference FTContext) protecting at 1e-3, or
    (None, None)."""
    if not protect:
        return None, None
    return (layers.FTContext(FTPolicy(protect_linears=True, threshold=1e-3)),
            ref_layers.FTContext(RefFTPolicy(protect_linears=True,
                                             threshold=1e-3)))


def _cap(cfg, tokens):
    return max(math.ceil(tokens * cfg.top_k / cfg.num_experts
                         * cfg.capacity_factor), 8)


@pytest.mark.parametrize("protect", [False, True], ids=["plain", "ft"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_portable_matches_reference(arch, dtype, protect):
    pc, rc = configs.get_smoke_config(arch), ref_configs.get_smoke_config(
        arch)
    pp, rp = _params(arch)
    x = np.random.default_rng(11).standard_normal((2, 16, pc.d_model))
    xp, xr = _inputs(x.astype(np.float32), dtype)
    pft, rft = _ft(protect)
    got, aux = moe._moe_block_portable(pp, xp, pc, ft=pft)
    want, raux = ref_moe._moe_block_portable(rp, xr, rc, ft=rft)
    assert got.dtype == xp.dtype
    _close(got, want, TOL[dtype])
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    if protect:
        # the three expert products' (e,) stats and the shared expert's
        ps, rs = pft.summary(), rft.summary()
        assert len(pft.flagged) == len(rft.flagged)
        assert [tuple(f.shape) for f in pft.flagged] == \
            [tuple(np.shape(f)) for f in rft.flagged]
        assert float(ps["ft_flagged"]) == float(rs["ft_flagged"]) == 0.0
        assert 0.0 < float(ps["ft_max_score"]) < 1e-3
        # the shared expert's three products take sites 0, 1, 2
        assert pft.sites == rft.sites == (3 if pc.num_shared_experts else 0)
    # moe_block is the portable path on one card
    again, _ = moe.moe_block(pp, xp, pc, ft=None)
    plain, _ = moe._moe_block_portable(pp, xp, pc)
    assert torch.equal(again, plain)


def _kept(idx, cap):
    """Per token, the experts that keep it: the (token, slot) choices in
    order, each expert keeping its first ``cap`` (an independent model of
    the stable sort by expert)."""
    seen = {}
    out = []
    for row in idx.tolist():
        kept = set()
        for e in row:
            if seen.get(e, 0) < cap:
                kept.add(e)
            seen[e] = seen.get(e, 0) + 1
        out.append(frozenset(kept))
    return out


@pytest.mark.parametrize("protect", [False, True], ids=["plain", "ft"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_over_capacity_matches_reference(arch, protect):
    """A batch pushed toward expert 0 (its router column added to every
    token) overflows its capacity: the kept set (``_slots``) is the
    independent model's, choices are dropped, and the output and aux loss
    are the reference's, whose stable argsort keeps the same tokens."""
    pc, rc = configs.get_smoke_config(arch), ref_configs.get_smoke_config(
        arch)
    pp, rp = _params(arch, seed=2)
    b, t = 4, 32
    rng = np.random.default_rng(12)
    col = np.asarray(rp["router"])[:, 0]
    x = (rng.standard_normal((b, t, pc.d_model))
         + 3.0 * col / np.linalg.norm(col) * np.sqrt(pc.d_model)
         ).astype(np.float32)
    xp, xr = _inputs(x, "float32")
    _, _, idx = moe._route(pp["router"], xp.reshape(b * t, -1), pc.top_k)
    cap = _cap(pc, b * t)
    order, keep, dest, src = moe._slots(idx, cap, pc.num_experts)
    kept = [set() for _ in range(b * t)]
    for i in torch.nonzero(keep).flatten().tolist():
        kept[int(src[i])].add(int(idx.reshape(-1)[order[i]]))
    assert [frozenset(s) for s in kept] == _kept(idx.numpy(), cap)
    assert int(keep.sum()) < b * t * pc.top_k              # drops occur
    assert sorted(dest[keep].tolist()) == sorted(set(dest[keep].tolist()))
    pft, rft = _ft(protect)
    got, aux = moe._moe_block_portable(pp, xp, pc, ft=pft)
    want, raux = ref_moe._moe_block_portable(rp, xr, rc, ft=rft)
    _close(got, want, TOL["float32"])
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)


def test_dispatch_compute_drops_ids_outside_the_experts():
    """``_dispatch_compute`` with expert ids outside [0, E) (the EP path's
    rebased ids) sends them to the drop bucket, as the reference's."""
    rc = ref_configs.get_smoke_config("deepseek_v3_671b")
    pp, rp = _params("deepseek_v3_671b")
    rng = np.random.default_rng(13)
    t, k, e = 24, 2, rc.num_experts
    xf = rng.standard_normal((t, rc.d_model)).astype(np.float32)
    idx = rng.integers(0, e + 3, (t, k)).astype(np.int32)
    vals = rng.random((t, k)).astype(np.float32)
    cap = 4
    got, _ = moe._dispatch_compute(
        torch.from_numpy(xf), torch.from_numpy(vals), torch.from_numpy(idx),
        pp["wi_gate"], pp["wi_up"], pp["wo"], cap, e, dtype=torch.float32)
    want, _ = ref_moe._dispatch_compute(
        jnp.asarray(xf), jnp.asarray(vals), jnp.asarray(idx), rp["wi_gate"],
        rp["wi_up"], rp["wo"], cap, e, dtype=jnp.float32)
    _close(got, want, TOL["float32"])
    _, keep, dest, _ = moe._slots(torch.from_numpy(idx), cap, e)
    assert bool((dest[~keep] == e * cap).all())
    assert int(keep.sum()) <= e * cap


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    got = moe.aux_load_balance_loss(torch.from_numpy(probs),
                                    torch.from_numpy(idx), 8)
    want = ref_moe.aux_load_balance_loss(jnp.asarray(probs),
                                         jnp.asarray(idx), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_params_match_reference_tree():
    for arch in ARCHS:
        cfg = configs.get_smoke_config(arch)
        got = moe.make_moe_params(None, cfg, device="meta")
        want = jax.tree.map(np.asarray, ref_moe.make_moe_params(
            jax.random.PRNGKey(0), ref_configs.get_smoke_config(arch)))
        gl = jax.tree_util.tree_flatten_with_path(got)[0]
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in gl] == [p for p, _ in wl]
        assert [tuple(a.shape) for _, a in gl] == [a.shape for _, a in wl]


# ---------------------------------------------------------------------------
# the batched checked product
# ---------------------------------------------------------------------------

def _ref_batched(x, w, inject):
    return jax.vmap(lambda b2, w2, i2: ref_abft.ft_matmul(
        b2, w2, threshold=1e-3, with_correction=True, inject=i2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(inject))


# (E, F, 3) [row, col, eps] per expert: none (eps 0), one, two in distinct
# columns, two in one column (uncorrectable), one outside the product
INJECT = np.array([
    [[0, 0, 0.0], [3, 5, 0.0]],
    [[7, 11, 250.0], [0, 0, 0.0]],
    [[2, 4, -300.0], [5, 40, 180.0]],
    [[1, 9, 200.0], [6, 9, 220.0]],
    [[8, 3, 400.0], [2, 64, 300.0]],
], np.float32)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "random"])
def test_ft_matmul_batched_matches_vmapped_reference(integer):
    """Per expert: y, flagged, corrected and uncorrectable equal the
    reference's vmapped ``ft_matmul`` with the same injections (bit for
    bit on integer operands, where every sum is exact), the score to 1e-5;
    expert 0 clean, 1 corrected, 2 two corrected, 3 uncorrectable (two
    faults in one column), 4 a row past C and a column past d_out that
    address no element."""
    rng = np.random.default_rng(15)
    e, c, d, f = 5, 8, 48, 64
    if integer:
        x = rng.integers(-4, 5, (e, c, d)).astype(np.float32)
        w = rng.integers(-4, 5, (e, d, f)).astype(np.float32)
    else:
        x = rng.standard_normal((e, c, d)).astype(np.float32)
        w = rng.standard_normal((e, d, f)).astype(np.float32)
    y, s = abft_gemm.ft_matmul_batched(torch.from_numpy(x),
                                       torch.from_numpy(w), threshold=1e-3,
                                       inject=torch.from_numpy(INJECT))
    ry, rs = _ref_batched(x, w, INJECT)
    if integer:
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    else:
        _close(y, ry, 1e-5)
    for key in STATS:
        assert tuple(s[key].shape) == (e,)
        np.testing.assert_array_equal(s[key].numpy(), np.asarray(rs[key]))
    # a clean product's score is its checksums' rounding noise (~1e-7),
    # which two libraries' sums give differently: held to 1e-5 absolute
    np.testing.assert_allclose(s["score"].numpy(), np.asarray(rs["score"]),
                               rtol=1e-5, atol=1e-5)
    assert s["flagged"].tolist() == [0, 1, 2, 1, 0]
    assert s["corrected"].tolist() == [0, 1, 2, 0, 0]
    clean = np.einsum("ecd,edf->ecf", x.astype(np.float64), w)
    ok = [0, 1, 2, 4]
    np.testing.assert_allclose(y.numpy()[ok], clean[ok], rtol=0,
                               atol=1e-4 * np.abs(clean).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ft_matmul_batched_equals_each_experts_ft_matmul(dtype):
    """Each expert's slice is the port's 2-D checked product of that
    expert, y to one step of ``dtype`` and the counts exactly."""
    rng = np.random.default_rng(16)
    tdt = DTYPES[dtype][0]
    x = torch.from_numpy(rng.standard_normal((3, 8, 64)).astype(
        np.float32)).to(tdt)
    w = torch.from_numpy(rng.standard_normal((3, 64, 32)).astype(np.float32))
    inj = torch.tensor([[[1.0, 2.0, 90.0]], [[0.0, 0.0, 0.0]],
                        [[7.0, 31.0, -80.0]]])
    y, s = abft_gemm.ft_matmul_batched(x, w, inject=inj)
    assert y.dtype == tdt
    for i in range(3):
        yi, si = abft_gemm.ft_matmul(x[i], w[i], inject=inj[i])
        _close(y[i], yi, TOL[dtype])
        for key in STATS:
            assert float(s[key][i]) == float(si[key]), (i, key)


def test_ft_matmul_batched_rejects_unbatched_shapes():
    with pytest.raises(ValueError, match="E, C, d_in"):
        abft_gemm.ft_matmul_batched(torch.zeros(4, 8), torch.zeros(8, 4))
    with pytest.raises(ValueError, match="E, C, d_in"):
        abft_gemm.ft_matmul_batched(torch.zeros(2, 4, 8),
                                    torch.zeros(3, 8, 4))


def test_moe_config_fields_match_reference():
    for arch in ARCHS:
        a = dataclasses.asdict(configs.get_config(arch))
        b = dataclasses.asdict(ref_configs.get_config(arch))
        a.pop("ft"), b.pop("ft")
        assert a == b
        assert a["capacity_factor"] == 1.25
