"""The port's recurrent mixers (``repro_torch.models.ssm``: RG-LRU, mLSTM,
sLSTM) against the reference ``repro.models.ssm`` on the same seeded numpy
inputs, with the reference's own initialised params carried across by
``params_from_numpy``, at the SMOKE widths of RecurrentGemma (RG-LRU) and
xLSTM (mLSTM, sLSTM): each block's forward (no state) and its decode over
T steps from a given nonzero state, the new state compared too; the
causal conv with and without a carried state; the doubling scan against
the reference's ``associative_scan`` and a sequential loop; the protected
blocks against the unprotected ones, with an SEU at each protected site
caught and corrected. CPU only.

Tolerances, each relative to max|reference|: float32 1e-4 (float32 sums in
another order, and the transcendental functions of two libraries, which
differ in the last place); bfloat16 activations 2e-2 (each block rounds a
dozen intermediates to bfloat16, 2^-8 relative); decode against forward
2e-3, the reference's ``test_prefill_decode_equivalence``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.core.ft import FTPolicy as RefFTPolicy
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm

from repro_torch import configs
from repro_torch.core.ft import FTPolicy
from repro_torch.models import layers, params_from_numpy, ssm

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_TOL = 2e-3
KINDS = ("rglru", "mlstm", "slstm")
ARCH = {"rglru": "recurrentgemma_2b", "mlstm": "xlstm_350m",
        "slstm": "xlstm_350m"}
# each mixer's protected products, in call order (the block's MLP, where it
# has one, takes the sites after these)
SITES = {"rglru": ("w_in_gate", "w_in_rec", "w_out"),
         "mlstm": ("w_up", "wq", "wk", "wv", "w_down"),
         "slstm": ("w_i", "w_f", "w_z", "w_o", "ffn.wi_gate", "ffn.wi_up",
                   "ffn.wo")}
B, T = 2, 12


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


def _cfgs(kind):
    return (configs.get_smoke_config(ARCH[kind]),
            ref_configs.get_smoke_config(ARCH[kind]))


_MAKE = {"rglru": "make_rglru_params", "mlstm": "make_mlstm_params",
         "slstm": "make_slstm_params"}


def _params(kind, seed=1):
    """(port params, reference params) from the reference's init."""
    _, rc = _cfgs(kind)
    tree = jax.tree.map(np.asarray, getattr(ref_ssm, _MAKE[kind])(
        jax.random.PRNGKey(seed), rc))
    return params_from_numpy(tree, device="cpu"), jax.tree.map(jnp.asarray,
                                                              tree)


def _state(kind, dtype, seed=2):
    """A nonzero decode state of the reference's shapes, as numpy: random
    carries, a positive sLSTM normalizer, stabilizers of either sign."""
    _, rc = _cfgs(kind)
    init = getattr(ref_ssm, f"init_{kind}_state")(rc, B, jnp.dtype(dtype))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in init.items():
        a = rng.standard_normal(v.shape).astype(np.float32)
        if kind == "slstm" and k == "n":
            a = 1.0 + np.abs(a)
        out[k] = np.asarray(jnp.asarray(a, v.dtype))
    return out


def _port_state(state):
    return params_from_numpy(state, device="cpu")


def _block(mod, kind, p, x, cfg, **kw):
    fn = getattr(mod, f"{kind}_block")
    if kind == "rglru":
        return fn(p, x, **kw)
    return fn(p, x, cfg=cfg, **kw)


def _x(cfg, t=T, dtype="float32", seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, t, cfg.d_model)).astype(np.float32)
    xr = jnp.asarray(x, jnp.dtype(dtype))
    return torch.from_numpy(_np(xr)).to(getattr(torch, dtype)), xr


# ---------------------------------------------------------------------------
# forward and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_block_forward_matches_reference(kind, dtype):
    pc, rc = _cfgs(kind)
    pp, rp = _params(kind)
    xp, xr = _x(pc, dtype=dtype)
    got, gs = _block(ssm, kind, pp, xp, pc)
    want, ws = _block(ref_ssm, kind, rp, xr, rc)
    assert gs is None and ws is None
    assert got.dtype == xp.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("kind", KINDS)
def test_block_decode_from_a_state_matches_reference(kind):
    """T single-token steps from a nonzero state, the state carried on
    each side: every step's output and the final state. The port writes
    the new state into the tensors it was given and returns them."""
    pc, rc = _cfgs(kind)
    pp, rp = _params(kind)
    xp, xr = _x(pc, t=5, seed=4)
    st = _state(kind, "float32")
    ps, rs = _port_state(st), jax.tree.map(jnp.asarray, st)
    given = dict(ps)
    for i in range(xp.shape[1]):
        got, new = _block(ssm, kind, pp, xp[:, i:i + 1], pc, state=ps)
        want, rs = _block(ref_ssm, kind, rp, xr[:, i:i + 1], rc, state=rs)
        assert all(new[k] is given[k] for k in given)
        _close(got, want, TOL["float32"])
    assert sorted(new) == sorted(rs)
    for k in rs:
        assert new[k].dtype == getattr(torch, rs[k].dtype.name), k
        _close(new[k], rs[k], TOL["float32"])


@pytest.mark.parametrize("kind", KINDS)
def test_block_decode_several_tokens_a_call_matches_reference(kind):
    """One decode call of 3 tokens from a nonzero state (the RG-LRU's
    unrolled loop, the LSTMs' scan over T) against the reference's."""
    pc, rc = _cfgs(kind)
    pp, rp = _params(kind)
    xp, xr = _x(pc, t=3, seed=6)
    st = _state(kind, "float32", seed=7)
    got, new = _block(ssm, kind, pp, xp, pc, state=_port_state(st))
    want, ws = _block(ref_ssm, kind, rp, xr, rc,
                      state=jax.tree.map(jnp.asarray, st))
    _close(got, want, TOL["float32"])
    for k in ws:
        _close(new[k], ws[k], TOL["float32"])


@pytest.mark.parametrize("kind", KINDS)
def test_block_decode_matches_forward(kind):
    """T single-token steps from the zero state give the forward's
    outputs (the doubling scan / the sequential loop against the decode
    recurrence)."""
    pc, _ = _cfgs(kind)
    pp, _ = _params(kind)
    xp, _ = _x(pc, seed=8)
    full, _ = _block(ssm, kind, pp, xp, pc)
    state = getattr(ssm, f"init_{kind}_state")(pc, B, torch.float32,
                                                device="cpu")
    steps = [_block(ssm, kind, pp, xp[:, i:i + 1], pc, state=state)[0]
             for i in range(xp.shape[1])]
    _close(torch.cat(steps, dim=1), full, DECODE_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_params_and_states_match_reference_shapes(kind):
    pc, rc = _cfgs(kind)
    got = getattr(ssm, _MAKE[kind])(None, pc, device="meta")
    want = getattr(ref_ssm, _MAKE[kind])(jax.random.PRNGKey(0), rc)
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    assert [(tuple(t.shape), t.dtype) for _, t in gl] == \
        [(a.shape, getattr(torch, a.dtype.name)) for _, a in wl]
    got = getattr(ssm, f"init_{kind}_state")(pc, 3, torch.bfloat16,
                                              device="meta",
                                              layers_shape=(2,))
    want = getattr(ref_ssm, f"init_{kind}_state")(rc, 3, jnp.bfloat16,
                                                  layers_shape=(2,))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == \
        {k: (v.shape, f"torch.{v.dtype.name}") for k, v in want.items()}


def test_slstm_ffn_width_is_the_references_rounding():
    """``int(round(d * 4 / 3 / 64)) * 64`` with Python's half-to-even
    round: 1344 at xLSTM-350M's d_model 1024 (64 x 21, no multiple of 128),
    64 at SMOKE's 64; at d = 48, 48 * 4/3/64 = 1.0 exactly."""
    for d, ffs in ((1024, 1344), (64, 64), (48, 64), (2048, 2752)):
        pc = dataclasses.replace(configs.get_smoke_config("xlstm_350m"),
                                 d_model=d, num_heads=4)
        p = ssm.make_slstm_params(None, pc, device="meta")
        assert tuple(p["ffn"]["wi_gate"].shape) == (d, ffs), d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activations_round_as_the_reference(act, dtype):
    """``ssm.silu``/``gelu`` are ``jax.nn.silu``/``gelu`` with
    each operation, and each constant, rounded to the input's dtype as the
    reference rounds them: bit for bit at bfloat16 (``F.silu`` and
    ``F.gelu`` there round once and differ in a third of the elements); at
    float32 the two libraries' ``exp`` and ``tanh`` differ in the last
    place, so within 1e-6 relative."""
    x = np.random.default_rng(8).standard_normal(1 << 14).astype(
        np.float32) * 4
    xj = jnp.asarray(x, jnp.dtype(dtype))
    want = _np(getattr(jax.nn, act)(xj))
    got = _np(getattr(ssm, act)(torch.from_numpy(_np(xj)).to(
        getattr(torch, dtype))))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_matches_reference_where_exp_overflows(dtype):
    """``ssm.silu``'s gradient is ``jax.grad(jax.nn.silu)``'s, finite also
    below -88.7, where ``exp(-x)`` overflows (autograd through ``exp`` and
    ``reciprocal`` gave ``0 * inf = nan`` there: a MoE model's expert
    products reach it at the published widths with 8 experts); at float32
    within 1e-6 x max, at bfloat16 within one bfloat16 step of max."""
    x = np.concatenate([np.array([-1e4, -200.0, -100.0, -89.0, -88.0, -20.0,
                                  0.0, 20.0, 100.0, 1e4], np.float32),
                        np.random.default_rng(9).standard_normal(1 << 12)
                        .astype(np.float32) * 30])
    xj = jnp.asarray(x, jnp.dtype(dtype))
    want = _np(jax.vmap(jax.grad(jax.nn.silu))(xj))
    xt = torch.from_numpy(_np(xj)).to(getattr(torch, dtype))
    xt.requires_grad_(True)
    ssm.silu(xt).backward(torch.ones_like(xt))
    got = _np(xt.grad)
    assert np.isfinite(got).all()
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# the causal conv and the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_reference(carried):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32) if carried \
        else None
    got, gs = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if st is None else torch.from_numpy(st))
    want, ws = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    None if st is None else jnp.asarray(st))
    _close(got, want, 1e-6)
    _close(gs, ws, 0.0)                       # the last K - 1 inputs
    # one step at a time with the carry gives the whole sequence's conv
    if carried:
        state, ys = torch.from_numpy(st), []
        for i in range(x.shape[1]):
            y, state = ssm._causal_conv(torch.from_numpy(x[:, i:i + 1]),
                                        torch.from_numpy(w), state)
            ys.append(y)
        _close(torch.cat(ys, dim=1), got, 1e-6)


def _decays(rng, t, w):
    """RG-LRU coefficients across the configs' range: a = exp(-8
    softplus(lam) r), lam in linspace(2, 6) (the init), r in (0, 1), so a
    runs from about e^-48 to 1; b as the block's, sqrt(1 - a^2) i u."""
    lam = np.linspace(2.0, 6.0, w)
    r = rng.uniform(0.0, 1.0, (2, t, w))
    a = np.exp(-8.0 * np.log1p(np.exp(lam)) * r)
    b = np.sqrt(np.maximum(1.0 - a * a, 1e-12)) * rng.uniform(
        0, 1, (2, t, w)) * rng.standard_normal((2, t, w))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("t", [1, 2, 7, 64, 333, 512])
def test_doubling_scan_matches_associative_scan_and_loop(t):
    a, b = _decays(np.random.default_rng(t), t, 64)
    got = ssm._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert bool(torch.isfinite(got).all())

    def comb(l, r):
        return (r[0] * l[0], r[0] * l[1] + r[1])

    _, want = jax.lax.associative_scan(comb, (jnp.asarray(a),
                                              jnp.asarray(b)), axis=1)
    _close(got, want, TOL["float32"])
    h, loop = np.zeros(a[:, 0].shape), []
    for i in range(t):                        # float64 sequential loop
        h = a[:, i].astype(np.float64) * h + b[:, i]
        loop.append(h)
    _close(got, np.stack(loop, axis=1), TOL["float32"])


# ---------------------------------------------------------------------------
# protection
# ---------------------------------------------------------------------------

def _ft(module, policy, backend, inject=None):
    pol = policy(protect_linears=True, threshold=1e-3,
                 **({"gemm_backend": backend} if backend else {}))
    return module.FTContext(pol, inject=inject)


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("kind", KINDS)
def test_protected_block_matches_unprotected(kind, backend):
    """Every protected product through the checked GEMM (``fused``: the
    kernel's plain version, with the tiles fitted to the SMOKE widths):
    the unprotected block's output, one checked product a site, no flag."""
    pc, rc = _cfgs(kind)
    pp, _ = _params(kind)
    xp, _ = _x(pc)
    plain, _ = _block(ssm, kind, pp, xp, pc)
    ft = _ft(layers, FTPolicy, backend)
    got, _ = _block(ssm, kind, pp, xp, pc, ft=ft)
    _close(got, plain, TOL["float32"])
    assert ft.sites == len(SITES[kind])
    s = ft.summary()
    assert float(s["ft_flagged"]) == float(s["ft_corrected"]) == 0.0


_SEU_CASES = [(k, s) for k in KINDS for s in range(len(SITES[k]))]


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("kind,site", _SEU_CASES,
                         ids=[f"{k}-{SITES[k][s]}" for k, s in _SEU_CASES])
def test_seu_at_each_site_is_caught_and_corrected(kind, site, backend):
    """An SEU in one protected product (``[site, row, col, enable, eps]``)
    is flagged and corrected there: the block's output and new state are
    the clean protected run's, and the reference's protected block, armed
    alike, flags and corrects it too."""
    pc, rc = _cfgs(kind)
    pp, rp = _params(kind)
    xp, xr = _x(pc, t=3, seed=11)
    st = _state(kind, "float32", seed=12)
    inj = np.array([[site, 4, 5, 1.0, 300.0]], np.float32)
    clean, cs = _block(ssm, kind, pp, xp, pc, state=_port_state(st),
                       ft=_ft(layers, FTPolicy, backend))
    ft = _ft(layers, FTPolicy, backend, inject=torch.from_numpy(inj))
    got, gs = _block(ssm, kind, pp, xp, pc, state=_port_state(st), ft=ft)
    s = ft.summary()
    assert (float(s["ft_flagged"]), float(s["ft_corrected"])) == (1.0, 1.0)
    _close(got, clean, TOL["float32"])
    for k in cs:
        _close(gs[k], cs[k], TOL["float32"])
    rft = _ft(ref_layers, RefFTPolicy, None, inject=jnp.asarray(inj))
    want, _ = _block(ref_ssm, kind, rp, xr, rc,
                     state=jax.tree.map(jnp.asarray, st), ft=rft)
    rs = rft.summary()
    assert (float(rs["ft_flagged"]), float(rs["ft_corrected"])) == (1.0, 1.0)
    _close(got, want, TOL["float32"])
