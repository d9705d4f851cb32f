"""The port's model layers, configs and weight carrier against the reference
on the same numpy inputs: norms, RoPE, embedding, dense (plain and through
the checked GEMM plan), the protected SwiGLU and GELU MLPs with
``FTContext`` at narrow tile-aligned widths (d = 128, d_ff = 256, 128
tokens) with the reference's weights carried across by
``params_from_numpy``, the configs, and the init helpers. CPU only; the
``"fused"`` backend runs the kernel's plain version.

Tolerances, each relative to max|reference|: float32 1e-5 (the same
float32 products summed in another order); bfloat16 activations 2^-6 (each
of the MLP's four bf16 roundings, after the three products and the gate,
can land one bf16 step, 2^-8 relative, apart when the float32 sums fall
on either side of a boundary); RoPE tables 1e-5 absolute (angles up to
64 rad, where a one-ulp difference in the frequency's float32 power moves
the angle by ~4e-6).
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
from repro.core.ft import injection as ref_injection
from repro.models import layers as ref_layers

from repro_torch import configs
from repro_torch.core.ft import FTPolicy, injection
from repro_torch.models import convert, layers
from repro_torch.models.convert import params_from_numpy

CPU = "cpu"
REF_BACKEND = {"eager": "xla", "fused": "pallas"}
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


def _pair(a, dtype):
    """The same numpy array as a torch tensor and a JAX array of dtype."""
    return (torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch,
                                                                 dtype)),
            jnp.asarray(a, dtype))


def _ref_params(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# norms, RoPE, embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(rng, kind, dtype):
    x = (3.0 * rng.standard_normal((4, 8, 96)) + 0.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(96)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(96)).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    xt, xj = _pair(x, dtype)
    got = layers.norm(params_from_numpy(p, device=CPU), xt, kind)
    want = ref_layers.norm(p, xj, kind)
    assert got.dtype == xt.dtype
    _close(got, want, dtype)
    fn, ref_fn = ((layers.rmsnorm, ref_layers.rmsnorm) if kind == "rmsnorm"
                  else (layers.layernorm, ref_layers.layernorm))
    _close(fn(params_from_numpy(p, device=CPU), xt, eps=1e-5),
           ref_fn(p, xj, eps=1e-5), dtype)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_tables_match_reference(theta):
    pos = np.arange(64, dtype=np.int32).reshape(2, 32)
    cos, sin = layers.rope(torch.from_numpy(pos), 64, theta)
    rcos, rsin = ref_layers.rope(jnp.asarray(pos), 64, theta)
    assert cos.shape == (2, 32, 32) and cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), rtol=0,
                               atol=1e-5)
    cb, _ = layers.rope(torch.from_numpy(pos), 64, theta,
                        dtype=torch.bfloat16)
    assert cb.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(rng, dtype):
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    ang = rng.uniform(0, 6, (2, 16, 32)).astype(np.float32)
    xt, xj = _pair(x, dtype)
    ct, cj = _pair(np.cos(ang), dtype)
    st, sj = _pair(np.sin(ang), dtype)
    got = layers.apply_rope(xt, ct, st)
    want = ref_layers.apply_rope(xj, cj, sj)
    assert got.dtype == xt.dtype
    _close(got, want, dtype)


def test_embed_matches_reference(rng):
    table = rng.standard_normal((50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, (3, 7))
    p = params_from_numpy({"embedding": table}, device=CPU)
    got = layers.embed(p, torch.from_numpy(tok), torch.bfloat16)
    want = ref_layers.embed({"embedding": table}, jnp.asarray(tok),
                            jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# dense and the protected MLPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("protect", ["off", "eager", "fused"])
def test_dense_matches_reference(rng, protect, dtype):
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    p = {"w": (rng.standard_normal((128, 128)) / 11).astype(np.float32),
         "b": rng.standard_normal(128).astype(np.float32)}
    xt, xj = _pair(x, dtype)
    ft = ref_ft = None
    if protect != "off":
        ft = layers.FTContext(FTPolicy(protect_linears=True,
                                       gemm_backend=protect))
        ref_ft = ref_layers.FTContext(RefFTPolicy(
            protect_linears=True, gemm_backend=REF_BACKEND[protect]))
    got = layers.dense(params_from_numpy(p, device=CPU), xt, ft=ft)
    want = ref_layers.dense(p, xj, ft=ref_ft)
    assert got.dtype == xt.dtype and got.shape == (2, 64, 128)
    _close(got, want, dtype)
    if ft is not None:
        assert ft.sites == 1 and float(ft.summary()["ft_flagged"]) == 0.0


def _mlp_case(rng, act, dtype, backend, inject=None):
    """(port y, port summary, sites), (reference y, summary) of one
    protected MLP on the reference's weights, 128 tokens."""
    d, d_ff = 128, 256
    ref_p = _ref_params(ref_layers.make_mlp_params(
        jax.random.PRNGKey(3), d, d_ff, act))
    x = rng.standard_normal((2, 64, d)).astype(np.float32)
    xt, xj = _pair(x, dtype)
    ctx = layers.FTContext(
        FTPolicy(protect_linears=True, threshold=1e-3, gemm_backend=backend),
        inject=None if inject is None else inject[0])
    ref_ctx = ref_layers.FTContext(
        RefFTPolicy(protect_linears=True, threshold=1e-3,
                    gemm_backend=REF_BACKEND[backend]),
        inject=None if inject is None else inject[1])
    y = layers.mlp(params_from_numpy(ref_p, device=CPU), xt, act, ft=ctx)
    want = ref_layers.mlp(ref_p, xj, act, ft=ref_ctx)
    plain = layers.mlp(params_from_numpy(ref_p, device=CPU), xt, act)
    return (y, ctx.summary(), ctx.sites, plain), (want, ref_ctx.summary())


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_protected_mlp_matches_reference(rng, act, dtype, backend):
    (y, s, sites, plain), (want, rs) = _mlp_case(rng, act, dtype, backend)
    assert y.dtype == getattr(torch, dtype) and y.shape == (2, 64, 128)
    _close(y, want, dtype)
    _close(plain, want, dtype)          # the unprotected path agrees too
    assert sites == (3 if act == "swiglu" else 2)
    assert float(s["ft_flagged"]) == float(rs["ft_flagged"]) == 0.0
    assert float(s["ft_corrected"]) == 0.0
    assert 0.0 < float(s["ft_max_score"]) < 1e-3   # checksums were taken


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", [0, 1, 2])
def test_protected_swiglu_corrects_scheduled_seu(rng, site, dtype, backend):
    """A fault descriptor from ``FaultSchedule.for_step_gemm`` arms one
    site; both packages flag and correct it. The port's corrected output is
    held to its clean one at the dtype's tolerance: both of its paths keep
    the product float32 through the correction. It is held to the
    reference's at that tolerance plus, in bf16 on the fused path, the
    reference's own correction residual: its kernel stores the product in
    bf16 before the decode adds d2 back, which leaves about 2^-8 * |eps| in
    the corrected element."""
    entries = ((0, site, 77, 100, 60.0, 0.0),)
    inj = (injection.FaultSchedule(entries).for_step_gemm(0),
           ref_injection.FaultSchedule(entries).for_step_gemm(0))
    (y, s, _, plain), (want, rs) = _mlp_case(rng, "swiglu", dtype, backend,
                                             inject=inj)
    for key in ("ft_flagged", "ft_corrected"):
        assert float(s[key]) == float(rs[key]) == 1.0, key
    np.testing.assert_allclose(float(s["ft_max_score"]),
                               float(rs["ft_max_score"]), rtol=1e-3)
    resid = 2.0 ** -7 * 60.0 if (dtype == "bfloat16"
                                 and backend == "fused") else 0.0
    err = np.abs(_np(y) - _np(plain)).max()
    assert err <= TOL[dtype] * np.abs(_np(plain)).max(), err
    err = np.abs(_np(y) - _np(want)).max()
    assert err <= TOL[dtype] * np.abs(_np(want)).max() + resid, err


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_ftcontext_site_masking(rng, backend):
    """The (site, row, col, enable, eps) descriptor arms exactly one
    protected matmul per call position (mirror of the reference test)."""
    x = rng.integers(-3, 4, (128, 128)).astype(np.float32)
    w1 = rng.integers(-3, 4, (128, 128)).astype(np.float32)
    w2 = rng.integers(-3, 4, (128, 128)).astype(np.float32)
    desc = np.array([[1.0, 5.0, 9.0, 1.0, 400.0]], np.float32)
    ctx = layers.FTContext(FTPolicy(protect_linears=True, threshold=1e-3,
                                    gemm_backend=backend),
                           inject=torch.from_numpy(desc))
    ref_ctx = ref_layers.FTContext(
        RefFTPolicy(protect_linears=True, threshold=1e-3,
                    gemm_backend=REF_BACKEND[backend]),
        inject=jnp.asarray(desc))
    h = layers.dense({"w": torch.from_numpy(w1)}, torch.from_numpy(x),
                     ft=ctx)                  # site 0: stays disarmed
    y = layers.dense({"w": torch.from_numpy(w2)}, h, ft=ctx)  # site 1: fires
    rh = ref_layers.dense({"w": jnp.asarray(w1)}, jnp.asarray(x), ft=ref_ctx)
    ry = ref_layers.dense({"w": jnp.asarray(w2)}, rh, ft=ref_ctx)
    s = ctx.summary()
    assert float(s["ft_flagged"]) == 1.0
    assert float(s["ft_corrected"]) == 1.0
    assert [float(f) for f in ctx.flagged] == [0.0, 1.0] == [
        float(f) for f in ref_ctx.flagged]
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(y.numpy(), x @ w1 @ w2)


def test_ftcontext_take_inject_and_summary():
    ctx = layers.FTContext(FTPolicy(protect_linears=True))
    assert ctx.take_inject() is None and ctx.sites == 1
    z = ctx.summary()
    assert all(float(v) == 0.0 for v in z.values())
    ctx = layers.FTContext(FTPolicy(), inject=torch.tensor(
        [[0.0, 1.0, 2.0, 1.0, 5.0], [1.0, 3.0, 4.0, 1.0, 6.0]]))
    assert not ctx.enabled                       # protect_linears is off
    np.testing.assert_array_equal(
        ctx.take_inject().numpy(), [[1, 2, 1, 5], [3, 4, 0, 6]])
    np.testing.assert_array_equal(
        ctx.take_inject().numpy(), [[1, 2, 0, 5], [3, 4, 1, 6]])
    h = layers.dense({"w": torch.ones(4, 4)}, torch.ones(2, 4), ft=ctx)
    assert not ctx.flagged and float(h[0, 0]) == 4.0


# ---------------------------------------------------------------------------
# params_from_numpy, init helpers
# ---------------------------------------------------------------------------

def test_params_from_numpy_keeps_structure_and_bits(rng):
    w = rng.standard_normal((8, 4)).astype(np.float32)
    tree = {"mlp": {"wo": w, "bf": np.asarray(jnp.asarray(w, jnp.bfloat16))},
            "layers": [{"ids": np.arange(3)}, (w[0],)]}
    got = params_from_numpy(tree, device=CPU)
    assert got["mlp"]["wo"].dtype == torch.float32
    np.testing.assert_array_equal(got["mlp"]["wo"].numpy(), w)
    assert got["mlp"]["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["mlp"]["bf"].float().numpy(),
                                  np.asarray(jnp.asarray(w, jnp.bfloat16),
                                             np.float32))
    assert isinstance(got["layers"], list)
    assert isinstance(got["layers"][1], tuple)
    assert got["layers"][0]["ids"].dtype == torch.int64
    w[0, 0] = 123.0                              # copied, not shared
    assert float(got["mlp"]["wo"][0, 0]) != 123.0
    cast = params_from_numpy(tree, device=CPU, dtype=torch.bfloat16)
    assert cast["mlp"]["wo"].dtype == torch.bfloat16
    assert cast["layers"][0]["ids"].dtype == torch.int64
    assert convert.params_from_numpy is params_from_numpy


def test_init_helpers():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (512, 256), device=CPU)
    std = 1.0 / np.sqrt(512)
    assert w.shape == (512, 256) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * std
    # a standard normal truncated at +-2 has std 0.8796
    np.testing.assert_allclose(float(w.std()), 0.8796 * std, rtol=0.02)
    again = layers.dense_init(torch.Generator().manual_seed(0), (512, 256),
                              device=CPU)
    assert torch.equal(w, again)
    t = layers.truncated_normal(gen, (64, 32), 2.0, dtype=torch.bfloat16,
                                device=CPU)
    assert t.dtype == torch.bfloat16
    assert float(t.abs().max()) <= 2 * 2.0 / np.sqrt(64) * (1 + 2 ** -8)
    p = layers.make_dense_params(gen, 16, 8, bias=True, device=CPU)
    assert p["w"].shape == (16, 8) and not p["b"].any()
    n = layers.make_norm_params(16, "layernorm", device=CPU)
    assert float(n["scale"].sum()) == 16.0 and not n["bias"].any()
    for act in ("swiglu", "gelu"):
        got = layers.make_mlp_params(gen, 16, 32, act, device=CPU)
        want = ref_layers.make_mlp_params(jax.random.PRNGKey(0), 16, 32, act)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelConfig", "ParallelConfig",
                                  "ShapeConfig", "RunConfig"])
def test_config_fields_and_defaults_match_reference(name):
    got = [(n, d) for n, d in _fields(getattr(configs, name)) if n != "ft"]
    want = [(n, d) for n, d in _fields(getattr(ref_configs, name))
            if n != "ft"]
    assert got == want
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_phi4_mini_config_matches_reference(which):
    get = {"CONFIG": "get_config", "SMOKE": "get_smoke_config"}[which]
    got = getattr(configs, get)("phi4-mini-3.8b")
    want = getattr(ref_configs, get)("phi4-mini-3.8b")
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert a.pop("ft") == b.pop("ft")           # the policies' fields too
    assert a == b
    assert isinstance(got.ft, FTPolicy)
    assert got.layer_kinds() == want.layer_kinds()
    assert got.inactive_expert_params() == want.inactive_expert_params() == 0


def test_config_registry():
    assert configs.ARCHS == ref_configs.ARCHS == configs.all_arch_names()
    from repro_torch.configs import phi4_mini_3p8b
    assert configs.get_config("phi4_mini_3p8b") is phi4_mini_3p8b.CONFIG
    assert phi4_mini_3p8b.CONFIG.d_model == 3072
    assert phi4_mini_3p8b.CONFIG.d_ff == 8192
    # the ported configs are the reference's, field for field
    for arch in configs.ARCHS:
        for get in ("get_config", "get_smoke_config"):
            a = dataclasses.asdict(getattr(configs, get)(arch))
            b = dataclasses.asdict(getattr(ref_configs, get)(arch))
            assert a.pop("ft") == b.pop("ft") and a == b, (arch, get)
    assert configs.get_config("gemma3-1b").tie_embeddings
    assert configs.get_config("whisper-base").is_encdec
    assert configs.get_config("internvl2-1b").frontend == "patch_stub"
    assert configs.get_config("deepseek-v3-671b").kv_lora_rank == 512
    assert configs.get_config("llama4-maverick-400b-a17b").moe_interval == 2
    with pytest.raises(ValueError, match="unknown architecture"):
        configs.get_config("no_such_model")
