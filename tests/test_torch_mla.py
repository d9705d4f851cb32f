"""The port's MLA attention (``repro_torch.models.attention``:
``make_mla_params``, ``mla_attention``, ``init_mla_cache``) against the
reference ``repro.models.attention`` on the same seeded numpy inputs,
with the reference's own initialised params carried across by
``params_from_numpy``, at DeepSeek-V3's SMOKE widths (d_model 128, 4
heads, q/kv LoRA 48/32, nope/rope/v 16/8/16) and at its no-LoRA branch:
the prefill (the naive path: K and V rebuilt from the latent, value heads
narrower than the query's) at float32 and bfloat16, chunked and not; the
decode (the weight-absorbed path against the latent cache, written in
place) step by step against the reference's decode and the port's own
prefill; the cache; and the protected MLA block's fault sites in call
order against the reference's. CPU only.

Tolerances, each relative to max|reference|: float32 1e-5 (float32 sums
in another order); bfloat16 2^-7 (one bf16 step of the largest output:
the products round as XLA's do, and an f32 sum landing on the other side
of a rounding boundary moves one element a step); decode against the
prefill 2e-3, the reference's ``test_prefill_decode_equivalence``.
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
from repro.models import attention as ref_attention
from repro.models import transformer as ref_transformer

from repro_torch import configs
from repro_torch.core.ft import FTPolicy
from repro_torch.models import attention, params_from_numpy, transformer

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
DECODE_TOL = 2e-3
ARCH = "deepseek_v3_671b"
B, T = 2, 16


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


def _cfgs(lora=True):
    """(port config, reference config): DeepSeek SMOKE, or its no-LoRA
    branch (queries straight from x through ``wq``)."""
    kw = {} if lora else {"q_lora_rank": 0}
    return (dataclasses.replace(configs.get_smoke_config(ARCH), **kw),
            dataclasses.replace(ref_configs.get_smoke_config(ARCH), **kw))


def _params(rc, seed=3):
    tree = jax.tree.map(np.asarray, ref_attention.make_mla_params(
        jax.random.PRNGKey(seed), rc))
    return params_from_numpy(tree, device="cpu"), jax.tree.map(jnp.asarray,
                                                              tree)


def _x(d, seed=4, t=T):
    return np.random.default_rng(seed).standard_normal(
        (B, t, d)).astype(np.float32)


@pytest.mark.parametrize("block_q", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lora", [True, False], ids=["lora", "no_lora"])
def test_mla_prefill_matches_reference(lora, dtype, block_q):
    pc, rc = _cfgs(lora)
    pp, rp = _params(rc)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    xr = jnp.asarray(_x(rc.d_model), jdt)
    xp = torch.tensor(_np(xr)).to(getattr(torch, dtype))
    pos = np.arange(T)
    got, gc = attention.mla_attention(pp, xp, cfg=pc,
                                      positions=torch.as_tensor(pos),
                                      block_q=block_q)
    want, wc = ref_attention.mla_attention(rp, xr, cfg=rc,
                                           positions=jnp.asarray(pos),
                                           block_q=block_q)
    assert gc is None and wc is None
    assert got.dtype == xp.dtype and tuple(got.shape) == (B, T, rc.d_model)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("lora", [True, False], ids=["lora", "no_lora"])
def test_mla_decode_matches_reference_and_prefill(lora):
    """Steps of one and of three tokens against the latent cache: the
    absorbed path's outputs and caches equal the reference's, and its
    outputs the naive prefill's over the same positions."""
    pc, rc = _cfgs(lora)
    pp, rp = _params(rc)
    x = _x(rc.d_model, seed=5, t=10)
    s = 12
    pcache = attention.init_mla_cache(pc, B, s, dtype=torch.float32,
                                      device="cpu")
    rcache = ref_attention.init_mla_cache(rc, B, s, dtype=jnp.float32)
    got, want = [], []
    for lo, hi in ((0, 1), (1, 2), (2, 5), (5, 6), (6, 10)):
        pos = np.arange(lo, hi)
        g, pcache = attention.mla_attention(
            pp, torch.from_numpy(x[:, lo:hi]), cfg=pc,
            positions=torch.as_tensor(pos), cache=pcache, cache_pos=lo)
        w, rcache = ref_attention.mla_attention(
            rp, jnp.asarray(x[:, lo:hi]), cfg=rc, positions=jnp.asarray(pos),
            cache=rcache, cache_pos=jnp.int32(lo))
        got.append(g)
        want.append(np.asarray(w))
    got = torch.cat(got, 1)
    _close(got, np.concatenate(want, 1), TOL["float32"])
    for key in ("ckv", "kr"):
        _close(pcache[key], rcache[key], TOL["float32"])
        assert not bool(pcache[key][:, 10:].any())         # unwritten
    full, _ = attention.mla_attention(pp, torch.from_numpy(x), cfg=pc,
                                      positions=torch.arange(10))
    _close(got, full, DECODE_TOL)


def test_mla_decode_writes_the_cache_in_place():
    pc, rc = _cfgs()
    pp, _ = _params(rc)
    cache = attention.init_mla_cache(pc, B, 4, dtype=torch.float32,
                                     device="cpu")
    held = dict(cache)
    _, new = attention.mla_attention(
        pp, torch.from_numpy(_x(rc.d_model, t=1)), cfg=pc,
        positions=torch.tensor([2]), cache=cache, cache_pos=2)
    for key in ("ckv", "kr"):
        assert new[key] is held[key]
        assert bool(held[key][:, 2].any()) and not bool(
            held[key][:, :2].any())


@pytest.mark.parametrize("layers_shape", [(), (3,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_cache_matches_reference(dtype, layers_shape):
    pc, rc = _cfgs()
    got = attention.init_mla_cache(pc, 2, 7, dtype=getattr(torch, dtype),
                                   layers_shape=layers_shape, device="cpu")
    want = ref_attention.init_mla_cache(rc, 2, 7,
                                        dtype=getattr(jnp, dtype),
                                        layers_shape=layers_shape)
    assert sorted(got) == sorted(want) == ["ckv", "kr"]
    for key in got:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).endswith(str(want[key].dtype))
        assert not bool(got[key].any())


def test_mla_params_match_reference_tree():
    for lora in (True, False):
        pc, rc = _cfgs(lora)
        got = attention.make_mla_params(None, pc, device="meta")
        want = jax.tree.map(np.asarray, ref_attention.make_mla_params(
            jax.random.PRNGKey(0), rc))
        gl = jax.tree_util.tree_flatten_with_path(got)[0]
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in gl] == [p for p, _ in wl]
        assert [tuple(a.shape) for _, a in gl] == [a.shape for _, a in wl]


# the protected products of an MLA block in call order: MLA's four, then the
# FFN's gate, up and down (the dense MLP's, or the MoE's shared expert's);
# the routed experts take none
SITES = ("wq_a", "wq_b", "wkv_a", "wo", "ffn.wi_gate", "ffn.wi_up", "ffn.wo")


def _block_params(kind, seed=6):
    _, rc = _cfgs()
    tree = jax.tree.map(np.asarray, ref_transformer.make_block_params(
        jax.random.PRNGKey(seed), rc, kind))
    return params_from_numpy(tree, device="cpu"), jax.tree.map(jnp.asarray,
                                                              tree)


@pytest.mark.parametrize("site", range(len(SITES) + 1),
                         ids=list(SITES) + ["experts"])
@pytest.mark.parametrize("kind", ["mla|mlp", "mla|moe"])
def test_protected_mla_block_sites_match_reference(kind, site):
    """One fault armed at ``site`` of a protected block (bfloat16
    activations): the port flags and corrects it where the reference does,
    in the product the reference's site order gives it. Which product
    that is shows in the score, the fault over that product's checksum
    scale, held to the reference's. Site 7 is past the block's protected
    products: the routed experts take no site, so nothing is flagged.
    The block's output is the clean one's, as the reference's is."""
    pc, rc = _cfgs()
    pft = FTPolicy(protect_linears=True, threshold=1e-3)
    rft = RefFTPolicy(protect_linears=True, threshold=1e-3)
    pp, rp = _block_params(kind)
    xr = jnp.asarray(_x(rc.d_model, seed=7), jnp.bfloat16)
    xp = torch.tensor(_np(xr)).to(torch.bfloat16)
    inj = np.array([[site, 7.0, 5.0, 1.0, 64.0]], np.float32)
    pos = np.arange(T)
    out = {}
    for armed in (None, inj):
        got, _, aux = transformer.block_apply(
            pp, xp, cfg=pc, kind=kind, positions=torch.as_tensor(pos),
            block_q=0, ftp=pft,
            inject=None if armed is None else torch.from_numpy(armed))
        want, _, raux = ref_transformer.block_apply(
            rp, xr, cfg=rc, kind=kind, positions=jnp.asarray(pos),
            block_q=0, ftp=rft,
            inject=None if armed is None else jnp.asarray(armed))
        out[armed is None] = got
        hit = float(armed is not None and site < len(SITES))
        for key in ("ft_flagged", "ft_corrected"):
            assert float(aux[key]) == float(raux[key]) == hit, key
        if hit:
            np.testing.assert_allclose(float(aux["ft_max_score"]),
                                       float(raux["ft_max_score"]),
                                       rtol=1e-3)
            assert float(aux["ft_max_score"]) > 1e-3
        _close(got, want, TOL["bfloat16"])
    _close(out[False], out[True], TOL["bfloat16"])
