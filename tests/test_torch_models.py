"""The port's model stack (``repro_torch.models.attention``, ``ssm``,
``transformer``, ``model``) against the reference ``repro.models`` on the
same numpy inputs, with the reference's own initialised params carried
across by ``params_from_numpy``: each ported config at its SMOKE size (the
dense decoder family, the recurrent models, RecurrentGemma and xLSTM, and
the MoE models, DeepSeek-V3 with MLA and Llama-4 Maverick),
full-sequence forward, cached decode, a Gemma-3 ring buffer that wraps,
the protected forward, parameter counts, the layer grouping, and the
encoder-decoder's and the VLM's configs. The recurrent mixers alone are
``tests/test_torch_ssm.py``'s; Whisper's encoder-decoder and InternVL2's
patch frontend are ``tests/test_torch_encdec.py``'s and
``tests/test_torch_vlm.py``'s. CPU only; the protected products take the
eager path (and the fused path's plain version where the widths are
tile-aligned).

Tolerances, each relative to max|reference|: float32 logits 1e-4 (float32
sums over up to 6 layers in another order; the reference's own CPU tests
hold its decode to its forward at 2e-3); bfloat16 activations 2e-2 (each
layer rounds a dozen intermediates to bfloat16, 2^-8 relative, and the
port's and XLA's sums can land on either side of a rounding boundary);
decode against forward 2e-3, the reference's
``test_prefill_decode_equivalence``.

The bfloat16 forward is held against the reference's forward with its
layers unrolled (``force_unroll``), which runs each operation on its own
and rounds each result to bfloat16, as the port does. Its ``lax.scan``
compiles the repeated super-block, and XLA's fusions there keep some
intermediates in float32: that forward and the unrolled one differ by
2.5% of max|logits| on RecurrentGemma SMOKE, whose random-weight recurrent
layers amplify a one-step rounding difference more than the dense
family's layers (0.9% on Phi-4-mini SMOKE, 1.1% on xLSTM SMOKE). A MoE
model's router is discontinuous: its bf16 forward is held where the two
packages' routing agrees (``_close_where_routes_agree``).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models import attention as ref_attention
from repro.models import count_params as ref_count_params
from repro.models.model import model_flops_per_token as ref_flops_per_token
from repro.models import transformer as ref_transformer

from repro_torch import configs
from repro_torch.models import Model, attention, count_params, moe
from repro_torch.models import transformer
from repro_torch.models import model_flops_per_token, params_from_numpy

CPU = "cpu"
# the decoder-only language models; the encoder-decoder and the VLM have
# files of their own
ENCDEC_VLM = ["whisper_base", "internvl2_1b"]
PORTED = [a for a in configs.ARCHS if a not in ENCDEC_VLM]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_TOL = 2e-3
# the MoE models at bfloat16, at the positions whose routing agrees: their
# experts (init std 1/sqrt(E), large at SMOKE's E) amplify a one-step
# rounding difference more than the dense layers do. A one-bf16-step
# difference of one element of DeepSeek SMOKE's first block (torch's and
# XLA's CPU bf16 products round an f32 sum on either side of a boundary)
# grows to 2.4% of max|logits| over its three MoE blocks; the reference's
# own scanned and unrolled forwards differ by 3.2% where their routing
# agrees. A routing flip is a near-tie: the top-k gap under 2^-5 of the
# k-th probability, eight bf16 steps of 2^-8 in the router's input
MOE_BF16_TOL = 2.0 ** -5
NEAR_TIE = 2.0 ** -5


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


def _cfgs(arch, dtype="float32", protect=False):
    """(port config, reference config) of ``arch``'s SMOKE size."""
    pc = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    rc = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=dtype)
    if protect:
        pc = dataclasses.replace(pc, ft=dataclasses.replace(
            pc.ft, protect_linears=True))
        rc = dataclasses.replace(rc, ft=dataclasses.replace(
            rc.ft, protect_linears=True))
    return pc, rc


@functools.lru_cache(maxsize=None)
def _ref_params_np(arch, seed=0):
    """The reference's initialised SMOKE params as numpy (dtype-free: the
    param dtype is float32 whatever the activations)."""
    _, rc = _cfgs(arch)
    return jax.tree.map(np.asarray, RefModel(rc).init(
        jax.random.PRNGKey(seed)))


def _both_params(arch):
    tree = _ref_params_np(arch)
    return (params_from_numpy(tree, device=CPU),
            jax.tree.map(jnp.asarray, tree))


def _unrolled(rc, tree):
    """The reference's stacked param tree as the all-prefix tree of its
    unrolled layer grouping (``force_unroll``), layers in order."""
    g = ref_transformer.layer_groups(rc)
    stack = tree["stack"]
    layers = [stack["prefix"][str(i)] for i in range(len(g.prefix))]
    layers += [jax.tree.map(lambda a, i=i: a[i], stack["scan"][f"slot{j}"])
               for i in range(g.n_super) for j in range(len(g.super_block))]
    layers += [stack["tail"][str(i)] for i in range(len(g.tail))]
    return dict(tree, stack={"prefix": {str(i): p
                                        for i, p in enumerate(layers)}})


def _tokens(cfg, b, t, seed=3):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))
    return (torch.as_tensor(toks, dtype=torch.int32),
            jnp.asarray(toks, jnp.int32))


def _port_cfg(rc):
    """A port ModelConfig with every field of the reference's ``rc``."""
    return configs.ModelConfig(**{f.name: getattr(rc, f.name)
                                  for f in dataclasses.fields(rc)
                                  if f.name != "ft"})


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_q", [0, 8])
@pytest.mark.parametrize("arch", PORTED)
def test_apply_matches_reference(arch, block_q):
    pc, rc = _cfgs(arch)
    pp, rp = _both_params(arch)
    tp, tr = _tokens(pc, 2, 16)
    got, aux = Model(pc).apply(pp, {"tokens": tp}, block_q=block_q)
    want, raux = RefModel(rc).apply(rp, {"tokens": tr}, block_q=block_q)
    assert got.dtype == torch.float32
    _close(got, want, TOL["float32"])
    assert float(aux["ft_flagged"]) == float(raux["ft_flagged"]) == 0.0


@pytest.mark.parametrize("arch", PORTED)
def test_apply_bf16_activations_match_reference(arch, monkeypatch):
    """The MoE models' routers are discontinuous: their logits are held
    where the routing agrees (``_close_where_routes_agree``)."""
    pc, rc = _cfgs(arch, "bfloat16")
    pp, rp = _both_params(arch)
    tp, tr = _tokens(pc, 2, 16)
    routes = _record_routes(monkeypatch) if pc.num_experts else None
    got, _ = Model(pc).apply(pp, {"tokens": tp}, block_q=8)
    unrolled = _unrolled(rc, rp)
    with ref_transformer.force_unroll():
        want, _ = RefModel(rc).apply(unrolled, {"tokens": tr}, block_q=8)
    assert got.dtype == torch.float32
    if routes is None:
        _close(got, want, TOL["bfloat16"])
    else:
        _close_where_routes_agree(got, want, routes, pc)


def _record_routes(monkeypatch):
    """Record each MoE layer's router probabilities and top-k experts, in
    call order: the port's ``moe._route`` and the reference's
    ``jax.lax.top_k`` (its only caller in a forward is ``moe.py``)."""
    routes = {"port": [], "ref": []}
    port_route, ref_top_k = moe._route, jax.lax.top_k

    def port(*args):
        r = port_route(*args)
        routes["port"].append((r[0].numpy(), r[2].numpy()))
        return r

    def ref(probs, k):
        r = ref_top_k(probs, k)
        routes["ref"].append((np.asarray(probs), np.asarray(r[1])))
        return r

    monkeypatch.setattr(moe, "_route", port)
    monkeypatch.setattr(jax.lax, "top_k", ref)
    return routes


def _kept(idx, cap):
    """Per token, the experts that keep it: the (token, slot) choices in
    order, each expert keeping its first ``cap`` (the stable sort by
    expert of the capacity dispatch)."""
    seen = collections.Counter()
    out = []
    for row in idx.tolist():
        out.append(frozenset(e for e in row if seen[e] < cap))
        seen.update(row)
    return out


def _close_where_routes_agree(got, want, routes, cfg):
    """Logits of a MoE model against the reference's at bfloat16.

    Each token whose top-k set differs between the two runs in some MoE
    layer must be a near-tie: the reference router's k-th and (k+1)-th
    probabilities within NEAR_TIE of the k-th. Such a token, or one whose
    capacity keep differs (a flip moves the later choices of its experts),
    and every later position of its sequence (attention carries it on),
    is left out; the rest, at least half, are held to MOE_BF16_TOL.
    """
    b, t = got.shape[:2]
    k = cfg.top_k
    cap = max(math.ceil(b * t * k / cfg.num_experts * cfg.capacity_factor),
              8)
    assert len(routes["port"]) == len(routes["ref"]) > 0
    clean = np.ones((b, t), bool)
    for (_, p_idx), (r_probs, r_idx) in zip(routes["port"], routes["ref"]):
        p_keep, r_keep = _kept(p_idx, cap), _kept(r_idx, cap)
        for tok in range(b * t):
            if set(p_idx[tok]) != set(r_idx[tok]):
                top = np.sort(r_probs[tok])[::-1]
                gap = (top[k - 1] - top[k]) / top[k - 1]
                assert gap < NEAR_TIE, (tok, gap)
            if set(p_idx[tok]) != set(r_idx[tok]) or \
                    p_keep[tok] != r_keep[tok]:
                clean[tok // t, tok % t:] = False
    assert clean.sum() >= clean.size // 2, clean
    g, w = _np(got), _np(want)
    err = np.abs(g - w)[clean].max()
    assert err <= MOE_BF16_TOL * np.abs(w).max(), err


def test_embedding_scale_is_rounded_to_the_activations_dtype():
    """sqrt(d_model) is rounded to bf16 before the multiply, as the
    reference's ``jnp.asarray(sqrt(d), adt)``: 55.43 -> 55.5 at 3072."""
    cfg = dataclasses.replace(configs.get_smoke_config("phi4_mini_3p8b"),
                              d_model=3072)
    params = {"embed": {"embedding": torch.ones((4, 3072))}}
    x = Model(cfg)._embed(params, torch.tensor([[1]]), torch.bfloat16)
    assert x.dtype == torch.bfloat16 and float(x[0, 0, 0]) == 55.5


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_both(arch, steps, b=2, max_len=32):
    # no MoE capacity drops in the forward, as in the reference's
    # test_prefill_decode_equivalence: a drop depends on the batch's other
    # tokens, which a decode step does not see
    pc, rc = (dataclasses.replace(c, capacity_factor=8.0)
              for c in _cfgs(arch))
    pp, rp = _both_params(arch)
    tp, tr = _tokens(pc, b, steps, seed=5)
    pm, rm = Model(pc), RefModel(rc)
    pcache = pm.init_cache(b, max_len, dtype=torch.float32, device=CPU)
    rcache = rm.init_cache(batch=b, max_len=max_len, dtype=jnp.float32)
    got, want = [], []
    for i in range(steps):
        lp, pcache, _ = pm.decode_step(pp, pcache, tp[:, i:i + 1], i)
        lr, rcache, _ = rm.decode_step(rp, rcache, tr[:, i:i + 1],
                                       jnp.int32(i))
        got.append(lp[:, 0])
        want.append(np.asarray(lr[:, 0]))
    full, _ = pm.apply(pp, {"tokens": tp}, block_q=0)
    return torch.stack(got, 1), np.stack(want, 1), full, pcache, rcache


@pytest.mark.parametrize("arch", PORTED)
def test_decode_step_matches_reference_and_forward(arch):
    got, want, full, pcache, rcache = _decode_both(arch, 8)
    _close(got, want, TOL["float32"])
    _close(got, full, DECODE_TOL)
    # the cache trees: the reference's keys, nesting and stacked axes
    flat_p = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, pcache))
    flat_r = jax.tree_util.tree_flatten_with_path(rcache)
    assert [p for p, _ in flat_p[0]] == [p for p, _ in flat_r[0]]
    for (_, a), (_, b) in zip(flat_p[0], flat_r[0]):
        _close(a, b, TOL["float32"])


def test_gemma3_ring_buffer_wraps():
    """24 decode steps against Gemma-3 SMOKE's 16-slot local caches: the
    ring writes wrap and the slots' positions (floor-mod) keep the window
    right, against the reference's decode and the port's own forward."""
    cfg = configs.get_smoke_config("gemma3_1b")
    assert cfg.window_size == 16
    got, want, full, pcache, _ = _decode_both("gemma3_1b", 24, max_len=32)
    assert pcache["prefix"]["0"]["k"].shape[1] == 16       # local: window
    assert pcache["prefix"]["5"]["k"].shape[1] == 32       # global: max_len
    _close(got, want, TOL["float32"])
    _close(got, full, DECODE_TOL)


def test_cache_write_clamps_like_dynamic_update_slice():
    """A T-entry write whose slot would pass the end of the cache lands at
    S - T, as ``jax.lax.dynamic_update_slice_in_dim`` clamps it; the ring
    positions are a floor-mod (``torch.remainder``)."""
    buf = np.zeros((1, 8, 1, 2), np.float32)
    new = np.arange(6, dtype=np.float32).reshape(1, 3, 1, 2) + 1
    for slot in (0, 5, 6, 7):
        got = attention._cache_write(torch.from_numpy(buf.copy()),
                                     torch.from_numpy(new), slot)
        want = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(buf),
                                                   jnp.asarray(new), slot,
                                                   axis=1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos, s = 5, 8
    got = pos - torch.remainder(pos - torch.arange(s), s)
    want = pos - (pos - jnp.arange(s)) % s
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < 0).sum() == 2               # unwritten slots


@pytest.mark.parametrize("kind,softcap", [
    ("local", 0.0),        # banded chunks: a band of 128 keys of S = 256
    ("bidir", 30.0),       # the softcap
])
def test_sdpa_chunked_paths_match_reference(rng, kind, softcap):
    b, t, kh, g, hd = 1, 256, 2, 2, 8
    window, block_q = 16, 64
    q = rng.standard_normal((b, t, kh, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kh, hd)).astype(np.float32)
    pos = np.arange(t)
    got = attention._sdpa(*map(torch.from_numpy, (q, k, v, pos, pos)),
                          kind, window, block_q, softcap)
    want = ref_attention._sdpa(*map(jnp.asarray, (q, k, v, pos, pos)),
                               kind, window, block_q, softcap)
    _close(got, want, 1e-5)


def test_cross_attention_matches_reference(rng):
    _, rc = _cfgs("phi4_mini_3p8b")
    pc = _port_cfg(rc)
    tree = jax.tree.map(np.asarray, ref_attention.make_attn_params(
        jax.random.PRNGKey(1), rc.d_model, rc.num_heads, rc.num_kv_heads,
        rc.head_dim))
    x = rng.standard_normal((2, 5, rc.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 7, rc.d_model)).astype(np.float32)
    got, gc = attention.attention(
        params_from_numpy(tree, device=CPU), torch.from_numpy(x), cfg=pc,
        kind="cross", positions=torch.arange(5),
        kv_source=torch.from_numpy(src), use_rope=False)
    want, wc = ref_attention.attention(
        tree, jnp.asarray(x), cfg=rc, kind="cross",
        positions=jnp.arange(5), kv_source=jnp.asarray(src), use_rope=False)
    _close(got, want, 1e-5)
    _close(gc["k"], wc["k"], 1e-5)


# ---------------------------------------------------------------------------
# protection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_protected_apply_matches_unprotected(arch):
    """Every linear protected: the logits of the unprotected forward, no
    flag, and a detection score above 0 (the checksums' rounding noise)
    but under the threshold."""
    pc, _ = _cfgs(arch, protect=True)
    pp, _ = _both_params(arch)
    tp, _ = _tokens(pc, 2, 16)
    got, aux = Model(pc).apply(pp, {"tokens": tp}, block_q=0)
    plain, _ = Model(_cfgs(arch)[0]).apply(pp, {"tokens": tp}, block_q=0)
    _close(got, plain, TOL["float32"])
    assert float(aux["ft_flagged"]) == float(aux["ft_corrected"]) == 0.0
    assert 0.0 < float(aux["ft_max_score"]) < pc.ft.threshold


# Phi-4-mini's structure at tile-aligned widths (K and N multiples of 128),
# so that the fused path runs (its plain version on the CPU)
ALIGNED = dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
               head_dim=64, d_ff=256, vocab_size=512)


@pytest.mark.parametrize("site,row", [(0, 1), (3, 0), (6, 1)])
def test_decode_on_the_padded_fused_path(site, row):
    """A decode step's protected products (M = the batch, 2) on the fused
    path pad M to 64 rows: the logits equal the eager path's, and a fault
    at ``site`` of every block is detected and corrected in each of them."""
    base = dataclasses.replace(configs.get_smoke_config("phi4_mini_3p8b"),
                               dtype="float32", **ALIGNED)
    models = {be: Model(dataclasses.replace(base, ft=dataclasses.replace(
        base.ft, protect_linears=True, threshold=1e-3, gemm_backend=be)))
        for be in ("eager", "fused")}
    params = models["eager"].init(torch.Generator().manual_seed(0),
                                  device=CPU)
    toks = torch.tensor([[7], [300]], dtype=torch.int32)
    inj = torch.tensor([[site, row, 5.0, 1.0, 40.0]])
    out = {}
    for be, m in models.items():
        for armed in (None, inj):
            cache = m.init_cache(2, 8, dtype=torch.float32, device=CPU)
            logits, _, aux = m.decode_step(params, cache, toks, 0,
                                           inject=armed)
            out[be, armed is None] = logits
            want = 0 if armed is None else ALIGNED["num_layers"]
            assert float(aux["ft_flagged"]) == want, (be, armed)
            assert float(aux["ft_corrected"]) == want, (be, armed)
    _close(out["fused", True], out["eager", True], 1e-5)
    _close(out["fused", False], out["fused", True], 1e-4)


# ---------------------------------------------------------------------------
# counts and grouping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_count_params_matches_reference_without_allocating(arch):
    cfg = configs.get_config(arch)
    tree = Model(cfg).init(None, device="meta")
    leaves = jax.tree_util.tree_leaves(tree)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    n = count_params(cfg)
    assert n == ref_count_params(ref_configs.get_config(arch))
    assert model_flops_per_token(cfg, n) == ref_flops_per_token(
        ref_configs.get_config(arch), n) == 6.0 * (
            n - cfg.inactive_expert_params())


# the reference's ``test_param_counts_in_published_range``, for what is ported
PUBLISHED = {"qwen15_110b": (100e9, 120e9), "phi3_medium_14b": (12e9, 16e9),
             "phi4_mini_3p8b": (3.0e9, 4.6e9), "gemma3_1b": (0.7e9, 1.3e9),
             "xlstm_350m": (0.25e9, 0.50e9),
             "recurrentgemma_2b": (2.0e9, 3.2e9),
             "deepseek_v3_671b": (600e9, 700e9),
             "llama4_maverick": (350e9, 440e9)}


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_in_published_range(arch):
    lo, hi = PUBLISHED[arch]
    assert lo <= count_params(configs.get_config(arch)) <= hi


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_layer_groups_match_reference(arch, which):
    get = (ref_configs.get_config if which == "full"
           else ref_configs.get_smoke_config)
    rc = get(arch)
    pc = _port_cfg(rc)
    assert transformer.effective_kinds(pc) == \
        ref_transformer.effective_kinds(rc)
    assert dataclasses.asdict(transformer.layer_groups(pc)) == \
        dataclasses.asdict(ref_transformer.layer_groups(rc))
    with transformer.force_unroll(), ref_transformer.force_unroll():
        assert dataclasses.asdict(transformer.layer_groups(pc)) == \
            dataclasses.asdict(ref_transformer.layer_groups(rc))


def test_params_tree_matches_reference_structure():
    for arch in PORTED:
        pc, _ = _cfgs(arch)
        got = Model(pc).init(None, device="meta")
        want = _ref_params_np(arch)
        gl = jax.tree_util.tree_flatten_with_path(got)[0]
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in gl] == [p for p, _ in wl], arch
        assert [tuple(t.shape) for _, t in gl] == \
            [a.shape for _, a in wl], arch


# ---------------------------------------------------------------------------
# the encoder-decoder's and the VLM's configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_encdec_and_vlm_configs_match_reference(arch):
    """Whisper's and InternVL2's full and SMOKE configs are the
    reference's, field for field, and a model builds on each."""
    for get in ("get_config", "get_smoke_config"):
        a = dataclasses.asdict(getattr(configs, get)(arch))
        b = dataclasses.asdict(getattr(ref_configs, get)(arch))
        assert a.pop("ft") == b.pop("ft") and a == b, get
        Model(getattr(configs, get)(arch))
