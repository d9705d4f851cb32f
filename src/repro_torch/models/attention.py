"""Attention blocks: GQA (full / local-window / bidirectional / cross) and
DeepSeek-style MLA with compressed KV. Query-chunked score computation
keeps the activation peak at ``block_q * S`` instead of ``S^2``. Port of
``repro.models.attention``.

Layouts: x (B, T, D); q (B, T, KH, G, hd); k/v (B, S, KH, hd).
Decode caches: {"k": (B, S, KH, hd), "v": ...}; MLA caches only the
latent: {"ckv": (B, S, r_kv), "kr": (B, S, r_rope)}. Both are written in
place (the reference returns updated copies; the returned cache holds the
same tensors, so a caller that keeps the old cache sees the new entries).

The score and value products are plain ``torch`` einsums, as the reference
leaves them to ``jnp.einsum`` outside any Pallas kernel; the scores are
float32 products of the activations (``preferred_element_type``), the
masking and softmax the reference's letter for letter (``NEG_INF``, the
softcap, ring slots with a negative position). The protected projections
go through :func:`~repro_torch.models.layers.dense`; MLA's up-projections
``w_uk``/``w_uv`` (the halves of ``wkv_b``) are plain einsums there, as in
the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from . import layers
from .layers import apply_rope, dense, dense_init, rope

__all__ = ["make_attn_params", "attention", "make_mla_params",
           "mla_attention", "init_kv_cache", "init_mla_cache"]

NEG_INF = -2.0 ** 30


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def _mask(q_pos, k_pos, kind: str, window: int):
    """(..., Tq, Tk) boolean mask. q_pos/k_pos: integer position vectors."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if kind == "bidir" or kind == "cross":
        return torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                          dtype=torch.bool, device=q.device)
    causal = (k <= q) & (k >= 0)  # k < 0 marks unwritten ring-buffer slots
    if kind == "local":
        return causal & (k > q - window)
    return causal


# ---------------------------------------------------------------------------
# GQA core
# ---------------------------------------------------------------------------

def make_attn_params(gen, d_model, num_heads, num_kv_heads, head_dim, *,
                     qkv_bias=False, dtype=torch.float32,
                     device="cuda") -> dict:
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(gen, (d_model, num_heads * head_dim), **kw),
        "wk": dense_init(gen, (d_model, num_kv_heads * head_dim), **kw),
        "wv": dense_init(gen, (d_model, num_kv_heads * head_dim), **kw),
        "wo": dense_init(gen, (num_heads * head_dim, d_model), **kw),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((num_heads * head_dim,), **kw)
        p["bk"] = torch.zeros((num_kv_heads * head_dim,), **kw)
        p["bv"] = torch.zeros((num_kv_heads * head_dim,), **kw)
    return p


def _slice(t, lo, hi, axis):
    return t.narrow(axis if axis >= 0 else t.dim() + axis, lo, hi - lo)


def _sdpa(q, k, v, q_pos, k_pos, kind, window, block_q, softcap=0.0):
    """Query-chunked scaled dot-product attention.

    q: (B, T, KH, G, hd); k, v: (B, S, KH, hd) -> (B, T, KH, G, hd).

    Local-window chunks are *banded*: each query chunk only reads the
    K/V slice that its window can see (scores cost bq*(bq+window) instead
    of bq*S).
    """
    b, t, kh, g, hd = q.shape
    s = k.shape[1]
    scale = float(1.0 / np.sqrt(hd))

    def one_chunk(qc, qp, kc, vc, kp):
        # qc: (B, bq, KH, G, hd); kc/vc: (B, Sc, KH, *); float32 scores of
        # the activations' products
        scores = torch.einsum("btkgh,bskh->bkgts", qc.float(),
                              kc.float()) * scale
        if softcap > 0:
            scores = torch.tanh(scores / softcap) * softcap
        m = _mask(qp, kp, kind, window)          # (bq, Sc)
        scores = torch.where(m[None, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(vc.dtype)
        return torch.einsum("bkgts,bskh->btkgh", probs, vc)

    if block_q <= 0 or t <= block_q or t % block_q:
        return one_chunk(q, q_pos, k, v, k_pos)
    nchunk = t // block_q
    banded = (kind == "local" and s == t and window < s)
    band = min(s, ((window + block_q + 127) // 128) * 128)
    outs = []
    for i in range(nchunk):
        qc = _slice(q, i * block_q, (i + 1) * block_q, 1)
        pc = _slice(q_pos, i * block_q, (i + 1) * block_q, -1)
        if banded:
            lo = max(0, min((i + 1) * block_q - band, s - band))
            kc = _slice(k, lo, lo + band, 1)
            vc = _slice(v, lo, lo + band, 1)
            kp = _slice(k_pos, lo, lo + band, -1)
        elif kind == "causal" and s == t:
            # causal triangle: chunk i sees only K[0:(i+1)*bq]
            hi = (i + 1) * block_q
            kc, vc = _slice(k, 0, hi, 1), _slice(v, 0, hi, 1)
            kp = _slice(k_pos, 0, hi, -1)
        else:
            kc, vc, kp = k, v, k_pos
        outs.append(one_chunk(qc, pc, kc, vc, kp))
    return torch.cat(outs, dim=1)


def _proj(params, w, b, x, ft):
    return dense({"w": params[w], **({"b": params[b]} if b in params
                                     else {})}, x, ft=ft)


def _cache_write(buf, new, slot: int):
    """``dynamic_update_slice_in_dim(buf, new, slot, axis=1)`` in place:
    like the reference, the start is clamped so that the T new entries
    fit (a ring write that would pass the end lands at ``S - T``)."""
    s_c, t = buf.shape[1], new.shape[1]
    start = min(max(slot, 0), s_c - t)
    buf[:, start:start + t] = new.to(buf.dtype)
    return buf


def attention(params, x, *, cfg, kind: str, positions, cache=None,
              cache_pos=None, kv_source=None, theta=None, use_rope=True,
              block_q=1024, ft=None):
    """GQA attention; returns (out, new_cache).

    * train/prefill: ``cache=None`` — self-attention over x.
    * decode: ``cache`` holds (B, S, KH, hd) K/V; ``cache_pos`` is the
      write index (an int); x has T=1 (or a small chunk).
    * cross-attention: ``kv_source`` supplies the encoder output; cache may
      hold its precomputed K/V.
    """
    b, t, d = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kh
    theta = cfg.rope_theta if theta is None else theta

    q = _proj(params, "wq", "bq", x, ft).reshape(b, t, kh, g, hd)

    if kind == "cross" and cache is not None and "k" in cache and \
            kv_source is None:
        k, v = cache["k"], cache["v"]
        new_cache = cache
        k_pos = torch.arange(k.shape[1], device=x.device)
    else:
        src = x if kv_source is None else kv_source
        k = _proj(params, "wk", "bk", src, ft)
        v = _proj(params, "wv", "bv", src, ft)
        k = k.reshape(b, src.shape[1], kh, hd)
        v = v.reshape(b, src.shape[1], kh, hd)
        if use_rope and kind != "cross":
            # new K entries sit at the same absolute positions as the queries
            k = _rope_kv(k, positions, hd, theta, x.dtype)
        if cache is not None and kind != "cross":
            # Ring-buffer write: windowed caches (local attention) hold only
            # the last `window` entries; full caches degenerate to slot==pos.
            pos = int(cache_pos)
            s_c = cache["k"].shape[1]
            slot = pos % s_c
            k = _cache_write(cache["k"], k, slot)
            v = _cache_write(cache["v"], v, slot)
            new_cache = {"k": k, "v": v}
            # absolute position held by each ring slot (-ve => unwritten);
            # torch.remainder is a floor-mod, as jnp's %
            k_pos = pos - torch.remainder(
                pos - torch.arange(s_c, device=x.device), s_c)
        elif kind == "cross":
            new_cache = {"k": k, "v": v}
            k_pos = torch.arange(k.shape[1], device=x.device)
        else:
            new_cache = None
            k_pos = positions

    if use_rope and kind != "cross":
        qcos, qsin = rope(positions, hd, theta, x.dtype)
        q = apply_rope(q.reshape(b, t, kh * g, hd), qcos[None], qsin[None]
                       ).reshape(b, t, kh, g, hd)

    out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), positions, k_pos, kind,
                cfg.window_size, block_q, cfg.logit_softcap)
    out = out.reshape(b, t, h * hd)
    out = dense({"w": params["wo"]}, out, ft=ft)
    return out, new_cache


def _rope_kv(k, positions, hd, theta, dtype):
    """Apply rope to K at the given absolute positions."""
    kcos, ksin = rope(positions, hd, theta, dtype)
    b, s, kh, _ = k.shape
    return apply_rope(k.reshape(b, s, kh, hd), kcos[None], ksin[None]
                      ).reshape(b, s, kh, hd)


def init_kv_cache(cfg, batch, max_len, dtype=torch.bfloat16, layers_shape=(),
                  device="cuda"):
    shape = tuple(layers_shape) + (batch, max_len, cfg.num_kv_heads,
                                   cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2/V3): low-rank compressed KV + decoupled RoPE
# ---------------------------------------------------------------------------

def make_mla_params(gen, cfg, dtype=torch.float32, device="cuda") -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device)
    p = {}
    if rq:
        p["wq_a"] = dense_init(gen, (d, rq), **kw)
        p["q_norm"] = layers.make_norm_params(rq, device=device)
        p["wq_b"] = dense_init(gen, (rq, h * (dn + dr)), **kw)
    else:
        p["wq"] = dense_init(gen, (d, h * (dn + dr)), **kw)
    p["wkv_a"] = dense_init(gen, (d, rkv + dr), **kw)
    p["kv_norm"] = layers.make_norm_params(rkv, device=device)
    p["wkv_b"] = dense_init(gen, (rkv, h * (dn + dv)), **kw)
    p["wo"] = dense_init(gen, (h * dv, d), **kw)
    return p


def mla_attention(params, x, *, cfg, positions, cache=None, cache_pos=None,
                  block_q=1024, ft=None):
    """MLA self-attention (causal). Returns (out, new_cache).

    Prefill: reconstructs full K/V from the latent (naive path) and runs
    :func:`_sdpa` with K = H heads of one query each.
    Decode: the weight-absorbed path — float32 scores and the values
    computed directly against the cached latent, O(S * (r_kv + d_rope))
    per step; the latent is written into ``cache`` in place at
    ``cache_pos`` (an int).
    """
    b, t, d = x.shape
    h = cfg.num_heads
    rkv = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    # queries
    if cfg.q_lora_rank:
        qa = dense({"w": params["wq_a"]}, x, ft=ft)
        qa = layers.rmsnorm(params["q_norm"], qa, cfg.norm_eps)
        q = dense({"w": params["wq_b"]}, qa, ft=ft)
    else:
        q = dense({"w": params["wq"]}, x, ft=ft)
    q = q.reshape(b, t, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope(positions, dr, cfg.rope_theta, x.dtype)
    q_rope = apply_rope(q_rope, cos[None], sin[None])

    # latent kv
    kv = dense({"w": params["wkv_a"]}, x, ft=ft)
    ckv, k_rope = kv[..., :rkv], kv[..., rkv:]
    ckv = layers.rmsnorm(params["kv_norm"], ckv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None], cos[None], sin[None])[:, :, 0]

    wkv_b = params["wkv_b"].reshape(rkv, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]

    if cache is None:
        # prefill/train: reconstruct per-head K/V (naive path)
        k_nope = torch.einsum("btr,rhd->bthd", ckv, w_uk.to(ckv.dtype))
        v = torch.einsum("btr,rhd->bthd", ckv, w_uv.to(ckv.dtype))
        k = torch.cat([k_nope, k_rope[:, :, None].expand(b, t, h, dr)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = _sdpa(qq.reshape(b, t, h, 1, dn + dr), k, v, positions,
                    positions, "causal", cfg.window_size, block_q)
        out = out.reshape(b, t, h * dv)
        new_cache = None
    else:
        # decode: absorbed path against the latent cache
        pos = int(cache_pos)
        ckv_c = _cache_write(cache["ckv"], ckv, pos)
        kr_c = _cache_write(cache["kr"], k_rope, pos)
        new_cache = {"ckv": ckv_c, "kr": kr_c}
        s = ckv_c.shape[1]
        # absorb W_uk into q: (b,t,h,dn) x (r,h,dn) -> (b,t,h,r)
        q_abs = torch.einsum("bthd,rhd->bthr", q_nope,
                             w_uk.to(q_nope.dtype))
        # float32 scores of the activations' products
        scores = (torch.einsum("bthr,bsr->bhts", q_abs.float(),
                               ckv_c.to(q_abs.dtype).float())
                  + torch.einsum("bthd,bsd->bhts", q_rope.float(),
                                 kr_c.to(q_rope.dtype).float()))
        scores = scores / float(np.sqrt(dn + dr))
        m = _mask(positions, torch.arange(s, device=x.device), "causal",
                  cfg.window_size)
        scores = torch.where(m[None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhts,bsr->bthr", probs, ckv_c.to(x.dtype))
        out = torch.einsum("bthr,rhd->bthd", ctx, w_uv.to(x.dtype))
        out = out.reshape(b, t, h * dv)

    out = dense({"w": params["wo"]}, out, ft=ft)
    return out, new_cache


def init_mla_cache(cfg, batch, max_len, dtype=torch.bfloat16, layers_shape=(),
                   device="cuda"):
    lead = tuple(layers_shape) + (batch, max_len)
    return {
        "ckv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype,
                           device=device),
        "kr": torch.zeros(lead + (cfg.qk_rope_head_dim,), dtype=dtype,
                          device=device),
    }
