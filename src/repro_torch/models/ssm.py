"""Recurrent blocks: RG-LRU (RecurrentGemma/Griffin), mLSTM + sLSTM (xLSTM).
Port of ``repro.models.ssm``, function for function: the same param keys
and shapes, the same protected products in the same call order.

The RG-LRU's scan over time is a log-depth doubling (Hillis-Steele) scan
on the reference's ``associative_scan`` combine; the LSTM variants keep
the exact sequential loop over T with float32 state, as the reference's
``jax.lax.scan``. All of them are plain torch: the reference runs them
outside any Pallas kernel. The protected projections go through
:func:`~repro_torch.models.layers.dense`; the RG-LRU's gate products
``w_a``/``w_x`` and the mLSTM's ``w_ig``/``w_fg`` are unprotected there
and here, so the site numbering is the reference's.

Every block takes an optional decode ``state`` (a dict of tensors) and
returns ``(y, new_state)``. With a state, the new one is written into the
given tensors in place (``copy_``, each keeping its dtype) and that dict
is returned: the model's cache tree holds views into its stacked slots
and keeps no returned tree, as for the KV caches.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import layers
from .layers import dense, dense_init

__all__ = [
    "make_rglru_params", "rglru_block", "init_rglru_state",
    "make_mlstm_params", "mlstm_block", "init_mlstm_state",
    "make_slstm_params", "slstm_block", "init_slstm_state", "silu", "gelu",
]

_C = 8.0  # RG-LRU decay sharpness constant (Griffin)


# The activations of a model with recurrent mixers, as the reference's
# ``jax.nn`` operations: each operation rounded to the activations' dtype,
# each constant rounded to it first (JAX's weakly typed scalars).
# ``F.silu`` and ``F.gelu`` compute in float32 and round once, a bfloat16
# step off in a third to a half of the elements, which the random-weight
# recurrences amplify past the bfloat16 tolerance. The models without a
# recurrent mixer keep the fused ones (one kernel, not five to eight).

@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype: torch.dtype) -> tuple[float, float]:
    return tuple(torch.tensor(v, dtype=dtype).item()
                 for v in (math.sqrt(2 / math.pi), 0.044715))


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    c, k = _gelu_constants(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


class _Silu(torch.autograd.Function):
    """``jax.nn.silu``'s forward, op by op, with ``jax.nn.sigmoid``'s
    derivative ``t (1 - t)`` (``lax.logistic``'s): autograd through ``exp``
    and ``reciprocal`` gives ``0 * inf = nan`` where ``exp(-x)`` overflows,
    x below -88.7 in float32 and bfloat16 alike."""

    @staticmethod
    def forward(ctx, x):
        t = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, t)
        return x * t

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        return g * t + (g * x) * (t * (1 - t))


def silu(x):
    """``jax.nn.silu``: ``x * (1 / (1 + exp(-x)))`` (``reciprocal`` is one
    kernel; a Python ``1 /`` is a reciprocal and a multiply), its gradient
    finite everywhere (``_Silu``)."""
    return _Silu.apply(x)


def _write_state(state: dict, new: dict) -> dict:
    """Copy each of ``new``'s tensors into ``state``'s (in its dtype)."""
    for k, v in new.items():
        state[k].copy_(v)
    return state


# ---------------------------------------------------------------------------
# causal depthwise conv1d (shared by rglru / mlstm)
# ---------------------------------------------------------------------------

def _causal_conv(x, w, state=None):
    """x: (B, T, C), w: (K, C) depthwise. state: (B, K-1, C) carry or None.

    Returns (y, new_state). Train path pads with zeros; decode path uses the
    carried last K-1 inputs.
    """
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return y, new_state


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------

def make_rglru_params(gen, cfg, dtype=torch.float32, device="cuda"):
    d, w = cfg.d_model, cfg.lru_width
    kw = dict(dtype=dtype, device=device)
    return {
        "w_in_gate": dense_init(gen, (d, w), **kw),     # gelu branch
        "w_in_rec": dense_init(gen, (d, w), **kw),      # recurrent branch
        "conv_w": dense_init(gen, (cfg.conv1d_width, w), **kw),
        "w_a": dense_init(gen, (w, w), **kw),           # recurrence gate
        "w_x": dense_init(gen, (w, w), **kw),           # input gate
        # Lambda init: softplus(lam) in [2, 6] -> decay a in ~[0.86, 0.999]
        "lam": torch.as_tensor(np.linspace(2.0, 6.0, w), dtype=torch.float32
                               ).to(device),
        "w_out": dense_init(gen, (w, d), **kw),
    }


def _rglru_coeffs(params, u):
    """u: (B, T, W) conv output -> (a, b) recurrence coefficients (f32)."""
    uf = u.float()
    r = torch.sigmoid(dense({"w": params["w_a"]}, uf))
    i = torch.sigmoid(dense({"w": params["w_x"]}, uf))
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def _linear_scan(a, b):
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, as a
    doubling scan: step s combines each element with the one ``s`` before
    it by the reference's ``(r0 l0, r0 l1 + r1)``, both read from the old
    values, so log2(T) steps give every prefix. Products of decays stay
    products (``log a`` reaches about -48 a step, so a sum of logs would
    underflow within a few)."""
    t, s = a.shape[1], 1
    while s < t:
        a, b = (torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1),
                torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1))
        s *= 2
    return b


def rglru_block(params, x, *, state=None, ft=None):
    """Griffin recurrent block. x: (B, T, D) -> (y, new_state).

    state: None (train) or {"h": (B, W), "conv": (B, K-1, W)} (decode),
    written in place.
    """
    gate = gelu(dense({"w": params["w_in_gate"]}, x, ft=ft))
    u = dense({"w": params["w_in_rec"]}, x, ft=ft)
    conv_state = None if state is None else state["conv"]
    u, new_conv = _causal_conv(u, params["conv_w"], conv_state)
    a, b = _rglru_coeffs(params, u)

    if state is None:
        h = _linear_scan(a, b)
    else:
        h = state["h"].float()
        hs = []
        for t in range(x.shape[1]):  # decode: t is 1 (or tiny), unrolled
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        h = torch.stack(hs, dim=1)
        state = _write_state(state, {"h": h[:, -1], "conv": new_conv})
    y = dense({"w": params["w_out"]}, h.to(x.dtype) * gate, ft=ft)
    return y, state


def init_rglru_state(cfg, batch, dtype=torch.bfloat16, device="cuda",
                     layers_shape=()):
    w = cfg.lru_width
    return {
        "h": torch.zeros(layers_shape + (batch, w), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(layers_shape + (batch, cfg.conv1d_width - 1, w),
                            dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix-memory cell, exponential gating, m-stabilized
# ---------------------------------------------------------------------------

def make_mlstm_params(gen, cfg, dtype=torch.float32, device="cuda"):
    d = cfg.d_model
    e = cfg.expand_factor * d
    h = cfg.num_heads
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_up": dense_init(gen, (d, 2 * e), **kw),
        "conv_w": dense_init(gen, (cfg.conv1d_width, e), **kw),
        "wq": dense_init(gen, (e, e), **kw),
        "wk": dense_init(gen, (e, e), **kw),
        "wv": dense_init(gen, (e, e), **kw),
        "w_ig": dense_init(gen, (e, h), **f32),
        "w_fg": dense_init(gen, (e, h), **f32),
        "fg_bias": torch.full((h,), 4.0, **f32),  # open forget gates
        "out_norm": layers.make_norm_params(e, device=device),
        "w_down": dense_init(gen, (e, d), **kw),
    }


def _mlstm_cell_scan(q, k, v, logi, logf, c0, n0, m0):
    """Exact sequential mLSTM over time (f32 state, m-stabilized).

    q,k,v: (B, T, H, hd); logi, logf: (B, T, H).
    state: C (B, H, hd, hd), n (B, H, hd), m (B, H).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    c, n, m = c0, n0, m0
    outs = []
    for t in range(q.shape[1]):
        qt, kt, vt, li, lf = q[:, t], k[:, t], v[:, t], logi[:, t], logf[:, t]
        m_new = torch.maximum(lf + m, li)
        fg = torch.exp(lf + m - m_new)[..., None]
        ig = torch.exp(li - m_new)[..., None]
        c = fg[..., None] * c + ig[..., None] * (kt[..., :, None] *
                                                 vt[..., None, :])
        n = fg * n + ig * kt
        num = torch.einsum("bhd,bhde->bhe", qt * scale, c)
        den = torch.abs(torch.einsum("bhd,bhd->bh", qt * scale, n))
        den = torch.maximum(den, torch.exp(-m_new))[..., None]
        outs.append(num / den)
        m = m_new
    return torch.stack(outs, dim=1), (c, n, m)


def mlstm_block(params, x, *, cfg, state=None, ft=None):
    """x: (B, T, D) -> (y, new_state). state carries (C, n, m, conv),
    written in place."""
    b, t, d = x.shape
    e = cfg.expand_factor * d
    h = cfg.num_heads
    hd = e // h

    up = dense({"w": params["w_up"]}, x, ft=ft)
    xm, xz = up[..., :e], up[..., e:]
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv(xm, params["conv_w"], conv_state)
    xc = silu(xc)

    q = dense({"w": params["wq"]}, xc, ft=ft).reshape(b, t, h, hd)
    k = dense({"w": params["wk"]}, xc, ft=ft).reshape(b, t, h, hd)
    v = dense({"w": params["wv"]}, xm, ft=ft).reshape(b, t, h, hd)
    logi = xc.float() @ params["w_ig"]
    logf = F.logsigmoid(xc.float() @ params["w_fg"] + params["fg_bias"])

    f32 = dict(dtype=torch.float32, device=x.device)
    if state is None:
        c0 = torch.zeros((b, h, hd, hd), **f32)
        n0 = torch.zeros((b, h, hd), **f32)
        m0 = torch.zeros((b, h), **f32)
    else:
        c0, n0, m0 = (state[key].float() for key in ("c", "n", "m"))
    out, (c, n, m) = _mlstm_cell_scan(q.float(), k.float(), v.float(), logi,
                                      logf, c0, n0, m0)
    out = out.reshape(b, t, e).to(x.dtype)
    out = layers.rmsnorm(params["out_norm"], out, cfg.norm_eps)
    out = out * silu(xz)
    y = dense({"w": params["w_down"]}, out, ft=ft)
    if state is not None:
        state = _write_state(state, {"c": c, "n": n, "m": m,
                                     "conv": new_conv})
    return y, state


def init_mlstm_state(cfg, batch, dtype=torch.bfloat16, device="cuda",
                     layers_shape=()):
    e = cfg.expand_factor * cfg.d_model
    h = cfg.num_heads
    hd = e // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros(layers_shape + (batch, h, hd, hd), **f32),
        "n": torch.zeros(layers_shape + (batch, h, hd), **f32),
        "m": torch.zeros(layers_shape + (batch, h), **f32),
        "conv": torch.zeros(layers_shape + (batch, cfg.conv1d_width - 1, e),
                            dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar-memory cell with block-diagonal recurrence
# ---------------------------------------------------------------------------

def make_slstm_params(gen, cfg, dtype=torch.float32, device="cuda"):
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    kw = dict(dtype=dtype, device=device)
    # the reference's FFN width, Python's round (half to even) included
    ffs = int(round(d * 4 / 3 / 64)) * 64
    p = {}
    for gate in ("i", "f", "z", "o"):
        p[f"w_{gate}"] = dense_init(gen, (d, d), **kw)
        p[f"r_{gate}"] = dense_init(gen, (h, hd, hd), **kw)
    p["f_bias"] = torch.full((d,), 4.0, dtype=torch.float32, device=device)
    p["out_norm"] = layers.make_norm_params(d, device=device)
    p["ffn"] = layers.make_mlp_params(gen, d, ffs, "swiglu", dtype,
                                      device=device)
    return p


def slstm_block(params, x, *, cfg, state=None, ft=None):
    """x: (B, T, D) -> (y, new_state). Strictly sequential (h->h
    recurrence); a given state is written in place."""
    b, t, d = x.shape
    h = cfg.num_heads
    hd = d // h

    wi = dense({"w": params["w_i"]}, x, ft=ft).float()
    wf = dense({"w": params["w_f"]}, x, ft=ft).float() + params["f_bias"]
    wz = dense({"w": params["w_z"]}, x, ft=ft).float()
    wo = dense({"w": params["w_o"]}, x, ft=ft).float()

    if state is None:
        hidden, cell, norm, stab = (
            torch.zeros((b, d), dtype=torch.float32, device=x.device)
            for _ in range(4))
    else:
        hidden, cell, norm, stab = (state[k].float()
                                    for k in ("h", "c", "n", "m"))

    rw = {g: params[f"r_{g}"].float() for g in "ifzo"}

    def rmat(hprev, g):
        hh = hprev.reshape(b, h, hd)
        return torch.einsum("bhd,hde->bhe", hh, rw[g]).reshape(b, d)

    hs = []
    for s in range(t):
        it = wi[:, s] + rmat(hidden, "i")
        ftg = wf[:, s] + rmat(hidden, "f")
        zt = torch.tanh(wz[:, s] + rmat(hidden, "z"))
        ot = torch.sigmoid(wo[:, s] + rmat(hidden, "o"))
        logf = F.logsigmoid(ftg)
        m_new = torch.maximum(logf + stab, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(logf + stab - m_new)
        cell = f_s * cell + i_s * zt
        norm = f_s * norm + i_s
        hidden = ot * cell / torch.clamp(norm, min=1.0)
        stab = m_new
        hs.append(hidden)
    out = torch.stack(hs, dim=1).to(x.dtype)
    out = layers.rmsnorm(params["out_norm"], out, cfg.norm_eps)
    # cell output + its gated FFN (caller adds the outer residual)
    y = out + layers.swiglu(params["ffn"], out, ft=ft, silu=silu)
    if state is not None:
        state = _write_state(state, {"h": hidden, "c": cell, "n": norm,
                                     "m": stab})
    return y, state


def init_slstm_state(cfg, batch, dtype=torch.bfloat16, device="cuda",
                     layers_shape=()):
    d = cfg.d_model
    return {k: torch.zeros(layers_shape + (batch, d), dtype=torch.float32,
                           device=device) for k in ("h", "c", "n", "m")}
