"""Primitive layers: inits, norms, dense (with optional ABFT protection),
embeddings, RoPE, MLPs. Functional, as ``repro.models.layers``: params are
nested dicts of tensors, so the reference's params carry across one to one
(``models.convert.params_from_numpy``).

Every dense contraction routes through :func:`dense`, which consults the
model's FT policy — when ``protect_linears`` is on, the product is computed
through the paper's two-sided ABFT via the cached GEMM plan layer
(``core.gemm``), so compute SEUs in any projection are detected and
corrected online.

Dtypes follow the reference: activations in ``cfg.dtype`` (bf16), params in
``param_dtype`` (f32). A protected product promotes (bf16 x f32 -> f32
accumulation) and casts ``y`` back to ``x.dtype``; the unprotected one casts
``w`` to ``x.dtype`` first.

The init helpers draw from an explicit ``torch.Generator`` (the reference
splits PRNG keys; the two give different numbers from one seed, so tests
carry weights across instead). Tensors are made on the generator's
device and moved to ``device``; on the ``meta`` device they are shapes
only and no generator is needed (``models.model.count_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import gemm
from repro_torch.core.ft import FTPolicy

__all__ = ["truncated_normal", "rmsnorm", "layernorm", "make_norm_params",
           "dense", "make_dense_params", "embed", "rope", "apply_rope",
           "swiglu", "gelu_mlp", "make_mlp_params", "mlp", "FTContext"]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _trunc_normal(gen: torch.Generator, shape, std: float, dtype, device):
    if torch.device(device).type == "meta":     # shapes only: no draw
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # scaled in place: a 15 GB expert stack drawn on the card has no copy
    return t.mul_(std).to(device=device, dtype=dtype)


def truncated_normal(gen, shape, scale, dtype=torch.float32, device="cuda"):
    stddev = scale / np.sqrt(max(shape[0], 1) if len(shape) > 1 else 1.0)
    return _trunc_normal(gen, shape, stddev, dtype, device)


def _fan_in(shape: Sequence[int], contract_dims: int = 1) -> float:
    f = 1
    for s in shape[:contract_dims]:
        f *= s
    return float(f)


def dense_init(gen, shape, dtype=torch.float32, contract_dims: int = 1,
               device="cuda"):
    std = 1.0 / np.sqrt(_fan_in(shape, contract_dims))
    return _trunc_normal(gen, shape, std, dtype, device)


# ---------------------------------------------------------------------------
# FT context — threads detection counters out of functional layers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FTContext:
    """Accumulator for ABFT stats over one forward (entries are 0-d tensors
    collected during apply and summed by :meth:`summary`).

    Each protected matmul routes through :meth:`matmul` — the shared GEMM
    plan layer (``core.gemm``) built from this context's policy. ``inject``
    optionally carries a fault descriptor ``(5,)`` / ``(F, 5)`` rows
    ``[site, row, col, enable, eps]``: every protected matmul takes the next
    *site* number (call order) and arms only descriptors whose site matches,
    so one fixed program can fault any layer.
    """

    policy: FTPolicy
    flagged: list = dataclasses.field(default_factory=list)
    corrected: list = dataclasses.field(default_factory=list)
    scores: list = dataclasses.field(default_factory=list)
    inject: torch.Tensor | None = None
    sites: int = 0

    @property
    def enabled(self) -> bool:
        return self.policy is not None and self.policy.protect_linears

    def take_inject(self) -> torch.Tensor | None:
        """Next site's ``(F, 4)`` ``[row, col, enable, eps]`` descriptor
        (``None`` when no schedule is armed). Advances the site counter."""
        site = self.sites
        self.sites += 1
        if self.inject is None:
            return None
        d = torch.as_tensor(self.inject, dtype=torch.float32).reshape(-1, 5)
        enable = d[:, 3] * (d[:, 0] == site).to(torch.float32)
        return torch.stack([d[:, 1], d[:, 2], enable, d[:, 4]], dim=-1)

    def matmul(self, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Checked ``x2 @ w`` through the cached GEMM plan; records stats."""
        spec = gemm.spec_for(x2, w, ft=self.policy.to_ft_config(),
                             backend=self.policy.gemm_backend)
        y, stats = gemm.plan(spec).ft_matmul(x2, w,
                                             inject=self.take_inject())
        self.record(stats)
        return y

    def record(self, stats: dict):
        self.flagged.append(stats["flagged"])
        self.corrected.append(stats.get(
            "corrected", torch.zeros((), dtype=torch.float32)))
        self.scores.append(stats["score"])

    def summary(self) -> dict:
        if not self.flagged:
            z = torch.zeros((), dtype=torch.float32)
            return {"ft_flagged": z, "ft_corrected": z, "ft_max_score": z}
        # entries may mix scalars with per-expert (e,) vectors — reduce each
        # before stacking
        return {
            "ft_flagged": torch.stack([f.sum() for f in self.flagged]).sum(),
            "ft_corrected": torch.stack(
                [c.sum() for c in self.corrected]).sum(),
            "ft_max_score": torch.stack(
                [s.max() for s in self.scores]).max(),
        }


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def make_norm_params(d: int, kind: str = "rmsnorm", device="cuda") -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm(params, x, eps=1e-6):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dt)


def norm(params, x, kind: str = "rmsnorm", eps: float = 1e-6):
    return rmsnorm(params, x, eps) if kind == "rmsnorm" else layernorm(
        params, x, eps)


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def make_dense_params(gen, d_in, d_out, *, bias=False, dtype=torch.float32,
                      device="cuda") -> dict:
    p = {"w": dense_init(gen, (d_in, d_out), dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(params, x, *, ft: FTContext | None = None):
    """y = x @ w (+ b), optionally through two-sided ABFT (paper's scheme)
    via the shared GEMM plan layer (``core.gemm``)."""
    w = params["w"]
    if ft is not None and ft.enabled and x.dim() >= 2 and w.dim() == 2:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y2 = ft.matmul(x2, w)
        y = y2.reshape(lead + (w.shape[-1],))
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def embed(params, tokens, dtype):
    return params["embedding"][tokens].to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(positions, head_dim, theta, dtype=torch.float32):
    """Rotary embedding tables. positions: (...,) -> (..., head_dim/2) each."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = torch.pow(torch.tensor(1.0 / theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (..., T, H, D) with tables (..., T, D/2), broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def make_mlp_params(gen, d, d_ff, act: str, dtype=torch.float32,
                    device="cuda") -> dict:
    kw = dict(dtype=dtype, device=device)
    if act == "swiglu":
        return {
            "wi_gate": dense_init(gen, (d, d_ff), **kw),
            "wi_up": dense_init(gen, (d, d_ff), **kw),
            "wo": dense_init(gen, (d_ff, d), **kw),
        }
    return {
        "wi": dense_init(gen, (d, d_ff), **kw),
        "wo": dense_init(gen, (d_ff, d), **kw),
    }


def swiglu(params, x, *, ft=None, silu=F.silu):
    g = dense({"w": params["wi_gate"]}, x, ft=ft)
    u = dense({"w": params["wi_up"]}, x, ft=ft)
    h = silu(g) * u
    return dense({"w": params["wo"]}, h, ft=ft)


def gelu_mlp(params, x, *, ft=None):
    # the reference's GELU is the tanh approximation
    h = F.gelu(dense({"w": params["wi"]}, x, ft=ft), approximate="tanh")
    return dense({"w": params["wo"]}, h, ft=ft)


def mlp(params, x, act: str, *, ft=None, silu=F.silu):
    return swiglu(params, x, ft=ft, silu=silu) if act == "swiglu" \
        else gelu_mlp(params, x, ft=ft)
