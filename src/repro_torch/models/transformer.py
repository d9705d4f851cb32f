"""Block assembly and the layer grouping. Port of
``repro.models.transformer``.

A *block* = pre-norm mixer (attention family / MLA / recurrent family) +
pre-norm FFN (dense or MoE; none for xLSTM's blocks, which hold their
own). Layers are grouped into (prefix, repeated super-blocks, tail) as in
the reference, whose ``jax.lax.scan`` runs the super-blocks as one loop;
here a Python loop walks the leading ``n_super`` axis of
``stack["scan"][f"slot{j}"]``. The param and cache trees keep that
stacked axis, so the reference's params carry across unchanged
(``models.convert.params_from_numpy``).

Every block kind of the decoder stack is ported: the
``attn``/``local``/``global``/``bidir`` and ``mla`` mixers with an ``mlp``
or ``moe`` FFN, ``rglru`` with an ``mlp``, and ``mlstm``/``slstm`` with
none (``models.ssm``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import attention, layers, moe, ssm
from .layers import FTContext

__all__ = ["effective_kinds", "layer_groups", "make_block_params",
           "block_apply", "init_block_state", "LayerGroups", "force_unroll",
           "check_kind"]


ATTN_KINDS = ("attn", "local", "global", "bidir")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")

def check_kind(kind: str) -> None:
    """Raise ``ValueError`` for a 'mixer|ffn' kind that is no kind at
    all."""
    base, ffn = kind.split("|")
    if base not in ATTN_KINDS + ("mla",) + RECURRENT_KINDS:
        raise ValueError(base)
    if ffn not in ("mlp", "moe", "none"):
        raise ValueError(ffn)


def effective_kinds(cfg) -> tuple[str, ...]:
    """Per-layer 'mixer|ffn' descriptors, e.g. 'attn|moe', 'rglru|mlp'."""
    kinds = []
    pat = cfg.block_pattern
    for i in range(cfg.num_layers):
        base = pat[i % len(pat)]
        if base in RECURRENT_KINDS and base != "rglru":
            ffn = "none"          # xLSTM blocks integrate their FFN
        elif base == "rglru":
            ffn = "mlp"
        else:
            ffn = "moe" if cfg.is_moe_layer(i) else "mlp"
        kinds.append(f"{base}|{ffn}")
    return tuple(kinds)


@dataclasses.dataclass(frozen=True)
class LayerGroups:
    prefix: tuple[str, ...]          # unrolled leading layer kinds
    super_block: tuple[str, ...]     # kinds within one repeated super-block
    n_super: int                     # number of repeated super-blocks
    tail: tuple[str, ...]            # unrolled trailing layer kinds

    @property
    def total(self) -> int:
        return (len(self.prefix) + len(self.super_block) * self.n_super
                + len(self.tail))


# When True, layer_groups unrolls everything (no stacked super-blocks), as
# the reference's dry-run asks for its two-point cost measurement.
FORCE_UNROLL = False


class force_unroll:
    def __enter__(self):
        global FORCE_UNROLL
        self._old = FORCE_UNROLL
        FORCE_UNROLL = True

    def __exit__(self, *a):
        global FORCE_UNROLL
        FORCE_UNROLL = self._old


def layer_groups(cfg) -> LayerGroups:
    kinds = effective_kinds(cfg)
    n = len(kinds)
    # leading layers that break the periodic pattern (deepseek first-k-dense)
    period = len(cfg.block_pattern)
    if cfg.num_experts and cfg.moe_interval > 1:
        period = int(np.lcm(period, cfg.moe_interval))
    s = cfg.first_k_dense if cfg.num_experts else 0
    rest = n - s
    n_super = rest // period
    tail_len = rest % period
    if FORCE_UNROLL or n_super <= 1:  # not worth stacking
        return LayerGroups(prefix=kinds, super_block=(), n_super=0, tail=())
    return LayerGroups(
        prefix=kinds[:s],
        super_block=kinds[s:s + period],
        n_super=n_super,
        tail=kinds[s + period * n_super:] if tail_len else (),
    )


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def make_block_params(gen, cfg, kind: str, dtype=torch.float32,
                      device="cuda") -> dict:
    check_kind(kind)
    base, ffn = kind.split("|")
    p: dict = {"norm1": layers.make_norm_params(cfg.d_model, cfg.norm,
                                                device=device)}
    if base in ATTN_KINDS:
        p["attn"] = attention.make_attn_params(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dtype, device=device)
    elif base == "mla":
        p["attn"] = attention.make_mla_params(gen, cfg, dtype, device=device)
    else:
        make = {"rglru": ssm.make_rglru_params,
                "mlstm": ssm.make_mlstm_params,
                "slstm": ssm.make_slstm_params}[base]
        p["mixer"] = make(gen, cfg, dtype, device=device)
    if ffn == "mlp":
        p["norm2"] = layers.make_norm_params(cfg.d_model, cfg.norm,
                                             device=device)
        p["mlp"] = layers.make_mlp_params(gen, cfg.d_model,
                                          cfg.dense_d_ff or cfg.d_ff,
                                          cfg.act, dtype, device=device)
    elif ffn == "moe":
        p["norm2"] = layers.make_norm_params(cfg.d_model, cfg.norm,
                                             device=device)
        p["moe"] = moe.make_moe_params(gen, cfg, dtype, device=device)
    return p


def block_apply(params, x, *, cfg, kind: str, positions=None, cache=None,
                cache_pos=None, block_q=1024, ftp=None, inject=None):
    """One transformer block. Returns (y, new_cache, aux_dict).

    ``inject`` is an optional fault descriptor ``(F, 5)`` ``[site, row,
    col, enable, eps]`` armed against this block's protected matmuls (site
    = matmul index within the block, call order: the mixer's, then the
    FFN's; q, k, v, o for attention, ``wq_a``, ``wq_b``, ``wkv_a``, ``wo``
    for MLA, ``models.ssm`` for the recurrent mixers; a MoE FFN's shared
    expert takes the FFN's, its routed experts none) — see
    :class:`FTContext`. Each block builds its own context,
    so one descriptor faults its site in every block, as in the reference.
    A recurrent mixer writes its new state into ``cache`` in place.
    """
    check_kind(kind)
    base, ffn = kind.split("|")
    ft = (FTContext(ftp, inject=inject)
          if (ftp is not None and ftp.protect_linears) else None)
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"moe_aux": z}

    h = layers.norm(params["norm1"], x, cfg.norm, cfg.norm_eps)
    if base in ATTN_KINDS:
        theta = cfg.rope_theta_global if base == "global" else cfg.rope_theta
        mix, new_cache = attention.attention(
            params["attn"], h, cfg=cfg,
            kind={"attn": "causal", "global": "causal"}.get(base, base),
            positions=positions, cache=cache, cache_pos=cache_pos,
            theta=theta, block_q=block_q, ft=ft)
    elif base == "mla":
        mix, new_cache = attention.mla_attention(
            params["attn"], h, cfg=cfg, positions=positions, cache=cache,
            cache_pos=cache_pos, block_q=block_q, ft=ft)
    elif base == "rglru":
        mix, new_cache = ssm.rglru_block(params["mixer"], h, state=cache,
                                         ft=ft)
    elif base == "mlstm":
        mix, new_cache = ssm.mlstm_block(params["mixer"], h, cfg=cfg,
                                         state=cache, ft=ft)
    else:
        mix, new_cache = ssm.slstm_block(params["mixer"], h, cfg=cfg,
                                         state=cache, ft=ft)
    x = x + mix
    if ffn == "mlp":
        h = layers.norm(params["norm2"], x, cfg.norm, cfg.norm_eps)
        # a model with recurrent mixers or experts takes the op-by-op silu
        # (the experts' router reads the activations it rounds)
        silu = ssm.silu if (set(RECURRENT_KINDS) & set(cfg.block_pattern)
                            or cfg.num_experts) \
            else torch.nn.functional.silu
        x = x + layers.mlp(params["mlp"], h, cfg.act, ft=ft, silu=silu)
    elif ffn == "moe":
        h = layers.norm(params["norm2"], x, cfg.norm, cfg.norm_eps)
        y, aux["moe_aux"] = moe.moe_block(params["moe"], h, cfg, ft=ft)
        x = x + y

    if ft is not None:
        aux.update({k: v.to(x.device) for k, v in ft.summary().items()})
    else:
        aux.update({"ft_flagged": z, "ft_corrected": z, "ft_max_score": z})
    return x, new_cache, aux


def init_block_state(cfg, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cuda"):
    """Decode-time cache (attention, MLA's latent) or recurrent state for
    one block."""
    check_kind(kind)
    base, _ = kind.split("|")
    if base == "rglru":
        return ssm.init_rglru_state(cfg, batch, dtype, device=device)
    if base == "mlstm":
        return ssm.init_mlstm_state(cfg, batch, dtype, device=device)
    if base == "slstm":
        return ssm.init_slstm_state(cfg, batch, dtype, device=device)
    if base == "mla":
        return attention.init_mla_cache(cfg, batch, max_len, dtype,
                                        device=device)
    if base == "local":
        max_len = min(max_len, cfg.window_size)
    return attention.init_kv_cache(cfg, batch, max_len, dtype, device=device)
