"""Model assembly: embeddings -> (prefix | repeated super-blocks | tail) ->
final norm -> lm head, and the encoder-decoder model. Port of
``repro.models.model``: the dense family, the recurrent models
(RecurrentGemma, xLSTM), the MoE models (DeepSeek-V3 with MLA, Llama-4
Maverick), InternVL2's patch frontend stub and Whisper's encoder-decoder
with its audio frontend stub.

Functional, as the reference: ``Model.init`` builds the param tree (on the
``meta`` device it allocates nothing: :func:`count_params`),
``Model.apply`` runs the full-sequence forward (training shapes and
prefill), ``Model.decode_step`` advances one token against the cache tree
from ``Model.init_cache`` (KV caches, MLA's latent caches and recurrent
states, stacked along the repeated super-blocks; the encoder-decoder's
self and cross caches a decoder layer), whose tensors it writes in place.

``Model.apply(remat=...)`` recomputes each block's activations in the
backward (``torch.utils.checkpoint``, non-reentrant): ``"block"`` or
``"full"`` saves only the block's input, ``"dots"`` also the outputs of
the products autograd records (the reference's
``dots_with_no_batch_dims_saveable``; :func:`_dots_policy`). Each block
builds its own ``FTContext``, so the recompute's ABFT stats and fault
sites are a fresh context's, which ``checkpoint`` drops: the step's stats
and site numbers are the first forward's. The recompute runs each
protected product's check again, so under remat a protected block
launches ``ft_matmul`` twice a step (the reference recomputes its Pallas
call too, which no policy saves).

The encoder-decoder copies the reference's behaviours (ROADMAP queue 3,
"In the reference itself", items 8-10): its decode passes no encoder
output, so the cross caches stay the zeros ``init_cache`` makes
(reference ``model.py:322``, ``:365``; item 8); no fault descriptor
reaches its blocks, in ``apply`` or in a decode (``:271``, ``:282``; item
9); a batch without ``frames`` raises ``KeyError`` (``:264``), so
``launch.train``'s token batches cannot train it (item 10). Its ``apply``
ignores ``remat`` as well (``:140``). The frontend stubs' products and
the cross-attention's are plain ones: the reference gives them no FT
context.

The reference's ``constrain_hidden``/``constrain_logits`` are hints to
XLA's partitioner and have no counterpart: under a mesh a rank runs the
model on its own shard of the batch (``parallel.sharding``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig

from . import attention, layers
from .transformer import (block_apply, check_kind, effective_kinds,
                          init_block_state, layer_groups, make_block_params)

__all__ = ["Model", "count_params", "model_flops_per_token"]


def _dt(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _zeros_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_aux": z, "ft_flagged": z, "ft_corrected": z,
            "ft_max_score": z}


def _merge_aux(a, b):
    return {
        "moe_aux": a["moe_aux"] + b["moe_aux"],
        "ft_flagged": a["ft_flagged"] + b["ft_flagged"],
        "ft_corrected": a["ft_corrected"] + b["ft_corrected"],
        "ft_max_score": torch.maximum(a["ft_max_score"], b["ft_max_score"]),
    }


def _index(tree, i):
    """Slot ``i`` of every leaf's leading (stacked) axis; views."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> list:
    """The ``n`` slots of every leaf's leading (stacked) axis as ``n``
    trees of views, from one ``unbind`` a leaf: under autograd the stacked
    leaf's gradient is one stack of the slots' gradients, where ``n``
    indexings would each scatter into a zero tensor of the whole stack."""
    if isinstance(tree, dict):
        kids = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in kids.items()} for i in range(n)]
    return list(tree.unbind(0))


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpoint policy of ``remat="dots"``: save the output of
    every matrix product that autograd records (an ``mm`` whose output has
    more than one row and column: a vector product's output is squeezed
    in place, which a saved tensor must not be), recompute the rest. A
    product inside an ``autograd.Function``'s forward (the fused checked
    GEMM's plain version) runs with grad off and is recomputed, as the
    reference recomputes its Pallas call. A product with batch dims is a
    ``bmm`` (the mLSTM's and sLSTM's per-head einsums, attention's, the
    routed experts' batched products) and is recomputed too: the
    reference's ``dots_with_no_batch_dims_saveable``."""
    if (op is torch.ops.aten.mm.default and torch.is_grad_enabled()
            and args[0].shape[0] > 1 and args[1].shape[1] > 1):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(remat):
    """The ``context_fn`` of each block's checkpoint, or ``None`` for no
    recompute: the reference takes any true ``remat`` but ``"none"`` as a
    recompute, and ``"dots"`` as the selective one."""
    if not remat or remat == "none":
        return None
    if remat == "dots":
        return functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return torch_checkpoint.noop_context_fn


def _stacked(make, n: int):
    """``n`` trees from ``make(i)`` stacked along a new leading axis, one
    slot at a time, so that only one tree is alive beside the stack."""
    first = make(0)

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = t.new_empty((n,) + tuple(t.shape))
        out[0] = t
        return out

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], i)
        else:
            dst[i] = src

    out = alloc(first)
    del first
    for i in range(1, n):
        fill(out, make(i), i)
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        for kind in sorted(set(effective_kinds(self.cfg))):
            check_kind(kind)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator | None, device="cuda") -> dict:
        """The param tree, drawn from ``gen`` on its device and moved to
        ``device`` (on ``meta``: shapes only, ``gen`` may be None). The
        reference's keys and nesting; its numbers come from JAX's PRNG, so
        tests carry the reference's params across instead."""
        cfg = self.cfg
        pdt = _dt(cfg.param_dtype)
        params: dict = {
            "embed": {"embedding": layers.dense_init(
                gen, (cfg.vocab_size, cfg.d_model), pdt, device=device)},
            "final_norm": layers.make_norm_params(cfg.d_model, cfg.norm,
                                                  device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": layers.dense_init(
                gen, (cfg.d_model, cfg.vocab_size), pdt, device=device)}

        def frontend():
            return {"w": layers.dense_init(
                gen, (cfg.frontend_dim, cfg.d_model), pdt, device=device)}

        if cfg.frontend == "patch_stub":
            params["frontend"] = frontend()
        if not cfg.is_encdec:
            params["stack"] = self._init_groups(gen, pdt, device)
            return params
        params["encoder"] = self._init_stack(
            gen, ["bidir|mlp"] * cfg.encoder_layers, pdt, device)
        params["enc_norm"] = layers.make_norm_params(cfg.d_model, cfg.norm,
                                                     device=device)
        params["enc_pos"] = layers.dense_init(
            gen, (cfg.max_source_positions, cfg.d_model), pdt, device=device)
        params["dec_pos"] = layers.dense_init(
            gen, (cfg.max_target_positions, cfg.d_model), pdt, device=device)
        if cfg.frontend == "audio_stub":
            params["frontend"] = frontend()
        params["decoder"] = self._init_stack(
            gen, ["attn|mlp"] * cfg.decoder_layers, pdt, device, cross=True)
        return params

    def _init_stack(self, gen, kinds, pdt, device, *, cross=False) -> dict:
        """The encoder's or decoder's blocks, keyed "0", "1", ... and not
        stacked, as the reference's; a decoder block also holds its
        ``cross_norm`` and ``cross_attn``."""
        cfg = self.cfg
        stack = {}
        for i, kind in enumerate(kinds):
            p = make_block_params(gen, cfg, kind, pdt, device)
            if cross:
                p["cross_norm"] = layers.make_norm_params(
                    cfg.d_model, cfg.norm, device=device)
                p["cross_attn"] = attention.make_attn_params(
                    gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim, dtype=pdt, device=device)
            stack[str(i)] = p
        return stack

    def _init_groups(self, gen, pdt, device) -> dict:
        cfg = self.cfg
        g = layer_groups(cfg)
        out: dict = {}
        if g.prefix:
            out["prefix"] = {
                str(i): make_block_params(gen, cfg, kind, pdt, device)
                for i, kind in enumerate(g.prefix)}
        if g.n_super:
            out["scan"] = {
                f"slot{j}": _stacked(
                    lambda _, kind=kind: make_block_params(gen, cfg, kind,
                                                           pdt, device),
                    g.n_super)
                for j, kind in enumerate(g.super_block)}
        if g.tail:
            out["tail"] = {
                str(i): make_block_params(gen, cfg, kind, pdt, device)
                for i, kind in enumerate(g.tail)}
        return out

    # --------------------------------------------------------------- forward
    def apply(self, params, batch: dict, *, block_q: int = 1024,
              remat=False, inject=None):
        """Full-sequence forward. Returns (logits_f32, aux).

        ``remat`` (``False``/``"none"``, ``"block"``/``"full"``,
        ``"dots"``) recomputes each block in the backward (see the module
        docstring). ``inject`` threads a GEMM fault descriptor into every
        protected block (see ``transformer.block_apply``). The
        encoder-decoder takes neither, as the reference's
        (``_apply_encdec``).
        """
        if self.cfg.is_encdec:
            return self._apply_encdec(params, batch, block_q)
        adt = _dt(self.cfg.dtype)
        x, positions = self._embed_inputs(params, batch, adt)
        x, aux = self._run_groups(params["stack"], x, positions, block_q,
                                  inject=inject, remat=remat)
        return self._head(params, x), aux

    def _embed(self, params, tokens, adt):
        x = layers.embed(params["embed"], tokens, adt)
        # the reference scales by sqrt(d_model) rounded to the activations'
        # dtype first (55.43 -> 55.5 in bfloat16 at d_model 3072)
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=adt,
                                device=x.device)

    def _embed_inputs(self, params, batch, adt):
        """The scaled token embeddings; with ``patch_embeds`` in the batch
        of a ``patch_stub`` model, its projected patches (not scaled, an
        unprotected product) before them, positions over both."""
        x = self._embed(params, batch["tokens"], adt)
        if self.cfg.frontend == "patch_stub" and "patch_embeds" in batch:
            patches = layers.dense(params["frontend"],
                                   batch["patch_embeds"].to(adt))
            x = torch.cat([patches, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        return x, positions

    def _head(self, params, x):
        """Logits in float32 from the activations' dtype: the operands are
        rounded to it and their products summed in float32 (the
        reference's ``preferred_element_type=float32``)."""
        cfg = self.cfg
        x = layers.norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            w = params["embed"]["embedding"].T
        else:
            w = params["lm_head"]["w"]
        return torch.matmul(x.float(), w.to(x.dtype).float())

    def _run_groups(self, stack, x, positions, block_q, caches=None,
                    cache_pos=None, inject=None, remat=False):
        """The blocks in order: prefix, the repeated super-blocks (slot j
        of repeat i is layer ``i * len(super_block) + j``, the reference's
        scan), tail. Every cache and recurrent state is written in place
        (the blocks' returned trees are those tensors, or views of them),
        so the cache tree given is the new one. ``remat`` wraps each
        block of a full-sequence forward in a checkpoint."""
        cfg = self.cfg
        g = layer_groups(cfg)
        aux = _zeros_aux(x.device)
        context_fn = _remat_context(remat) if caches is None else None

        def run(p, kind, cache):
            nonlocal x, aux
            fn = functools.partial(
                block_apply, cfg=cfg, kind=kind, positions=positions,
                cache=cache, cache_pos=cache_pos, block_q=block_q,
                ftp=cfg.ft, inject=inject)
            if context_fn is None:
                x, _, a = fn(p, x)
            else:
                x, _, a = torch_checkpoint.checkpoint(
                    fn, p, x, use_reentrant=False, context_fn=context_fn)
            aux = _merge_aux(aux, a)

        def cache(group, key, i=None):
            if caches is None:
                return None
            c = caches[group][key]
            return c if i is None else _index(c, i)

        for i, kind in enumerate(g.prefix):
            run(stack["prefix"][str(i)], kind, cache("prefix", str(i)))
        slots = {f"slot{j}": _unbind(stack["scan"][f"slot{j}"], g.n_super)
                 for j in range(len(g.super_block))}
        for i in range(g.n_super):
            for j, kind in enumerate(g.super_block):
                run(slots[f"slot{j}"][i], kind,
                    cache("scan", f"slot{j}", i))
        for i, kind in enumerate(g.tail):
            run(stack["tail"][str(i)], kind, cache("tail", str(i)))
        return (x, aux) if caches is None else (x, aux, caches)

    # --------------------------------------------------------------- enc-dec
    def _encode(self, params, batch, block_q):
        """The frames through the frontend stub (an unprotected product),
        the learned positions and the bidirectional blocks, then
        ``enc_norm``. The blocks get the model's policy but no fault
        descriptor (reference ``model.py:271``; ROADMAP queue 3, "In the
        reference itself", item 9)."""
        cfg = self.cfg
        adt = _dt(cfg.dtype)
        h = layers.dense(params["frontend"], batch["frames"].to(adt))
        f = h.shape[1]
        h = h + params["enc_pos"][:f].to(adt)[None]
        positions = torch.arange(f, device=h.device)
        aux = _zeros_aux(h.device)
        for i in range(cfg.encoder_layers):
            h, _, a = block_apply(params["encoder"][str(i)], h, cfg=cfg,
                                  kind="bidir|mlp", positions=positions,
                                  block_q=block_q, ftp=cfg.ft)
            aux = _merge_aux(aux, a)
        return layers.norm(params["enc_norm"], h, cfg.norm, cfg.norm_eps), aux

    def _decoder_block(self, p, x, enc_out, positions, cache, cache_pos,
                       block_q):
        """Self-attention and MLP (protected under the model's policy, no
        fault descriptor: reference ``model.py:282``), then cross-attention
        on ``enc_out`` or, in a decode, the cross cache; its projections
        are plain products, as the reference gives them no FT context."""
        cfg = self.cfg
        x, _, a = block_apply(
            {k: v for k, v in p.items() if not k.startswith("cross")}, x,
            cfg=cfg, kind="attn|mlp", positions=positions,
            cache=None if cache is None else cache["self"],
            cache_pos=cache_pos, block_q=block_q, ftp=cfg.ft)
        h = layers.norm(p["cross_norm"], x, cfg.norm, cfg.norm_eps)
        mix, _ = attention.attention(
            p["cross_attn"], h, cfg=cfg, kind="cross", positions=positions,
            cache=None if cache is None else cache["cross"],
            kv_source=enc_out, use_rope=False, block_q=block_q)
        return x + mix, a

    def _apply_encdec(self, params, batch, block_q):
        cfg = self.cfg
        adt = _dt(cfg.dtype)
        enc_out, aux = self._encode(params, batch, block_q)
        x = layers.embed(params["embed"], batch["tokens"], adt)
        x = x + params["dec_pos"][:x.shape[1]].to(adt)[None]
        positions = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.decoder_layers):
            x, a = self._decoder_block(params["decoder"][str(i)], x, enc_out,
                                       positions, None, None, block_q)
            aux = _merge_aux(aux, a)
        return self._head(params, x), aux

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        cfg = self.cfg
        if cfg.is_encdec:
            return {"decoder": {
                str(i): {"self": init_block_state(cfg, "attn|mlp", batch,
                                                  max_len, dtype, device),
                         "cross": attention.init_kv_cache(
                             cfg, batch, cfg.max_source_positions, dtype,
                             device=device)}
                for i in range(cfg.decoder_layers)}}
        g = layer_groups(cfg)
        caches: dict = {}
        if g.prefix:
            caches["prefix"] = {
                str(i): init_block_state(cfg, kind, batch, max_len, dtype,
                                         device)
                for i, kind in enumerate(g.prefix)}
        if g.n_super:
            caches["scan"] = {
                f"slot{j}": {k: t.new_zeros((g.n_super,) + tuple(t.shape))
                             for k, t in init_block_state(
                                 cfg, kind, batch, max_len, dtype,
                                 device).items()}
                for j, kind in enumerate(g.super_block)}
        if g.tail:
            caches["tail"] = {
                str(i): init_block_state(cfg, kind, batch, max_len, dtype,
                                         device)
                for i, kind in enumerate(g.tail)}
        return caches

    def decode_step(self, params, cache, tokens, pos: int, *,
                    block_q: int = 0, inject=None):
        """One decode step. tokens: (B, T) (T = 1 in the decode loop); pos:
        the write index, an int. Returns (logits_f32, cache, aux); the
        cache's tensors are written in place.

        ``inject`` threads a GEMM fault descriptor into every protected
        block (serving arms it per step from a FaultSchedule). The
        encoder-decoder ignores it, and passes its decoder blocks no
        encoder output, so they attend to the cross caches as
        ``init_cache`` made them, zeros (reference ``model.py:356-369``;
        ROADMAP queue 3, "In the reference itself", items 8 and 9).
        """
        if self.cfg.is_encdec:
            return self._decode_encdec(params, cache, tokens, pos, block_q)
        adt = _dt(self.cfg.dtype)
        x = self._embed(params, tokens, adt)
        positions = pos + torch.arange(tokens.shape[1], device=x.device)
        x, aux, new_caches = self._run_groups(
            params["stack"], x, positions, block_q, caches=cache,
            cache_pos=pos, inject=inject)
        return self._head(params, x), new_caches, aux

    def _decode_encdec(self, params, cache, tokens, pos, block_q):
        cfg = self.cfg
        adt = _dt(cfg.dtype)
        t = tokens.shape[1]
        x = layers.embed(params["embed"], tokens, adt)
        # dynamic_slice_in_dim's clamped start
        start = min(max(pos, 0), params["dec_pos"].shape[0] - t)
        x = x + params["dec_pos"][start:start + t].to(adt)[None]
        positions = pos + torch.arange(t, device=x.device)
        aux = _zeros_aux(x.device)
        for i in range(cfg.decoder_layers):
            x, a = self._decoder_block(params["decoder"][str(i)], x, None,
                                       positions, cache["decoder"][str(i)],
                                       pos, block_q)
            aux = _merge_aux(aux, a)
        return self._head(params, x), cache, aux


# ---------------------------------------------------------------------------
# analytics
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the param tree built on the ``meta``
    device (shapes only, no allocation)."""
    tree = Model(cfg).init(None, device="meta")

    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            yield t

    return int(sum(t.numel() for t in leaves(tree)))


def model_flops_per_token(cfg: ModelConfig, params_total: int | None = None
                          ) -> float:
    """6 * N_active per token (dense) — the reference's MODEL_FLOPS basis."""
    n = params_total if params_total is not None else count_params(cfg)
    n_active = n - cfg.inactive_expert_params()
    return 6.0 * n_active
