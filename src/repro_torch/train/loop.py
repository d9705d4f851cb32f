"""Serve and prefill step factories. Port of the inference half of
``repro.train.loop``; the training factories (``make_train_step``,
``make_eval_step``, ``cross_entropy``) wait for the training slice
(ROADMAP queue 1 item 9).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import Model

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(model: Model, run: RunConfig) -> Callable:
    """One batched greedy decode step: (params, cache, tokens, pos) ->
    (next_tokens, cache, aux)."""

    def serve_step(params, cache, tokens, pos, inject=None):
        logits, cache, aux = model.decode_step(params, cache, tokens, pos,
                                               block_q=0, inject=inject)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], cache, aux

    return serve_step


def make_prefill_step(model: Model, run: RunConfig) -> Callable:
    """Full-sequence forward for inference-prefill shapes (logits only)."""

    def prefill_step(params, batch):
        logits, aux = model.apply(params, batch,
                                  block_q=run.parallel.attn_block_q)
        return logits[:, -1], aux

    return prefill_step
