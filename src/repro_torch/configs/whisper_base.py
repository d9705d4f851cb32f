"""Whisper-base [audio]: 6+6 enc-dec, d=512 8H ff=2048 V=51865, GeLU MLP,
LayerNorm, learned positions; conv frontend is a STUB (input_specs provides
precomputed mel-frame embeddings (B, 1500, 80)) [arXiv:2212.04356].
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    encoder_layers=6, decoder_layers=6,
    # whisper's architectural decoder max is 448; the assigned shape grid
    # drives the decoder to 32k, so the learned-pos table is sized for the
    # grid (documented in DESIGN.md §Arch-applicability)
    max_target_positions=32768,
    act="gelu", norm="layernorm",
    frontend="audio_stub", frontend_dim=80, max_source_positions=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512, encoder_layers=2,
    decoder_layers=2, max_source_positions=64, max_target_positions=128)
