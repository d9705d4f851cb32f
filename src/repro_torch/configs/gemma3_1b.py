"""Gemma-3 1B [dense]: 26L d=1152 4H (GQA kv=1) ff=6912 V=262144.

5:1 local:global attention, 512-token sliding window, theta 10k local /
1M global [hf:google/gemma-3-1b-pt]
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
    head_dim=256, d_ff=6912, vocab_size=262144,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    window_size=512, rope_theta=1e4, rope_theta_global=1e6,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-smoke", num_layers=7, d_model=64, num_heads=2,
    num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=512, window_size=16)
