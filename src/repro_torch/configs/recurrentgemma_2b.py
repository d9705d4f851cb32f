"""RecurrentGemma-2B [hybrid]: 26L d=2560 10H (GQA kv=1) ff=7680 V=256000.

Griffin pattern: (RG-LRU, RG-LRU, local-attn) with 2048-token window,
lru_width=2560 [arXiv:2402.19427].
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    head_dim=256, d_ff=7680, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window_size=2048, conv1d_width=4, lru_width=2560,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="recurrentgemma-smoke", num_layers=6, d_model=64,
    num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=512,
    window_size=16, lru_width=64)
