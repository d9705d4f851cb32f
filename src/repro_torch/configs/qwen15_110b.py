"""Qwen1.5-110B [dense]: 80L d=8192 64H (GQA kv=8) ff=49152 V=152064, QKV bias.

[hf:Qwen/Qwen1.5-110B family; structure per hf:Qwen/Qwen1.5-0.5B config]
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064, qkv_bias=True,
    rope_theta=1e6, block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen1.5-smoke", num_layers=4, d_model=128, num_heads=8,
    num_kv_heads=2, d_ff=256, vocab_size=512)
