"""Phi-3-medium 14B [dense]: 40L d=5120 40H (GQA kv=10) ff=17920 V=100352.

RoPE + SwiGLU + GQA [arXiv:2404.14219]
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=100352, rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi3-smoke", num_layers=3, d_model=128, num_heads=8,
    num_kv_heads=2, d_ff=256, vocab_size=512)
