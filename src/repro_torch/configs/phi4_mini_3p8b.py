"""Phi-4-mini 3.8B [dense]: 32L d=3072 24H (GQA kv=8) ff=8192 V=200064.

RoPE + SwiGLU + GQA [arXiv:2412.08905]
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064, rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi4-smoke", num_layers=3, d_model=96, num_heads=6,
    num_kv_heads=2, d_ff=192, vocab_size=512)
