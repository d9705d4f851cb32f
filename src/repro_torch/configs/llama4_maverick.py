"""Llama-4 Maverick 400B-A17B [moe]: 48L d=5120 40H (GQA kv=8) ff=8192,
128 routed experts top-1 + shared expert, MoE every other layer,
V=202048 [hf:meta-llama/Llama-4 family]. Text backbone (early-fusion
multimodal frontend out of scope -> dense text path).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    num_experts=128, num_shared_experts=1, top_k=1, moe_d_ff=8192,
    moe_interval=2, rope_theta=5e5,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama4-smoke", num_layers=4, d_model=128, num_heads=8,
    num_kv_heads=2, d_ff=256, vocab_size=512, num_experts=4,
    num_shared_experts=1, top_k=1, moe_d_ff=256)
