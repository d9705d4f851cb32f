"""DeepSeek-V3 671B [moe]: 61L d=7168 128H MLA, 1 shared + 256 routed top-8
experts (moe_d_ff=2048), first 3 layers dense (ff=18432), V=129280
[arXiv:2412.19437]. MTP head omitted (training-objective add-on; noted in
DESIGN.md).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=2048, dense_d_ff=18432, vocab_size=129280,
    block_pattern=("mla",),
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=256, num_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_k_dense=3, rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-smoke", num_layers=4, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=64, dense_d_ff=256, vocab_size=512,
    q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16,
    num_experts=8, num_shared_experts=1, top_k=2, moe_d_ff=64,
    first_k_dense=1)
