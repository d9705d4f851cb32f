"""InternVL2-1B [vlm]: InternViT frontend (stub) + 24L Qwen2-0.5B-style LM:
d=896 14H (GQA kv=2) ff=4864 V=151655 [arXiv:2404.16821].

The ViT is a STUB per assignment: input_specs provides precomputed patch
embeddings (B, 256, 1024) fed through a learned projector.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, rope_theta=1e6, qkv_bias=True,
    frontend="patch_stub", num_patches=256, frontend_dim=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, name="internvl2-smoke", num_layers=3, d_model=112, num_heads=7,
    num_kv_heads=1, d_ff=224, vocab_size=512, num_patches=8, frontend_dim=32)
