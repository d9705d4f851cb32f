"""xLSTM-350M [ssm]: 24L d=1024, alternating mLSTM/sLSTM blocks (kv ratio per
assignment header: 4H), no separate FFN (d_ff=0; blocks integrate their own
projections) [arXiv:2405.04517].
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    expand_factor=2, conv1d_width=4,
)

SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-smoke", num_layers=4, d_model=64, num_heads=2,
    vocab_size=512)
