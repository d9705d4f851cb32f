"""Config schema: model / parallelism / run / shape configs.

One ``ModelConfig`` covers all ten assigned architecture families via the
per-layer ``block_pattern`` (cycled across layers) — dense attention, local
windows, MLA, MoE, RG-LRU, s/mLSTM, enc-dec. ``configs/<arch>.py`` files
instantiate the exact published configurations.

A copy of ``repro.configs.base`` whose ``ft`` field holds the port's
:class:`~repro_torch.core.ft.FTPolicy`; fields and defaults are the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.ft import FTPolicy

__all__ = ["ModelConfig", "ParallelConfig", "ShapeConfig", "RunConfig",
           "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # per-layer block types, cycled: "attn", "local", "global", "mla",
    # "rglru", "mlstm", "slstm". Empty -> ("attn",) * num_layers.
    block_pattern: tuple[str, ...] = ()
    # attention
    window_size: int = 4096
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_global: float = 1e6    # gemma3 uses a larger theta globally
    logit_softcap: float = 0.0
    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_d_ff: int = 0               # d_ff of the leading dense layers
    first_k_dense: int = 0            # deepseek: first k layers stay dense
    moe_interval: int = 1             # llama4: MoE every `interval` layers
    capacity_factor: float = 1.25
    # SSM / hybrid
    conv1d_width: int = 4
    lru_width: int = 0                # 0 -> d_model
    expand_factor: int = 2            # mlstm/rglru up-projection
    # enc-dec (whisper)
    encoder_layers: int = 0
    decoder_layers: int = 0
    max_source_positions: int = 1500
    max_target_positions: int = 8192  # learned-pos table (enc-dec decoder)
    # modality frontend stubs
    frontend: str = "none"            # none | patch_stub | audio_stub
    num_patches: int = 256
    frontend_dim: int = 0             # raw embedding dim provided by stub
    # misc
    act: str = "swiglu"               # swiglu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    # fault tolerance (the paper's technique as a first-class feature)
    ft: FTPolicy = dataclasses.field(default_factory=FTPolicy)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("attn",))
        if self.num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # -- derived -----------------------------------------------------------
    def layer_kinds(self) -> tuple[str, ...]:
        """Resolved per-layer block kind for the decoder-only stack."""
        pat = self.block_pattern
        kinds = []
        for i in range(self.num_layers):
            if self.num_experts and self.first_k_dense and i < self.first_k_dense:
                kinds.append(pat[i % len(pat)] + ":dense")
            else:
                kinds.append(pat[i % len(pat)])
        return tuple(kinds)

    def is_moe_layer(self, i: int) -> bool:
        if not self.num_experts:
            return False
        if i < self.first_k_dense:
            return False
        return (i - self.first_k_dense) % self.moe_interval == 0

    @property
    def is_encdec(self) -> bool:
        return self.decoder_layers > 0

    def inactive_expert_params(self) -> int:
        """Params idle per token in MoE layers (for 6*N_active*D FLOPs).

        This analytic adjustment subtracts the routed experts not selected
        by top-k.
        """
        if not self.num_experts:
            return 0
        moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        per_expert = 3 * self.d_model * self.moe_d_ff  # swiglu: gate/up/down
        return int(moe_layers * (self.num_experts - self.top_k) * per_expert)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh + sharding strategy knobs."""

    multi_pod: bool = False
    fsdp: bool = True                  # shard params over (pod, data)
    seq_shard_decode: bool = True      # SP for decode when batch < data size
    remat: str = "block"               # none | block | full
    microbatch: int = 1                # gradient accumulation steps
    compress_grads: bool = False       # int8 error-feedback all-reduce
    attn_block_q: int = 1024           # query-chunked attention block
    pipeline_stages: int = 1


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    # training
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
