"""zamba2-1.2b [hybrid] — Mamba2 blocks + shared attention block. [arXiv:2411.15242; hf]

Zamba2 applies ONE weight-shared transformer block (attention+MLP) every
``shared_attn_interval`` Mamba2 blocks, with the block input being
concat(hidden, original_embedding) (2*d_model). LoRA-adapters on the shared
block are omitted (structural mechanism kept; see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,               # mamba2 blocks
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,                # shared block queries from concat(2*d_model)=4096
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,             # d_inner=4096 -> 64 ssd heads
    ssm_ngroups=1,
    ssm_chunk=256,
    shared_attn_interval=6,
    tie_embeddings=True,
    source="arXiv:2411.15242",
)

TRAIN = TrainConfig(optimizer="adamw", remat="full", accum_steps=1)

SPEC = ArchSpec(model=MODEL, train=TRAIN, skips={})  # long_500k RUNS (hybrid)
