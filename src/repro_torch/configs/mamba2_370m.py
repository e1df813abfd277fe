"""mamba2-370m [ssm] — SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    d_ff=0,                      # attention-free, no MLP
    vocab_size=50_280,
    attention="none",
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,             # d_inner=2048 -> 32 ssd heads
    ssm_ngroups=1,
    ssm_chunk=256,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

TRAIN = TrainConfig(optimizer="adamw", remat="full", accum_steps=1)

SPEC = ArchSpec(model=MODEL, train=TRAIN, skips={})  # long_500k RUNS (O(1)-state decode)
