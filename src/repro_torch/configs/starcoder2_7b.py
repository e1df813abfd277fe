"""starcoder2-7b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_432,
    vocab_size=49_152,
    act="gelu",                  # non-gated MLP
    source="arXiv:2402.19173",
)

TRAIN = TrainConfig(optimizer="adamw", remat="full", accum_steps=1)

_SKIP = "pure full-attention arch: long_500k needs sub-quadratic attention (task spec)"
SPEC = ArchSpec(model=MODEL, train=TRAIN, skips={"long_500k": _SKIP})
