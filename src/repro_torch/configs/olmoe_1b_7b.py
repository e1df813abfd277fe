"""olmoe-1b-7b [moe] — 64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,                  # (unused: every layer is MoE)
    moe_d_ff=1024,
    vocab_size=50_304,
    num_experts=64,
    experts_per_token=8,
    num_shared_experts=0,
    first_k_dense=0,
    router_type="softmax",
    source="arXiv:2409.02060",
)

TRAIN = TrainConfig(optimizer="adamw", remat="full", accum_steps=1)

_SKIP = "pure full-attention arch: long_500k needs sub-quadratic attention (task spec)"
SPEC = ArchSpec(model=MODEL, train=TRAIN, skips={"long_500k": _SKIP})
