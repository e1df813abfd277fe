"""mistral-nemo-12b [dense] — 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,      # long-context rope base
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)

TRAIN = TrainConfig(optimizer="adamw", remat="full", accum_steps=1)

_SKIP = "pure full-attention arch: long_500k needs sub-quadratic attention (task spec)"
SPEC = ArchSpec(model=MODEL, train=TRAIN, skips={"long_500k": _SKIP})
