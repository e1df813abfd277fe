"""paligemma-3b [vlm] — SigLIP + gemma backbone. [arXiv:2407.07726; hf]

The SigLIP vision tower is a STUB per task spec: ``input_specs()`` provides
256 precomputed patch embeddings; the transformer backbone (gemma-2B shape)
is real. Prefix-LM masking: image+prefix bidirectional, suffix causal.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,              # MQA
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    prefix_lm=True,
    num_patches=256,
    act="geglu",
    tie_embeddings=True,
    source="arXiv:2407.07726",
)

TRAIN = TrainConfig(optimizer="adamw", remat="full", accum_steps=1)

_SKIP = "pure full-attention arch: long_500k needs sub-quadratic attention (task spec)"
SPEC = ArchSpec(model=MODEL, train=TRAIN, skips={"long_500k": _SKIP})
