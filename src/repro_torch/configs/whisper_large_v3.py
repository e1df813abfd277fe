"""whisper-large-v3 [audio] — enc-dec, conv frontend STUB. [arXiv:2212.04356; unverified]

Per task spec the modality frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (1500 frames post-conv, d_model). 32 encoder +
32 decoder layers. RoPE is used as the positional stand-in for whisper's
sinusoidal/learned embeddings (structural simplification, DESIGN.md §4).
Shape cells exercise the decoder at the assigned seq_len (beyond whisper's
real 448-token decoder, as specified).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,               # decoder layers
    num_enc_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    enc_seq=1500,
    act="gelu",                  # non-gated
    tie_embeddings=True,
    source="arXiv:2212.04356",
)

TRAIN = TrainConfig(optimizer="adamw", remat="full", accum_steps=1)

_SKIP = "enc-dec full attention; long_500k needs sub-quadratic attention (task spec)"
SPEC = ArchSpec(model=MODEL, train=TRAIN, skips={"long_500k": _SKIP})
