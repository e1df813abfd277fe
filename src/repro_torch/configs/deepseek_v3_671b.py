"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP. [arXiv:2412.19437; hf]

A copy of the JAX package's config. Adam's fp32 moments for 671B params
alone take about 5.4 TB, so the assigned TrainConfig uses Adafactor
(factored second moment) with full remat.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,            # MLA: latent cache, head count used for q/v
    head_dim=128,
    d_ff=18_432,                 # first_k_dense layers
    moe_d_ff=2048,
    vocab_size=129_280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    first_k_dense=3,
    router_type="sigmoid",
    mtp_depth=1,
    source="arXiv:2412.19437",
)

TRAIN = TrainConfig(optimizer="adafactor", remat="full", accum_steps=1)

_SKIP = "full-softmax attention (MLA compresses KV, not attention score cost); task spec: skip"
SPEC = ArchSpec(model=MODEL, train=TRAIN, skips={"long_500k": _SKIP})
