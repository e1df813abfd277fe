"""The paper's own RQ2 workload models (§VI.A: "ViT and nanoGPT").

BONUS configs beyond the 10 assigned architectures — kept in a separate
registry so the 40-cell dry-run table is unchanged. nanoGPT is a dense
decoder (reuses the dense family verbatim); ViT is encoder-only (the vlm
family with prefix_len = everything, i.e. fully bidirectional, and a
classification readout in its workflow step).

(As in the JAX package, ``apply_lm`` makes only the ``num_patches`` patches
bidirectional; the text tokens after them attend causally.)
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, TrainConfig

NANOGPT = ModelConfig(
    name="nanogpt-124m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50_304,
    act="gelu",
    tie_embeddings=True,
    source="github:karpathy/nanoGPT (gpt2-124m shape)",
)

VIT_B16 = ModelConfig(
    name="vit-base-16",
    family="vlm",                 # patches frontend + transformer backbone
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=1024,              # class-token vocabulary (readout stub)
    num_patches=196,              # 224/16 squared
    prefix_lm=True,               # bidirectional over all patches
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2010.11929 (ViT-B/16 shape)",
)

TRAIN = TrainConfig(optimizer="adamw", remat="none", accum_steps=1)

BONUS_ARCHS = {
    "nanogpt-124m": ArchSpec(model=NANOGPT, train=TRAIN,
                             skips={"long_500k": "full attention"}),
    "vit-base-16": ArchSpec(model=VIT_B16, train=TRAIN,
                            skips={"long_500k": "encoder-only",
                                   "decode_32k": "encoder-only: no decode"}),
}
