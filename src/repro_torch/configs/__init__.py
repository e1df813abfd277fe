"""Architecture registry of the port: ``get_arch(id)`` / ``reduced(cfg)``.

Every family of the JAX registry is ported: ``ARCHS`` holds the
registry's archs, ``BONUS_ARCHS`` the paper's own RQ2 workload models
(``paper_workload.py``: nanogpt-124m, vit-base-16), kept apart as in the
JAX package; ``get_arch`` finds either. The dataclasses and the specs are
copies of the JAX package's, so the port never imports it.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ArchSpec, LM_SHAPES, ModelConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.configs import (deepseek_v3_671b, granite_3_8b, mamba2_370m,
                                 mistral_nemo_12b, olmoe_1b_7b, paligemma_3b,
                                 stablelm_1_6b, starcoder2_7b, whisper_large_v3,
                                 zamba2_1_2b)
from repro_torch.configs.paper_workload import BONUS_ARCHS

ARCHS: Dict[str, ArchSpec] = {
    "mamba2-370m": mamba2_370m.SPEC,
    "olmoe-1b-7b": olmoe_1b_7b.SPEC,
    "deepseek-v3-671b": deepseek_v3_671b.SPEC,
    "paligemma-3b": paligemma_3b.SPEC,
    "starcoder2-7b": starcoder2_7b.SPEC,
    "stablelm-1.6b": stablelm_1_6b.SPEC,
    "mistral-nemo-12b": mistral_nemo_12b.SPEC,
    "granite-3-8b": granite_3_8b.SPEC,
    "zamba2-1.2b": zamba2_1_2b.SPEC,
    "whisper-large-v3": whisper_large_v3.SPEC,
}

ARCH_IDS: List[str] = list(ARCHS) + list(BONUS_ARCHS)
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def get_arch(arch_id: str) -> ArchSpec:
    spec = ARCHS.get(arch_id) or BONUS_ARCHS.get(arch_id)
    if spec is None:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return spec


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU tests (same cut as the JAX package)."""
    kw = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        vocab_size=512,
        pad_vocab_multiple=16,
    )
    if cfg.attention != "none":
        kw.update(num_heads=4, head_dim=16,
                  num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads else 0)
        if cfg.num_kv_heads == 1:
            kw["num_kv_heads"] = 1
    if cfg.d_ff:
        kw["d_ff"] = 128
    if cfg.attention == "mla":
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
                  qk_nope_dim=16, v_head_dim=16)
    if cfg.num_experts:
        kw.update(num_experts=8, experts_per_token=2, moe_d_ff=64,
                  first_k_dense=min(cfg.first_k_dense, 1),
                  mtp_depth=min(cfg.mtp_depth, 1))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)  # d_inner=128 -> 8 heads
    if cfg.shared_attn_interval:
        kw.update(shared_attn_interval=2, num_layers=4)
    if cfg.num_enc_layers:
        kw.update(num_enc_layers=2, enc_seq=16)
    if cfg.num_patches:
        kw.update(num_patches=8)
    return cfg.replace(**kw)


__all__ = ["ARCHS", "ARCH_IDS", "ArchSpec", "BONUS_ARCHS", "LM_SHAPES", "ModelConfig",
           "PORTED_FAMILIES", "ShapeConfig", "TrainConfig", "get_arch",
           "reduced"]
