"""Config dataclasses for the PyTorch port (a copy of the JAX package's).

Every assigned architecture is expressed as a ``ModelConfig`` (+ a
``TrainConfig`` for optimizer/remat policy).  Shapes (seq_len x global_batch
cells) are ``ShapeConfig``s shared across LM-family archs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention flavour
    attention: str = "gqa"          # gqa | mla | none
    rope_theta: float = 10_000.0
    prefix_lm: bool = False         # bidirectional prefix (vlm)

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0          # leading dense layers (deepseek)
    router_type: str = "softmax"    # softmax | sigmoid (deepseek v3)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001

    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # --- hybrid (zamba2) ---
    shared_attn_interval: int = 0   # apply the single shared attn block every k layers

    # --- encoder-decoder (whisper) ---
    num_enc_layers: int = 0
    enc_seq: int = 0                # stub frame count (post-conv)

    # --- vlm (paligemma) ---
    num_patches: int = 0            # stub patch-embedding count

    # misc
    norm_eps: float = 1e-5
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    mtp_depth: int = 0              # deepseek multi-token prediction heads
    pad_vocab_multiple: int = 256
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # source provenance (kept for DESIGN/EXPERIMENTS cross-reference)
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        if self.vocab_size == 0:
            return 0
        return _round_up(self.vocab_size, self.pad_vocab_multiple)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # parameter counting (analytic; used for MODEL_FLOPS and roofline)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        """Returns dict(total=..., active=...) parameter counts (analytic)."""
        D = self.d_model
        V = self.padded_vocab
        embed = V * D
        head = 0 if self.tie_embeddings else V * D

        def attn_params() -> int:
            if self.attention == "mla":
                p = 0
                if self.q_lora_rank:
                    p += D * self.q_lora_rank
                    p += self.q_lora_rank * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                else:
                    p += D * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                p += D * (self.kv_lora_rank + self.qk_rope_dim)
                p += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                p += self.num_heads * self.v_head_dim * D
                return p
            hd = self.head_dim
            return (D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd
                    + self.num_heads * hd * D)

        def mlp_params(ff: int) -> int:
            mult = 3 if self.act == "swiglu" else 2
            return mult * D * ff

        def ssm_params() -> int:
            d_in = self.ssm_expand * D
            nheads = d_in // self.ssm_head_dim
            conv_dim = d_in + 2 * self.ssm_ngroups * self.ssm_state
            p = D * (2 * d_in + 2 * self.ssm_ngroups * self.ssm_state + nheads)  # in_proj
            p += conv_dim * self.ssm_conv                                        # conv1d
            p += nheads * 2                                                      # A_log, D
            p += d_in                                                             # gate norm
            p += d_in * D                                                         # out_proj
            return p

        total = embed + head
        active = embed + head
        if self.family == "ssm":
            per = ssm_params() + D
            total += self.num_layers * per
            active += self.num_layers * per
        elif self.family == "hybrid":
            per = ssm_params() + D
            total += self.num_layers * per
            active += self.num_layers * per
            # one shared attention block over concat(2D) input
            Dc = 2 * D
            hd = self.head_dim
            shared = (Dc * self.num_heads * hd + 2 * Dc * self.num_kv_heads * hd
                      + self.num_heads * hd * D + mlp_params(self.d_ff) + 2 * Dc)
            total += shared
            active += shared
        elif self.family == "moe":
            a = attn_params() + 2 * D
            total += self.num_layers * a
            active += self.num_layers * a
            n_moe = self.num_layers - self.first_k_dense
            total += self.first_k_dense * mlp_params(self.d_ff)
            active += self.first_k_dense * mlp_params(self.d_ff)
            per_exp = mlp_params(self.moe_d_ff)
            total += n_moe * (self.num_experts * per_exp
                              + self.num_shared_experts * per_exp
                              + D * self.num_experts)
            active += n_moe * (self.experts_per_token * per_exp
                               + self.num_shared_experts * per_exp
                               + D * self.num_experts)
            if self.mtp_depth:
                mtp = self.mtp_depth * (a + self.num_experts * per_exp * 0 + mlp_params(self.moe_d_ff) * self.experts_per_token + 2 * D * D)
                total += self.mtp_depth * (a + self.num_experts * per_exp + 2 * D * D)
                active += mtp
        elif self.family == "encdec":
            enc = attn_params() + mlp_params(self.d_ff) + 2 * D
            dec = 2 * attn_params() + mlp_params(self.d_ff) + 3 * D
            total += self.num_enc_layers * enc + self.num_layers * dec
            active += self.num_enc_layers * enc + self.num_layers * dec
        else:  # dense, vlm
            per = attn_params() + mlp_params(self.d_ff) + 2 * D
            total += self.num_layers * per
            active += self.num_layers * per
        return {"total": int(total), "active": int(active)}


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"        # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    remat: str = "none"             # none | full | dots
    accum_steps: int = 1            # microbatch gradient accumulation
    grad_compression: str = "none"  # none | int8 (error-feedback DP compression)
    zero1: bool = False             # shard optimizer state over the data axis


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


@dataclass(frozen=True)
class ArchSpec:
    """An assigned architecture: model + train policy + shape applicability."""
    model: ModelConfig
    train: TrainConfig
    # shape-name -> None (runs) or reason string (skip)
    skips: dict = field(default_factory=dict)

    def applicable_shapes(self):
        return [s for s in LM_SHAPES if s.name not in self.skips]
