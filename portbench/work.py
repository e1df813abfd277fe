"""The yardstick's arithmetic: the card's peaks, each kernel call's bytes and
least time of operations, the products' work, and the model's products per
optimizer step.

Frozen copies of ``repro_torch/roofline/analysis.py``'s ``valid_pairs``,
``ssd_ops_s``, ``ssd_bwd_ops_s``, ``kernel_work`` (flash and ssd parts) and
``bound``, so that a later change to the program cannot move the ruler it is
measured by. Only the causal-pairs sum is written in closed form.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_BF16 = 989e12          # FLOP/s on the tensor cores, bf16 operands
PEAK_FP32 = 67e12           # FLOP/s outside the tensor cores
HBM_BW = 3.35e12            # bytes/s
PEAK_BY_DTYPE = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16, "float32": PEAK_FP32}
SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def valid_pairs(Sq: int, Sk: int, causal: bool, prefix: int = 0) -> int:
    """(row, key) pairs the mask lets through: under ``causal`` row i sees
    keys j <= i, and every key j < ``prefix``."""
    if not causal:
        return Sq * Sk
    if prefix:
        return sum(min(Sk, max(i + 1, prefix)) for i in range(Sq))
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + (Sq - n) * Sk


def split_tc_s(rows: int, products) -> float:
    return rows * sum(f * t for f, t in products) / PEAK_BF16


def _bc_terms(bc_dtype: str):
    return (1, 2) if bc_dtype == "bfloat16" else (3, 3)


def ssd_ops_s(BH: int, S: int, P: int, N: int, Q: int, bc_dtype: str,
              heads_per_group: int = 1) -> Tuple[float, str]:
    """Least seconds of one SSD scan's operations: the smallest of the
    recurrence's 5 N P fp32 flops a row and head, the chunked form's (C B^T
    at B/C's own rate once a group, the rest fp32) and the chunked form's
    products on the bf16 tensor cores with their split terms."""
    rows = BH * S
    recurrence = 5 * rows * N * P / PEAK_FP32
    chunked = rows * (Q * N / heads_per_group / PEAK_BY_DTYPE[bc_dtype]
                      + (Q * P + 4 * N * P) / PEAK_FP32)
    cb, with_bc = _bc_terms(bc_dtype)
    tensor = split_tc_s(rows, [(Q * N / heads_per_group, cb), (Q * P, 3),
                               (4 * N * P, with_bc)])
    return min((recurrence, "recurrence"), (chunked, "chunked"),
               (tensor, "chunked_tensor_cores"))


def ssd_bwd_ops_s(BH: int, S: int, P: int, N: int, Q: int, bc_dtype: str,
                  heads_per_group: int = 1) -> Tuple[float, str]:
    """Least seconds of one SSD scan backward's operations: the reverse
    recurrence's 14 N P fp32 flops a row and head, the chunked form's, and
    the chunked form's on the tensor cores with their split terms."""
    rows = BH * S
    recurrence = 14 * rows * N * P / PEAK_FP32
    chunked = rows * (Q * N / heads_per_group / PEAK_BY_DTYPE[bc_dtype]
                      + (2 * Q * P + 2 * Q * N + 8 * N * P) / PEAK_FP32)
    cb, with_bc = _bc_terms(bc_dtype)
    tensor = split_tc_s(rows, [(Q * N / heads_per_group, cb), (2 * Q * P, 3),
                               (2 * Q * N, with_bc), (4 * N * P, with_bc),
                               (4 * N * P, 3)])
    return min((recurrence, "recurrence"), (chunked, "chunked"),
               (tensor, "chunked_tensor_cores"))


def kernel_work(name: str, f: Dict) -> Tuple[float, float]:
    """(bytes, least seconds of operations) of one call of ``name``
    (flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd) with the
    call's shape fields ``f``: each input byte read once, each output byte
    written once; flash over the mask's valid pairs (forward two products,
    backward five: S recomputed, dV, dP, dQ, dK)."""
    if name in ("flash_attention", "flash_attention_bwd"):
        B, H, KH, Sq, Sk, D, Dv = (f[k] for k in ("B", "H", "KH", "Sq", "Sk", "D", "Dv"))
        es = SIZE[f["dtype"]]
        pairs = valid_pairs(Sq, Sk, f["causal"], f["prefix_len"])
        q, kv = B * H * Sq, B * KH * Sk
        peak = PEAK_BY_DTYPE[f["dtype"]]
        if name == "flash_attention":
            nbytes = (q * D + kv * D + kv * Dv + q * Dv) * es + (4 * q if f.get("lse") else 0)
            return nbytes, 2 * B * H * pairs * (D + Dv) / peak
        nbytes = (2 * q * D + 2 * kv * D + 2 * kv * Dv + 2 * q * Dv) * es + 4 * q
        return nbytes, 2 * B * H * pairs * (3 * D + 2 * Dv) / peak
    B, S, H, G, P, N, Q = (f[k] for k in ("B", "S", "H", "G", "P", "N", "chunk"))
    bc = SIZE[f["bc_dtype"]]
    x = B * S * H * P
    if name == "ssd_scan":
        ops_s, _ = ssd_ops_s(B * H, S, P, N, Q, f["bc_dtype"], H // G)
        return 2 * x * f.get("x_bytes", 4) + 4 * B * S * H + 2 * B * S * G * N * bc, ops_s
    ops_s, _ = ssd_bwd_ops_s(B * H, S, P, N, Q, f["bc_dtype"], H // G)
    nbytes = (3 * x * 4 + 4 * B * S * G * N * bc + 8 * B * H * S
              + 4 * B * H * (S // Q) * N * P + 4 * B * S * H
              + (2 * 4 * B * H * N * P if f.get("dstate") else 0))
    return nbytes, ops_s


def bound_s(nbytes: float, ops_s: float) -> float:
    """The least time: the larger of the bytes at ``HBM_BW`` and the
    operations' seconds."""
    return max(nbytes / HBM_BW, ops_s)


# ---------------------------------------------------------------------------
# products (cuBLAS) from an aten op's input shapes
# ---------------------------------------------------------------------------

PRODUCT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def product_work(op: str, shapes: Sequence[Sequence[int]], dtype: str = "bfloat16"
                 ) -> Tuple[float, float]:
    """(flops, least seconds) of one product op from its input shapes:
    2 M K N (times the batch), at the operands' peak, or the operands and
    the result at ``HBM_BW`` where that takes longer."""
    if op == "aten::mm":
        (M, K), (_, N) = shapes[0], shapes[1]
        b = 1
    elif op == "aten::addmm":
        (M, K), (_, N) = shapes[1], shapes[2]
        b = 1
    elif op == "aten::bmm":
        (b, M, K), (_, _, N) = shapes[0], shapes[1]
    elif op == "aten::baddbmm":
        (b, M, K), (_, _, N) = shapes[1], shapes[2]
    else:
        raise ValueError(f"not a product op: {op}")
    flops = 2.0 * b * M * K * N
    nbytes = b * (M * K + K * N + M * N) * SIZE.get(dtype, 2)
    return flops, bound_s(nbytes, flops / PEAK_BY_DTYPE.get(dtype, PEAK_BF16))


# ---------------------------------------------------------------------------
# the model's products per optimizer step (for mfu)
# ---------------------------------------------------------------------------

def attention_products(m: Dict, B: int, S: int, d_in: int) -> float:
    """One causal attention layer from ``d_in`` wide inputs back to
    ``d_model``: the four projections, 2 T in out each, and 2 (D + Dv) a
    valid (row, key) pair and head."""
    T, H, KH, hd = B * S, m["num_heads"], m["num_kv_heads"], m["head_dim"]
    proj = 2.0 * T * d_in * (H + 2 * KH) * hd + 2.0 * T * H * hd * m["d_model"]
    return proj + 2.0 * B * H * valid_pairs(S, S, True) * (hd + hd)


def mlp_products(m: Dict, T: int, d_in: int, d_out: int) -> float:
    """One MLP of ``d_ff`` over T rows: two input matrices where ``act`` is
    gated (swiglu, geglu), one where it is not (gelu), and the down matrix."""
    ins = 2 if m["act"] in ("swiglu", "geglu") else 1
    return ins * 2.0 * T * d_in * m["d_ff"] + 2.0 * T * m["d_ff"] * d_out


def ssm_products(m: Dict, B: int, S: int) -> float:
    """One Mamba2 layer: the input projections (z, x, B, C, dt), the output
    projection, and the SSD scan's chunked products, 2 (Q N + Q P + 2 N P) a
    row and head. The depthwise convolution is no product."""
    T, D = B * S, m["d_model"]
    d_in = m["ssm_expand"] * D
    Hs = d_in // m["ssm_head_dim"]
    G, N, P, Q = m["ssm_ngroups"], m["ssm_state"], m["ssm_head_dim"], min(m["ssm_chunk"], S)
    return (2.0 * T * D * (2 * d_in + 2 * G * N + Hs) + 2.0 * T * d_in * D
            + 2.0 * T * Hs * (Q * N + Q * P + 2 * N * P))


def forward_products(m: Dict, B: int, S: int) -> float:
    """Product FLOPs of one forward over (B, S) tokens of the model ``m``
    (a configuration file's ``model`` dict), with no recompute: the layers
    as the family's file counts them (``families/<family>.py``), and the
    head, 2 T D V over the padded vocabulary. An embedding lookup and a norm
    are no products."""
    from portbench import families
    V = -(-m["vocab_size"] // m["pad_vocab_multiple"]) * m["pad_vocab_multiple"]
    return (2.0 * B * S * m["d_model"] * V
            + families.load(m["family"]).forward_products(m, B, S))


def model_flops_per_step(m: Dict, micro_batch: int, seq: int, accum_steps: int) -> float:
    """Products of one optimizer step with no recompute: each micro-batch's
    forward and its backward, twice the forward (both operands' gradients)."""
    return 3.0 * accum_steps * forward_products(m, micro_batch, seq)

