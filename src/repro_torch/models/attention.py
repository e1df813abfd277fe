"""Attention, GQA/MHA half: full-sequence and single-token decode paths.

Port of the GQA half of ``repro/models/attention.py`` in the same layouts:
q (B, H, S, hd) and a KV cache (B, KH, S, hd). The full-sequence path goes
through ``ops.flash_attention`` (the CUDA kernel on the card), which takes
GQA by head index and any S. ``blockwise_attention`` stays as the plain
model-level version (key padding, separate ``qpos``/``kpos``) that the
kernel is held against. Decode attention had no Pallas kernel and stays
plain PyTorch. The prefix-LM mask comes with the vlm slice, MLA (and its
own scale) with the moe slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import device as dev
from repro_torch.kernels import ops
from repro_torch.models import layers as L

KV_BLOCK = 1024
NEG = -1e30


def init_attention(gen: torch.Generator, cfg, d_in: Optional[int] = None,
                   dtype=torch.float32) -> nn.ParameterDict:
    """Projections from ``d_in`` (default d_model) wide inputs back to d_model."""
    d_in = d_in or cfg.d_model
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    p = {"wq": L.dense_init(gen, d_in, H * hd, dtype),
         "wk": L.dense_init(gen, d_in, KH * hd, dtype),
         "wv": L.dense_init(gen, d_in, KH * hd, dtype),
         "wo": L.dense_init(gen, H * hd, cfg.d_model, dtype)}
    return nn.ParameterDict({k: L._param(v) for k, v in p.items()})


def _block_attn(q, k, v, qpos, kpos, scale):
    """One KV block of online-softmax attention; returns (o, m, l) terms."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    mask = qpos[None, None, :, None] >= kpos[None, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m_blk = s.amax(dim=-1)                              # (B,H,Sq)
    p = torch.exp(s - m_blk[..., None])
    l_blk = p.sum(dim=-1)
    o_blk = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return o_blk, m_blk, l_blk


def blockwise_attention(q, k, v, qpos, kpos, block: int = KV_BLOCK):
    """q: (B,H,Sq,hd), k/v: (B,H,Sk,hd). Returns (B,H,Sq,hd). Plain version."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale = hd ** -0.5
    block = min(block, Sk)
    pad = (-Sk) % block
    if pad:  # pad keys; sentinel positions are masked out by the causal test
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=2 ** 30)
        Sk += pad
    acc = torch.zeros((B, H, Sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, H, Sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for s0 in range(0, Sk, block):
        o_blk, m_blk, l_blk = _block_attn(
            q, k[:, :, s0:s0 + block], v[:, :, s0:s0 + block], qpos,
            kpos[s0:s0 + block], scale)
        m_new = torch.maximum(m, m_blk)
        a = torch.exp(m - m_new)
        b = torch.exp(m_blk - m_new)
        acc = acc * a[..., None] + o_blk * b[..., None]
        l = l * a + l_blk * b
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _qkv(p, cfg, x, S):
    B = x.shape[0]
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, KH, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, KH, hd)
    return q, k, v


def apply_attention_full(p, cfg, x, positions):
    """x: (B,S,D_in) -> (B,S,D). Causal full attention through the kernel."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, S)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    # (B,S,heads,hd) -> (B,heads,S,hd) views; the kernel reads them by stride
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True)
    out = out.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype)


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device: dev.DeviceLike = "cuda"):
    hd, KH = cfg.head_dim, cfg.num_kv_heads
    device = dev.resolve(device)
    return {"k": torch.zeros((batch, KH, max_len, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, KH, max_len, hd), dtype=dtype, device=device)}


def apply_attention_decode(p, cfg, x, cache, index: int):
    """x: (B,1,D_in); cache k/v: (B,KH,S,hd); index: current position.

    Writes the new key and value into ``cache`` in place (the JAX version
    returns an updated copy) and returns (out (B,1,D), cache).
    """
    B = x.shape[0]
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q, k, v = _qkv(p, cfg, x, 1)
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    k_c, v_c = cache["k"], cache["v"]
    k_c[:, :, index] = k[:, 0].to(k_c.dtype)
    v_c[:, :, index] = v[:, 0].to(v_c.dtype)

    G = H // KH
    qg = q.reshape(B, KH, G, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), k_c.float()) * hd ** -0.5
    S = k_c.shape[2]
    valid = torch.arange(S, device=x.device) <= index
    s = torch.where(valid, s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(v_c.dtype), v_c)
    o = o.reshape(B, 1, H * hd).to(dt)
    return o @ p["wo"].to(dt), cache
