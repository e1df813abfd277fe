"""Attention: GQA/MHA and MLA (DeepSeek latent), full + decode paths.

Port of ``repro/models/attention.py`` in the same layouts: q (B, H, S, hd)
and a KV cache (B, KH, S, hd); MLA caches the compressed latent (B, S,
kv_lora_rank) and the shared RoPE key (B, S, qk_rope_dim). The
full-sequence paths go through ``ops.flash_attention`` (the CUDA kernel on
the card), which takes GQA by head index, Dv != D and any S; MLA's runs at
D = qk_nope + qk_rope and Dv = v_head_dim, where the kernel's scale D^-0.5
is the reference's explicit ``(nope + rope) ** -0.5``. ``blockwise_attention``
stays as the plain model-level version (key padding, separate
``qpos``/``kpos``) that the kernel is held against. Decode attention had no
Pallas kernel and stays plain PyTorch (MLA's absorbed form with fp32 scores
and softmax). The full GQA path takes the prefix-LM mask of the vlm family
and of the encoder (``prefix_len``).

Under a mesh each (B, S, heads x hd) projection is split into heads by
``ctx.split_heads``, which first gives up the model axis where the heads do
not divide it, and GQA decode over a cache laid out by ``cache_specs`` runs
on each rank's block of it (``_decode_on_shards``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import device as dev
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import shard, split_heads

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


def _block_attn(q, k, v, qpos, kpos, prefix_len, scale):
    """One KV block of online-softmax attention; returns (o, m, l) terms.
    Key j is valid for row i iff kpos[j] <= qpos[i] or kpos[j] < prefix_len
    (``prefix_len`` None: the causal test alone)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    mask = qpos[None, None, :, None] >= kpos[None, None, None, :]
    if prefix_len is not None:
        mask = mask | (kpos[None, None, None, :] < prefix_len)
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m_blk = s.amax(dim=-1)                              # (B,H,Sq)
    p = torch.exp(s - m_blk[..., None])
    l_blk = p.sum(dim=-1)
    o_blk = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return o_blk, m_blk, l_blk


def blockwise_attention(q, k, v, qpos, kpos, prefix_len=None, block: int = KV_BLOCK):
    """q: (B,H,Sq,hd), k/v: (B,H,Sk,hd). Returns (B,H,Sq,hd). Plain version,
    with ``_block_attn``'s mask."""
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
            kpos[s0:s0 + block], prefix_len, scale)
        m_new = torch.maximum(m, m_blk)
        a = torch.exp(m - m_new)
        b = torch.exp(m_blk - m_new)
        acc = acc * a[..., None] + o_blk * b[..., None]
        l = l * a + l_blk * b
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _qkv(p, cfg, x, seq_q="seq_q"):
    """(B, S, heads, hd) views of the projections, laid out for the
    (B, heads, S, hd) shards that follow: q by ("batch", "heads", ``seq_q``),
    k and v by ("batch", "heads"), as ``apply_attention_full`` takes them."""
    H, KH = cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q = split_heads(x @ p["wq"].to(dt), H, "batch", "heads", seq_q, None)
    k = split_heads(x @ p["wk"].to(dt), KH, "batch", "heads", None, None)
    v = split_heads(x @ p["wv"].to(dt), KH, "batch", "heads", None, None)
    return q, k, v


def apply_attention_full(p, cfg, x, positions, prefix_len=None):
    """x: (B,S,D_in) -> (B,S,D). Causal (or prefix-LM, keys below
    ``prefix_len`` seen by every row) full attention through the kernel;
    ``positions`` are 0..S-1, so the kernel's row indices are the positions."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    # (B,S,heads,hd) -> (B,heads,S,hd) views; the kernel reads them by stride.
    # K/V keep their KH heads (the kernel takes GQA by head index) under the
    # "heads" rule that JAX applies to them repeated to H.
    q = shard(q.transpose(1, 2), "batch", "heads", "seq_q", None)
    k = shard(k.transpose(1, 2), "batch", "heads", None, None)
    v = shard(v.transpose(1, 2), "batch", "heads", None, None)
    out = ops.flash_attention(q, k, v, causal=True, prefix_len=prefix_len or 0)
    out = out.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    return shard(out, "batch", None, "heads") @ p["wo"].to(x.dtype)


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device: dev.DeviceLike = "cuda"):
    hd, KH = cfg.head_dim, cfg.num_kv_heads
    device = dev.resolve(device)
    return {"k": torch.zeros((batch, KH, max_len, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, KH, max_len, hd), dtype=dtype, device=device)}


def apply_attention_decode(p, cfg, x, cache, index: int):
    """x: (B,1,D_in); cache k/v: (B,KH,S,hd); index: current position.

    Writes the new key and value into ``cache`` in place (the JAX version
    returns an updated copy) and returns (out (B,1,D), cache). A cache of
    DTensors (laid out by ``cache_specs``) is read and written on each
    rank's block (``_decode_on_shards``).
    """
    B = x.shape[0]
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q, k, v = _qkv(p, cfg, x, None)
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    if ctx.is_dtensor(cache["k"]):
        o = _decode_on_shards(q, k, v, cache, index)
        return o.to(dt) @ p["wo"].to(dt), cache
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


def _decode_on_shards(q, k, v, cache, index: int):
    """GQA decode on each rank's block of a cache of DTensors, whose batch,
    KV heads and positions may each be sharded (``cache_specs``): the new key
    and value go into the block that holds position ``index``, each rank
    scores the positions of its block (global positions for the mask), and
    the softmax over all of them is combined by a pmax of the maxima and
    psums of the exponential sums and weighted values over the mesh axes
    that shard the positions (the split-KV combine GSPMD derives for JAX's
    einsums); with the positions whole on every rank it is the unsharded
    path's softmax. The weights are normalised before they are rounded to
    the cache's dtype, as the unsharded path rounds them. q (B,1,H,hd),
    k and v (B,1,KH,hd) -> o (B,1,H*hd), sharded as the cache's batch and
    KV heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    kc, vc = cache["k"], cache["v"]
    mesh, pl = kc.device_mesh, tuple(kc.placements)
    if tuple(vc.placements) != pl or any(not isinstance(a, (Shard, Replicate)) for a in pl):
        raise ValueError(f"a decode cache of Shard/Replicate placements, got {pl}, "
                         f"{vc.placements}")
    # the token's rows by the cache's batch and heads, whole over its positions
    tok = [Shard(0) if a == Shard(0) else Shard(2) if a == Shard(1) else Replicate()
           for a in pl]
    seq_axes = [n for n, a in zip(mesh.mesh_dim_names, pl) if a == Shard(2)]
    (ql, kl, vl), _ = ops.enter_local([(t, tok, None) for t in (q, k, v)], tok)
    kcl, vcl = kc.to_local(), vc.to_local()
    rows = ctx.local_slices(kc.shape, mesh, pl)[2]
    if rows.start <= index < rows.stop:
        kcl[:, :, index - rows.start] = kl[:, 0].to(kcl.dtype)
        vcl[:, :, index - rows.start] = vl[:, 0].to(vcl.dtype)
    b, kh, _, hd = kcl.shape
    s = torch.einsum("bkgd,bksd->bkgs", ql.reshape(b, kh, -1, hd).float(),
                     kcl.float()) * hd ** -0.5
    valid = torch.arange(rows.start, rows.stop, device=s.device) <= index
    s = torch.where(valid, s, torch.full_like(s, NEG))
    if not seq_axes:
        w = torch.softmax(s, dim=-1)
    else:
        e = torch.exp(s - C.pmax_over(s.amax(dim=-1, keepdim=True), mesh, seq_axes))
        w = e / C.psum_over(e.sum(dim=-1, keepdim=True), mesh, seq_axes)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(vcl.dtype), vcl)
    if seq_axes:
        o = C.psum_over(o.float(), mesh, seq_axes).to(vcl.dtype)
    return DTensor.from_local(o.reshape(b, 1, -1), mesh, tok, run_check=False)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg, dtype=torch.float32) -> nn.ParameterDict:
    D, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return nn.ParameterDict({
        "wq_a": L._param(L.dense_init(gen, D, qr, dtype)),
        "q_norm": L.init_rmsnorm(qr, dtype, gen.device),
        "wq_b": L._param(L.dense_init(gen, qr, H * (nope + rope), dtype)),
        "wkv_a": L._param(L.dense_init(gen, D, kvr + rope, dtype)),
        "kv_norm": L.init_rmsnorm(kvr, dtype, gen.device),
        "wkv_b": L._param(L.dense_init(gen, kvr, H * (nope + vd), dtype)),
        "wo": L._param(L.dense_init(gen, H * vd, D, dtype)),
    })


def _mla_qkv(p, cfg, x, positions):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_kv (B,S,kvr) normed,
    k_rope (B,S,1,rope)), RoPE applied."""
    H, kvr = cfg.num_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    dt = x.dtype
    q = L.apply_rmsnorm(p["q_norm"], x @ p["wq_a"].to(dt), cfg.norm_eps)
    q = split_heads(q @ p["wq_b"].to(dt), H, "batch", "heads", "seq_q", None)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    kv = x @ p["wkv_a"].to(dt)                           # (B,S,kvr+rope)
    c_kv = L.apply_rmsnorm(p["kv_norm"], kv[..., :kvr], cfg.norm_eps)
    k_rope = L.apply_rope(kv[..., kvr:][..., None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def apply_mla_full(p, cfg, x, positions):
    """x: (B,S,D) -> (B,S,D), causal, through the kernel at D = nope + rope
    (the reference's scale (nope + rope)^-0.5 is the kernel's D^-0.5) and
    Dv = v_head_dim. k_nope and v are one product of the latent with
    ``wkv_b``, split by head; the RoPE key is broadcast to the H heads."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = x.dtype
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    kv = split_heads(c_kv @ p["wkv_b"].to(dt), H, "batch", "heads", None, None)
    k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, rope)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = kv[..., nope:]                                   # a strided view, by head
    q = shard(q.transpose(1, 2), "batch", "heads", "seq_q", None)
    k = shard(k.transpose(1, 2), "batch", "heads", None, None)
    v = shard(v.transpose(1, 2), "batch", "heads", None, None)
    out = ops.flash_attention(q, k, v, causal=True)
    out = out.transpose(1, 2).reshape(B, S, H * vd)
    return shard(out, "batch", None, "heads") @ p["wo"].to(dt)


def init_mla_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: dev.DeviceLike = "cuda"):
    """MLA caches the COMPRESSED latent (this is the point of MLA)."""
    device = dev.resolve(device)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                                  device=device)}


def apply_mla_decode(p, cfg, x, cache, index: int):
    """Absorbed-matmul MLA decode: attends in latent space over the cache,
    scores and softmax in fp32. Writes the new latent and RoPE key into
    ``cache`` in place; returns (out (B,1,D), cache)."""
    B = x.shape[0]
    H, kvr = cfg.num_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = x.dtype
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, cfg, x, pos)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[:, index] = c_kv_new[:, 0].to(c_kv.dtype)
    k_rope[:, index] = k_rope_new[:, 0, 0].to(k_rope.dtype)
    c_kv = shard(c_kv, "batch", "kv_seq", None)
    k_rope = shard(k_rope, "batch", "kv_seq", None)

    kvb = p["wkv_b"].to(dt).reshape(kvr, H, nope + vd)
    w_uk, w_uv = kvb[..., :nope], kvb[..., nope:]
    # absorb W_uk into the query -> latent-space scores
    q_lat = torch.einsum("bshn,chn->bshc", q_nope, w_uk)          # (B,1,H,kvr)
    s = torch.einsum("bshc,btc->bhst", q_lat.float(), c_kv.float())
    s = s + torch.einsum("bshr,btr->bhst", q_rope.float(), k_rope.float())
    s = s * (nope + rope) ** -0.5
    valid = torch.arange(c_kv.shape[1], device=x.device) <= index
    s = torch.where(valid, s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhst,btc->bshc", w.to(c_kv.dtype), c_kv)  # latent ctx
    o = torch.einsum("bshc,chn->bshn", ctx.to(dt), w_uv)          # (B,1,H,vd)
    return o.reshape(B, 1, H * vd) @ p["wo"].to(dt), cache
