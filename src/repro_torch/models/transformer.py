"""Model assembly for all six families (dense / moe / ssm / hybrid / encdec
/ vlm): parameters, forward and decode.

Port of ``repro/models/transformer.py``. The parameters
are an ``nn.ModuleDict`` whose keys follow the JAX tree: ``embed/table``,
``final_norm/scale``, ``lm_head/w`` and, per layer, ``layers/<i>/...``
(dense and vlm: ``ln1``, ``attn/{wq,wk,wv,wo}``, ``ln2``,
``mlp/{gate,up,down}``; ssm: ``ln``, ``ssm/...``). The hybrid family
(zamba2) has ``groups/<g>/<j>/...`` (``shared_attn_interval`` ssm layers
per group), ``leftover/<i>/...`` and one weight-shared attention+MLP block
``shared/...`` applied after every group over ``concat(h, emb0)``. The
encdec family (whisper) has ``enc_layers/<i>/...`` (dense layers over the
frames, bidirectional), ``enc_norm/scale`` and ``dec_layers/<i>/...``
(``ln1``, ``self_attn``, ``ln_x``, ``cross_attn`` over the encoder's
output, ``ln2``, ``mlp``). The vlm family (paligemma, vit) is the dense
stack over ``concat(patches, embed(tokens))`` with the patches a
bidirectional prefix. The moe family (olmoe, deepseek-v3) has
``dense_layers/<i>/...`` (deepseek's ``first_k_dense``: ``ln1``, ``attn``
(MLA or GQA), ``ln2``, ``mlp``), ``layers/<i>/...`` (the same with ``moe``
in place of ``mlp``: ``router``, ``experts/{gate,up,down}`` stacked on the
expert axis, ``shared``) and, with ``mtp_depth``, ``mtp/{proj, norm_h,
norm_e, block}``: the multi-token-prediction head, whose block is a dense
GQA layer at ``d_ff = moe_d_ff * experts_per_token``, as in JAX. The
modality frontends are stubs, as in the JAX package: frames and patches
arrive as (B, n, d_model) embeddings. The JAX package stacks the layers on
leading axes and scans over them; here they are ``nn.ModuleList``s and
loops.

``apply_lm``         : full-sequence forward -> (logits, aux)  [train/prefill]
``apply_lm_decode``  : one-token forward with caches -> (logits, caches)

``apply_lm(..., remat=)`` wraps each layer body as the JAX package's
``_remat`` does (``transformer.py:35``): ``"full"`` recomputes the whole
body in the backward (``torch.utils.checkpoint``, non-reentrant, the
counterpart of ``nothing_saveable``); ``"dots"`` keeps the outputs of the
plain matrix products (``aten.mm``) and recomputes the rest, the counterpart
of ``checkpoint_dots_with_no_batch_dims``; ``"none"`` calls it. Under
``"full"`` and ``"dots"`` the kernels in a body launch again during the
recompute, so a training step counts each layer's forward launches twice.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as dev
from repro_torch.configs import PORTED_FAMILIES
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.sharding.ctx import shard, split_heads


def _check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the families are "
                         f"{'/'.join(PORTED_FAMILIES)}")


def _cdt(cfg) -> torch.dtype:
    return L.dtype_of(cfg.compute_dtype)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the (B*S, in) x (in, out) products' outputs."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``fn`` wrapped for the remat policy ``mode`` (none | full | dots)."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got {mode!r}")
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def hybrid_split(cfg) -> Tuple[int, int]:
    """(groups, leftover layers) of the hybrid family."""
    return divmod(cfg.num_layers, cfg.shared_attn_interval)


# ---------------------------------------------------------------------------
# per-family layer init
# ---------------------------------------------------------------------------

def _init_dense_layer(gen, cfg, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": A.init_attention(gen, cfg, dtype=dtype),
        "ln2": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
    })


def _init_moe_attention(gen, cfg, dtype):
    return (A.init_mla(gen, cfg, dtype) if cfg.attention == "mla"
            else A.init_attention(gen, cfg, dtype=dtype))


def _init_moe_layer(gen, cfg, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": _init_moe_attention(gen, cfg, dtype),
        "ln2": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "moe": M.init_moe(gen, cfg, dtype),
    })


def _init_moe_dense_layer(gen, cfg, dtype) -> nn.ModuleDict:
    """DeepSeek first_k_dense layers: MLA attention + dense MLP."""
    return nn.ModuleDict({
        "ln1": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": _init_moe_attention(gen, cfg, dtype),
        "ln2": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
    })


def _mtp_cfg(cfg):
    """The MTP block's config: a dense GQA layer at moe_d_ff x k."""
    return cfg.replace(d_ff=cfg.moe_d_ff * cfg.experts_per_token)


def _init_ssm_layer(gen, cfg, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({"ln": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
                          "ssm": S.init_ssm(gen, cfg, dtype)})


def _init_encdec_dec_layer(gen, cfg, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "self_attn": A.init_attention(gen, cfg, dtype=dtype),
        "ln_x": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "cross_attn": A.init_attention(gen, cfg, dtype=dtype),
        "ln2": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
    })


def _init_shared_block(gen, cfg, dtype) -> nn.ModuleDict:
    """Zamba2 shared attention block over concat(hidden, embed0) = 2*d_model."""
    Dc = 2 * cfg.d_model
    mlp = {"gate": L.dense_init(gen, Dc, cfg.d_ff, dtype),
           "up": L.dense_init(gen, Dc, cfg.d_ff, dtype),
           "down": L.dense_init(gen, cfg.d_ff, cfg.d_model, dtype)}
    return nn.ModuleDict({
        "ln1": L.init_rmsnorm(Dc, dtype, gen.device),
        "attn": A.init_attention(gen, cfg, d_in=Dc, dtype=dtype),
        "ln2": L.init_rmsnorm(Dc, dtype, gen.device),
        "mlp": nn.ParameterDict({k: L._param(v) for k, v in mlp.items()}),
    })


def init_lm(cfg, seed: int = 0, *, device: dev.DeviceLike = "cuda") -> nn.ModuleDict:
    """Seeded random parameters at cfg's widths, drawn on ``device``."""
    _check_family(cfg)
    d = dev.resolve(device)
    gen = torch.Generator(device=d).manual_seed(seed)
    dtype = L.dtype_of(cfg.param_dtype)
    V, D = cfg.padded_vocab, cfg.d_model
    params = nn.ModuleDict({"embed": L.init_embed(gen, V, D, dtype),
                            "final_norm": L.init_rmsnorm(D, dtype, d)})
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.ParameterDict(
            {"w": L._param(L.dense_init(gen, D, V, dtype))})

    def stack(init, n):
        return nn.ModuleList([init(gen, cfg, dtype) for _ in range(n)])

    if cfg.family in ("dense", "vlm"):
        params["layers"] = stack(_init_dense_layer, cfg.num_layers)
    elif cfg.family == "moe":
        if cfg.first_k_dense:
            params["dense_layers"] = stack(_init_moe_dense_layer, cfg.first_k_dense)
        params["layers"] = stack(_init_moe_layer, cfg.num_layers - cfg.first_k_dense)
        if cfg.mtp_depth:
            params["mtp"] = nn.ParameterDict({
                "proj": L._param(L.dense_init(gen, 2 * D, D, dtype)),
                "norm_h": L.init_rmsnorm(D, dtype, d),
                "norm_e": L.init_rmsnorm(D, dtype, d),
                "block": _init_dense_layer(gen, _mtp_cfg(cfg), dtype)})
    elif cfg.family == "ssm":
        params["layers"] = stack(_init_ssm_layer, cfg.num_layers)
    elif cfg.family == "encdec":
        params["enc_layers"] = stack(_init_dense_layer, cfg.num_enc_layers)
        params["dec_layers"] = stack(_init_encdec_dec_layer, cfg.num_layers)
        params["enc_norm"] = L.init_rmsnorm(D, dtype, d)
    else:                                                    # hybrid
        n_groups, leftover = hybrid_split(cfg)
        params["groups"] = nn.ModuleList(
            [stack(_init_ssm_layer, cfg.shared_attn_interval)
             for _ in range(n_groups)])
        if leftover:
            params["leftover"] = stack(_init_ssm_layer, leftover)
        params["shared"] = _init_shared_block(gen, cfg, dtype)
    return params


# ---------------------------------------------------------------------------
# full-sequence bodies
# ---------------------------------------------------------------------------

def _dense_body(cfg, lp, h, positions, prefix_len=None):
    h = h + A.apply_attention_full(lp["attn"], cfg,
                                   L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps),
                                   positions, prefix_len)
    h = h + L.apply_mlp(lp["mlp"], L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                        cfg.act)
    return shard(h, "batch", None, None)


def _moe_attention(cfg, lp, x, positions):
    if cfg.attention == "mla":
        return A.apply_mla_full(lp["attn"], cfg, x, positions)
    return A.apply_attention_full(lp["attn"], cfg, x, positions)


def _moe_dense_body(cfg, lp, h, positions):
    """DeepSeek first_k_dense layers: MLA (or GQA) attention + dense MLP."""
    h = h + _moe_attention(cfg, lp, L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps), positions)
    h = h + L.apply_mlp(lp["mlp"], L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                        cfg.act)
    return shard(h, "batch", None, None)


def _moe_body(cfg, lp, h, positions):
    h = h + _moe_attention(cfg, lp, L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps), positions)
    y, aux = M.apply_moe(lp["moe"], cfg, L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps))
    return shard(h + y, "batch", None, None), aux


def _mtp(params, cfg, h, tokens, positions):
    """The multi-token-prediction head's logits: the next token's embedding
    beside the final hidden state, projected, one dense GQA block, the final
    norm and the head. Outside the remat'd layers, as in JAX."""
    mp = params["mtp"]
    e = L.apply_embed(params["embed"], torch.roll(tokens, -1, dims=1)).to(h.dtype)
    m = torch.cat([L.apply_rmsnorm(mp["norm_h"], h, cfg.norm_eps),
                   L.apply_rmsnorm(mp["norm_e"], e, cfg.norm_eps)], dim=-1)
    m = m @ mp["proj"].to(h.dtype)
    m = _dense_body(_mtp_cfg(cfg), mp["block"], m, positions)
    return _head(params, cfg, L.apply_rmsnorm(params["final_norm"], m, cfg.norm_eps))


def _ssm_body(cfg, lp, h):
    h = h + S.apply_ssm_full(lp["ssm"], cfg,
                             L.apply_rmsnorm(lp["ln"], h, cfg.norm_eps))
    return shard(h, "batch", None, None)


def _shared_mlp(cfg, sp, h, emb0):
    """The shared block's second half: h + MLP(ln2(concat(h, emb0)))."""
    m = L.apply_rmsnorm(sp["ln2"], torch.cat([h, emb0], dim=-1), cfg.norm_eps)
    mlp, dt = sp["mlp"], h.dtype
    m = F.silu(m @ mlp["gate"].to(dt)) * (m @ mlp["up"].to(dt))
    return shard(h + m @ mlp["down"].to(dt), "batch", None, None)


def _shared_body(cfg, sp, h, emb0, positions):
    c = torch.cat([h, emb0], dim=-1)
    h = h + A.apply_attention_full(sp["attn"], cfg,
                                   L.apply_rmsnorm(sp["ln1"], c, cfg.norm_eps),
                                   positions)
    return _shared_mlp(cfg, sp, h, emb0)


def _cross_attention(p, cfg, x, enc_out):
    """Decoder queries (B, Sq, D) over the encoder's output (B, Se, D), every
    key valid for every query and no RoPE (the JAX version's qpos = kpos = 0
    with prefix_len 1). K and V stay at KH heads: the kernel takes GQA by
    head index."""
    B, Sq, _ = x.shape
    Se = enc_out.shape[1]
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q = split_heads(x @ p["wq"].to(dt), H, "batch", "heads", None, None)
    k = split_heads(enc_out @ p["wk"].to(dt), KH, "batch", "heads", None, None)
    v = split_heads(enc_out @ p["wv"].to(dt), KH, "batch", "heads", None, None)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=False)
    out = out.transpose(1, 2).reshape(B, Sq, H * hd)
    return shard(out, "batch", None, "heads") @ p["wo"].to(dt)


def _decoder_body(cfg, lp, h, positions, enc_out):
    """An encdec decoder layer: causal self-attention, cross-attention over
    the encoder's output, MLP, each after its pre-norm."""
    h = h + A.apply_attention_full(lp["self_attn"], cfg,
                                   L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps), positions)
    h = h + _cross_attention(lp["cross_attn"], cfg,
                             L.apply_rmsnorm(lp["ln_x"], h, cfg.norm_eps), enc_out)
    h = h + L.apply_mlp(lp["mlp"], L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                        cfg.act)
    return shard(h, "batch", None, None)


def _encode(params, cfg, frames: torch.Tensor, *, remat: str = "none") -> torch.Tensor:
    """The encdec encoder: frames (B, Se, D) through the encoder layers, each
    bidirectional over the Se frames (prefix_len Se), then ``enc_norm``."""
    he = frames.to(_cdt(cfg))
    B, Se = he.shape[:2]
    epos = torch.arange(Se, dtype=torch.int32, device=he.device)[None].expand(B, Se)
    body = _remat(lambda hh, lp: _dense_body(cfg, lp, hh, epos, Se), remat)
    for lp in params["enc_layers"]:
        he = body(he, lp)
    return L.apply_rmsnorm(params["enc_norm"], he, cfg.norm_eps)


def _head(params, cfg, h):
    """fp32 logits from a product in the compute dtype."""
    if "lm_head" in params:
        logits = h @ params["lm_head"]["w"].to(h.dtype)
    else:
        logits = h @ params["embed"]["table"].T.to(h.dtype)
    return shard(logits.float(), "batch", None, "vocab")


def apply_lm(params, cfg, tokens: torch.Tensor, *, frames=None, patches=None,
             remat: str = "none") -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B,S) int; frames: (B, enc_S, D) [encdec]; patches: (B, P, D)
    [vlm], placed before the tokens as a bidirectional prefix. Returns
    (logits (B, S*, V) fp32, with S* = P + S for vlm, and an aux dict).
    ``remat`` wraps each layer body (none | full | dots), as the JAX
    ``apply_lm``. The aux dict holds ``moe_aux`` (the moe layers' summed
    load-balance loss, 0 for other families) and, for a moe model whose
    params have the ``mtp`` head, ``mtp_logits``."""
    _check_family(cfg)
    B = tokens.shape[0]
    h = L.apply_embed(params["embed"], tokens).to(_cdt(cfg))
    prefix_len = None
    if cfg.family == "vlm":
        h = torch.cat([patches.to(h.dtype), h], dim=1)
        prefix_len = cfg.num_patches
    h = shard(h, "batch", None, None)
    S_ = h.shape[1]
    positions = torch.arange(S_, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S_)
    moe_aux = torch.zeros((), dtype=torch.float32, device=h.device)
    mtp_logits = None
    if cfg.family in ("dense", "vlm"):
        body = _remat(lambda hh, lp: _dense_body(cfg, lp, hh, positions, prefix_len),
                      remat)
        for lp in params["layers"]:
            h = body(h, lp)
    elif cfg.family == "moe":
        dbody = _remat(lambda hh, lp: _moe_dense_body(cfg, lp, hh, positions), remat)
        for lp in (params["dense_layers"] if "dense_layers" in params else ()):
            h = dbody(h, lp)
        body = _remat(lambda hh, lp: _moe_body(cfg, lp, hh, positions), remat)
        for lp in params["layers"]:
            h, a = body(h, lp)
            moe_aux = moe_aux + a
        if cfg.mtp_depth and "mtp" in params:
            mtp_logits = _mtp(params, cfg, h, tokens, positions)
    elif cfg.family == "encdec":
        he = _encode(params, cfg, frames, remat=remat)
        body = _remat(lambda hh, lp, e: _decoder_body(cfg, lp, hh, positions, e), remat)
        for lp in params["dec_layers"]:
            h = body(h, lp, he)
    else:
        body = _remat(lambda hh, lp: _ssm_body(cfg, lp, hh), remat)
        if cfg.family == "ssm":
            for lp in params["layers"]:
                h = body(h, lp)
        else:                                                # hybrid
            emb0 = h
            for group in params["groups"]:
                for lp in group:
                    h = body(h, lp)
                h = _shared_body(cfg, params["shared"], h, emb0, positions)
            for lp in (params["leftover"] if "leftover" in params else ()):
                h = body(h, lp)
    h = L.apply_rmsnorm(params["final_norm"], h, cfg.norm_eps)
    aux = {"moe_aux": moe_aux}
    if mtp_logits is not None:
        aux["mtp_logits"] = mtp_logits
    return _head(params, cfg, h), aux


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                device: dev.DeviceLike = "cuda"):
    """Per-layer caches in the layout of the parameters: dense and vlm
    {"layers": [{"k", "v"}, ...]}; ssm {"layers": [{"state", "conv_*"}, ...]};
    hybrid {"groups": [[ssm cache, ...], ...], "shared": [kv cache per group],
    "leftover": [...]}; encdec {"self": [kv cache per decoder layer],
    "cross": [kv cache of ``enc_seq`` per decoder layer]}, the cross caches
    zero until ``fill_cross_caches`` writes them; moe {"layers": [...],
    "dense_layers": [...]}, MLA caches ({"c_kv", "k_rope"}) or KV caches. The ssm caches are fp32
    whatever ``dtype`` is, as in the JAX package."""
    _check_family(cfg)
    d = dev.resolve(device)

    def ssm_caches(n):
        return [S.init_ssm_cache(cfg, batch, device=d) for _ in range(n)]

    if cfg.family in ("dense", "vlm"):
        return {"layers": [A.init_kv_cache(cfg, batch, max_len, dtype, d)
                           for _ in range(cfg.num_layers)]}
    if cfg.family == "moe":
        init = A.init_mla_cache if cfg.attention == "mla" else A.init_kv_cache
        c = {"layers": [init(cfg, batch, max_len, dtype, d)
                        for _ in range(cfg.num_layers - cfg.first_k_dense)]}
        if cfg.first_k_dense:
            c["dense_layers"] = [init(cfg, batch, max_len, dtype, d)
                                 for _ in range(cfg.first_k_dense)]
        return c
    if cfg.family == "encdec":
        return {"self": [A.init_kv_cache(cfg, batch, max_len, dtype, d)
                         for _ in range(cfg.num_layers)],
                "cross": [A.init_kv_cache(cfg, batch, cfg.enc_seq, dtype, d)
                          for _ in range(cfg.num_layers)]}
    if cfg.family == "ssm":
        return {"layers": ssm_caches(cfg.num_layers)}
    n_groups, leftover = hybrid_split(cfg)
    c = {"groups": [ssm_caches(cfg.shared_attn_interval) for _ in range(n_groups)],
         "shared": [A.init_kv_cache(cfg, batch, max_len, dtype, d)
                    for _ in range(n_groups)]}
    if leftover:
        c["leftover"] = ssm_caches(leftover)
    return c


@torch.no_grad()
def fill_cross_caches(params, cfg, caches, frames: torch.Tensor):
    """Runs the encoder on ``frames`` and writes each decoder layer's
    cross-attention keys and values of its output into ``caches["cross"]``
    in place (as ``tests/test_models.py`` fills the JAX caches; the serving
    engine, as the JAX one, leaves them zero). Returns ``caches``."""
    he = _encode(params, cfg, frames)
    B, Se = he.shape[:2]
    hd, KH = cfg.head_dim, cfg.num_kv_heads
    for lp, cache in zip(params["dec_layers"], caches["cross"]):
        for name, w in (("k", "wk"), ("v", "wv")):
            t = (he @ lp["cross_attn"][w].to(he.dtype)).reshape(B, Se, KH, hd)
            cache[name].copy_(t.transpose(1, 2))
    return caches


def _cross_attention_decode(p, cfg, x, kc, vc):
    """One decoder token (B, 1, D) over cross caches k/v (B, KH, Se, hd):
    every key valid. Plain torch (the JAX version had no Pallas kernel)."""
    B = x.shape[0]
    hd, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, KH, H // KH, hd)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), kc.float()) * hd ** -0.5
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w.to(vc.dtype), vc)
    return o.reshape(B, 1, H * hd).to(dt) @ p["wo"].to(dt)


def _ssm_layers_decode(cfg, layers, h, caches):
    """Runs ssm layers one token; replaces each layer's cache in the list."""
    for i, lp in enumerate(layers):
        y, caches[i] = S.apply_ssm_decode(
            lp["ssm"], cfg, L.apply_rmsnorm(lp["ln"], h, cfg.norm_eps), caches[i])
        h = h + y
    return h


def apply_lm_decode(params, cfg, token: torch.Tensor, caches, index: int):
    """token: (B,1) int; index: current position. Updates ``caches`` in place
    (KV caches are written into, ssm caches replaced in their lists).

    Returns (logits (B,1,V) fp32, caches).
    """
    _check_family(cfg)
    h = L.apply_embed(params["embed"], token).to(_cdt(cfg))
    if cfg.family in ("dense", "vlm"):          # vlm decode sees no patches, as in JAX
        for lp, cache in zip(params["layers"], caches["layers"]):
            a, _ = A.apply_attention_decode(
                lp["attn"], cfg, L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps),
                cache, index)
            h = h + a
            h = h + L.apply_mlp(lp["mlp"], L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                                cfg.act)
    elif cfg.family == "moe":
        dec = A.apply_mla_decode if cfg.attention == "mla" else A.apply_attention_decode
        for lp, cache in zip(params["dense_layers"] if "dense_layers" in params else (),
                             caches.get("dense_layers", ())):
            a, _ = dec(lp["attn"], cfg, L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps),
                       cache, index)
            h = h + a
            h = h + L.apply_mlp(lp["mlp"], L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                                cfg.act)
        for lp, cache in zip(params["layers"], caches["layers"]):
            a, _ = dec(lp["attn"], cfg, L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps),
                       cache, index)
            h = h + a
            y, _ = M.apply_moe(lp["moe"], cfg, L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps))
            h = h + y
    elif cfg.family == "encdec":
        for lp, scache, xcache in zip(params["dec_layers"], caches["self"],
                                      caches["cross"]):
            a, _ = A.apply_attention_decode(
                lp["self_attn"], cfg, L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps),
                scache, index)
            h = h + a
            h = h + _cross_attention_decode(
                lp["cross_attn"], cfg, L.apply_rmsnorm(lp["ln_x"], h, cfg.norm_eps),
                xcache["k"], xcache["v"])
            h = h + L.apply_mlp(lp["mlp"], L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                                cfg.act)
    elif cfg.family == "ssm":
        h = _ssm_layers_decode(cfg, params["layers"], h, caches["layers"])
    else:                                                    # hybrid
        emb0, sp = h, params["shared"]
        for group, gcache, scache in zip(params["groups"], caches["groups"],
                                         caches["shared"]):
            h = _ssm_layers_decode(cfg, group, h, gcache)
            c = torch.cat([h, emb0], dim=-1)
            a, _ = A.apply_attention_decode(
                sp["attn"], cfg, L.apply_rmsnorm(sp["ln1"], c, cfg.norm_eps),
                scache, index)
            h = _shared_mlp(cfg, sp, h + a, emb0)
        if "leftover" in params:
            h = _ssm_layers_decode(cfg, params["leftover"], h, caches["leftover"])
    h = L.apply_rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _head(params, cfg, h), caches
