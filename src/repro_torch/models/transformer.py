"""Model assembly, families ``dense``, ``ssm`` and ``hybrid``: parameters,
forward and decode.

Port of those families in ``repro/models/transformer.py``. The parameters
are an ``nn.ModuleDict`` whose keys follow the JAX tree: ``embed/table``,
``final_norm/scale``, ``lm_head/w`` and, per layer, ``layers/<i>/...``
(dense: ``ln1``, ``attn/{wq,wk,wv,wo}``, ``ln2``, ``mlp/{gate,up,down}``;
ssm: ``ln``, ``ssm/...``). The hybrid family (zamba2) has
``groups/<g>/<j>/...`` (``shared_attn_interval`` ssm layers per group),
``leftover/<i>/...`` and one weight-shared attention+MLP block ``shared/...``
applied after every group over ``concat(h, emb0)``. The JAX package stacks
the layers on leading axes and scans over them; here they are
``nn.ModuleList``s and loops. Other families come with later slices.

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
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

_LATER = {"moe": "the moe slice", "encdec": "the vlm/encdec slice",
          "vlm": "the vlm/encdec slice"}


def _check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with "
            f"{_LATER.get(cfg.family, 'a later slice')}")


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


def _init_ssm_layer(gen, cfg, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({"ln": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
                          "ssm": S.init_ssm(gen, cfg, dtype)})


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

    if cfg.family == "dense":
        params["layers"] = stack(_init_dense_layer, cfg.num_layers)
    elif cfg.family == "ssm":
        params["layers"] = stack(_init_ssm_layer, cfg.num_layers)
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

def _dense_body(cfg, lp, h, positions):
    h = h + A.apply_attention_full(lp["attn"], cfg,
                                   L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps),
                                   positions)
    return h + L.apply_mlp(lp["mlp"], L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                           cfg.act)


def _ssm_body(cfg, lp, h):
    return h + S.apply_ssm_full(lp["ssm"], cfg,
                                L.apply_rmsnorm(lp["ln"], h, cfg.norm_eps))


def _shared_mlp(cfg, sp, h, emb0):
    """The shared block's second half: h + MLP(ln2(concat(h, emb0)))."""
    m = L.apply_rmsnorm(sp["ln2"], torch.cat([h, emb0], dim=-1), cfg.norm_eps)
    mlp, dt = sp["mlp"], h.dtype
    m = F.silu(m @ mlp["gate"].to(dt)) * (m @ mlp["up"].to(dt))
    return h + m @ mlp["down"].to(dt)


def _shared_body(cfg, sp, h, emb0, positions):
    c = torch.cat([h, emb0], dim=-1)
    h = h + A.apply_attention_full(sp["attn"], cfg,
                                   L.apply_rmsnorm(sp["ln1"], c, cfg.norm_eps),
                                   positions)
    return _shared_mlp(cfg, sp, h, emb0)


def _head(params, cfg, h):
    """fp32 logits from a product in the compute dtype."""
    if "lm_head" in params:
        logits = h @ params["lm_head"]["w"].to(h.dtype)
    else:
        logits = h @ params["embed"]["table"].T.to(h.dtype)
    return logits.float()


def apply_lm(params, cfg, tokens: torch.Tensor, *,
             remat: str = "none") -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B,S) int. Returns (logits (B,S,V) fp32, aux dict). ``remat``
    wraps each layer body (none | full | dots), as the JAX ``apply_lm``."""
    _check_family(cfg)
    B, S_ = tokens.shape
    h = L.apply_embed(params["embed"], tokens).to(_cdt(cfg))
    positions = torch.arange(S_, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S_)
    if cfg.family == "dense":
        body = _remat(lambda hh, lp: _dense_body(cfg, lp, hh, positions), remat)
        for lp in params["layers"]:
            h = body(h, lp)
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
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=h.device)}
    return _head(params, cfg, h), aux


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                device: dev.DeviceLike = "cuda"):
    """Per-layer caches in the layout of the parameters: dense
    {"layers": [{"k", "v"}, ...]}; ssm {"layers": [{"state", "conv_*"}, ...]};
    hybrid {"groups": [[ssm cache, ...], ...], "shared": [kv cache per group],
    "leftover": [...]}. The ssm caches are fp32 whatever ``dtype`` is, as in
    the JAX package."""
    _check_family(cfg)
    d = dev.resolve(device)

    def ssm_caches(n):
        return [S.init_ssm_cache(cfg, batch, device=d) for _ in range(n)]

    if cfg.family == "dense":
        return {"layers": [A.init_kv_cache(cfg, batch, max_len, dtype, d)
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
    if cfg.family == "dense":
        for lp, cache in zip(params["layers"], caches["layers"]):
            a, _ = A.apply_attention_decode(
                lp["attn"], cfg, L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps),
                cache, index)
            h = h + a
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
