"""Model assembly, family ``dense``: parameters, forward and decode.

Port of the dense half of ``repro/models/transformer.py``. The parameters
are an ``nn.ModuleDict`` whose keys follow the JAX tree: ``embed/table``,
``final_norm/scale``, ``lm_head/w`` and, per layer, ``layers/<i>/ln1``,
``attn/{wq,wk,wv,wo}``, ``ln2``, ``mlp/{gate,up,down}``. The JAX package
stacks the layers on a leading axis and scans over them; here they are an
``nn.ModuleList`` and a loop. Other families come with later slices.

``apply_lm``         : full-sequence forward -> (logits, aux)  [prefill/eval]
``apply_lm_decode``  : one-token forward with caches -> (logits, caches)
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch import device as dev
from repro_torch.models import attention as A
from repro_torch.models import layers as L

_LATER = {"moe": "the moe slice", "ssm": "the ssm/hybrid slice",
          "hybrid": "the ssm/hybrid slice", "encdec": "the vlm/encdec slice",
          "vlm": "the vlm/encdec slice"}


def _check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with "
            f"{_LATER.get(cfg.family, 'a later slice')}")


def _cdt(cfg) -> torch.dtype:
    return L.dtype_of(cfg.compute_dtype)


def _init_dense_layer(gen, cfg, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": A.init_attention(gen, cfg, dtype=dtype),
        "ln2": L.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
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
    params["layers"] = nn.ModuleList(
        [_init_dense_layer(gen, cfg, dtype) for _ in range(cfg.num_layers)])
    return params


def _dense_body(cfg, lp, h, positions):
    h = h + A.apply_attention_full(lp["attn"], cfg,
                                   L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps),
                                   positions)
    return h + L.apply_mlp(lp["mlp"], L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                           cfg.act)


def _head(params, cfg, h):
    """fp32 logits from a product in the compute dtype."""
    if "lm_head" in params:
        logits = h @ params["lm_head"]["w"].to(h.dtype)
    else:
        logits = h @ params["embed"]["table"].T.to(h.dtype)
    return logits.float()


def apply_lm(params, cfg, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B,S) int. Returns (logits (B,S,V) fp32, aux dict)."""
    _check_family(cfg)
    B, S = tokens.shape
    h = L.apply_embed(params["embed"], tokens).to(_cdt(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    for lp in params["layers"]:
        h = _dense_body(cfg, lp, h, positions)
    h = L.apply_rmsnorm(params["final_norm"], h, cfg.norm_eps)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=h.device)}
    return _head(params, cfg, h), aux


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                device: dev.DeviceLike = "cuda"):
    """One KV cache per layer: {"layers": [{"k", "v"}, ...]}."""
    _check_family(cfg)
    d = dev.resolve(device)
    return {"layers": [A.init_kv_cache(cfg, batch, max_len, dtype, d)
                       for _ in range(cfg.num_layers)]}


def apply_lm_decode(params, cfg, token: torch.Tensor, caches, index: int):
    """token: (B,1) int; index: current position. Updates ``caches`` in place.

    Returns (logits (B,1,V) fp32, caches).
    """
    _check_family(cfg)
    h = L.apply_embed(params["embed"], token).to(_cdt(cfg))
    for lp, cache in zip(params["layers"], caches["layers"]):
        a, _ = A.apply_attention_decode(
            lp["attn"], cfg, L.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps),
            cache, index)
        h = h + a
        h = h + L.apply_mlp(lp["mlp"], L.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                            cfg.act)
    h = L.apply_rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _head(params, cfg, h), caches
