"""Core functional layers: norms, MLP, RoPE, embeddings.

Port of ``repro/models/layers.py``. Parameters are ``nn.ParameterDict``s
keyed as in the JAX package, and dense weights are laid out (in, out) and
applied as ``x @ w``, so a JAX parameter tree maps onto them leaf by leaf.
``init_*`` draw from an explicit ``torch.Generator`` with the JAX package's
distributions (not its numbers); ``apply_*`` consume the parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as dev
from repro_torch.kernels import ops
from repro_torch.sharding import ctx


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.div_(math.sqrt(in_dim)).to(dtype)         # one fp32 copy alive


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32,
                 device: dev.DeviceLike = "cuda") -> nn.ParameterDict:
    return nn.ParameterDict({"scale": _param(torch.ones(
        dim, dtype=dtype, device=dev.resolve(device)))})


def apply_rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 math, result in x.dtype; the (B*S, D) rows go to ``ops.rmsnorm``,
    copied where they are not contiguous (a slice of a wider projection, as
    MLA's latent)."""
    D = x.shape[-1]
    return ops.rmsnorm(x.reshape(-1, D).contiguous(), p["scale"],
                       eps=eps).reshape(x.shape)


# ---------------------------------------------------------------------------
# MLP: gated (swiglu / geglu) or plain (gelu)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype=torch.float32) -> nn.ParameterDict:
    p = {}
    if act in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, d_model, d_ff, dtype)
        p["up"] = dense_init(gen, d_model, d_ff, dtype)
    else:
        p["up"] = dense_init(gen, d_model, d_ff, dtype)
    p["down"] = dense_init(gen, d_ff, d_model, dtype)
    return nn.ParameterDict({k: _param(v) for k, v in p.items()})


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion (bf16 @ f32 computes in f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(matmul(x, p["gate"])) * matmul(x, p["up"])
    elif act == "geglu":
        h = F.gelu(matmul(x, p["gate"]), approximate="tanh") * matmul(x, p["up"])
    else:
        h = F.gelu(matmul(x, p["up"]), approximate="tanh")
    return matmul(h, p["down"])


# ---------------------------------------------------------------------------
# RoPE (split-half, angles in fp32)
# ---------------------------------------------------------------------------

def _rope_tables(positions: torch.Tensor, dim: int, theta: float):
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs          # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    cos, sin = _rope_tables(positions, x.shape[-1], theta)
    cos = cos[..., None, :]                             # broadcast over heads
    sin = sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> nn.ParameterDict:
    return nn.ParameterDict({"table": _param(embed_init(gen, vocab, dim, dtype))})


def apply_embed(p, tokens: torch.Tensor) -> torch.Tensor:
    table = p["table"]
    if ctx.is_dtensor(table):
        return _embed_local(table, tokens)
    return table[tokens]


def _embed_local(table, tokens):
    """The lookup under a mesh, on local shards: the table gathered whole,
    each rank's tokens looked up, the rows keeping the tokens' placements;
    the table's gradient is partial over the axes that shard the tokens.
    (DTensor's own lookup fails in the backward's ``index_put`` sharding
    propagation on torch 2.11.)"""
    from torch.distributed.tensor import Partial, Replicate
    pl = tokens.placements if ctx.is_dtensor(tokens) else [Replicate()] * table.device_mesh.ndim
    (tab, tok), out = ops.enter_local(
        [(table, [Replicate()] * len(pl),
          [Partial() if q.is_shard() else Replicate() for q in pl]),
         (tokens, pl, None)], pl)
    return out(tab[tok])


def apply_lm_head(embed_params, x: torch.Tensor, head_params=None) -> torch.Tensor:
    """Tied (embed transpose) or untied head."""
    if head_params is not None:
        return matmul(x, head_params["w"])
    return x @ embed_params["table"].T.to(x.dtype)
