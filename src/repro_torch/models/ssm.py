"""Mamba2 SSD block: chunked full-sequence scan and O(1)-state decode.

Port of ``repro/models/ssm.py`` in the same layouts and parameter keys. The
full-sequence path sends the chunked scan to ``ops.ssd_scan`` (the CUDA
kernel on the card), which reads B and C per group, so nothing is repeated
per head. The decode step had no Pallas kernel and stays plain PyTorch.

JAX promotes mixed types silently; ``torch.einsum`` and ``torch.cat`` do
not. Where the JAX code mixes them (the fp32 decode caches against a bf16
token and bf16 weights in ``_conv_step``), the port casts to the type JAX
promotes to, so each intermediate has JAX's dtype. ``dt``, ``dA``, the
dt-scaled input and the state are fp32, as in the JAX code.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as dev
from repro_torch.kernels import ops
from repro_torch.models import layers as L

# Leaves drawn in float32 whatever the param type, as in the JAX code.
FP32_PARAMS = ("dt_bias", "A_log", "D_skip")


def dims(cfg) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_ngroups, cfg.ssm_state


def init_ssm(gen: torch.Generator, cfg, dtype=torch.float32) -> nn.ParameterDict:
    D = cfg.d_model
    d_in, H, G, N = dims(cfg)
    K = cfg.ssm_conv
    where = gen.device

    def conv(width):
        w = torch.randn((K, width), generator=gen, dtype=torch.float32, device=where)
        return L._param((w * 0.1).to(dtype))

    def f32(fill):
        return L._param(torch.full((H,), fill, dtype=torch.float32, device=where))

    return nn.ParameterDict({
        "in_z": L._param(L.dense_init(gen, D, d_in, dtype)),
        "in_x": L._param(L.dense_init(gen, D, d_in, dtype)),
        "in_B": L._param(L.dense_init(gen, D, G * N, dtype)),
        "in_C": L._param(L.dense_init(gen, D, G * N, dtype)),
        "in_dt": L._param(L.dense_init(gen, D, H, dtype)),
        "dt_bias": f32(0.0),
        "conv_x": conv(d_in),
        "conv_B": conv(G * N),
        "conv_C": conv(G * N),
        "A_log": f32(0.0),                               # A = -exp(A_log) = -1
        "D_skip": f32(1.0),
        "gate_norm": L.init_rmsnorm(d_in, dtype, where),
        "out": L._param(L.dense_init(gen, d_in, D, dtype)),
    })


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u: (B,S,C), w: (K,C)."""
    K, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for i in range(K):                                   # K=4: unrolled taps
        out = out + pad[:, i: i + S, :] * w[i][None, None, :]
    return out


def ssd_chunked(xh, dt, a_log, Bm, Cm, chunk: int):
    """Chunked SSD scan through ``ops.ssd_scan``.

    xh: (B,S,H,P) inputs; dt: (B,S,H) positive step sizes;
    a_log: (H,) with A = -exp(a_log); Bm/Cm: (B,S,G,N). ``chunk`` (capped at
    S) must divide S. Returns y: (B,S,H,P) in xh.dtype and the final state
    (B,H,P,N) fp32.
    """
    A = -torch.exp(a_log.float())                        # (H,) negative
    dA = dt.float() * A[None, None, :]                   # (B,S,H) log-decay <0
    xbar = xh.float() * dt.float()[..., None]
    y, state = ops.ssd_scan(xbar, dA, Bm, Cm, chunk=chunk, return_state=True)
    return y.to(xh.dtype), state.transpose(-1, -2)       # state (B,H,P,N)


def apply_ssm_full(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D). Full-sequence chunked SSD."""
    B, S, D = x.shape
    d_in, H, G, N = dims(cfg)
    dt_ = x.dtype
    z = x @ p["in_z"].to(dt_)
    xs = _causal_conv(x @ p["in_x"].to(dt_), p["conv_x"].to(dt_))
    Bm = _causal_conv(x @ p["in_B"].to(dt_), p["conv_B"].to(dt_))
    Cm = _causal_conv(x @ p["in_C"].to(dt_), p["conv_C"].to(dt_))
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    dt = F.softplus((x @ p["in_dt"].to(dt_)).float() + p["dt_bias"][None, None, :])

    xh = xs.reshape(B, S, H, cfg.ssm_head_dim)
    y, _ = ssd_chunked(xh, dt, p["A_log"], Bm.reshape(B, S, G, N),
                       Cm.reshape(B, S, G, N), cfg.ssm_chunk)
    y = y + xh * p["D_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = L.apply_rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out"].to(dt_)


def init_ssm_cache(cfg, batch: int, dtype=torch.float32,
                   device: dev.DeviceLike = "cuda"):
    d_in, H, G, N = dims(cfg)
    device = dev.resolve(device)
    K = cfg.ssm_conv
    return {
        "state": torch.zeros((batch, H, cfg.ssm_head_dim, N), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((batch, K - 1, d_in), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, K - 1, G * N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, K - 1, G * N), dtype=dtype, device=device),
    }


def _conv_step(u1, conv_state, w):
    """u1: (B,1,C); conv_state: (B,K-1,C); w: (K,C). JAX's promotion: the
    window takes the wider of the two types, the product the wider of that
    and w's."""
    wdt = torch.promote_types(conv_state.dtype, u1.dtype)
    window = torch.cat([conv_state.to(wdt), u1.to(wdt)], dim=1)      # (B,K,C)
    odt = torch.promote_types(wdt, w.dtype)
    out = torch.einsum("bkc,kc->bc", window.to(odt), w.to(odt))[:, None, :]
    return out, window[:, 1:, :]


def apply_ssm_decode(p, cfg, x: torch.Tensor, cache):
    """x: (B,1,D); O(1)-state recurrent decode step. Returns (out, new cache)."""
    B = x.shape[0]
    d_in, H, G, N = dims(cfg)
    Pd = cfg.ssm_head_dim
    dt_ = x.dtype
    z = x @ p["in_z"].to(dt_)
    xs_raw = x @ p["in_x"].to(dt_)
    Bm_raw = x @ p["in_B"].to(dt_)
    Cm_raw = x @ p["in_C"].to(dt_)
    xs, cs_x = _conv_step(xs_raw, cache["conv_x"], p["conv_x"].to(dt_))
    Bm, cs_B = _conv_step(Bm_raw, cache["conv_B"], p["conv_B"].to(dt_))
    Cm, cs_C = _conv_step(Cm_raw, cache["conv_C"], p["conv_C"].to(dt_))
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    dt = F.softplus((x @ p["in_dt"].to(dt_)).float()
                    + p["dt_bias"][None, None, :])[:, 0]           # (B,H)

    xh = xs.reshape(B, H, Pd).float()
    Bv = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    Cv = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()

    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A[None, :])                               # (B,H)
    state = cache["state"] * decay[:, :, None, None]
    state = state + torch.einsum("bhp,bhn,bh->bhpn", xh, Bv, dt)
    y = torch.einsum("bhpn,bhn->bhp", state, Cv)
    y = y + xh * p["D_skip"][None, :, None]
    y = y.reshape(B, 1, d_in).to(dt_)
    y = L.apply_rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out"].to(dt_)
    return out, {"state": state, "conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C}
