"""Plain PyTorch oracles for the port's kernels (the allclose ground truth).

Torch copies of ``repro/kernels/ref.py``. The CPU path of every wrapper in
``ops.py`` runs these, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card. ``reference_ssd`` comes with the ssm slice.
"""
from __future__ import annotations

import torch


def reference_attention(q, k, v, *, causal: bool = True, scale=None):
    """q,k: (BH, Sq/Sk, D), v: (BH, Sk, Dv) -> (BH, Sq, Dv). Full softmax."""
    Sq, Sk = q.shape[1], k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def reference_rmsnorm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
