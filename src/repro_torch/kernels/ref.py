"""Plain PyTorch oracles for the port's kernels (the allclose ground truth).

Torch copies of ``repro/kernels/ref.py``. The CPU path of every wrapper in
``ops.py`` runs these, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card. ``reference_ssd`` is the sequential recurrence, independent
of both the chunked plain version (``ops.ssd_scan_plain``) and the kernel.
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


def reference_ssd(x, dA, Bm, Cm):
    """Sequential SSD recurrence.

    x: (BH, S, P) inputs (already dt-scaled); dA: (BH, S) log-decays (<=0);
    Bm, Cm: (BH, S, N). Returns (y (BH,S,P), final_state (BH,N,P) fp32).

        h_t = exp(dA_t) * h_{t-1} + B_t (x) x_t ;   y_t = C_t . h_t
    """
    BH, S, P = x.shape
    N = Bm.shape[-1]
    x32, dA32, B32, C32 = x.float(), dA.float(), Bm.float(), Cm.float()
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(dA32[:, t])[:, None, None] + torch.einsum(
            "bn,bp->bnp", B32[:, t], x32[:, t])
        ys.append(torch.einsum("bn,bnp->bp", C32[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def reference_rmsnorm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def ssd_chunk_passes(x, dA, Bm, Cm, *, chunk: int):
    """The CUDA ``ssd_scan``'s three-pass decomposition in plain PyTorch, for
    the tests only (no path of the port runs it).

    Model layout: x (Bsz,S,H,P), dA (Bsz,S,H), B/C (Bsz,S,G,N), ``chunk``
    dividing S. Every chunk at once:
      1. the chunks' own states S_c = (B o exp(cum_last - cum))^T x;
      2. the states entering each chunk, state_{c+1} = state_c exp(cum_last_c) + S_c;
      3. y = ((C B^T) o tril(exp(cum_t - cum_s))) x + (C o exp(cum)) state_c,
         with C B^T once per group.
    Returns (y (Bsz,S,H,P) in x.dtype, final state (Bsz,H,N,P) fp32).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R, Q = H // G, chunk
    nc = S // Q
    x32 = x.float().reshape(Bsz, nc, Q, G, R, P)
    cum = dA.float().reshape(Bsz, nc, Q, G, R).cumsum(dim=2)
    B32 = Bm.float().reshape(Bsz, nc, Q, G, N)
    C32 = Cm.float().reshape(Bsz, nc, Q, G, N)

    w = (cum[:, :, -1:] - cum).exp()
    own = torch.einsum("bcsgn,bcsgr,bcsgrp->bcgrnp", B32, w, x32)

    decay = cum[:, :, -1].exp()[..., None, None]                # (Bsz,nc,G,R,1,1)
    run = torch.zeros_like(own[:, 0])
    entering = []
    for c in range(nc):
        entering.append(run)
        run = run * decay[:, c] + own[:, c]
    entering = torch.stack(entering, dim=1)                     # (Bsz,nc,G,R,N,P)

    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None] - cum[:, :, None]                  # (Bsz,nc,Qt,Qs,G,R)
    Lmat = torch.where(tri[:, :, None, None], seg.exp(), 0.0)
    CB = torch.einsum("bctgn,bcsgn->bcgts", C32, B32)
    y = torch.einsum("bcgts,bctsgr,bcsgrp->bctgrp", CB, Lmat, x32)
    y = y + torch.einsum("bctgn,bctgr,bcgrnp->bctgrp", C32, cum.exp(), entering)
    return y.reshape(Bsz, S, H, P).to(x.dtype), run.reshape(Bsz, H, N, P)
