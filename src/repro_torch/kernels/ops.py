"""Public kernel entry points of the port.

Each wrapper launches its hand-written CUDA kernel for a tensor on a CUDA
device and runs its plain PyTorch version for a tensor on the CPU. There is
no fallback from one to the other: a CUDA tensor the kernel cannot take
raises. ``LAUNCHES`` counts kernel launches, one per call that launched,
and nothing else, so a run can show that its path went through the kernels.

``rmsnorm`` always, and ``flash_attention`` where an input requires grad
(and grad is enabled), go through ``torch.autograd.Function``s whose
backward is a kernel too: ``_RMSNormFn`` saves x and scale and launches
``rmsnorm_bwd``; ``_FlashAttentionFn`` saves q, k, v, o and the forward's
lse and launches ``flash_attention_bwd`` (without grad the forward skips the
lse output). Each backward call counts one in
``LAUNCHES`` under its own name. On the CPU the same Functions run the plain
forward and backward versions of ``ref.py``. ``ssd_scan`` has no backward
kernel yet: a CUDA call that autograd would differentiate raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0, "rmsnorm": 0,
            "rmsnorm_bwd": 0, "ssd_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"}:
        raise RuntimeError(f"tensors on {sorted(kinds)}: the kernels take "
                           "CUDA tensors and the plain versions CPU tensors")
    return True


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if _on_card(x, scale):
            out = rmsnorm_cuda(x, scale, eps)
            LAUNCHES["rmsnorm"] += 1
            return out
        return ref.reference_rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        if _on_card(x, scale, dy):
            dx, dscale = rmsnorm_bwd_cuda(x, scale, dy, ctx.eps)
            LAUNCHES["rmsnorm_bwd"] += 1
        else:
            dx, dscale = ref.reference_rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D); scale: (D,). Returns (R, D) in x.dtype, fp32 math."""
    return _RMSNormFn.apply(x, scale, eps)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          return_lse: bool = False):
    """The plain version of ``flash_attention`` in the 4-D model layout, on
    any device: K/V heads repeated for GQA, then ``ref.reference_attention``.
    ``return_lse`` also returns the (B, H, Sq) fp32 logsumexp."""
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    k = k.repeat_interleave(H // KH, dim=1)
    v = v.repeat_interleave(H // KH, dim=1)
    o = ref.reference_attention(q.reshape(B * H, Sq, D),
                                k.reshape(B * H, Sk, D),
                                v.reshape(B * H, Sk, Dv), causal=causal,
                                return_lse=return_lse)
    if return_lse:
        return o[0].reshape(B, H, Sq, Dv), o[1].reshape(B, H, Sq)
    return o.reshape(B, H, Sq, Dv)


class _FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        if _on_card(q, k, v):
            fa.plan_bwd(q, k, v)          # refuse before the forward runs
            o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
            LAUNCHES["flash_attention"] += 1
        else:
            o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _on_card(q, k, v, do):
            if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not fa.rows_16b(do)):
                do = do.contiguous()              # a layout the kernel reads by rows
            grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, ctx.causal)
            LAUNCHES["flash_attention_bwd"] += 1
        else:
            grads = ref.reference_attention_bwd(q, k, v, o, lse, do,
                                                causal=ctx.causal)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention with scale D^-0.5 and a causal positional mask (qpos >= kpos).

    Either the Pallas contract, q/k (BH, S, D) and v (BH, S, Dv), or the model
    layout, q (B, H, Sq, D), k (B, KH, Sk, D), v (B, KH, Sk, Dv) with KH
    dividing H. Returns q's leading dims with Dv.
    """
    three_d = q.dim() == 3
    if three_d:
        q, k, v = q[:, None], k[:, None], v[:, None]
    if _needs_grad(q, k, v):
        o = _FlashAttentionFn.apply(q, k, v, causal)
    elif _on_card(q, k, v):
        o = fa.flash_attention_cuda(q, k, v, causal)
        LAUNCHES["flash_attention"] += 1
    else:
        o = flash_attention_plain(q, k, v, causal=causal)
    return o[:, 0] if three_d else o


def ssd_scan_plain(x, dA, Bm, Cm, *, chunk: int):
    """The plain version of ``ssd_scan`` in the model layout, on any device.

    The chunk loop of ``repro/models/ssm.py::ssd_chunked``, with one chunk's
    (Q x Q) term live at a time; B and C are viewed per group, not repeated.
    ``chunk`` divides S. Returns (y (Bsz,S,H,P) in x.dtype, state (Bsz,H,N,P)
    fp32).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    x32 = x.float().reshape(Bsz, S, G, R, P)
    a32 = dA.float().reshape(Bsz, S, G, R)
    B32, C32 = Bm.float(), Cm.float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((Bsz, G, R, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        a_k, x_k = a32[:, c0:c0 + chunk], x32[:, c0:c0 + chunk]
        B_k, C_k = B32[:, c0:c0 + chunk], C32[:, c0:c0 + chunk]
        cum = a_k.cumsum(dim=1)                                  # (B,Q,G,R)
        seg = cum[:, :, None] - cum[:, None]                     # (B,Qt,Qs,G,R)
        Lmat = torch.where(tri[None, :, :, None, None], seg.exp(), 0.0)
        CB = torch.einsum("btgn,bsgn->bgts", C_k, B_k)
        y = torch.einsum("bgts,btsgr,bsgrp->btgrp", CB, Lmat, x_k)
        y = y + torch.einsum("btgn,btgr,bgrnp->btgrp", C_k, cum.exp(), state)
        decay_to_end = (cum[:, -1:] - cum).exp()                 # (B,Q,G,R)
        s_chunk = torch.einsum("bsgn,bsgr,bsgrp->bgrnp", B_k, decay_to_end, x_k)
        state = state * cum[:, -1].exp()[..., None, None] + s_chunk
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(Bsz, S, H, P).to(x.dtype)
    return y, state.reshape(Bsz, H, N, P)


def ssd_scan(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 128, return_state: bool = False):
    """Mamba2 SSD chunked scan; ``chunk`` (capped at S) must divide S.

    Either the Pallas contract, x (BH, S, P), dA (BH, S), Bm/Cm (BH, S, N), or
    the model layout, x (Bsz, S, H, P), dA (Bsz, S, H), Bm/Cm (Bsz, S, G, N)
    with G dividing H (head h reads group h // (H // G)). x is already
    dt-scaled and dA holds the log-decays. Returns y in x's layout and dtype
    and, with ``return_state``, also the final state in fp32: (BH, N, P) or
    (Bsz, H, N, P).
    """
    three_d = x.dim() == 3
    if three_d:
        x, dA, Bm, Cm = x[:, :, None], dA[:, :, None], Bm[:, :, None], Cm[:, :, None]
    S = x.shape[1]
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"chunk {Q} must divide the sequence length {S}")
    if _on_card(x, dA, Bm, Cm):
        if _needs_grad(x, dA, Bm, Cm):
            raise NotImplementedError(
                "ssd_scan has no backward kernel yet: it comes with the ssm "
                "training slice; call it under torch.no_grad() or "
                "torch.inference_mode()")
        # the kernel takes x in fp32, as the model hands it over
        y, state = ssd_scan_cuda(x.float(), dA, Bm, Cm, Q, return_state)
        y = y.to(x.dtype)
        LAUNCHES["ssd_scan"] += 1
    else:
        y, state = ssd_scan_plain(x, dA, Bm, Cm, chunk=Q)
    if three_d:
        y, state = y[:, :, 0], state[:, 0] if state is not None else None
    return (y, state) if return_state else y
