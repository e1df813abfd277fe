"""Public kernel entry points of the port.

Each wrapper launches its hand-written CUDA kernel for a tensor on a CUDA
device and runs its plain PyTorch version for a tensor on the CPU. There is
no fallback from one to the other: a CUDA tensor the kernel cannot take
raises. ``LAUNCHES`` counts kernel launches, one per call that launched,
and nothing else, so a run can show that its path went through the kernels.

The kernels have no backward yet (it comes with the training slice), so a
CUDA call that autograd would need to differentiate raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda

LAUNCHES = {"flash_attention": 0, "rmsnorm": 0}


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "the CUDA kernels have no backward yet; call them under "
            "torch.no_grad() or torch.inference_mode()")
    return True


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D); scale: (D,). Returns (R, D) in x.dtype, fp32 math."""
    if _on_card(x, scale):
        out = rmsnorm_cuda(x, scale, eps)
        LAUNCHES["rmsnorm"] += 1
        return out
    return ref.reference_rmsnorm(x, scale, eps)


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """The plain version of ``flash_attention`` in the 4-D model layout, on
    any device: K/V heads repeated for GQA, then ``ref.reference_attention``."""
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    k = k.repeat_interleave(H // KH, dim=1)
    v = v.repeat_interleave(H // KH, dim=1)
    o = ref.reference_attention(q.reshape(B * H, Sq, D),
                                k.reshape(B * H, Sk, D),
                                v.reshape(B * H, Sk, Dv), causal=causal)
    return o.reshape(B, H, Sq, Dv)


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
    if _on_card(q, k, v):
        o = flash_attention_cuda(q, k, v, causal)
        LAUNCHES["flash_attention"] += 1
    else:
        o = flash_attention_plain(q, k, v, causal=causal)
    return o[:, 0] if three_d else o
