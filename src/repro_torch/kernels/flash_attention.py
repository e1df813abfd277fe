"""Flash-attention forward on Hopper: the launcher of ``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::flash_attention``
and, on the model path, ``models/attention.py::blockwise_attention``. It takes
the model layout directly: q (B, H, Sq, D), k (B, KH, Sk, D), v (B, KH, Sk, Dv),
each through its strides with a unit last stride, so the transposed views the
model makes are not copied and GQA needs no repeated K/V. Any Sq and Sk.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Returns a contiguous (B, H, Sq, Dv) in q.dtype; scale D^-0.5."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_cuda takes 4-D q, k, v")
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape != (B, KH, Sk, D) or v.shape[:3] != (B, KH, Sk)
            or H % KH != 0 or Sk < 1):
        raise ValueError(f"bad attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims up to {MAX_HEAD_DIM}, got {D}, {Dv}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    if q.dtype not in build.DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_cuda needs a unit last stride")
    o = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        code = build.library().lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, H, KH, Sq, Sk, D, Dv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            D ** -0.5, int(causal), build.DTYPE_CODE[q.dtype],
            build.stream_handle(q.device))
    build.check(code, "flash_attention_fwd")
    return o
