"""Fused RMSNorm on Hopper: the launcher of ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``. One block
per row, so any row count is taken; rows up to ``MAX_DIM`` wide. The plain
version is ``ref.reference_rmsnorm``; ``ops.rmsnorm`` picks between them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_DIM = 8192


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D) on a CUDA device; scale: (D,). Returns (R, D) in x.dtype."""
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (R, D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if not x.is_cuda or scale.device != x.device:
        raise ValueError("rmsnorm_cuda needs x and scale on one CUDA device")
    if x.dtype not in build.DTYPE_CODE or scale.dtype not in build.DTYPE_CODE:
        raise TypeError(f"rmsnorm takes float32/bfloat16, got {x.dtype}, "
                        f"{scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and scale")
    R, D = x.shape
    if D > MAX_DIM:
        raise ValueError(f"rmsnorm_cuda takes D <= {MAX_DIM}, got {D}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = build.library().lib.rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), R, D, float(eps),
            build.DTYPE_CODE[x.dtype], build.DTYPE_CODE[scale.dtype],
            build.stream_handle(x.device))
    build.check(code, "rmsnorm_fwd")
    return out
