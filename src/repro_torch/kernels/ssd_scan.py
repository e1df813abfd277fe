"""Mamba2 SSD chunked scan on Hopper: the launcher of ``csrc/ssd_scan.cu``.

Replaces the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan`` and, on
the model path, the chunk loop of ``models/ssm.py::ssd_chunked``. It takes
the model layout directly: x (Bsz, S, H, P), dA (Bsz, S, H), B and C
(Bsz, S, G, N), each through its strides with a unit last stride. Head h
reads group h // (H // G), so B and C are never repeated per head. The
plain version is ``ops.ssd_scan_plain``; ``ops.ssd_scan`` picks between them.

One call makes ``CUDA_LAUNCHES`` kernel launches, each parallel over
chunks: the chunks' own states, a short scan of the states over the chunks,
then the outputs. It allocates two scratch tensors for them: the chunks'
cumulative log-decays, (Bsz, H, S) in fp64, and their states, (Bsz, H,
S / chunk, N, P) in fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_N = 128
MAX_P = 128
MAX_CHUNK = 4096
CUDA_LAUNCHES = 3


def ssd_scan_cuda(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, chunk: int, return_state: bool
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns y, a contiguous fp32 (Bsz, S, H, P), and the final state, a
    (Bsz, H, N, P) fp32 tensor or None. x and dA are fp32, B and C fp32 or
    bf16. ``chunk`` must divide S."""
    if x.dim() != 4 or dA.dim() != 3 or Bm.dim() != 4:
        raise ValueError("ssd_scan_cuda takes x (Bsz,S,H,P), dA (Bsz,S,H), "
                         "B and C (Bsz,S,G,N)")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dA.shape != (Bsz, S, H) or Bm.shape[:2] != (Bsz, S)
            or Cm.shape != Bm.shape or H % G != 0):
        raise ValueError(f"bad ssd shapes x {tuple(x.shape)}, dA {tuple(dA.shape)}, "
                         f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"ssd_scan_cuda takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P {P}, N {N}")
    if not (1 <= chunk <= MAX_CHUNK) or S < 1 or S % chunk:
        raise ValueError(f"chunk {chunk} must divide S {S} and be <= {MAX_CHUNK}")
    if not (x.is_cuda and all(t.device == x.device for t in (dA, Bm, Cm))):
        raise ValueError("ssd_scan_cuda needs x, dA, B, C on one CUDA device")
    if (x.dtype != torch.float32 or dA.dtype != torch.float32
            or Bm.dtype not in build.DTYPE_CODE or Cm.dtype != Bm.dtype):
        raise TypeError(f"ssd_scan_cuda takes x and dA in float32 and B/C in "
                        f"float32 or bfloat16, got x {x.dtype}, dA {dA.dtype}, "
                        f"B {Bm.dtype}, C {Cm.dtype}")
    if x.stride(3) != 1 or Bm.stride(3) != 1 or Cm.stride(3) != 1:
        raise ValueError("ssd_scan_cuda needs a unit last stride in x, B and C")
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    state = (torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
             if return_state else None)
    cum = torch.empty((Bsz, H, S), dtype=torch.float64, device=x.device)
    states = torch.empty((Bsz, H, S // chunk, N, P), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        code = build.library().lib.ssd_scan_fwd(
            x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), None if state is None else state.data_ptr(),
            cum.data_ptr(), states.data_ptr(), Bsz, S, H, G, P, N, chunk,
            x.stride(0), x.stride(1), x.stride(2),
            dA.stride(0), dA.stride(1), dA.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2),
            build.DTYPE_CODE[Bm.dtype], build.stream_handle(x.device))
    build.check(code, "ssd_scan_fwd")
    return y, state
