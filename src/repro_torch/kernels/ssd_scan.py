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
cumulative log-decays, (Bsz, H, S) in fp64, and the states entering each
chunk, (Bsz, H, S / chunk, N, P) in fp32. ``ssd_scan_cuda`` hands them back
beside y and the final state, so that a forward under autograd keeps them
for the backward; the serving path drops them.

``ssd_scan_bwd_cuda`` launches the backward (``CUDA_LAUNCHES_BWD`` launches:
the chunks' state-gradient terms, the reverse scan of the state gradients,
the per-head gradients of every chunk, their sums over each group's heads,
and the reverse running sums of the log-decay gradients) from the forward's
inputs and scratch. It allocates the state gradients (as large as
``states``), per-head dB and dC, (Bsz, S, H, N) fp32 each, and the per-head
log-decay gradients, (Bsz, H, S) fp32. The plain version is
``ref.ssd_scan_bwd``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_N = 128
MAX_P = 128
MAX_CHUNK = 4096
CUDA_LAUNCHES = 3
CUDA_LAUNCHES_BWD = 5


def check_inputs(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk: int, name: str = "ssd_scan_cuda") -> None:
    """Raises on what the kernels do not take: the forward's rules, which
    the backward shares."""
    if x.dim() != 4 or dA.dim() != 3 or Bm.dim() != 4:
        raise ValueError(f"{name} takes x (Bsz,S,H,P), dA (Bsz,S,H), "
                         "B and C (Bsz,S,G,N)")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dA.shape != (Bsz, S, H) or Bm.shape[:2] != (Bsz, S)
            or Cm.shape != Bm.shape or H % G != 0):
        raise ValueError(f"bad ssd shapes x {tuple(x.shape)}, dA {tuple(dA.shape)}, "
                         f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N):
        raise ValueError(f"{name} takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P {P}, N {N}")
    if not (1 <= chunk <= MAX_CHUNK) or S < 1 or S % chunk:
        raise ValueError(f"chunk {chunk} must divide S {S} and be <= {MAX_CHUNK}")
    if not (x.is_cuda and all(t.device == x.device for t in (dA, Bm, Cm))):
        raise ValueError(f"{name} needs x, dA, B, C on one CUDA device")
    if (x.dtype != torch.float32 or dA.dtype != torch.float32
            or Bm.dtype not in build.DTYPE_CODE or Cm.dtype != Bm.dtype):
        raise TypeError(f"{name} takes x and dA in float32 and B/C in "
                        f"float32 or bfloat16, got x {x.dtype}, dA {dA.dtype}, "
                        f"B {Bm.dtype}, C {Cm.dtype}")
    if x.stride(3) != 1 or Bm.stride(3) != 1 or Cm.stride(3) != 1:
        raise ValueError(f"{name} needs a unit last stride in x, B and C")


def ssd_scan_cuda(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, chunk: int, return_state: bool):
    """Returns (y, state, cum, states): y, a contiguous fp32 (Bsz, S, H, P);
    the final state, a (Bsz, H, N, P) fp32 tensor or None; the forward's cum
    (Bsz, H, S) fp64 and states (Bsz, H, S / chunk, N, P) fp32, which
    ``ssd_scan_bwd_cuda`` takes. x and dA are fp32, B and C fp32 or bf16.
    ``chunk`` must divide S."""
    check_inputs(x, dA, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
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
    return y, state, cum, states


def ssd_scan_bwd_cuda(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                      Cm: torch.Tensor, chunk: int, cum: torch.Tensor,
                      states: torch.Tensor, state: Optional[torch.Tensor],
                      dy: torch.Tensor, dstate: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``ssd_scan_cuda``'s y and final state. x, dA, B, C and
    ``chunk`` as the forward took them; ``cum``, ``states`` and the final
    ``state`` as it handed them back (``state`` is read only with a
    ``dstate``); dy (Bsz, S, H, P); dstate (Bsz, H, N, P) or None for zero.
    Returns dx and d dA in fp32, dB and dC in B's dtype, each contiguous in
    its input's shape."""
    check_inputs(x, dA, Bm, Cm, chunk, "ssd_scan_bwd_cuda")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    if (cum.shape != (Bsz, H, S) or cum.dtype != torch.float64
            or states.shape != (Bsz, H, nc, N, P) or states.dtype != torch.float32
            or not (cum.is_contiguous() and states.is_contiguous())):
        raise ValueError("ssd_scan_bwd_cuda takes the forward's cum (Bsz,H,S) "
                         "fp64 and states (Bsz,H,S/chunk,N,P) fp32")
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} on {x.device}, got "
                         f"{tuple(dy.shape)} on {dy.device}")
    if dstate is not None:
        if dstate.shape != (Bsz, H, N, P) or dstate.device != x.device:
            raise ValueError(f"dstate must be {(Bsz, H, N, P)} on {x.device}, got "
                             f"{tuple(dstate.shape)} on {dstate.device}")
        if state is None or state.shape != (Bsz, H, N, P) or not state.is_contiguous():
            raise ValueError("a dstate needs the forward's final state, "
                             f"a contiguous {(Bsz, H, N, P)} fp32")
        dstate = dstate.float().contiguous()
    dy = dy.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, H, P), **f32)
    ddA = torch.empty((Bsz, S, H), **f32)
    dB = torch.empty((Bsz, S, G, N), dtype=Bm.dtype, device=x.device)
    dC = torch.empty((Bsz, S, G, N), dtype=Bm.dtype, device=x.device)
    dstates = torch.empty((Bsz, H, nc, N, P), **f32)
    dbh = torch.empty((Bsz, S, H, N), **f32)
    dch = torch.empty((Bsz, S, H, N), **f32)
    dcum = torch.empty((Bsz, H, S), **f32)
    with torch.cuda.device(x.device):
        code = build.library().lib.ssd_scan_bwd(
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), cum.data_ptr(),
            states.data_ptr(), None if dstate is None else state.data_ptr(),
            dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
            dx.data_ptr(), ddA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dstates.data_ptr(), dbh.data_ptr(), dch.data_ptr(), dcum.data_ptr(),
            Bsz, S, H, G, P, N, chunk,
            x.stride(0), x.stride(1), x.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2),
            build.DTYPE_CODE[Bm.dtype], build.stream_handle(x.device))
    build.check(code, "ssd_scan_bwd")
    return dx, ddA, dB, dC
