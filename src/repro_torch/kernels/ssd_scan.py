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
the gradients of every chunk's 64-row tiles, their sums over each group's
head blocks, and the reverse running sums of the log-decay gradients) from
the forward's inputs and scratch. Its products run on the tensor cores with
fp32 operands split into bf16 pieces (``SPLIT_PIECES``); ``plan_bwd`` picks
the route and the chunk_grads instance (heads a block, cp.async ring), on
any device, the wrapper passes them to the kernel, and ``BWD_PLAN`` is the
last launch's. It allocates the state gradients (as large as ``states``), dB and
dC summed over each block's heads, (Bsz, S, G * blocks per group, N) fp32
each, and the per-head log-decay gradients, (Bsz, H, S) fp32. The plain
version is ``ref.ssd_scan_bwd``; ``ref.ssd_bwd_tiles`` is the kernel's
decomposition, with its split products emulated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import H100_SMS

MAX_N = 128
MAX_P = 128
MAX_CHUNK = 4096
CUDA_LAUNCHES = 3
CUDA_LAUNCHES_BWD = 5

# chunk_grads' shared memory (csrc/ssd_scan.cu ``GradLayout``): 64-row tiles,
# bf16 rows padded by 8, and the most one block may use on the H100.
TILE = 64
MAX_BLOCK_SMEM = 232448
WARPS = 16                      # warps of a chunk_grads block (``kGradWarps``)
SMS = 132                       # SMs of the H100 SXM

# The backward's split products by route: the bf16 pieces of each kind of
# operand, as csrc/ssd_scan.cu's ``Pieces`` gives them (a test reads them
# there). "F": an fp32 operand of dy x^T and of the cross-chunk products,
# three pieces: d cum = C.dC - B.dB, whose terms cancel, is summed over up
# to a chunk of rows into d dA, and two pieces leave that above its fp32
# tolerance at slow decay. "T": the decayed tiles T1, T2 and the fp32
# operand of their products, which only reach dx, dB and dC. "BC": B and
# C, one exact piece in bf16.
ROUTE_PIECES = {"bf16_bc": {"F": 3, "T": 2, "BC": 1},
                "split_bc": {"F": 3, "T": 3, "BC": 3}}
# each product's two operands, by kind
PRODUCTS = {"C B^T": ("BC", "BC"), "dy x^T": ("F", "F"), "T1^T dy": ("T", "T"),
            "T2^T C": ("T", "BC"), "T2 B": ("T", "BC"), "G_c^T B": ("BC", "F"),
            "G_c x": ("F", "F"), "h_c dy": ("F", "F"), "C^T (e o dy)": ("BC", "F")}
SPLIT_PIECES = {route: {name: (kinds[a], kinds[b]) for name, (a, b) in PRODUCTS.items()}
                for route, kinds in ROUTE_PIECES.items()}


def split_terms(pa: int, pb: int) -> int:
    """Products of pieces i.j with i + j below the larger piece count."""
    return sum(1 for i in range(pa) for j in range(pb) if i + j < max(pa, pb))


@dataclass(frozen=True)
class BwdPlan:
    """How ``ssd_scan_bwd`` runs: ``route`` "bf16_bc" (B and C exact in bf16)
    or "split_bc" (fp32 B and C split like the other operands);
    ``heads_per_block`` of one group per chunk_grads block, which sums their
    dB and dC; ``ring``, whether the next slab is copied (cp.async) while
    the current one is multiplied; ``widths`` (P, N) padded to 64 or 128;
    ``smem`` chunk_grads' bytes. (route, widths, heads, ring) name the
    chunk_grads instance that runs."""
    route: str
    heads_per_block: int
    ring: bool
    widths: Tuple[int, int]
    smem: int

    @property
    def pieces(self):
        """Each product's bf16 pieces of its two operands."""
        return SPLIT_PIECES[self.route]

    @property
    def terms(self):
        """Each product's pieces' products summed."""
        return {name: split_terms(*pp) for name, pp in self.pieces.items()}

    @property
    def kernel(self) -> str:
        """The chunk_grads instance, named as ``build.kernel_instance`` names
        a launched kernel."""
        tb = "bf16" if self.route == "bf16_bc" else "float"
        return (f"chunk_grads_kernel<{tb},{self.widths[0]},{self.widths[1]},"
                f"{self.heads_per_block},{str(self.ring).lower()}>")


BWD_PLAN: Optional[BwdPlan] = None


def _op_bytes(width: int, itemsize: int = 2) -> int:
    return TILE * (width + 8) * itemsize


def grad_smem(bf16_bc: bool, wp: int, wn: int, heads: int, ring: bool) -> int:
    """Bytes of chunk_grads' shared memory, as ``GradLayout`` in the source
    lays it out: each head's own rows of x (dy) in pieces, the own rows of
    B (C) in bf16 or fp32, a slab of C (B) and of dy (x) in pieces, the
    decayed tiles T1 and T2 (bf16 pieces or fp32: as many bytes), with the
    ring the raw slab the copies land in, and per head four row vectors and
    each column group's (a quarter of the warps) d cum sums."""
    pf, pbc = 3, (1 if bf16_bc else 3)
    own = heads * pf * _op_bytes(wp) + _op_bytes(wn, 2 if bf16_bc else 4)
    slab = pbc * _op_bytes(wn) + pf * _op_bytes(wp)
    tt = 2 * _op_bytes(TILE, 4)
    raw = TILE * wn * (2 if bf16_bc else 4) + TILE * wp * 4 if ring else 0
    vec = heads * (4 + WARPS // 4) * TILE * 4
    return own + slab + tt + raw + vec


def plan_bwd(N: int, P: int, Q: int, rep: int, bc_dtype: torch.dtype,
             tiles: Optional[int] = None, sms: int = SMS) -> BwdPlan:
    """The backward's route and chunk_grads' blocking, on any device. ``rep``
    heads share each group's B and C; ``tiles`` is chunk_grads' grid at one
    head a block, Bsz x groups x the 64-row tiles of every chunk. Heads a
    block: the most of 4, 2, 1 that fit a block's shared memory with the
    cp.async ring and that ``rep`` needs (no more than twice it), and of
    those, with ``tiles``, the most whose grid still gives each of ``sms``
    SMs a block (one block an SM; on a smaller grid fewer heads a block
    finish sooner), else one. The ring where it fits. Raises on what the
    kernels do not take."""
    if bc_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_scan_bwd takes B/C in float32 or bfloat16, got {bc_dtype}")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N and 1 <= Q <= MAX_CHUNK and rep >= 1):
        raise ValueError(f"ssd_scan_bwd takes P <= {MAX_P}, N <= {MAX_N}, a chunk "
                         f"<= {MAX_CHUNK} and rep >= 1, got P {P}, N {N}, chunk {Q}, "
                         f"rep {rep}")
    bf16 = bc_dtype == torch.bfloat16
    wp, wn = (64 if P <= 64 else 128), (64 if N <= 64 else 128)
    fits = [h for h in (4, 2, 1)
            if h == 1 or (h // 2 < rep and grad_smem(bf16, wp, wn, h, True) <= MAX_BLOCK_SMEM)]
    heads = next((h for h in fits if tiles is None or tiles * -(-rep // h) >= sms), 1)
    ring = grad_smem(bf16, wp, wn, heads, True) <= MAX_BLOCK_SMEM
    return BwdPlan("bf16_bc" if bf16 else "split_bc", heads, ring, (wp, wn),
                   grad_smem(bf16, wp, wn, heads, ring))


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
    if not build.on_card(x, dA, Bm, Cm):
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
    if build.dry(x):                           # a dry run: planned, not launched
        return y, state, cum, states
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
    if dy.shape != x.shape or not build.on_card(x, dy):
        raise ValueError(f"dy must be {tuple(x.shape)} on {x.device}, got "
                         f"{tuple(dy.shape)} on {dy.device}")
    if dstate is not None:
        if dstate.shape != (Bsz, H, N, P) or not build.on_card(x, dstate):
            raise ValueError(f"dstate must be {(Bsz, H, N, P)} on {x.device}, got "
                             f"{tuple(dstate.shape)} on {dstate.device}")
        if state is None or state.shape != (Bsz, H, N, P) or not state.is_contiguous():
            raise ValueError("a dstate needs the forward's final state, "
                             f"a contiguous {(Bsz, H, N, P)} fp32")
        dstate = dstate.float().contiguous()
    global BWD_PLAN
    sms = (H100_SMS if build.is_fake(x)
           else torch.cuda.get_device_properties(x.device).multi_processor_count)
    plan = plan_bwd(N, P, chunk, H // G, Bm.dtype,
                    tiles=Bsz * G * (S // chunk) * -(-chunk // TILE), sms=sms)
    dy = dy.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, H, P), **f32)
    ddA = torch.empty((Bsz, S, H), **f32)
    dB = torch.empty((Bsz, S, G, N), dtype=Bm.dtype, device=x.device)
    dC = torch.empty((Bsz, S, G, N), dtype=Bm.dtype, device=x.device)
    dstates = torch.empty((Bsz, H, nc, N, P), **f32)
    blocks = G * -(-(H // G) // plan.heads_per_block)
    dbp = torch.empty((Bsz, S, blocks, N), **f32)
    dcp = torch.empty((Bsz, S, blocks, N), **f32)
    dcum = torch.empty((Bsz, H, S), **f32)
    if build.dry(x):                           # a dry run: planned, not launched
        return dx, ddA, dB, dC
    with torch.cuda.device(x.device):
        err = build.library().lib.ssd_scan_bwd(
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), cum.data_ptr(),
            states.data_ptr(), None if dstate is None else state.data_ptr(),
            dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
            dx.data_ptr(), ddA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dstates.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), dcum.data_ptr(),
            Bsz, S, H, G, P, N, chunk,
            x.stride(0), x.stride(1), x.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2),
            plan.heads_per_block, int(plan.ring), build.DTYPE_CODE[Bm.dtype],
            build.stream_handle(x.device))
    build.check(err, "ssd_scan_bwd")
    BWD_PLAN = plan
    return dx, ddA, dB, dC
