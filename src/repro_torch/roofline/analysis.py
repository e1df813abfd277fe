"""Roofline terms of the port's steps, and the work of its kernels.

Port of ``repro/roofline/analysis.py``. ``model_flops``, ``RooflineTerms``
and ``roofline_report`` keep their meaning, keys and formulas, on the H100
figures of ``repro_torch/launch/mesh.py`` (data sheet, not measured):
``PEAK_FLOPS`` 989e12 bf16 FLOP/s and ``HBM_BW`` 3.35e12 B/s a card.

The JAX package parses the compiled SPMD HLO; the port has no compiled
program to read, so ``count_step(fn, *args)`` runs one step on fake tensors
(``FakeTensorMode``; under a mesh, DTensors of fake local shards) and counts
per device:

- product FLOPs: each aten op with a formula in
  ``torch.utils.flop_counter.FlopCounterMode``'s registry (its own
  formulas, on the op's shapes); an op on DTensors is counted on the share
  of the work one device does: the local share of its output, divided by
  the size of each mesh axis its output is a partial sum over;
- the kernels' own work, which no aten op shows: every kernel wrapper runs
  under ``ops.dry_run()``, and ``step_flops`` counts its products as the
  JAX program does them. ``blockwise_attention``
  (``repro/models/attention.py:72-102``) scans every key block with no
  skip, keys padded to whole blocks of ``KV_BLOCK``, under a
  ``jax.checkpoint`` per block: every (q, key) pair counts in 2 products
  forward and 6 backward (the block's 2 again, then 4). The SSD scan's
  chunked form (``repro/models/ssm.py:67``) counts its four einsums per
  chunk forward and twice that backward. rmsnorm has no product. Bytes are
  the kernels' own reads and writes (``kernel_work``), which is where the
  port's fused kernels and JAX's proxy (the operand and result bytes of
  every dot, the attention's score blocks included) part;
- collective wire bytes, by JAX's ring model per participant
  (``analysis.py:14-19``: all-gather result x (n-1)/n, reduce-scatter
  result x (n-1), all-reduce result x 2(n-1)/n, all-to-all result x
  (n-1)/n, a permute its result), from the functional collectives that
  DTensor's redistributes issue and from ``sharding/collectives.py``'s
  calls (``collectives.TRACE``). A collective whose group lies within one
  8-card NVLink node runs at ``NVLINK_BW``, one whose group spans nodes at
  ``INTER_NODE_BW``; on the production meshes every ``model`` group (16
  consecutive ranks) spans two nodes.

``kernel_work`` holds the one set of formulas for each kernel's bytes and
operations, which ``chip_smoke.py``'s ``bound_ms`` reads; ``bound`` turns
them into the least time. ``measured_report`` adds a measured step time:
``mfu`` and ``bound_fraction``.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.mesh import (HBM_BW, INTER_NODE_BW, NODE_CARDS, NVLINK_BW,
                                     PEAK_FLOPS)

# Peak rates by operand type: bf16 on the tensor cores, fp32 outside them
# (H100 SXM data sheet, dense).
PEAK_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": 67e12}
# JAX's attention key block (repro/models/attention.py:25): keys are padded
# to whole blocks of min(KV_BLOCK, Sk).
KV_BLOCK = 1024

_FUNCTIONAL = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


# ---------------------------------------------------------------------------
# the kernels' work: bytes, operations and the bound
# ---------------------------------------------------------------------------

def valid_pairs(Sq: int, Sk: int, causal: bool, prefix: int = 0) -> int:
    """(row, key) pairs the mask lets through: under ``causal`` row i sees
    keys j <= i and j < prefix."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, max(i + 1, prefix)) for i in range(Sq))


def split_tc_s(rows: int, products) -> float:
    """Least time of the chunked SSD form's products on the bf16 tensor cores,
    each (flops per row and head, terms) counted with the split terms that
    fp32-grade results need: 3 where both operands are fp32 (hi.hi + lo.hi +
    hi.lo of bf16 hi/lo parts), 2 where one is a bf16 B or C, 1 for C B^T of
    bf16 B and C; fp32 B and C count as split operands."""
    return rows * sum(f * t for f, t in products) / PEAK_BY_DTYPE["bfloat16"]


def _bc_terms(bc_dtype: str):
    """Split terms of C B^T, and of a product of B or C by an fp32 operand."""
    return (1, 2) if bc_dtype == "bfloat16" else (3, 3)


def ssd_ops_s(BH: int, S: int, P: int, N: int, Q: int, bc_dtype: str,
              heads_per_group: int = 1):
    """Least time for the operations of one SSD scan, and the count that gave
    it: the smallest of the sequential recurrence's 5*N*P fp32 flops per row
    and head (state decay and rank-1 update, then C . state); the chunked
    form's, whose C B^T term (Q*N per row, once per group of heads) may run
    at B/C's own rate (tensor cores for bf16) and whose rest (Q*P + 4*N*P
    per row and head) is fp32; and the chunked form's products all on the
    bf16 tensor cores with their split terms (``split_tc_s``): C B^T, (C B^T
    o L) x (3 terms) and the four state products B^T (w o x) and C state."""
    rows = BH * S
    recurrence = 5 * rows * N * P / PEAK_BY_DTYPE["float32"]
    chunked = rows * (Q * N / heads_per_group / PEAK_BY_DTYPE[bc_dtype]
                      + (Q * P + 4 * N * P) / PEAK_BY_DTYPE["float32"])
    cb, with_bc = _bc_terms(bc_dtype)
    tensor = split_tc_s(rows, [(Q * N / heads_per_group, cb), (Q * P, 3),
                               (4 * N * P, with_bc)])
    return min((recurrence, "recurrence"), (chunked, "chunked"),
               (tensor, "chunked_tensor_cores"))


def ssd_bwd_ops_s(BH: int, S: int, P: int, N: int, Q: int, bc_dtype: str,
                  heads_per_group: int = 1):
    """Least time for the operations of one SSD scan backward, and the count
    that gave it: the smallest of the reverse recurrence's fp32 work, 14*N*P
    flops per row and head (the forward state again, its decay and rank-1
    update without y, 3*N*P; the state gradient's decay and rank-1 update,
    3*N*P; dx, dB and dC, 6*N*P; the decay's gradient, 2*N*P); the chunked
    form's with fp32 products: per row and head 2*Q*P + 2*Q*N within the
    chunk (dy x^T and (C B^T o L)^T dy, (dy x^T o L)^T C and (dy x^T o L) B
    over the causal half) and 8*N*P across chunks (the state-gradient term
    and the three cross-chunk products), with C B^T's Q*N per row once per
    group at B/C's own rate; and the same products on the bf16 tensor cores
    with their split terms (``split_tc_s``): dy x^T and T1^T dy 3 terms, the
    two products with C and B and D_c and G_c^T B those of B/C, G_c x and
    h_c dy 3."""
    rows = BH * S
    recurrence = 14 * rows * N * P / PEAK_BY_DTYPE["float32"]
    chunked = rows * (Q * N / heads_per_group / PEAK_BY_DTYPE[bc_dtype]
                      + (2 * Q * P + 2 * Q * N + 8 * N * P) / PEAK_BY_DTYPE["float32"])
    cb, with_bc = _bc_terms(bc_dtype)
    tensor = split_tc_s(rows, [(Q * N / heads_per_group, cb), (2 * Q * P, 3),
                               (2 * Q * N, with_bc), (4 * N * P, with_bc),
                               (4 * N * P, 3)])
    return min((recurrence, "recurrence"), (chunked, "chunked"),
               (tensor, "chunked_tensor_cores"))


_SIZE = {"bfloat16": 2, "float32": 4}


def kernel_work(name: str, f: Dict) -> Tuple[float, float, str]:
    """(bytes, least seconds of operations, the count that gave them) of one
    call of kernel ``name`` with the fields ``f`` that ``ops`` records:

    - ``rmsnorm``: x (R, D) read and written, the scale read; 4 R D flops at
      x's type's peak. ``rmsnorm_bwd``: x and dy read, dx written, the scale
      read and dscale written; 9 R D fp32 flops;
    - ``flash_attention``: q, k, v read, o (and with ``lse`` the fp32 lse)
      written; 2 B H pairs (D + Dv) flops over the mask's valid pairs.
      ``flash_attention_bwd``: q, k, v read and their gradients written, o,
      do and the lse read; five products, 2 B H pairs (3 D + 2 Dv);
    - ``ssd_scan``: x read and y written (``x_bytes`` each), dA (fp32), B
      and C read; ``ssd_ops_s``. ``ssd_scan_bwd``: x and dy read and dx
      written (fp32), B and C read and their gradients written, cum (fp64),
      the chunk states and dA read (the final state and its gradient with
      ``dstate``); ``ssd_bwd_ops_s``."""
    if name in ("rmsnorm", "rmsnorm_bwd"):
        R, D = f["R"], f["D"]
        xs, ss = _SIZE[f["dtype"]], _SIZE[f["scale_dtype"]]
        if name == "rmsnorm":
            return 2 * R * D * xs + D * ss, 4 * R * D / PEAK_BY_DTYPE[f["dtype"]], "products"
        return 3 * R * D * xs + 2 * D * ss, 9 * R * D / PEAK_BY_DTYPE["float32"], "products"
    if name in ("flash_attention", "flash_attention_bwd"):
        B, H, KH, Sq, Sk, D, Dv = (f[k] for k in ("B", "H", "KH", "Sq", "Sk", "D", "Dv"))
        es = _SIZE[f["dtype"]]
        pairs = valid_pairs(Sq, Sk, f["causal"], f["prefix_len"])
        q, kv = B * H * Sq, B * KH * Sk
        if name == "flash_attention":
            nbytes = (q * D + kv * D + kv * Dv + q * Dv) * es + (4 * q if f.get("lse") else 0)
            return nbytes, 2 * B * H * pairs * (D + Dv) / PEAK_BY_DTYPE[f["dtype"]], "products"
        nbytes = (2 * q * D + 2 * kv * D + 2 * kv * Dv + 2 * q * Dv) * es + 4 * q
        return (nbytes, 2 * B * H * pairs * (3 * D + 2 * Dv) / PEAK_BY_DTYPE[f["dtype"]],
                "products")
    B, S, H, G, P, N, Q = (f[k] for k in ("B", "S", "H", "G", "P", "N", "chunk"))
    bc = _SIZE[f["bc_dtype"]]
    x = B * S * H * P
    if name == "ssd_scan":
        ops_s, form = ssd_ops_s(B * H, S, P, N, Q, f["bc_dtype"], H // G)
        return 2 * x * f.get("x_bytes", 4) + 4 * B * S * H + 2 * B * S * G * N * bc, ops_s, form
    ops_s, form = ssd_bwd_ops_s(B * H, S, P, N, Q, f["bc_dtype"], H // G)
    nbytes = (3 * x * 4 + 4 * B * S * G * N * bc + 8 * B * H * S
              + 4 * B * H * (S // Q) * N * P + 4 * B * S * H
              + (2 * 4 * B * H * N * P if f.get("dstate") else 0))
    return nbytes, ops_s, form


def bound(nbytes: float, ops_s: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes at
    ``HBM_BW`` and the operations' seconds."""
    t_bytes = nbytes / HBM_BW
    return 1e3 * max(t_bytes, ops_s), ("bytes" if t_bytes >= ops_s else "operations")


def step_flops(name: str, f: Dict) -> float:
    """The product FLOPs of one kernel call as the JAX program's step counts
    them (see the module docstring): attention over every (q, key) pair of
    the padded key blocks, 2 products forward and 6 backward; the SSD scan's
    four einsums per chunk forward, twice that backward; rmsnorm none."""
    if name.startswith("flash_attention"):
        Sk = f["Sk"]
        blk = min(KV_BLOCK, Sk)
        keys = -(-Sk // blk) * blk
        per = 2.0 * f["B"] * f["H"] * f["Sq"] * keys * (f["D"] + f["Dv"])
        return per * (3 if name.endswith("_bwd") else 1)
    if name.startswith("ssd_scan"):
        Q, N, P = f["chunk"], f["N"], f["P"]
        per = 2.0 * f["B"] * f["S"] * f["H"] * (Q * N + Q * P + 2 * N * P)
        return per * (2 if name.endswith("_bwd") else 1)
    return 0.0


# ---------------------------------------------------------------------------
# one step's terms, counted on fake tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device product flops (aten products + kernels)
    coll_bytes: float            # per-device wire bytes
    coll_f32_bytes: float        # fp32 portion of coll_bytes
    hbm_bytes: float             # per-device bytes: products' operands and results, kernels'
    coll_by_kind: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    collective_s_bf16: float     # with the fp32 wires sent in bf16
    dominant: str

    def as_dict(self):
        return dataclasses.asdict(self)


def _ring_wire(kind: str, result_bytes: float, n: int) -> float:
    if kind == "all-gather":
        return result_bytes * (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return result_bytes * 2 * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * (n - 1) / max(n, 1)
    return result_bytes                          # collective-permute


def link_bw(ranks) -> float:
    """The per-card link rate of a group: NVLink within one node, else the
    inter-node network."""
    return NVLINK_BW if len({r // NODE_CARDS for r in ranks}) <= 1 else INTER_NODE_BW


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _device_share(out) -> float:
    """The share of an op's work one device does, from its first output: the
    local share of it, over the sizes of the axes it is a partial sum on."""
    o = next((t for t in tree_leaves(out) if isinstance(t, torch.Tensor)), None)
    if o is None or not hasattr(o, "_local_tensor"):
        return 1.0
    share = o._local_tensor.numel() / o.numel() if o.numel() else 0.0
    for p, n in zip(o.placements, o.device_mesh.mesh.shape):
        if p.is_partial():
            share /= int(n)
    return share


def _tensors(tree):
    """The tensors of ``tree``, a module's parameters and buffers included."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            yield from leaf.parameters()
            yield from leaf.buffers()
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what one step dispatches: aten ops, product flops and their
    operand and result bytes, collectives' wire bytes, and (``memory``) the
    bytes of live storages, their peak, and which of them the arguments hold."""

    def __init__(self, memory: bool = False):
        super().__init__()
        self.aten_ops = 0
        self.flops = 0.0
        self.dot_bytes = 0.0
        self.collectives: List[Tuple[str, float, bool, float]] = []   # kind, wire, fp32, link
        self.memory = memory
        self.live = self.peak = self.argument_bytes = 0
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}
        self._args: set = set()
        self._alias: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.aten_ops += 1
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _FUNCTIONAL.get(packet.__name__)
            if kind is not None:
                self._collective(kind, out, args)
        else:
            from torch.utils.flop_counter import flop_registry
            if packet in flop_registry:
                share = _device_share(out)
                self.flops += share * flop_registry[packet](*args, **kwargs, out_val=out)
                self.dot_bytes += sum(_nbytes(t) for t in tree_leaves((args, out))
                                      if isinstance(t, torch.Tensor))
        if self.memory:
            if packet.__name__ == "wait_tensor":      # its output is its input
                self._alias[_local(out).untyped_storage()._cdata] = \
                    _local(args[0]).untyped_storage()._cdata
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._hold(_local(t))
        return out

    def _collective(self, kind: str, out, args) -> None:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = next(a for a in reversed(args) if isinstance(a, str))
        ranks = dist.get_process_group_ranks(_resolve_process_group(group))
        res = next(t for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        self.add_collective(kind, res.numel() * res.element_size(), ranks,
                            res.dtype == torch.float32)

    def add_collective(self, kind: str, result_bytes: float, ranks, fp32: bool) -> None:
        self.collectives.append((kind, _ring_wire(kind, result_bytes, len(ranks)), fp32,
                                 link_bw(ranks)))

    # live storages ---------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = self._alias.get(st._cdata, st._cdata)
        if key in self._refs:
            self._refs[key] += 1
        else:
            self._refs[key] = 1
            self._size[key] = st.nbytes()
            self.live += self._size[key]
            self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            self.live -= self._size.pop(key)
            del self._refs[key]

    def hold_arguments(self, tree) -> None:
        """Counts ``tree``'s tensors as live arguments, each by the bytes of
        its local shard (a shard may view a whole fake tensor's storage)."""
        for t in _tensors(tree):
            loc = _local(t)
            key = loc.untyped_storage()._cdata
            if key not in self._refs:
                self._args.add(key)
                self._refs[key] = 0
                self._size[key] = _nbytes(loc)
                self.argument_bytes += self._size[key]
                self.live += self._size[key]
                self.peak = max(self.peak, self.live)
            self._refs[key] += 1
            weakref.finalize(loc, self._drop, key)

    def output_bytes(self, tree) -> Tuple[int, int]:
        """(local bytes of ``tree``'s tensors, the part the arguments hold)."""
        seen, total, alias = set(), 0, 0
        for t in _tensors(tree):
            key = _local(t).untyped_storage()._cdata
            if key in seen:
                continue
            seen.add(key)
            total += _nbytes(t)
            alias += _nbytes(t) if key in self._args else 0
        return total, alias

    def terms(self, kernels) -> RooflineTerms:
        """This step's terms, with the kernel calls ``ops.dry_run`` recorded."""
        flops = self.flops + sum(step_flops(n, f) for n, f in kernels)
        hbm = self.dot_bytes + sum(kernel_work(n, f)[0] for n, f in kernels)
        coll = sum(w for _, w, _, _ in self.collectives)
        cf32 = sum(w for _, w, f32, _ in self.collectives if f32)
        by_kind: Dict[str, float] = {}
        for kind, w, _, _ in self.collectives:
            by_kind[kind] = by_kind.get(kind, 0.0) + w
        collective_s = sum(w / bw for _, w, _, bw in self.collectives)
        collective_s_bf16 = sum((w - (0.5 * w if f32 else 0.0)) / bw
                                for _, w, f32, bw in self.collectives)
        compute_s = flops / PEAK_FLOPS
        memory_s = hbm / HBM_BW
        dom = max((("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s)), key=lambda t: t[1])[0]
        return RooflineTerms(flops=flops, coll_bytes=coll, coll_f32_bytes=cf32,
                             hbm_bytes=hbm, coll_by_kind=by_kind, compute_s=compute_s,
                             memory_s=memory_s, collective_s=collective_s,
                             collective_s_bf16=collective_s_bf16, dominant=dom)


def count_step(fn, *args, counter: Optional[StepCounter] = None, **kwargs) -> RooflineTerms:
    """Runs ``fn(*args, **kwargs)`` once, its inputs fake tensors (or
    DTensors of fake shards), every kernel planned and none launched
    (``ops.dry_run``), and returns its per-device terms. ``counter`` (a
    ``StepCounter``) keeps the op count, the memory tally and, in
    ``counter.result``, what ``fn`` returned; ``counter.kernels`` holds the
    kernel calls."""
    from repro_torch.kernels import ops
    from repro_torch.sharding import collectives
    counter = counter if counter is not None else StepCounter()
    collectives.TRACE = counter
    try:
        with ops.dry_run() as kernels, counter:
            counter.result = fn(*args, **kwargs)
    finally:
        collectives.TRACE = None
    counter.kernels = list(kernels)
    return counter.terms(counter.kernels)


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def model_flops(cfg, shape, n_params_active: int) -> float:
    """6*N*D for train, 2*N*D for serve forward (D = tokens in the step)."""
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_params_active * tokens
    tokens = shape.global_batch            # decode: one token per sequence
    return 2.0 * n_params_active * tokens


def roofline_report(terms: RooflineTerms, cfg, shape, chips: int) -> Dict:
    counts = cfg.param_counts()
    mf = model_flops(cfg, shape, counts["active"])
    mf_per_chip = mf / chips
    return {
        "arch": cfg.name, "shape": shape.name, "chips": chips,
        "hlo_flops_per_chip": terms.flops,
        "coll_bytes_per_chip": terms.coll_bytes,
        "hbm_bytes_per_chip": terms.hbm_bytes,
        "coll_by_kind": terms.coll_by_kind,
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "collective_s_bf16adj": terms.collective_s_bf16,
        "dominant": terms.dominant,
        "model_flops_total": mf,
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_ratio": (mf_per_chip / terms.flops) if terms.flops else 0.0,
        "roofline_bound_s": max(terms.compute_s, terms.memory_s,
                                terms.collective_s),
        "model_compute_s": mf_per_chip / PEAK_FLOPS,
        # fraction of ideal: ideal time = model flops at peak; achieved-bound
        # time = dominant term
        "roofline_fraction": (mf_per_chip / PEAK_FLOPS) /
                             max(terms.compute_s, terms.memory_s,
                                 terms.collective_s, 1e-30),
    }


def measured_report(report: Dict, step_s: float) -> Dict:
    """``report`` with a measured step time: ``measured_s``, ``mfu`` (model
    flops per chip over the step at ``PEAK_FLOPS``) and ``bound_fraction``
    (the roofline bound over the step)."""
    return {**report, "measured_s": step_s,
            "mfu": report["model_flops_per_chip"] / (step_s * PEAK_FLOPS),
            "bound_fraction": report["roofline_bound_s"] / step_s}
