"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

At first use, every ``csrc/*.cu`` is compiled for sm_90a, one nvcc process
per source, all started together. The objects are linked into one shared
library with a plain C interface under ``<repo>/build/kernels/`` (listed in
``.gitignore``). The library's name carries a hash of the sources and the
flags, so a changed source builds anew and an unchanged one is reused.
Nothing is built or loaded when this module is imported.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.

A fake tensor (``FakeTensorMode``: shape, dtype and strides, no storage)
stands for a card tensor in a dry run (``ops.dry_run``): each launcher
checks and plans it as it would a card tensor, allocates its outputs, and
returns before the library is loaded or a kernel launched.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600

# Type codes shared with the C entry points.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # x, scale, out, rows, dim, eps, x_dtype, scale_dtype, path, grid,
    # vectors per thread, stream
    "rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    # x, scale, dy, dx, partials, dscale, rows, dim, eps, x_dtype,
    # scale_dtype, grid, path, vectors per thread, stream
    "rmsnorm_bwd": [_P] * 6 + [_I, _I, _F, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, lse (null: not written), B, H, KH, Sq, Sk, D, Dv,
    # 9 strides, scale, causal, prefix_len, stream
    "flash_attention_fwd_f32": [_P] * 5 + [_I] * 7 + [_L] * 9 + [_F, _I, _I, _P],
    # the same, then the (D, Dv) tile widths, before the stream
    "flash_attention_fwd_bf16": [_P] * 5 + [_I] * 7 + [_L] * 9 + [_F, _I, _I, _I, _I, _P],
    # q, k, v, o, do, lse, delta, dq, dk, dv, B, H, KH, Sq, Sk, D, Dv,
    # 24 strides (q, k, v, o, do, dq, dk, dv), scale, causal, prefix_len, stream
    "flash_attention_bwd_f32": [_P] * 10 + [_I] * 7 + [_L] * 24 + [_F, _I, _I, _P],
    "flash_attention_bwd_bf16": [_P] * 10 + [_I] * 7 + [_L] * 24 + [_F, _I, _I, _P],
    # x, dA, B, C, y, state, cum, states, Bsz, S, H, G, P, N, chunk,
    # 12 strides, bc_dtype, stream
    "ssd_scan_fwd": [_P] * 8 + [_I] * 7 + [_L] * 12 + [_I, _P],
    # x, B, C, cum, states, state, dy, dstate, dx, ddA, dB, dC, and the
    # scratch dstates, dbp, dcp, dcum; Bsz, S, H, G, P, N, chunk, 9 strides
    # (x, B, C), heads per block, ring, bc_dtype, stream
    "ssd_scan_bwd": [_P] * 16 + [_I] * 7 + [_L] * 9 + [_I, _I, _I, _P],
}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_s: float        # 0.0 when an existing build was loaded
    log: str              # nvcc's output (ptxas registers, shared memory, spills)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Runs the commands in parallel; raises with nvcc's output on failure."""
    return "\n".join(_run_each(cmds))


def _run_each(cmds):
    """Runs the commands in parallel and returns each one's output; raises
    with nvcc's output on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{out}")
            logs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return logs


def _build(sources, target: Path) -> str:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources, objs)])
        staged = Path(tmp) / target.name
        log += _run_all([[nvcc, "-shared", "-o", str(staged),
                          *map(str, objs)]])
        os.replace(staged, target)      # atomic: concurrent builds agree
    return log


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Builds (once per source hash) and loads the kernels' shared library."""
    sources = _sources()
    digest = _digest(sources)
    target = BUILD_DIR / f"librepro_torch_kernels-{digest}.so"
    log_path = target.with_suffix(".log")
    build_s = 0.0
    if not target.exists():
        t0 = time.perf_counter()
        log_path.parent.mkdir(parents=True, exist_ok=True)
        log_path.write_text(_build(sources, target))
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=lib, path=target, build_s=build_s, log=log)


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def _kernel_name(mangled: str) -> str:
    """``..18chunk_grads_kernelI13__nv_bfloat16Li64ELi128ELi2ELb1EEEvN..`` as
    ``chunk_grads_kernel<bf16,64,128,2,true>``."""
    end = mangled.find("_kernel")
    if end < 0:
        return mangled
    end += len("_kernel")
    start = end
    while start > 0 and (mangled[start - 1].isalpha() or mangled[start - 1] == "_"):
        start -= 1
    args = mangled[end:].split("EvN")[0].split("Ev")[0]
    if not args.startswith("I"):
        return mangled[start:end]
    args = re.sub(r"Li(\d+)E", r"\1,", args[1:].replace("13__nv_bfloat16", "bf16,"))
    args = re.sub(r"Lb([01])E", lambda m: ("true," if m.group(1) == "1" else "false,"), args)
    args = re.sub(r"^f", "float,", args).rstrip("E").rstrip(",")
    return f"{mangled[start:end]}<{args}>"


def kernel_instance(name: str) -> str:
    """A kernel's name as ``torch.profiler`` shows it, demangled (``void
    (anonymous namespace)::chunk_grads_kernel<__nv_bfloat16, 64, 128, 2,
    true>(...)``) or mangled, in ``ptxas_summary``'s form
    (``chunk_grads_kernel<bf16,64,128,2,true>``)."""
    m = re.search(r"(\w+_kernel)<([^>]*)>", name)
    if m:
        return f"{m.group(1)}<{m.group(2).replace(' ', '').replace('__nv_bfloat16', 'bf16')}>"
    return _kernel_name(name)


def ptxas_summary(log: str):
    """nvcc's ``-Xptxas -v`` output per kernel: registers, spill stores and
    static shared memory (bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1)), "registers": None,
                   "spill_stores": None, "smem": 0}
            out.append(cur)
        elif cur is not None:
            for key, pat in (("spill_stores", _SPILL), ("registers", _USED), ("smem", _SMEM)):
                hit = pat.search(line)
                if hit:
                    cur[key] = int(hit.group(1))
    return out


@functools.lru_cache(maxsize=None)
def _fake_tensor_type():
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor: a dry run's stand-in for a card tensor.
    (An isinstance test: a launcher runs it on every call.)"""
    return isinstance(t, _fake_tensor_type())


# Whether ``ops.dry_run()`` is open: only then does a launcher take fake tensors.
DRY_RUN = False


def dry(t: torch.Tensor) -> bool:
    """Whether a launcher plans ``t`` and returns without a launch: a fake
    tensor inside ``ops.dry_run()``. A fake tensor outside it raises, so that
    no count moves where no kernel ran."""
    if not is_fake(t):
        return False
    if not DRY_RUN:
        raise RuntimeError("a fake tensor outside ops.dry_run(): no kernel to launch")
    return True


def on_card(*ts: torch.Tensor) -> bool:
    """Whether every tensor lies on one CUDA device, or every one is fake."""
    if ts[0].is_cuda:
        return all(t.device == ts[0].device for t in ts)
    return all(is_fake(t) for t in ts)


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t`` starts on a 16-byte boundary; a fake tensor by its
    offset into a fresh allocation (the card's start on 256 bytes)."""
    if is_fake(t):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {code} ({msg})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
