"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

At first use, every ``csrc/*.cu`` is compiled for sm_90a, one nvcc process
per source, all started together. The objects are linked into one shared
library with a plain C interface under ``<repo>/build/kernels/`` (listed in
``.gitignore``). The library's name carries a hash of the sources and the
flags, so a changed source builds anew and an unchanged one is reused.
Nothing is built or loaded when this module is imported.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
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
    # 9 strides, scale, causal, stream
    "flash_attention_fwd_f32": [_P] * 5 + [_I] * 7 + [_L] * 9 + [_F, _I, _P],
    # the same, then the (D, Dv) tile widths, before the stream
    "flash_attention_fwd_bf16": [_P] * 5 + [_I] * 7 + [_L] * 9 + [_F, _I, _I, _I, _P],
    # q, k, v, o, do, lse, delta, dq, dk, dv, B, H, KH, Sq, Sk, D, Dv,
    # 24 strides (q, k, v, o, do, dq, dk, dv), scale, causal, stream
    "flash_attention_bwd_f32": [_P] * 10 + [_I] * 7 + [_L] * 24 + [_F, _I, _P],
    "flash_attention_bwd_bf16": [_P] * 10 + [_I] * 7 + [_L] * 24 + [_F, _I, _P],
    # x, dA, B, C, y, state, cum, states, Bsz, S, H, G, P, N, chunk,
    # 12 strides, bc_dtype, stream
    "ssd_scan_fwd": [_P] * 8 + [_I] * 7 + [_L] * 12 + [_I, _P],
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
    return "\n".join(logs)


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


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {code} ({msg})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
