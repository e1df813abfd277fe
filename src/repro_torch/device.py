"""Device resolution and card identity for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Asking for
CUDA where there is none raises: nothing falls back to the CPU silently.
"""
from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(device)!r}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card before a host clock is read (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
