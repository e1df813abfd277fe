"""Fake-tensor input stand-ins for every model input (no storage).

Port of ``repro/launch/specs.py``: ``input_specs(cfg, shape)`` returns the
batch of an (arch x shape) cell as fake tensors (``FakeTensorMode``: shape,
dtype and strides, no storage), which the dry run lays out and steps on.
The modality frontends are stubs, as in the JAX package: whisper gets frame
embeddings, paligemma patch embeddings. The shapes are JAX's; the dtypes
are the ones the port's own step takes (``training/train.py::to_device``):

- tokens and targets are int64 (JAX: int32);
- frames and patches are in the config's compute dtype, bfloat16 for every
  full-width config (JAX: bfloat16 always);
- decode's one new token is int64 (JAX: int32).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import transformer as T


def fake_mode():
    """The fake mode in force, or a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    return detect_fake_mode() or FakeTensorMode()


def input_specs(cfg, shape, device="cpu") -> Dict[str, torch.Tensor]:
    B = shape.global_batch
    S = shape.seq_len
    with fake_mode():
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": torch.empty((B, S), dtype=torch.long, device=device)}
            if shape.kind == "train":
                batch["targets"] = torch.empty((B, S), dtype=torch.long, device=device)
            dt = getattr(torch, cfg.compute_dtype)
            if cfg.family == "encdec":
                batch["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model), dtype=dt,
                                              device=device)
            if cfg.family == "vlm":
                batch["patches"] = torch.empty((B, cfg.num_patches, cfg.d_model), dtype=dt,
                                               device=device)
            return batch
        # decode: one new token against caches of length S
        return {"token": torch.empty((B, 1), dtype=torch.long, device=device)}


def cache_specs_shapes(cfg, shape, device="cpu"):
    """The decode cell's cache tree as fake tensors (``T.init_caches``, bf16)."""
    with fake_mode():
        return T.init_caches(cfg, shape.global_batch, shape.seq_len, torch.bfloat16,
                             device=device)
