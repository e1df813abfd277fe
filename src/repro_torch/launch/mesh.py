"""Device meshes of the port on ``torch.distributed``.

Port of ``repro/launch/mesh.py``: ``make_mesh(shape, axes)`` and
``make_production_mesh()`` return a ``DeviceMesh`` whose dim names are the
JAX mesh's axis names. The process group must already be up (one process
per device: ``launch/train.py --nproc N`` or ``torchrun``), and its world
size must be the mesh's product. Functions, not module constants, so that
importing this module starts nothing.

Single pod : (data=16, model=16)            = 256 cards
Multi-pod  : (pod=2, data=16, model=16)     = 512 cards
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch.distributed as dist

# H100 SXM5 data sheet (NVIDIA H100 80GB HBM3, 700 W): the port's
# counterparts of the JAX package's v5e constants.
HARDWARE = "NVIDIA H100 80GB HBM3, 700 W, data sheet"
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per direction per card
# Between nodes: an HGX H100 node holds 8 cards on NVLink; the nodes of a
# 256- or 512-card mesh meet over one 400 Gb/s InfiniBand NDR port per card
# (NVIDIA DGX H100 data sheet: 8 x ConnectX-7), 50 GB/s per direction.
NODE_CARDS = 8
INTER_NODE_BW = 50e9         # bytes/s per direction per card


def _mesh(shape: Sequence[int], axes: Sequence[str], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} processes, the process group has "
            f"{world}: start one process per device (launch/train.py --nproc "
            "or torchrun) before making the mesh")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda"):
    """Any mesh: ``axes`` name the dims of ``shape``."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object whose
    ``shape`` is such a mapping (the tests' mesh stand-ins)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)
