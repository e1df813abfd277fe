"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

It imports ``torch`` and never ``jax`` or ``repro``; ``repro`` stays the
reference it is tested against. Entry points run on the card unless called
with ``device="cpu"``.
"""
