"""Hand-written CUDA kernels (``csrc/``), their launchers and plain versions.

``ops`` is the public surface; ``ref`` holds the plain versions.
"""
