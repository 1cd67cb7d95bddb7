"""PyTorch/CUDA port of the ``repro`` serving system for one NVIDIA H100.

Mirrors ``src/repro/`` (the JAX reference, which stays as it is):
``configs/``, ``core/``, ``models/``, ``kernels/`` (hand-written Hopper
kernels beside their plain PyTorch versions), ``serving/``, ``launch/``,
``util.py`` and ``examples/``. Imports torch, numpy and the standard
library only.
"""
