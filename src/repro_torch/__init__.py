"""PyTorch/CUDA port of the TinyKG package ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package keeps its module
layout and names, imports only torch, numpy and the standard library, and
carries its hot paths on hand-written CUDA kernels (``csrc/``) built for
``sm_90a``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version.
"""
