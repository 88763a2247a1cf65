"""PyTorch/CUDA port of the domain-decomposed PINN system.

Counterpart of the JAX package ``repro``, with the same module layout; it
imports torch and numpy only.  Each TPU kernel of the reference is a
hand-written CUDA kernel for Hopper here (``repro_torch/csrc/``), with its
plain PyTorch version beside it.  Entry points run on the CUDA card unless
the caller asks for the CPU (``device="cpu"``).
"""
