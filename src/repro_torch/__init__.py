"""PyTorch/CUDA port of the EmApprox serving path.

A package beside the JAX package ``repro`` (the reference it is held
against), mirroring its module names.  It imports torch and numpy and
nothing of ``jax`` or ``repro``; its kernels are hand-written CUDA for
Hopper (``csrc/``), each with a plain PyTorch version beside it.
"""
