"""PyTorch/CUDA port of EmApprox: the serving path, the offline index
build, live ingest and the serving runtime, and the LM model zoo's
serving path (``models/``, ``launch/serve.py``: the ten architectures'
prefill and cached decode).

A package beside the JAX package ``repro`` (the reference it is held
against), mirroring its module names.  It imports torch and numpy and
nothing of ``jax`` or ``repro``; its kernels are hand-written CUDA for
Hopper (``csrc/``), each with a plain PyTorch version beside it.  The
LM path has no kernel of its own (the reference's has no Pallas call):
its matrix products are ``torch.matmul`` / ``einsum``.
"""
