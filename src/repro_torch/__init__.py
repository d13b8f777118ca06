"""PyTorch/CUDA port of EmApprox: the serving path, the offline index
build, live ingest and the serving runtime, and the LM model zoo's
serving and training paths (``models/``, ``launch/serve.py``: the ten
architectures' prefill and cached decode; ``optimizer/``,
``checkpoint/``, ``data/pipeline.py``, ``launch/train.py``: training
with the similarity curriculum, checkpoints and resume).

A package beside the JAX package ``repro`` (the reference it is held
against), mirroring its module names.  It imports torch and numpy and
nothing of ``jax`` or ``repro``; its kernels are hand-written CUDA for
Hopper (``csrc/``), each with a plain PyTorch version beside it.  The
LM paths have no kernel of their own (the reference's have no Pallas
call): their matrix products are ``torch.matmul`` / ``einsum``.
"""
