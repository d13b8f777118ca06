"""Public wrappers: the fused SGNS gradients and a whole PV-DBOW SGD
step, with the semantics of the JAX package's ``kernels/negsamp/ops.py``.

The call goes by where the tensors lie: CUDA tensors launch the
hand-written kernel (``kernel.py``), CPU tensors take the plain version
(``ref.py``); there is no fallback from one to the other.  The TPU
wrapper's tile argument (``tb``) and its batch padding have no
counterpart: the CUDA kernel takes any B.

``negsamp_step`` takes its negative ids already drawn (the reference
draws them inside the step from a threefry key, which torch cannot
reproduce; ``core/pv_dbow.py`` draws them with ``sample_negatives`` or
takes them injected).  The scatter-adds stay outside the kernel, as in
the reference, and duplicate ids add: ``index_add`` into the doc rows,
then the positive word rows, then the negative word rows.  On CUDA
``index_add`` adds with float atomics, so a step is not bitwise
repeatable from run to run there; on the CPU it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.negsamp import kernel as _k
from repro_torch.kernels.negsamp import ref as _ref


def negsamp_grads(d: torch.Tensor, w: torch.Tensor, wn: torch.Tensor, *,
                  temperature: float = 1.0):
    """(loss [B], grad_d [B, dim], grad_w [B, dim], grad_wn [B, K, dim])
    of the SGNS loss of each (doc, word, negatives) row."""
    if common.on_cuda(d, w, wn):
        return _k.negsamp_grads_kernel(d.contiguous(), w.contiguous(),
                                       wn.contiguous(),
                                       temperature=temperature)
    return _ref.negsamp_grads_ref(d, w, wn, temperature)


def negsamp_step(model, neg_ids: torch.Tensor, doc_ids: torch.Tensor,
                 word_ids: torch.Tensor, *, lr: float, unit_norm: bool,
                 temperature: float = 1.0):
    """One SGD step of the sum-reduced SGNS loss over the batch's
    (doc_ids[b], word_ids[b], neg_ids[b, :]) rows, all ids on the
    model's device.  Returns (new model, per-row mean loss); the model
    passed in is not modified."""
    from repro_torch.core.pv_dbow import PVDBOWModel, _unit_rows

    d = model.doc_vecs[doc_ids]
    w = model.word_vecs[word_ids]
    wn = model.word_vecs[neg_ids]
    loss, gd, gw, gwn = negsamp_grads(d, w, wn, temperature=temperature)

    # sum-reduction semantics (matches sgns_loss): per-row O(1) updates
    new_d = model.doc_vecs.index_add(0, doc_ids, gd, alpha=-lr)
    new_w = model.word_vecs.index_add(0, word_ids, gw, alpha=-lr)
    new_w.index_add_(0, neg_ids.reshape(-1), gwn.reshape(-1, gwn.shape[-1]),
                     alpha=-lr)
    if unit_norm:
        new_w = _unit_rows(new_w)
        new_d = _unit_rows(new_d)
    return PVDBOWModel(new_w, new_d), loss.mean()
