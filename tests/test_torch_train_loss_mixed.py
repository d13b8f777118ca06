"""The training loss and its gradients against the JAX package's for
the encoder-decoder, hybrid, MoE and VLM architectures (the tolerances
of ``tests/test_torch_train_loss.py``; the MoE losses carry the
router's load-balance term), and the three activation-checkpoint
policies: "none", "full" and "selective" give the same loss and
gradients bit for bit on the CPU, under the default (bf16 compute)
policy, and each does recompute what it should."""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_lm import ARCHS, check_loss_and_grads, configs, stacked_params, tbatch, train_batch
from repro_torch.launch.steps import _value_and_grad
from repro_torch.models import model as TM
from repro_torch.utils.trees import tree_leaves, tree_unflatten


@pytest.mark.parametrize("arch", ["whisper_small", "hymba_1_5b",
                                  "llama4_scout_17b_a16e",
                                  "llama4_maverick_400b_a17b",
                                  "llama_3_2_vision_11b"])
def test_loss_and_grads_match_reference_fp32(arch):
    check_loss_and_grads(arch)


def _port_state(arch: str):
    jc, tc = configs(arch)
    _, tp = stacked_params(jc, tc, seed=0)
    return tc, tp, tbatch(train_batch(jc, b=2, s=16, seed=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_agree_bit_for_bit(arch):
    tc, tp, batch = _port_state(arch)
    runs = {r: _value_and_grad(tp, batch, dataclasses.replace(tc, remat=r))
            for r in ("none", "full", "selective")}
    loss0, grads0 = runs["none"]
    for r in ("full", "selective"):
        loss, grads = runs[r]
        assert torch.equal(loss, loss0), r
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(grads), tree_leaves(grads0))), r


class _OpCounts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = self.other = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        else:
            self.other += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_should():
    """Ops run by the backward pass: "full" recomputes every op, the
    weight matmuls included; "selective" saves the matmuls and
    recomputes the rest; "none" recomputes nothing."""
    tc, tp, batch = _port_state("smollm_360m")
    counts = {}
    for r in ("none", "full", "selective"):
        cfg = dataclasses.replace(tc, remat=r)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
        loss = TM.loss_fn(tree_unflatten(tp, leaves), batch, cfg)
        with _OpCounts() as c:
            torch.autograd.grad(loss, leaves)
        counts[r] = (c.mm, c.other)
    assert counts["full"][0] > counts["none"][0]
    assert counts["selective"][0] == counts["none"][0]
    assert counts["selective"][1] > counts["none"][1]
