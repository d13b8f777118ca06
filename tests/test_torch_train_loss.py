"""The port's training loss and its gradients against the JAX
package's (``jax.value_and_grad(M.loss_fn)``) under the fp32 policy, on
the reference's parameters carried into the stacked training layout and
the same numpy batch (b=2, s=16, the second row's last quarter masked):
the dense and SSM architectures at their smoke configs.  Tolerances in
``_torch_lm.check_loss_and_grads``: the loss within rtol 1e-5, each
leaf's gradient within 1e-3 of its max |reference gradient|."""
import pytest

from _torch_lm import check_loss_and_grads


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen2_5_14b",
                                  "starcoder2_3b", "internlm2_20b",
                                  "mamba2_780m"])
def test_loss_and_grads_match_reference_fp32(arch):
    check_loss_and_grads(arch)
