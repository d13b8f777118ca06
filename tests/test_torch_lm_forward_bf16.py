"""The port's full-sequence forward against the JAX package's under the
default policy (fp32 parameters, bf16 compute), every architecture at
its smoke config, on carried parameters and the same numpy inputs:
within 3e-2 of max |reference logits|, Whisper too.  The port rounds
where the reference's XLA rounds: jax.nn's activations op by op, the
residual sum that a norm reads unrounded (``models/blocks._residual``),
and a bias added to the float32 dot (``models/layers.dot_bias``)."""
import pytest

from _torch_lm import ARCHS, check_forward


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_bf16(arch):
    check_forward(arch, "default")
