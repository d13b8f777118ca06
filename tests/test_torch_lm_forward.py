"""The port's full-sequence forward against the JAX package's under the
fp32 policy, every architecture at its smoke config, on the reference's
parameters carried over with ``model_from_arrays`` and the same numpy
tokens (and encoder inputs for Whisper and the VLM): within 1e-4 of max
|reference logits| (``_torch_lm.check_forward`` gives the rule for
Whisper's wider spread, at most 1e-3).  Also the MoE auxiliary loss of a forward."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_lm import ARCHS, FP32, carried_params, check_forward, configs, inputs, tt
from repro.models import model as JM
from repro_torch.models import model as TM


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_fp32(arch):
    check_forward(arch, "fp32")


def test_aux_loss_of_a_moe_forward_matches_reference():
    jc, tc = configs("llama4_scout_17b_a16e", FP32)
    jp, tp = carried_params(jc, tc, seed=0)
    toks, _ = inputs(jc, b=2, s=24, seed=1)
    _, jaux = JM._forward_impl(jp, jnp.asarray(toks), jc, None)
    _, taux = TM._forward_impl(tp, tt(toks), tc, None, want_aux=True)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
