"""One train step under the default policy (fp32 parameters and
moments, bf16 compute, the arch's remat) in both packages, smollm and
mamba2 at smoke width, warmup 0, on carried parameters and one numpy
batch (b=4, s=16, a row partly masked).

The loss and the parameters after the step are held within
``_torch_lm.bound`` of the reference's: 1e-4 (loss) and 1e-5
(parameters, relative to each leaf's max), or twice the reference's own
move under one ulp of its float32 parameters.  Readings: losses
2.8e-5 (smollm) and 1.6e-7 (mamba2) apart; the parameters equal
(Adam's first step moves every entry by lr * sign(g) plus decay, and
every sign agrees).

The gradient norm cannot be held that way: under bf16 compute the
reference's own gradients depend on how XLA fuses its graph.  XLA keeps
float32 values where the program rounds to bf16
(``--xla_allow_excess_precision``, on by default), so smollm's
reference jitted and the same reference evaluated op by op
(``jax.disable_jit()``, equal bit for bit to the jitted one with that
flag off) differ: gradient norm 14.577 against 15.179 (4.1 %), a leaf's
gradient up to 26 % of its max.  ``bound`` refuses a reference whose
own spread is that wide.  So the gradient norm is held to the bf16
tolerance the port's forward is held to (``FORWARD_TOL["default"]``,
3e-2 relative).  Readings: smollm 4.1e-3, mamba2 1.0e-3 (mamba2's bf16
forward is 3.8e-3 off the reference's; its reference does not move
between jit and op by op)."""
import jax
import numpy as np
import pytest

from _torch_lm import (FORWARD_TOL, bound, configs, jbatch, npf, one_ulp,
                       stacked_params, tbatch, train_batch)
from repro.launch.steps import make_train_step as jmake
from repro.optimizer.adamw import AdamWConfig as JCfg, adamw_init as jinit
from repro_torch.launch.steps import make_train_step as tmake
from repro_torch.optimizer.adamw import AdamWConfig as TCfg, adamw_init as tinit
from repro_torch.utils.trees import tree_leaves


def _leaf_rel(a, b) -> float:
    a, b = npf(a), npf(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch,lr", [("smollm_360m", 5e-3),
                                     ("mamba2_780m", 1e-3)])
def test_bf16_train_step_matches_reference(arch, lr):
    jc, tc = configs(arch)
    assert tc.dtypes.compute == "bfloat16" and tc.dtypes.params == "float32"
    jp, tp = stacked_params(jc, tc, seed=0)
    batch = train_batch(jc, b=4, s=16, seed=2)
    kw = dict(warmup_steps=0, total_steps=3)
    jstep = jax.jit(jmake(jc, JCfg(lr=lr), **kw))
    jp1, _, jm = jstep(jp, jinit(jp, JCfg(lr=lr)), jbatch(batch))
    tp1, _, tm = tmake(tc, TCfg(lr=lr), **kw)(tp, tinit(tp, TCfg(lr=lr)),
                                               tbatch(batch))
    nudged = one_ulp(jp)
    jpu, _, jmu = jstep(nudged, jinit(nudged, JCfg(lr=lr)), jbatch(batch))

    loss, want = float(tm["loss"]), float(jm["loss"])
    assert np.isfinite(loss)
    move = abs(float(jmu["loss"]) - want) / abs(want)
    assert abs(loss - want) / abs(want) <= bound(1e-4, move)
    pmove = max(_leaf_rel(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(jpu), jax.tree_util.tree_leaves(jp1)))
    tol = bound(1e-5, pmove)
    for got, ref in zip(tree_leaves(tp1), jax.tree_util.tree_leaves(jp1)):
        assert _leaf_rel(got, ref) <= tol
    gn, gn_ref = float(tm["grad_norm"]), float(jm["grad_norm"])
    assert abs(gn - gn_ref) / gn_ref <= FORWARD_TOL["default"]
