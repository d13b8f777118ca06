"""``launch/steps.make_train_step`` against the JAX package's over 3
steps, fp32 policy, warmup_steps=1 (the schedule reads the step before
its increment, so the first update has lr 0 and the next two lr and
0.55 lr), with 1 and 2 micro-batches, on the reference's parameters
carried into the stacked layout and one numpy batch (b=4, s=16, a row
partly masked).

Tolerances: ``lr`` equal; the loss within rtol 1e-5 at every step;
``grad_norm`` within rtol 1e-4 at steps 0 and 1 (the same parameters:
the first update has lr 0) and 1e-3 at step 2.  The parameters: with
eps 1e-8 an AdamW step moves an entry by about lr * sign(g), so an
entry whose gradient is near zero and of the other sign in one package
moves up to 2 lr apart.  So each leaf is held within 2 x (the sum of
the lrs) at its worst entry, and its median entry within 1e-3 of that
sum (most entries agree to float32 rounding)."""
import jax
import numpy as np
import pytest

from _torch_lm import FP32, configs, jbatch, npf, stacked_params, tbatch, train_batch
from repro.launch.steps import make_train_step as jmake
from repro.optimizer.adamw import AdamWConfig as JCfg, adamw_init as jinit
from repro_torch.launch.steps import make_train_step as tmake
from repro_torch.optimizer.adamw import AdamWConfig as TCfg, adamw_init as tinit
from repro_torch.utils.trees import tree_leaves


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch,lr", [("smollm_360m", 5e-3),
                                     ("mamba2_780m", 1e-3),
                                     ("llama4_scout_17b_a16e", 5e-3)])
def test_train_step_matches_reference(arch, lr, microbatches):
    jc, tc = configs(arch, FP32)
    jp, tp = stacked_params(jc, tc, seed=0)
    kw = dict(microbatches=microbatches, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jmake(jc, JCfg(lr=lr), **kw))
    tstep = tmake(tc, TCfg(lr=lr), **kw)
    js, ts = jinit(jp, JCfg(lr=lr)), tinit(tp, TCfg(lr=lr))
    batch = train_batch(jc, b=4, s=16, seed=2)
    lrs = []
    for k in range(3):
        jp, js, jm = jstep(jp, js, jbatch(batch))
        tp, ts, tm = tstep(tp, ts, tbatch(batch))
        assert set(tm) == {"loss", "grad_norm", "lr"}
        assert float(tm["lr"]) == float(jm["lr"])
        lrs.append(float(jm["lr"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=1e-4 if k < 2 else 1e-3)
    assert lrs[0] == 0.0 and lrs[1] == np.float32(lr)
    assert int(ts.step) == int(js.step) == 3
    total = sum(lrs)
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        d = np.abs(npf(got) - npf(want))
        assert d.max() <= 2 * total
        assert np.median(d) <= 1e-3 * total
