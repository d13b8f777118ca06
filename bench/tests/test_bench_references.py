"""The plain references against the port at the tests' sizes, in
float32: the forward, the loss and its gradients, two AdamW steps of
the train step, and the state prefill leaves."""
import dataclasses

import numpy as np
import pytest
import torch

from benchtest import CPU, SEED, ctx
from bench.lib import lm
from bench.reference import common as C


def _fp32(cfg):
    from repro_torch.models.config import DTypePolicy
    return dataclasses.replace(cfg, dtypes=DTypePolicy(
        compute="float32", kv_cache="float32"))


def _setup(cell):
    cx = ctx(cell)
    cfg = _fp32(cx.config.port_config(True))
    w = lm.make_weights(cx.config.leaves(cx.sizes), SEED, CPU)
    return cx, cfg, w


def _batch(cx, seq=32, rows=2):
    rng = np.random.default_rng(3)
    v = cx.config.token_vocab(cx.sizes)
    x = torch.from_numpy(rng.integers(0, v, (rows, seq + 1)))
    return x[:, :-1], x[:, 1:]


@pytest.mark.parametrize("cell", ["smollm-360m.train"])
def test_loss_and_gradients(cell):
    from repro_torch.models import model as M
    cx, cfg, w = _setup(cell)
    tok, lab = _batch(cx)
    port = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss_p = M.loss_fn(lm.to_tree(cx.config.PORT_PATHS, port),
                       {"tokens": tok, "labels": lab}, cfg)
    loss_p.backward()
    ref = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    model = cx.reference.Model(cx.sizes, ref)
    loss_r, grads = C.loss_and_grads(model, ref, tok, lab, block=1)
    assert float(loss_p.detach()) == pytest.approx(loss_r, rel=1e-5)
    for k in w:
        torch.testing.assert_close(port[k].grad, grads[k], rtol=2e-4,
                                   atol=2e-6 * float(grads[k].abs().max()))


@pytest.mark.parametrize("cell", ["smollm-360m.train"])
def test_two_train_steps(cell):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optimizer.adamw import AdamWConfig, adamw_init
    cx, cfg, w = _setup(cell)
    opt = dict(cx.config.SPEC["optimizer"], warmup_steps=1)
    ocfg = AdamWConfig(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"],
                       eps=opt["eps"], weight_decay=opt["weight_decay"],
                       grad_clip=opt["grad_clip"])
    step = make_train_step(cfg, ocfg, total_steps=opt["total_steps"],
                           warmup_steps=1)
    params = lm.to_tree(cx.config.PORT_PATHS,
                        {k: v.clone() for k, v in w.items()})
    state = adamw_init(params, ocfg)
    ref = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v = {k: torch.zeros_like(x) for k, x in w.items()}
    model = cx.reference.Model(cx.sizes, ref)
    for t in (1, 2):
        tok, lab = _batch(cx)
        params, state, met = step(params, state,
                                  {"tokens": tok, "labels": lab})
        loss_r, grads = C.loss_and_grads(model, ref, tok, lab, block=2)
        gn = C.adamw_step(ref, grads, m, v, t, opt)
        assert float(met["loss"]) == pytest.approx(loss_r, rel=1e-5)
        assert float(met["grad_norm"]) == pytest.approx(gn, rel=1e-4)
    got = lm.from_tree(cx.config.PORT_PATHS, params)
    change_p = lm.leaf_norms({k: got[k] - w[k] for k in w})
    change_r = lm.leaf_norms({k: ref[k].detach() - w[k] for k in w})
    gap, where = lm.worst_leaf_gap(change_p, change_r)
    assert gap < 1e-3, where


@pytest.mark.parametrize("cell", ["smollm-360m.prefill"])
def test_prefill_logits_and_state(cell):
    from repro_torch.models import model as M
    cx, cfg, w = _setup(cell)
    tok, _ = _batch(cx, seq=45, rows=3)
    params = lm.to_tree(cx.config.PORT_PATHS, w)
    layers = params.pop("layers")
    n = next(iter(layers.values()))
    n = (n if isinstance(n, torch.Tensor)
         else next(iter(n.values()))).shape[0]
    params["layers"] = [{k: ({kk: vv[i] for kk, vv in v.items()}
                             if isinstance(v, dict) else v[i])
                         for k, v in layers.items()} for i in range(n)]
    state = M.init_decode_state(cfg, 3, 45, device=CPU)
    logits, state = M.prefill(params, tok, cfg, state)
    ref_logits, ref_state = cx.reference.Model(cx.sizes, w).prefill(
        tok, want_state=True)
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-5)
    for r in range(3):
        got = cx.config.port_state(state, r)
        for k, x in got.items():
            torch.testing.assert_close(x.float(), ref_state[k][:, r],
                                       rtol=1e-4, atol=1e-5)
