"""The port's program spans (``utils/tracing.py``) and the pipeline's
wait counter: with no profiler a span is the one shared no-op; under
``torch.profiler`` (CPU activity) a smoke-size train step and prefill
give bit-identical results to the same calls without it, and their
trace holds every span of ``SPANS`` nested as the spans' table says
(on the CPU the autograd runs on the calling thread, so a recomputed
``model.layer`` lies inside ``train.backward``)."""
import dataclasses
import json
import os
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.smollm_360m import smoke_config
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models import model as M
from repro_torch.optimizer.adamw import AdamWConfig, adamw_init
from repro_torch.utils import tracing
from repro_torch.utils.trees import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _cfg():
    cfg = dataclasses.replace(smoke_config(), tie_embeddings=True)
    assert cfg.remat == "selective"
    return cfg


def _batches(cfg, n: int):
    g = torch.Generator().manual_seed(3)
    out = []
    for _ in range(n):
        tok = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
        mask = torch.ones(2, 32)
        mask[1, 20:] = 0.0
        out.append({"tokens": tok[:, :-1], "labels": tok[:, 1:],
                    "mask": mask})
    return out


def _train(cfg, traced: bool):
    """Two train steps fed through a ``PrefetchIterator``, the second
    under the profiler where ``traced``: (params, state, losses, the
    profiler or None)."""
    params = M.init_stacked_params(cfg, torch.Generator().manual_seed(0),
                                   device=CPU)
    opt = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt)
    step = make_train_step(cfg, opt, warmup_steps=0, total_steps=10)
    it = PrefetchIterator(iter(_batches(cfg, 2)), depth=1)
    losses, prof = [], None
    try:
        params, state, met = step(params, state, next(it))
        losses.append(met["loss"])
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                params, state, met = step(params, state, next(it))
        else:
            params, state, met = step(params, state, next(it))
        losses.append(met["loss"])
    finally:
        it.close()
    return params, state, losses, prof


def _prefill(cfg, traced: bool):
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device=CPU)
    tokens = torch.randint(0, cfg.vocab_size, (3, 12),
                           generator=torch.Generator().manual_seed(4))
    step = make_prefill_step(cfg)

    def call():
        state = M.init_decode_state(cfg, 3, 16, device=CPU)
        return step(params, tokens, state)
    if not traced:
        return call(), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    return out, prof


def _spans(prof, tmp_path) -> list:
    """(tid, start, end, name) of the trace's program spans."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())
    ev = ev["traceEvents"] if isinstance(ev, dict) else ev
    return [(e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["name"]) for e in ev if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name") in tracing.SPANS]


def _parents(spans: list) -> dict:
    """{name: the set of names of the innermost program span around
    each of its spans (None: none)}."""
    out = {}
    for tid, a, b, name in spans:
        around = [(a2, b2, n2) for t2, a2, b2, n2 in spans
                  if t2 == tid and a2 <= a and b <= b2
                  and (a2, b2) != (a, b)]
        inner = max(around, key=lambda x: (x[0], -x[1]))[2] \
            if around else None
        out.setdefault(name, set()).add(inner)
    return out


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tracing.span("train.forward"), tracing.span("data.wait")
    assert a is b is tracing._OFF
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = tracing.span("train.forward")
    assert on is not tracing._OFF


def test_train_step_is_bit_identical_under_the_profiler(tmp_path):
    cfg = _cfg()
    p0, s0, l0, _ = _train(cfg, traced=False)
    p1, s1, l1, prof = _train(cfg, traced=True)
    for a, b in zip(l0, l1):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(p0) + tree_leaves(s0.m) + tree_leaves(s0.v),
                    tree_leaves(p1) + tree_leaves(s1.m) + tree_leaves(s1.v)):
        assert torch.equal(a, b)
    assert int(s0.step) == int(s1.step) == 2

    spans = _spans(prof, tmp_path)
    par = _parents(spans)
    assert set(par) == set(tracing.SPANS) - {"serve.init_state"}
    assert par["train.forward"] == par["train.backward"] \
        == par["train.optimizer"] == par["data.wait"] == {None}
    assert par["model.cast"] == par["model.head"] == par["model.loss"] \
        == {"train.forward"}
    # run once a layer in the forward, again in the backward's recompute
    assert par["model.layer"] == {"train.forward", "train.backward"}
    assert par["layer.attention"] == {"model.layer"}
    n = sum(1 for s in spans if s[3] == "model.layer")
    assert n == 2 * cfg.n_layers
    fwd = [s for s in spans if s[3] == "train.forward"]
    bwd = [s for s in spans if s[3] == "train.backward"]
    opt = [s for s in spans if s[3] == "train.optimizer"]
    assert len(fwd) == len(bwd) == len(opt) == 1
    assert fwd[0][2] <= bwd[0][1] and bwd[0][2] <= opt[0][1]


def test_prefill_is_bit_identical_under_the_profiler(tmp_path):
    cfg = _cfg()
    (lg0, st0), _ = _prefill(cfg, traced=False)
    (lg1, st1), prof = _prefill(cfg, traced=True)
    assert torch.equal(lg0, lg1)
    for a, b in zip(st0.kv + (st0.pos,), st1.kv + (st1.pos,)):
        assert torch.equal(a, b)
    assert st0.length == st1.length == 12

    par = _parents(_spans(prof, tmp_path))
    assert set(par) == {"serve.init_state", "layer.attention", "model.head"}
    assert par["serve.init_state"] == par["layer.attention"] \
        == par["model.head"] == {None}


def test_prefetch_counts_its_gets_and_its_wait():
    release = threading.Event()

    def slow():
        yield 1
        release.wait(10)
        yield 2

    it = PrefetchIterator(slow(), depth=1)
    try:
        assert (it.gets, it.wait_s) == (0, 0.0)
        assert next(it) == 1
        threading.Timer(0.2, release.set).start()
        t0 = time.perf_counter()
        assert next(it) == 2
        waited = time.perf_counter() - t0
        with pytest.raises(StopIteration):
            next(it)
    finally:
        it.close()
    assert it.gets == 3
    assert 0.15 <= it.wait_s <= waited + 0.1


@pytest.mark.parametrize("name", tracing.SPANS)
def test_every_span_is_named_in_perf_md(name):
    with open(os.path.join(ROOT, "PERF.md")) as f:
        assert f"`{name}`" in f.read()
