"""The fused attention forward (``kernels/attention``): which calls take
it, the train path left bit for bit as it was, the benchmark's reader
of its device time, and, on the card, the kernel against
``dense_attention`` computed in float32.

The card's tests carry the ``cuda`` marker and skip without a GPU; the
file imports no JAX: ``python -m pytest -q -m cuda
tests/test_torch_attention_kernel.py``."""
import dataclasses
import json
import os
import sys

import pytest
import torch

from repro_torch.configs.smollm_360m import smoke_config
from repro_torch.kernels import common
from repro_torch.kernels.attention import kernel as K
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import (NEG_INF, _causal_mask,
                                               _gqa_out, _gqa_scores,
                                               _sqrt_in, dense_attention)
from repro_torch.models import attention as A
from repro_torch.models.blocks import attn_defs
from repro_torch.models.layers import materialize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench.lib import core, spec, spans  # noqa: E402
from bench.lib import trace as tr  # noqa: E402

READER = "attention_kernel_ms.prefill"


def _dense_before(q, k, v, *, causal, window=0, q_offset=0,
                  kv_valid_len=None):
    """``dense_attention`` as ``models/attention.py`` had it before the
    fused kernel: the train path must give these bits."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, hd)
    scores = _gqa_scores(qg, k) / _sqrt_in(hd, q.dtype)
    mask = None
    if causal:
        mask = _causal_mask(s, t, q_offset, window, q.device)[None, None, None]
    if kv_valid_len is not None:
        valid = (torch.arange(t, device=q.device)[None, :]
                 < kv_valid_len[:, None])
        valid = valid[:, None, None, None, :]
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = _gqa_out(p, v)
    return out.reshape(b, s, h, hd)


def _layer(device, *, grad: bool, impl: str = "dense", seed: int = 0):
    """(cfg, bfloat16 attention params, x [2, 24, d], positions) of the
    smoke config on ``device``; the params require grad where ``grad``."""
    cfg = dataclasses.replace(smoke_config(), attn_impl=impl)
    gen = torch.Generator().manual_seed(seed)
    p = materialize(attn_defs(cfg), gen, torch.float32, torch.device("cpu"))
    p = {n: w.to(device=device, dtype=torch.bfloat16).requires_grad_(grad)
         for n, w in p.items()}
    x = torch.randn(2, 24, cfg.d_model, generator=gen).to(device,
                                                           torch.bfloat16)
    return cfg, p, x, torch.arange(24, device=device)


# ----------------------------------------------------------------------
# which call takes the kernel (CPU: the card's route stands in by
# ``common.on_cuda`` answering True and a counted plain kernel)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("enabled,needs,want", [
    (True, (True, False, False), True), (True, (False, False, True), True),
    (True, (False, False, False), False), (False, (True, True, True), False)])
def test_records_grad(enabled, needs, want):
    ts = [torch.ones(2, requires_grad=r) for r in needs]
    with torch.set_grad_enabled(enabled):
        assert ops.records_grad(*ts) is want


@pytest.mark.parametrize("cuda,grad,impl,want", [
    (True, False, "dense", "kernel"), (True, False, "chunked", "kernel"),
    (True, True, "dense", "dense"), (True, True, "chunked", "chunked"),
    (False, False, "dense", "dense"), (False, False, "chunked", "chunked"),
    (False, True, "dense", "dense")])
def test_the_call_takes(cuda, grad, impl, want, monkeypatch):
    took = []

    def spy(name, fn):
        def call(*a, **kw):
            took.append(name)
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(common, "on_cuda", lambda *t: cuda)
    monkeypatch.setattr(K, "fused_attention_kernel",
                        spy("kernel", dense_attention))
    monkeypatch.setattr(A, "dense_attention", spy("dense", dense_attention))
    monkeypatch.setattr(A, "chunked_attention",
                        spy("chunked", A.chunked_attention))
    cfg, p, x, pos = _layer(torch.device("cpu"), grad=grad, impl=impl)
    A.attention_apply(p, x, cfg=cfg, positions=pos)
    assert took == [want]


def test_no_grad_inside_a_grad_step_takes_the_kernel(monkeypatch):
    """Parameters that require grad, read under ``torch.no_grad()``:
    autograd records nothing, so the call takes the kernel."""
    took = []
    monkeypatch.setattr(common, "on_cuda", lambda *t: True)
    monkeypatch.setattr(K, "fused_attention_kernel",
                        lambda *a, **kw: took.append(1) or dense_attention(
                            *a, **kw))
    cfg, p, x, pos = _layer(torch.device("cpu"), grad=True)
    with torch.no_grad():
        A.attention_apply(p, x, cfg=cfg, positions=pos)
    assert took == [1]


@pytest.mark.parametrize("impl,window", [("dense", 0), ("chunked", 0),
                                         ("dense", 8)])
def test_cpu_without_grad_keeps_the_plain_path(impl, window):
    before = K.fused_attention_kernel.launches
    cfg, p, x, pos = _layer(torch.device("cpu"), grad=False, impl=impl)
    got, _ = A.attention_apply(p, x, cfg=cfg, positions=pos, window=window)
    assert K.fused_attention_kernel.launches == before
    q = (x @ p["wq"]).reshape(2, 24, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(2, 24, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(2, 24, cfg.n_kv_heads, cfg.head_dim)
    q = A.apply_rope(q, pos[None], cfg.rope_theta)
    k = A.apply_rope(k, pos[None], cfg.rope_theta)
    plain = A.chunked_attention if impl == "chunked" else dense_attention
    want = plain(q, k, v, causal=True, window=window)
    want = want.reshape(2, 24, -1) @ p["wo"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("window", [0, 8])
def test_train_path_is_bit_for_bit_as_before(window, monkeypatch):
    """attention_apply with parameters that require grad: its output and
    every gradient equal those of the dense call it made before."""
    def run():
        cfg, p, x, pos = _layer(torch.device("cpu"), grad=True, seed=4)
        out, _ = A.attention_apply(p, x, cfg=cfg, positions=pos,
                                   window=window)
        grads = torch.autograd.grad(out.float().square().sum(),
                                    list(p.values()))
        return out, grads

    out, grads = run()
    monkeypatch.setattr(A, "dense_attention", _dense_before)
    out0, grads0 = run()
    assert torch.equal(out, out0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


@pytest.mark.parametrize("cuda,grad,want", [
    (True, False, True), (True, True, False), (False, False, False)])
def test_takes_kernel(cuda, grad, want, monkeypatch):
    monkeypatch.setattr(common, "on_cuda", lambda *t: cuda)
    q = torch.ones(1, 2, 2, 16, requires_grad=grad)
    assert ops.takes_kernel(q, q.detach(), q.detach()) is want


def test_the_kernel_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors before it loads or
    launches anything: the CPU's route is the plain version."""
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    before = K.fused_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_attention_kernel(q, q[:, :, :1], q[:, :, :1], causal=True)
    assert K.fused_attention_kernel.launches == before


# ----------------------------------------------------------------------
# the benchmark's reader of the kernel's device time
# ----------------------------------------------------------------------
def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 1,
            "ts": ts, "dur": dur, "args": args}


def _trace(with_kernel: bool):
    """One 1000 us window of two batches: a GEMM, a copy, and (where
    ``with_kernel``) three of the kernel's launches, one cut by the
    window's end, and one after it."""
    name = "fused_attention_fwd" if with_kernel else "elementwise_kernel"
    return [_x("user_annotation", tr.WINDOW, 0, 1000),
            _x("cpu_op", "aten::mm", 5, 4),
            _x("kernel", "nvjet_tst_128x64", 10, 30),
            _x("gpu_memcpy", "Memcpy DtoD", 45, 5),
            _x("kernel", name, 100, 40), _x("kernel", name, 500, 60),
            _x("kernel", name, 980, 50), _x("kernel", name, 1100, 10)]


def _run(events, path, monkeypatch, kind="prefill"):
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(spans, "TRACE_FILE", path)
    run = core.Run(cell=f"smollm-360m.{kind}", kind=kind)
    run.traced = tr.summarize(events, 2)
    return run


@pytest.mark.parametrize("with_kernel,want_ms", [(True, 0.060),
                                                 (False, 0.0)])
def test_reader_by_hand(with_kernel, want_ms, tmp_path, monkeypatch):
    # (40 + 60 + 20 clipped) us over 2 batches
    run = _run(_trace(with_kernel), tmp_path / "trace.json", monkeypatch)
    got = spec.metric_module(READER).read(run)
    assert got == pytest.approx(want_ms, abs=1e-12)


@pytest.mark.parametrize("case", ["train", "untraced", "another_run",
                                  "absent", "no_package"])
def test_reader_is_silent(case, tmp_path, monkeypatch):
    run = _run(_trace(True), tmp_path / "trace.json", monkeypatch,
               kind="train" if case == "train" else "prefill")
    reader = spec.metric_module(READER)
    if case == "untraced":
        run.traced = None
    elif case == "another_run":
        run.traced = dict(run.traced,
                          device_ops=run.traced["device_ops"] + 1)
    elif case == "absent":
        monkeypatch.setattr(spans, "TRACE_FILE", tmp_path / "absent.json")
    elif case == "no_package":
        monkeypatch.setattr(reader, "PACKAGE",
                            "repro_torch.kernels.no_such_kernel")
    assert reader.read(run) is None


def test_reader_is_in_the_manifest():
    m = next(m for m in spec.manifest()["per_layer"] if m["name"] == READER)
    assert m["layer"] == "attention" and m["moves"] == "prefill_tokens_per_s"
    assert READER in {x["name"] for x in
                      spec.metrics_of("smollm-360m.prefill", True)}
    assert READER not in {x["name"] for x in
                          spec.metrics_of("smollm-360m.train", True)}


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s, t, kh, g, hd, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, kh * g, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, t, kh, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, t, kh, hd, generator=gen, device=dev).to(dtype)
    return q, k, v


def _p_rounded(q, k, v, dtype, *, causal, window=0, q_offset=0):
    """``dense_attention`` in float32 with the probabilities rounded to
    ``dtype`` before the product with V: a kernel that rounds P lower
    than the port does, as a control the tolerance must catch."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = q.float().reshape(b, s, kh, h // kh, hd)
    scores = _gqa_scores(qg, k.float()) / _sqrt_in(hd, torch.float32)
    if causal:
        mask = _causal_mask(s, k.shape[1], q_offset, window, q.device)
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(dtype).float()
    return _gqa_out(p, v.float()).reshape(b, s, h, hd)


def _against_float32(q, k, v, **kw):
    """(max |kernel - dense in float32|, max |dense in q's dtype - dense
    in float32|): the kernel's error and the plain path's own."""
    got = K.fused_attention_kernel(q, k, v, **kw).float()
    want = dense_attention(q.float(), k.float(), v.float(), **kw)
    plain = dense_attention(q, k, v, **kw).float()
    return (float((got - want).abs().max()),
            float((plain - want).abs().max()))


# 16-bit inputs: the kernel rounds the probabilities to bfloat16 before
# the PV product and rounds the output, as dense_attention does, but
# keeps the scores in float32, where dense_attention rounds them to
# bfloat16 first.  So the kernel is held to the plain bfloat16 path's
# own error on the same inputs, with a factor 2 for the order of its
# sums and its exp2: no more than twice as far from float32 as the
# path it replaces.  (Where the plain path is exact, as at one key a
# row, so must the kernel be.)  A kernel that rounded P to float8 e4m3
# fails this bound (``test_the_bound_catches_p_in_float8``).
LENGTHS = (1, 63, 64, 65, 150, 1747, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("g", [1, 3, 5])
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_float32_dense(s, g, hd, causal, cuda_device):
    q, k, v = _qkv(2, s, s, 2, g, hd, torch.bfloat16, cuda_device, seed=s)
    err, plain = _against_float32(q, k, v, causal=causal)
    print(f"S={s} G={g} hd={hd} causal={causal}: kernel {err:.3g}, "
          f"dense bf16 {plain:.3g}")
    assert err <= 2 * plain


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("g", [1, 3, 5])
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("s,t,q_offset", [
    (65, 65, 0), (150, 150, 0), (1747, 1747, 0),
    (50, 150, 64), (63, 2048, 1985), (1, 65, 64), (64, 1747, 1000)])
def test_kernel_window_and_offset(s, t, q_offset, window, g, hd,
                                  cuda_device):
    """Causal, the sliding window and a query offset (the sharded
    prefill's rows, S != T)."""
    q, k, v = _qkv(1, s, t, 3, g, hd, torch.bfloat16, cuda_device, seed=t)
    err, plain = _against_float32(q, k, v, causal=True, window=window,
                                  q_offset=q_offset)
    print(f"S={s} T={t} q_offset={q_offset} window={window} G={g} "
          f"hd={hd}: kernel {err:.3g}, dense bf16 {plain:.3g}")
    assert err <= 2 * plain


@pytest.mark.cuda
@pytest.mark.parametrize("s,g,hd,window", [
    (150, 3, 64, 0), (1747, 3, 64, 0), (1747, 5, 128, 32)])
def test_the_bound_catches_p_in_float8(s, g, hd, window, cuda_device):
    """The control: probabilities rounded to float8 e4m3 instead of
    bfloat16 land outside the kernel's bound."""
    q, k, v = _qkv(1, s, s, 2, g, hd, torch.bfloat16, cuda_device, seed=s)
    kw = dict(causal=True, window=window)
    _, plain = _against_float32(q, k, v, **kw)
    want = dense_attention(q.float(), k.float(), v.float(), **kw)
    bad = _p_rounded(q, k, v, torch.float8_e4m3fn, **kw)
    assert float((bad - want).abs().max()) > 2 * plain


# float32 inputs: products in float32 on the FMA units, summed in
# another order than cuBLAS's, the running max's rescaling: 1e-5 of
# max|v|.
@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("g,window,causal", [(1, 0, True), (3, 32, True),
                                             (5, 0, False)])
def test_kernel_float32(hd, g, window, causal, cuda_device):
    q, k, v = _qkv(2, 150, 150, 2, g, hd, torch.float32, cuda_device)
    err, _ = _against_float32(q, k, v, causal=causal, window=window)
    assert err <= 1e-5 * float(v.abs().max())


@pytest.mark.cuda
def test_launches_and_repeatability(cuda_device):
    q, k, v = _qkv(3, 150, 150, 5, 3, 64, torch.bfloat16, cuda_device)
    before = K.fused_attention_kernel.launches
    a = K.fused_attention_kernel(q, k, v, causal=True)
    assert K.fused_attention_kernel.launches == before + 1
    b = K.fused_attention_kernel(q, k, v, causal=True)
    assert K.fused_attention_kernel.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert a.is_contiguous() and a.shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype,err", [
    (48, torch.bfloat16, ValueError), (96, torch.bfloat16, ValueError),
    (64, torch.float64, TypeError)])
def test_unsupported_inputs_raise(hd, dtype, err, cuda_device):
    q, k, v = _qkv(1, 16, 16, 1, 2, hd, dtype, cuda_device)
    before = K.fused_attention_kernel.launches
    with pytest.raises(err):
        K.fused_attention_kernel(q, k, v, causal=True)
    assert K.fused_attention_kernel.launches == before


@pytest.mark.cuda
def test_grad_takes_dense_on_the_card(cuda_device):
    """Under ``torch.enable_grad()`` with parameters that require grad
    the call is not launched; without grad it is, once a call; the
    kernel itself refuses a call that records a gradient."""
    for grad, launched in ((True, 0), (False, 1)):
        cfg, p, x, pos = _layer(cuda_device, grad=grad)
        before = K.fused_attention_kernel.launches
        with torch.enable_grad():
            A.attention_apply(p, x, cfg=cfg, positions=pos)
        assert K.fused_attention_kernel.launches == before + launched
    q, k, v = _qkv(1, 16, 16, 1, 2, 64, torch.bfloat16, cuda_device)
    with torch.enable_grad(), pytest.raises(RuntimeError):
        K.fused_attention_kernel(q.requires_grad_(), k, v, causal=True)
