"""Granite 4.0-H Micro on the port (``configs/granite_4_0_h_micro``,
``models.config.InterleavedConfig``, ``ssm.mamba2_apply``,
``blocks.apply_interleaved``): the port-only registry, the published
sizes, and at the smoke size in float32 the prefill, prefill then
decode, and the training loss and its gradients against the benchmark's
plain reference (``bench/reference/granite_4_0_h_micro.py``) on the
benchmark's seeded weights; the mixer's spans; the reference's SSD and
the port's against a step-by-step recurrence, and the port's scan bit
for bit against its former per-chunk loop; the attention's score scale;
the sharded entry points' refusal.

Tolerances: both sides compute in float32 (TF32 off), in other orders:
the SSD in chunks of 8 (the port) or 4 (the reference) against a
step-by-step sum, the attention in one pass or by query block, the
norms' sums.  Differences of order 1e-7 relative accumulate over the
three layers; 1e-4 relative (1e-5 absolute for entries near 0) is ten
times what they reach and still thousands of times below what a missing
term (the conv bias, D, the gate, a multiplier: 1e-2 and more) gives.

The card's test carries the ``cuda`` marker and skips without a GPU;
the file imports no JAX."""
import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.kernels.attention.ref import _sqrt_in, dense_attention
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.models.config import DTypePolicy, InterleavedConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench.lib import lm, spec  # noqa: E402
from bench.reference import common as C  # noqa: E402

ARCH = "granite-4.0-h-micro"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """(port cfg in float32, bench config module, smoke sizes, weights,
    reference Model class)."""
    C.no_tf32()
    cfgm = spec.config_module(ARCH)
    s = cfgm.sizes(True)
    cfg = dataclasses.replace(cfgm.port_config(True), dtypes=DTypePolicy(
        compute="float32", kv_cache="float32"))
    w = lm.make_weights(cfgm.leaves(s), SEED, CPU)
    return cfg, cfgm, s, w, spec.reference_module(ARCH).Model


def _serving(cfgm, w):
    """The port's serving tree: ``layers`` a list, the mixers stacked
    (as the benchmark's driver leaves them)."""
    params = lm.to_tree(cfgm.PORT_PATHS, w)
    layers = params.pop("layers")
    n = layers["norm1"].shape[0]
    params["layers"] = [{k: ({kk: vv[i] for kk, vv in v.items()}
                             if isinstance(v, dict) else v[i])
                         for k, v in layers.items()} for i in range(n)]
    return params


def _tokens(rows, seq, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (rows, seq)))


# ----------------------------------------------------------------------
# the registry and the published sizes
# ----------------------------------------------------------------------
def test_the_port_only_registry():
    assert "granite_4_0_h_micro" not in configs.list_archs()
    assert ARCH not in configs.ALIASES
    for name in (ARCH, "granite_4_0_h_micro"):
        assert get_config(name).name == ARCH
        assert get_config(name, smoke=True).n_layers == 3
    assert configs.PORT_ARCHS == ["granite_4_0_h_micro"]
    assert isinstance(get_config(ARCH), InterleavedConfig)


def test_the_published_sizes():
    cfg = get_config(ARCH)
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.count("mamba"), cfg.d_inner, cfg.ssm_heads,
            cfg.conv_width) == (36, 4096, 64, 4352)
    defs = dict(M.tree_paths(M.param_defs(cfg)))
    count = sum(math.prod(d.shape) for d in defs.values())
    assert count == cfg.param_count_estimate() == 3_191_396_096
    assert defs[("mamba", "in_proj")].shape == (36, 2048, 4096 + 4352 + 64)
    assert defs[("attn", "wk")].shape == (4, 2048, 512)
    assert not cfg.supports_long_context


@pytest.mark.parametrize("change,match", [
    (dict(layer_types=("mamba",) * 39), "layer_types"),
    (dict(layer_types=("mamba",) * 39 + ("mlp",)), "layer_types"),
    (dict(ssm_groups=2), "group"), (dict(family="hybrid"), "family")])
def test_the_config_refuses(change, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(get_config(ARCH), **change)


def test_the_sharded_steps_and_the_dryrun_refuse():
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as ST
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(NotImplementedError, match="no sharded step"):
        ST.make_prefill_step(cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="no sharded step"):
        ST.make_sharded_grads(cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="no sharded step"):
        dryrun.run_cell(ARCH, "train_4k", False)


def test_the_bench_paths_cover_the_port_tree(setup):
    cfg, cfgm, s, w, _ = setup
    defs = dict(M.tree_paths(M.param_defs(cfg)))
    paths = {tuple(p): name for name, p in cfgm.PORT_PATHS.items()}
    assert set(paths) == set(defs)
    for path, d in defs.items():
        assert tuple(w[paths[path]].shape) == d.shape, path


# ----------------------------------------------------------------------
# the model against the reference (float32)
# ----------------------------------------------------------------------
def test_prefill_logits_and_state(setup):
    cfg, cfgm, s, w, Ref = setup
    tok = _tokens(3, 21)
    state = M.init_decode_state(cfg, 3, 21, device=CPU)
    logits, state = M.prefill(_serving(cfgm, w), tok, cfg, state)
    ref_logits, ref_state = Ref(s, w, block=4).prefill(tok, want_state=True)
    torch.testing.assert_close(logits, ref_logits, **TOL)
    for r in range(3):
        got = cfgm.port_state(state, r)
        assert set(got) == set(ref_state) == {"k", "v", "ssm", "conv"}
        for k, x in got.items():
            torch.testing.assert_close(x, ref_state[k][:, r], **TOL)


@pytest.mark.parametrize("prompt", [2, 13])
def test_prefill_then_decode(setup, prompt):
    """A prompt shorter than the conv (2 tokens) and one over a chunk,
    then 8 tokens through the caches: every step's logits against the
    reference's full forward at that position."""
    cfg, cfgm, s, w, Ref = setup
    tok = _tokens(2, prompt + 8, seed=prompt)
    params = _serving(cfgm, w)
    full = Ref(s, w, block=4).forward(tok)
    state = M.init_decode_state(cfg, 2, prompt + 8, device=CPU)
    logits, state = M.prefill(params, tok[:, :prompt], cfg, state)
    torch.testing.assert_close(logits, full[:, prompt - 1], **TOL)
    for t in range(prompt, prompt + 8):
        logits, state = M.decode_step(params, tok[:, t:t + 1], cfg, state)
        torch.testing.assert_close(logits, full[:, t], **TOL)
    assert state.length == prompt + 8


def test_loss_and_gradients(setup):
    cfg, cfgm, s, w, Ref = setup
    tok = _tokens(2, 20 + 1, seed=9)
    x, y = tok[:, :-1], tok[:, 1:]
    port = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss_p = M.loss_fn(lm.to_tree(cfgm.PORT_PATHS, port),
                       {"tokens": x, "labels": y}, cfg)
    loss_p.backward()
    ref = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss_r, grads = C.loss_and_grads(Ref(s, ref, block=4), ref, x, y,
                                     block=1)
    assert float(loss_p.detach()) == pytest.approx(loss_r, rel=1e-5)
    for k in w:
        torch.testing.assert_close(port[k].grad, grads[k], rtol=2e-4,
                                   atol=2e-6 * float(grads[k].abs().max()))


@pytest.mark.parametrize("leaf", ["mamba.conv_b", "mamba.d_skip",
                                  "mamba.norm", "attn.wv"])
def test_the_comparison_sees_each_part(setup, leaf):
    """The reference with one of the mixer's parts changed (the conv's
    bias, D, the gate's norm weight, the attention's values) differs from
    the port by far more than the tolerance."""
    cfg, cfgm, s, w, Ref = setup
    tok = _tokens(2, 17)
    state = M.init_decode_state(cfg, 2, 17, device=CPU)
    logits, _ = M.prefill(_serving(cfgm, w), tok, cfg, state)
    bent = dict(w)
    bent[leaf] = w[leaf] * 1.5 + 0.01
    ref_logits, _ = Ref(s, bent, block=4).prefill(tok)
    err = float((logits - ref_logits).norm() / ref_logits.norm())
    assert err > 1e-3


def test_the_mixer_opens_its_spans(setup, tmp_path):
    """Under a profiler a prefill opens ``layer.ssm`` once a Mamba2
    layer with one ``ssm.scan`` inside it, and ``layer.attention`` once
    an attention layer; with none running, the results are the same
    bits."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.utils.tracing import SSM_SPANS
    cfg, cfgm, s, w, _ = setup
    tok = _tokens(2, 11)
    plain, _ = M.prefill(_serving(cfgm, w), tok, cfg,
                         M.init_decode_state(cfg, 2, 11, device=CPU))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced, _ = M.prefill(_serving(cfgm, w), tok, cfg,
                              M.init_decode_state(cfg, 2, 11, device=CPU))
    assert torch.equal(plain, traced)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    ev = [e for e in json.load(open(tmp_path / "t.json"))["traceEvents"]
          if e.get("cat") == "user_annotation"]
    got = {n: [(e["ts"], e["ts"] + e["dur"]) for e in ev if e["name"] == n]
           for n in (*SSM_SPANS, "layer.attention")}
    assert SSM_SPANS == ("layer.ssm", "ssm.scan")
    assert len(got["layer.ssm"]) == len(got["ssm.scan"]) == 2
    assert len(got["layer.attention"]) == 1
    for a, b in got["ssm.scan"]:
        assert any(a0 <= a and b <= b0 for a0, b0 in got["layer.ssm"])


# ----------------------------------------------------------------------
# the SSD scans
# ----------------------------------------------------------------------
def _recurrence(x, dt, a, b, c, h0):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t b_t^T, y_t = h_t c_t, one
    step at a time in float64."""
    h = h0.double()
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t].double() * a.double())          # [B, H]
        h = da[:, :, None, None] * h + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t].double(), x[:, t].double(),
            b[:, t].double())
        ys.append(torch.einsum("bhpn,bhn->bhp", h, c[:, t].double()))
    return torch.stack(ys, 1), h


def _ssd_inputs(seed, bsz=2, t=23, h=3, p=4, n=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(bsz, t, h, p, generator=g)
    dt = torch.rand(bsz, t, h, generator=g) * 0.5 + 0.01
    a = -torch.rand(h, generator=g) * 3 - 0.1
    b = torch.randn(bsz, t, h, n, generator=g)
    c = torch.randn(bsz, t, h, n, generator=g)
    h0 = torch.randn(bsz, h, p, n, generator=g)
    return x, dt, a, b, c, h0


@pytest.mark.parametrize("block", [1, 4, 8, 24])
@pytest.mark.parametrize("with_state", [False, True])
def test_the_reference_ssd_is_the_recurrence(block, with_state):
    ssd = spec.reference_module(ARCH).ssd
    x, dt, a, b, c, h0 = _ssd_inputs(block)
    h0 = h0 if with_state else torch.zeros_like(h0)
    want_y, want_h = _recurrence(x, dt, a, b, c, h0)
    pad = (-x.shape[1]) % block

    def padded(u):
        return torch.nn.functional.pad(u, (0, 0) * (u.dim() - 2) + (0, pad))

    y, h = ssd(padded(x * dt[..., None]), padded(a * dt), padded(b),
               padded(c), block,
               initial_state=h0 if with_state else None)
    # float32 against float64: sums of a few dozen terms of order 1
    torch.testing.assert_close(y[:, :x.shape[1]].double(), want_y,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h.double(), want_h, rtol=1e-4, atol=1e-4)


def test_the_port_scan_is_the_recurrence():
    """``ssd_chunked`` (one B / C group, what the published mixer
    passes it) against the same recurrence, over chunks and a
    carried state."""
    x, dt, a, b, c, h0 = _ssd_inputs(7)
    b1, c1 = b[:, :, 0], c[:, :, 0]
    bh = b1[:, :, None].expand_as(b)
    ch = c1[:, :, None].expand_as(c)
    want_y, want_h = _recurrence(x, dt, a, bh, ch, h0)
    y, h = SSM.ssd_chunked(x, dt, torch.log(-a), b1, c1, 8, init_state=h0)
    torch.testing.assert_close(y.double(), want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h.double(), want_h, rtol=1e-4, atol=1e-4)


def _ssd_per_chunk(xin, dt, a_log, b, c, chunk, init_state=None):
    """``ssd_chunked`` as it was before it computed the state-free terms
    for every chunk at once: each chunk's terms inside the loop."""
    F = torch.nn.functional
    bsz, s, h, hd = xin.shape
    n = b.shape[-1]
    nc = (s + chunk - 1) // chunk
    pad = nc * chunk - s
    if pad:
        xin = F.pad(xin, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    a = -torch.exp(a_log.float())
    dt32 = dt.float()
    da = dt32 * a[None, None, :]
    xin_c = xin.reshape(bsz, nc, chunk, h, hd)
    dt_c = dt32.reshape(bsz, nc, chunk, h)
    da_c = da.reshape(bsz, nc, chunk, h)
    b_c = b.reshape(bsz, nc, chunk, n).float()
    c_c = c.reshape(bsz, nc, chunk, n).float()
    cum = torch.cumsum(da_c, dim=2)
    seg_total = cum[:, :, -1, :]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    state = (init_state if init_state is not None
             else torch.zeros((bsz, h, hd, n), dtype=torch.float32))
    ys = []
    for i in range(nc):
        xin_i, dt_i, cum_i = xin_c[:, i], dt_c[:, i], cum[:, i]
        tot_i, b_i, c_i = seg_total[:, i], b_c[:, i], c_c[:, i]
        rel = cum_i[:, :, None, :] - cum_i[:, None, :, :]
        rel = torch.where(causal[None, :, :, None], rel, -1e30)
        gamma = torch.exp(rel)
        cb = torch.einsum("bln,btn->blt", c_i, b_i)
        w = cb[:, :, :, None] * gamma
        xdt = xin_i.float() * dt_i[..., None]
        y_intra = torch.einsum("blth,bthd->blhd", w, xdt)
        decay_in = torch.exp(cum_i)
        y_inter = torch.einsum("bln,bhdn,blh->blhd", c_i, state, decay_in)
        decay_out = torch.exp(tot_i[:, None, :] - cum_i)
        ds = torch.einsum("blh,blhd,bln->bhdn", decay_out, xdt, b_i)
        state = torch.exp(tot_i)[:, :, None, None] * state + ds
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * chunk, h, hd)[:, :s]
    return y.to(xin.dtype), state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,with_state", [(7, False), (45, True),
                                          (64, False), (300, True)])
def test_the_scan_is_bit_for_bit_its_per_chunk_loop(s, with_state, dtype):
    """The same arithmetic in the same order, the state-free terms
    batched over the chunks: the same bits (mamba2-780m's and hymba's
    scan is this one)."""
    g = torch.Generator().manual_seed(s)
    x = torch.randn(2, s, 4, 16, generator=g).to(dtype)
    dt = (torch.rand(2, s, 4, generator=g) * 0.3).to(dtype)
    a_log = torch.randn(4, generator=g)
    b = torch.randn(2, s, 16, generator=g).to(dtype)
    c = torch.randn(2, s, 16, generator=g).to(dtype)
    h0 = torch.randn(2, 4, 16, 16, generator=g) if with_state else None
    y, h = SSM.ssd_chunked(x, dt, a_log, b, c, 32, init_state=h0)
    y0, h0_ = _ssd_per_chunk(x, dt, a_log, b, c, 32, init_state=h0)
    assert torch.equal(y, y0) and torch.equal(h, h0_)


# ----------------------------------------------------------------------
# the attention's score scale
# ----------------------------------------------------------------------
def _qkv(seed, s=19, h=4, kh=2, hd=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, s, h, hd, generator=g).to(dtype)
    k = torch.randn(2, s, kh, hd, generator=g).to(dtype)
    v = torch.randn(2, s, kh, hd, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_scale_is_bit_for_bit_the_sqrt(dtype):
    q, k, v = _qkv(1, dtype=dtype)
    qg = q.reshape(2, 19, 2, 2, 16)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / _sqrt_in(16, dtype)
    mask = torch.ones(19, 19, dtype=torch.bool).tril()
    scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores.float(), dim=-1).to(dtype)
    want = torch.einsum("bkgst,btkd->bskgd", p, v).reshape(2, 19, 4, 16)
    assert torch.equal(dense_attention(q, k, v, causal=True), want)
    assert torch.equal(dense_attention(q, k, v, causal=True, scale=None),
                       want)


def test_a_scale_on_every_path():
    """Dense, chunked and the cached decode at a scale of 1/64 give
    softmax(q k^T / 64) v (float32)."""
    q, k, v = _qkv(2)
    kk = k.repeat_interleave(2, dim=2)
    vv = v.repeat_interleave(2, dim=2)
    sc = torch.einsum("bshd,bthd->bhst", q, kk) / 64.0
    sc = sc.masked_fill(~torch.ones(19, 19, dtype=torch.bool).tril(),
                        float("-inf"))
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), vv)
    for fn in (dense_attention, A.chunked_attention):
        got = fn(q, k, v, causal=True, scale=1 / 64)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    cache = A.init_kv_cache(2, 19, 2, 16, torch.float32, CPU)
    cache = A.cache_update(cache, k, v)
    got = A._decode_attention(q[:, -1:], cache, window=0, scale=1 / 64)
    torch.testing.assert_close(got, want[:, -1:], rtol=1e-5, atol=1e-6)
    assert not torch.allclose(dense_attention(q, k, v, causal=True), want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 65, 1200, 2048])
def test_kernel_at_granites_scale(s, cuda_device):
    """The fused kernel at head size 64, G = 4, divisor 64 (Granite's
    ``attention_multiplier`` 1/64) against ``dense_attention`` at that
    scale in float32: no more than twice as far from it as the plain
    bfloat16 path on the same inputs (the rule of the kernel's own
    tests)."""
    from repro_torch.kernels.attention import kernel as K
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    q = torch.randn(2, s, 8, 64, generator=gen, device=cuda_device)
    k = torch.randn(2, s, 2, 64, generator=gen, device=cuda_device)
    v = torch.randn(2, s, 2, 64, generator=gen, device=cuda_device)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    kw = dict(causal=True, scale=1 / 64)
    got = K.fused_attention_kernel(q, k, v, **kw).float()
    want = dense_attention(q.float(), k.float(), v.float(), **kw)
    plain = dense_attention(q, k, v, **kw).float()
    err = float((got - want).abs().max())
    own = float((plain - want).abs().max())
    print(f"S={s}: kernel {err:.3g}, dense bf16 {own:.3g}")
    assert err <= 2 * own
    if s > 1:   # the scale reaches the kernel: at 1/sqrt(64) it differs
        other = K.fused_attention_kernel(q, k, v, causal=True).float()
        assert float((other - want).abs().max()) > 2 * own
