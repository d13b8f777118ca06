"""Helpers shared by the LM model-zoo tests: one architecture's config in
both packages, the reference's parameters carried into the port, the
same numpy inputs through both, and error measures."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.config import DTypePolicy as JDT
from repro_torch.configs import get_config as tget
from repro_torch.models import model as TM
from repro_torch.models.config import DTypePolicy as TDT

ARCHS = [
    "smollm_360m", "qwen2_5_14b", "starcoder2_3b", "internlm2_20b",
    "mamba2_780m", "whisper_small", "hymba_1_5b", "llama4_scout_17b_a16e",
    "llama4_maverick_400b_a17b", "llama_3_2_vision_11b",
]
FP32 = ("float32", "float32", "float32")


def configs(arch: str, policy=None, **changes):
    """The smoke config of ``arch`` in both packages, with ``policy``
    (params, compute, kv_cache dtype names) and field ``changes``."""
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    if policy is not None:
        jc = dataclasses.replace(jc, dtypes=JDT(*policy))
        tc = dataclasses.replace(tc, dtypes=TDT(*policy))
    return (dataclasses.replace(jc, **changes),
            dataclasses.replace(tc, **changes))


@functools.lru_cache(maxsize=None)
def _reference_params(defs: str, params_dtype: str, jc, seed: int):
    """``init_params(jc, PRNGKey(seed))``, drawn once for every config
    with the same parameter definitions (``defs``, their repr) and
    parameter dtype: JAX's eager draws compile once a shape, and take
    seconds a tree."""
    del defs, params_dtype      # the cache key
    return JM.init_params(jc, jax.random.PRNGKey(seed))


def carried_params(jc, tc, seed: int):
    """The reference's ``init_params(cfg, PRNGKey(seed))`` and the same
    parameters carried into the port (on the CPU)."""
    jp = _reference_params(repr(JM.param_defs(jc)), jc.dtypes.params, jc,
                           seed)
    tp = TM.model_from_arrays(tc, jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jp, tp


def inputs(cfg, b: int, s: int, seed: int):
    """Token ids [b, s] and, for enc-dec / VLM, encoder inputs, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    enc = None
    if cfg.is_encdec:
        enc = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
    elif cfg.family == "vlm":
        enc = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model))
    return toks, None if enc is None else enc.astype(np.float32)


def jx(a):
    return None if a is None else jnp.asarray(a)


def tt(a):
    """numpy -> torch on the CPU (token ids as int64)."""
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if t.dtype == torch.int32 else t


def npf(x) -> np.ndarray:
    """A JAX array or torch tensor as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    g, w = npf(got), npf(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w)) / (np.max(np.abs(w)) + 1e-9))


def enc_states(jp, tp, jc, tc, enc):
    """The decode state's encoder context in both packages: Whisper's
    encoder output, the VLM's vision embeddings, or None."""
    if jc.is_encdec:
        return (JM.encode(jp, jnp.asarray(enc), jc),
                TM.encode(tp, torch.from_numpy(enc), tc))
    if jc.family == "vlm":
        return jnp.asarray(enc), torch.from_numpy(enc)
    return None, None


def kv_leaves(state) -> list:
    """A DecodeState's KV and SSM tensors in a fixed order, as float64
    numpy."""
    out = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        else:
            out.append(npf(t))
    walk(state.kv)
    walk(state.ssm)
    return out


def one_ulp(tree, seed: int = 7):
    """The tree (or array) with every float32 entry moved one ulp up or
    down (a random direction each), as JAX arrays."""
    rng = np.random.default_rng(seed)

    def nudge(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return jnp.asarray(a)
        up = rng.random(a.shape) < 0.5
        return jnp.asarray(np.nextafter(a, np.where(up, np.inf, -np.inf)
                                        .astype(np.float32)))
    return jax.tree_util.tree_map(nudge, tree)


def ulp_spread(ref_fn, jp) -> float:
    """The reference's own relative change under a one-ulp change of its
    float32 parameters; ``ref_fn(params)`` is the reference computation
    (jitted, so the second call compiles nothing).  At the reference's
    init scale a smoke model amplifies float32 rounding (Whisper's
    forward moves 3.0e-4 under one ulp): two float32 implementations
    cannot be held closer than the reference holds to itself."""
    return rel_err(ref_fn(one_ulp(jp)), ref_fn(jp))


def jax_route(probs, k, capacity):
    """The reference's routing lines (``models/moe.py`` moe_apply) on
    [G, t, E] probabilities: (gates, zero where dropped, expert ids,
    places, kept), each [G, t, k]."""
    e = probs.shape[-1]
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(expert_idx, e, dtype=jnp.int32)
    g, t = probs.shape[:2]
    flat = onehot.reshape(g, t * k, e)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(g, t, k, e)
           * onehot).sum(-1)
    keep = pos < capacity
    return gate_vals * keep, expert_idx, pos, keep


SPREAD_CAP = 1e-3


def bound(tol: float, *spreads: float) -> float:
    """``tol``, or twice the largest of the reference's own ``spreads``
    where that is larger (Whisper's under float32), and never above
    ``SPREAD_CAP``: a reference that moves further than that under one
    ulp leaves no bound that a wrong port would fail, and fails here."""
    b = max([tol] + [2 * s for s in spreads])
    assert b <= SPREAD_CAP, f"the reference's own spread leaves bound {b:.3g}"
    return b


FORWARD_TOL = {"fp32": 1e-4, "default": 3e-2}


def forward_errors(arch: str, policy: str):
    """(error, bound) of the port's forward against the reference's on
    carried parameters (b=2, s=24), after checking its shape, dtype and
    finiteness: the error is relative to max |reference logits|, the
    bound ``FORWARD_TOL[policy]``, under fp32 ``bound``'s: Whisper's
    logits amplify float32 rounding 5000 times, and the reference's
    forward moves 3.0e-4 under one ulp of its parameters, so Whisper is
    held within 6.0e-4."""
    jc, tc = configs(arch, FP32 if policy == "fp32" else None)
    jp, tp = carried_params(jc, tc, seed=0)
    toks, enc = inputs(jc, b=2, s=24, seed=1)
    ref = jax.jit(lambda p: JM.forward(p, jnp.asarray(toks), jc,
                                       enc_inputs=jx(enc)))
    want = ref(jp)
    got = TM.forward(tp, tt(toks), tc, enc_inputs=tt(enc))
    assert got.shape == (2, 24, jc.vocab_size)
    assert got.dtype == tc.dtypes.compute_dtype
    assert np.isfinite(got.float().numpy()).all()
    tol = FORWARD_TOL[policy]
    if policy == "fp32":
        tol = bound(tol, ulp_spread(ref, jp))
    return rel_err(got, want), tol


def check_forward(arch: str, policy: str) -> None:
    err, tol = forward_errors(arch, policy)
    assert err < tol


def _one_rounding_forms() -> None:
    """Swap the port's XLA-following roundings (``models/layers``'
    activations op by op and constants in the compute dtype, ``blocks``'
    unrounded residual sum for the norms) for torch's one-rounding
    forms: F.silu, F.gelu, F.softplus and one residual add."""
    import torch.nn.functional as F
    from repro_torch.models import blocks, layers, moe, ssm
    for m in (layers, moe, ssm):
        m.silu = F.silu
    layers.gelu_tanh = lambda x: F.gelu(x, approximate="tanh")
    ssm.softplus = F.softplus
    layers._in_dtype = lambda c, dtype: c
    blocks._residual = lambda x, y: (x + y,) * 2
    blocks._norm32 = lambda s, w, cfg, dtype: layers.rms_norm(
        s, w, cfg.norm_eps).to(dtype)


if __name__ == "__main__":
    # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_torch_lm.py
    #   [--one-rounding]: every arch's forward error and bound, both
    # policies (the second with torch's one-rounding forms swapped in)
    import sys
    if "--one-rounding" in sys.argv:
        _one_rounding_forms()
    for a in ARCHS:
        print(a, *(f"{p} {e:.3e} (bound {t:.3g})" for p in ("fp32", "default")
                   for e, t in [forward_errors(a, p)]), flush=True)


# ----------------------------------------------------------------------
# training (slice 7)
# ----------------------------------------------------------------------
# per leaf, max |port grad - reference grad| / max |reference grad|,
# fp32 policy, b=2, s=16: the largest readings are Whisper's encoder
# (7.1e-4; its forward amplifies float32 rounding 5000 times) and
# Qwen's (3.3e-4); the reference's own gradients move up to 2.6e-4
# under a one-ulp change of its parameters (Whisper), and a second
# float32 implementation rounds in every op, not only in its inputs
GRAD_TOL = SPREAD_CAP
LOSS_RTOL = 1e-5


def train_batch(cfg, b: int, s: int, seed: int):
    """A numpy training batch: tokens, next-token labels, a mask that
    drops the second row's last quarter, and encoder inputs where the
    family takes them."""
    toks, enc = inputs(cfg, b, s + 1, seed)
    mask = np.ones((b, s), np.float32)
    if b > 1:
        mask[1, s - s // 4:] = 0.0
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    if enc is not None:
        out["enc_inputs"] = enc
    return out


def jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch: dict) -> dict:
    return {k: tt(v) for k, v in batch.items()}


def stacked_params(jc, tc, seed: int):
    """The reference's parameters and the port's stacked training copy
    of them (on the CPU)."""
    jp = _reference_params(repr(JM.param_defs(jc)), jc.dtypes.params, jc,
                           seed)
    tp, _ = TM.train_state_from_arrays(
        tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def check_loss_and_grads(arch: str) -> None:
    """``loss_fn`` and its gradients, fp32 policy, against
    ``jax.value_and_grad(M.loss_fn)`` on the same parameters and batch:
    the loss within LOSS_RTOL, every leaf's gradient within GRAD_TOL of
    its max |reference gradient|."""
    from repro_torch.launch.steps import _value_and_grad
    from repro_torch.utils.trees import tree_leaves
    jc, tc = configs(arch, FP32)
    jp, tp = stacked_params(jc, tc, seed=0)
    batch = train_batch(jc, b=2, s=16, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=2)(
        jp, jbatch(batch), jc)
    tl, tg = _value_and_grad(tp, tbatch(batch), tc)
    assert tl.dtype == torch.float32 and np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    got, want = tree_leaves(tg), jax.tree_util.tree_leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        assert rel_err(g, w) < GRAD_TOL
