"""Tensor parallelism over ``model`` (``distributed.collectives.TPShard``)
in one process, against the JAX package's unsplit sublayers.

Each rank's partial of a split sublayer is computed in turn with
``TPShard.simulated(rank, m)`` (its collectives are identities) from
the whole weights, and the partials are joined as the collectives would
join them: the outputs summed (``region_out``) or concatenated along
the query rows (``seq_gather``); the input's gradient summed over the
ranks (``region_in``'s backward); each weight's gradient summed (a rank
reads its chunk, or, under the query-sequence split, the whole weight
for its rows).  The joined output and gradients are held against the
reference's ``attention_apply`` / ``swiglu`` / ``gelu_mlp`` on the same
numpy inputs (``jax.grad`` of the same cotangent), fp32, within
``_torch_lm.bound(SPLIT_TOL)``:

  * attention, head split: smollm and qwen2.5 (QKV bias) at m = 2,
    Whisper's encoder (non-causal, no RoPE) at m = 4;
  * attention, query-sequence split (2 KV heads do not divide 4):
    smollm and qwen2.5 at m = 4, dense and chunked, hymba's sliding
    window over 64 rows (16 a rank, masks at the rank's offset);
  * the SwiGLU MLP (smollm) and the GELU MLP (Whisper, ``b_out`` added
    once) at m = 2 and 4.

The vocabulary-parallel cross-entropy and the whole ``loss_fn`` are run
in lockstep (``Lockstep``: every rank runs the function, and the i-th
collective of a pass returns what the ranks fed the i-th collective in
the pass before): the loss equals the reference's masked mean and the
port's unsplit ``loss_fn``, the per-rank logits' gradients concatenate
to the unsplit ones.  A split of one rank is the unsharded model bit
for bit, every architecture's forward and loss."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import ARCHS, FP32, bound, carried_params, configs, inputs
from _torch_lm import rel_err, stacked_params, tbatch, train_batch, tt
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.distributed.collectives import NO_TP, TPShard
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.testing import lockstep

SPLIT_TOL = 1e-5
B, S = 2, 16


def _weights(defs: dict, seed: int) -> dict:
    """numpy float32 weights of a sublayer's ``ParamDef``s: std
    1 / sqrt(fan-in) (biases std 0.1, so that each one shows)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(defs):
        shape = defs[k].shape
        std = 0.1 if len(shape) == 1 else 1 / np.sqrt(shape[0])
        out[k] = (rng.standard_normal(shape) * std).astype(np.float32)
    return out


def _join(fn, p: dict, x: np.ndarray, ct: np.ndarray, m: int, rows: bool):
    """(output, input gradient, weight gradients) of ``m`` ranks'
    partials of ``fn(p, x, tp)`` joined: outputs concatenated along
    dim 1 where ``rows`` (each rank's cotangent its rows), else summed
    (each rank's cotangent the whole); gradients summed."""
    outs, gx, gp = [], 0, {k: 0 for k in p}
    n = x.shape[1] // m
    for r in range(m):
        pt = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        out = fn(pt, xt, TPShard.simulated(r, m))
        c = torch.from_numpy(ct[:, r * n:(r + 1) * n] if rows else ct)
        grads = torch.autograd.grad(out, [xt] + [pt[k] for k in p], c)
        outs.append(out.detach())
        gx = gx + grads[0]
        for k, g in zip(p, grads[1:]):
            gp[k] = gp[k] + g
    out = torch.cat(outs, 1) if rows else sum(outs)
    return out, gx, gp


def _reference(jfn, p: dict, x: np.ndarray, ct: np.ndarray):
    """The reference's output and its (weight, input) gradients of
    sum(output * ct)."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def f(jp, jx):
        return jnp.sum(jfn(jp, jx) * jnp.asarray(ct))
    gp, gx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    return jfn(jp, jnp.asarray(x)), gx, gp


def _check(got, want) -> None:
    out, gx, gp = got
    wout, wgx, wgp = want
    tol = bound(SPLIT_TOL)
    assert tuple(out.shape) == tuple(wout.shape)
    assert rel_err(out, wout) < tol
    assert rel_err(gx, wgx) < tol
    for k in gp:
        assert rel_err(gp[k], wgp[k]) < tol, k


# (arch, m, the split attention_split must choose, config changes,
#  query rows)
ATTN_CASES = [
    ("smollm_360m", 2, "heads", {}, S),
    ("qwen2_5_14b", 2, "heads", {}, S),
    ("whisper_small", 4, "heads", {}, S),
    ("smollm_360m", 4, "seq", {}, S),
    ("qwen2_5_14b", 4, "seq", {}, S),
    ("smollm_360m", 4, "seq", {"attn_impl": "chunked"}, S),
    ("hymba_1_5b", 4, "seq", {}, 64),
]


@pytest.mark.parametrize("arch,m,split,changes,s", ATTN_CASES,
                         ids=[f"{a}-m{m}-{sp}{'-chunked' if c else ''}"
                              for a, m, sp, c, _ in ATTN_CASES])
def test_attention_partials_join_to_the_reference(arch, m, split, changes,
                                                  s):
    jc, tc = configs(arch, FP32, **changes)
    assert TA.attention_split(tc, m, s) == split
    encoder = jc.is_encdec
    causal, rope = not encoder, not encoder
    window = tc.sliding_window if tc.family == "hybrid" else 0
    p = _weights(TB.attn_defs(tc), seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, s, tc.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, s, tc.d_model)).astype(np.float32)
    pos = np.arange(s)

    def port(pt, xt, tp):
        return TA.attention_apply(pt, xt, cfg=tc, positions=torch.arange(s),
                                  causal=causal, window=window,
                                  use_rope=rope, tp=tp)[0]

    def ref(jp, jx):
        return JA.attention_apply(jp, jx, cfg=jc, positions=jnp.asarray(pos),
                                  causal=causal, window=window,
                                  use_rope=rope)[0]
    _check(_join(port, p, x, ct, m, rows=split == "seq"),
           _reference(ref, p, x, ct))


@pytest.mark.parametrize("m", [2, 4])
def test_swiglu_partials_join_to_the_reference(m):
    """smollm's SwiGLU MLP: each rank's d_ff / m columns of ``w_gate``
    / ``w_up`` and rows of ``w_down``."""
    jc, tc = configs("smollm_360m", FP32)
    assert tc.d_ff % m == 0
    p = _weights(TB.mlp_defs(tc), seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    names = ("w_gate", "w_up", "w_down")

    def port(pt, xt, tp):
        return TL.swiglu(xt, *(pt[k] for k in names), tp, tc.d_ff)

    def ref(jp, jx):
        return JL.swiglu(jx, *(jp[k] for k in names))
    _check(_join(port, p, x, ct, m, rows=False), _reference(ref, p, x, ct))


@pytest.mark.parametrize("m", [2, 4])
def test_gelu_mlp_adds_b_out_once(m):
    """Whisper's GELU MLP in lockstep over ``m`` ranks (``Lockstep``):
    every rank's output is the reference's, so ``b_out`` (std 0.1) is
    added once, after the partials are summed; the input's and the split
    weights' gradients summed over the ranks, and ``b_out``'s on every
    rank (it is whole on each), are the reference's."""
    jc, tc = configs("whisper_small", FP32)
    assert tc.d_ff % m == 0
    p = _weights(TB.mlp_defs(tc, gelu=True), seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    names = ("w_in", "b_in", "w_out", "b_out")
    wout, wgx, wgp = _reference(
        lambda jp, jx: JL.gelu_mlp(jx, *(jp[k] for k in names)), p, x, ct)
    pts = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
           for _ in range(m)]
    xts = [torch.from_numpy(x).requires_grad_(True) for _ in range(m)]
    outs = lockstep(lambda tp: TL.gelu_mlp(
        xts[tp.rank], *(pts[tp.rank][k] for k in names), tp, tc.d_ff), m)
    tol = bound(SPLIT_TOL)
    grads = [torch.autograd.grad(o, [xt] + [pt[k] for k in names],
                                 torch.from_numpy(ct))
             for o, xt, pt in zip(outs, xts, pts)]
    for o, g in zip(outs, grads):
        assert rel_err(o, wout) < tol
        assert rel_err(g[-1], wgp["b_out"]) < tol
    assert rel_err(sum(g[0] for g in grads), wgx) < tol
    for i, k in enumerate(names[:-1]):
        assert rel_err(sum(g[i + 1] for g in grads), wgp[k]) < tol, k


# ----------------------------------------------------------------------
# the vocabulary: lockstep runs of every rank
# ----------------------------------------------------------------------
def _reference_ce(logits: np.ndarray, labels: np.ndarray,
                  mask: np.ndarray) -> float:
    """The reference's ``loss_fn`` lines from the logits on."""
    logp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None],
                               axis=-1)[..., 0]
    return float((nll * mask).sum() / jnp.maximum(mask.sum(), 1.0))


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_parallel_cross_entropy(m):
    """Each rank's V / m logits columns: the masked mean of
    ``vocab_parallel_nll`` equals the reference's from the whole
    logits, and the ranks' logits gradients concatenate to the unsplit
    ``vocab_parallel_nll``'s."""
    rng = np.random.default_rng(5)
    v = 256
    logits = (rng.standard_normal((B, S, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, (B, S))
    mask = np.ones((B, S), np.float32)
    mask[1, S // 2:] = 0.0
    lab, msk = torch.from_numpy(labels), torch.from_numpy(mask)

    def loss(z, tp):
        nll = TM.vocab_parallel_nll(z, lab, tp)
        return (nll * msk).sum() / msk.sum().clamp(min=1.0)
    whole = torch.from_numpy(logits).requires_grad_(True)
    want = loss(whole, NO_TP)
    (want_g,) = torch.autograd.grad(want, whole)
    want = float(want.detach())
    n = v // m
    chunks = [torch.from_numpy(logits[..., r * n:(r + 1) * n])
              .requires_grad_(True) for r in range(m)]
    got = lockstep(lambda tp: loss(chunks[tp.rank], tp), m)
    grads = [torch.autograd.grad(g, c)[0] for g, c in zip(got, chunks)]
    tol = bound(SPLIT_TOL)
    ref = _reference_ce(logits, labels, mask)
    for g in got:
        assert abs(float(g.detach()) - ref) <= tol * abs(ref)
        assert abs(float(g.detach()) - want) <= tol * abs(want)
    assert rel_err(torch.cat(grads, -1), want_g) < tol


@pytest.mark.parametrize("arch,m", [("smollm_360m", 2), ("smollm_360m", 4),
                                    ("qwen2_5_14b", 4),
                                    ("whisper_small", 4)])
def test_split_loss_fn_equals_loss_fn(arch, m):
    """The whole ``loss_fn`` of the smoke model in lockstep over ``m``
    ranks (the embedding, every split sublayer, the head and the
    vocabulary-parallel loss) equals the unsplit ``loss_fn`` on every
    rank, and the reference's."""
    jc, tc = configs(arch, FP32)
    jp, tp_ = stacked_params(jc, tc, seed=0)
    batch = train_batch(jc, b=2, s=S, seed=1)
    want = float(TM.loss_fn(tp_, tbatch(batch), tc))
    from repro.models import model as JM
    ref = float(JM.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                           jc))
    with torch.no_grad():
        got = lockstep(lambda tp: TM.loss_fn(tp_, tbatch(batch), tc, tp=tp),
                       m)
    tol = bound(SPLIT_TOL)
    for g in got:
        assert abs(float(g) - want) <= tol * abs(want)
        assert abs(float(g) - ref) <= tol * abs(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_of_one_rank_is_the_unsharded_model(arch):
    """``TPShard.simulated(0, 1)``: the forward's logits and
    ``loss_fn`` bit for bit with the unsharded model's (whose parity
    with the JAX package the forward and loss tests hold)."""
    jc, tc = configs(arch, FP32)
    _, tparams = carried_params(jc, tc, seed=0)
    toks, enc = inputs(jc, b=2, s=S, seed=1)
    one = TPShard.simulated(0, 1)
    want = TM.forward(tparams, tt(toks), tc, enc_inputs=tt(enc))
    got, _ = TM._forward_impl(tparams, tt(toks), tc, tt(enc), tp=one)
    assert torch.equal(got, want)
    _, stacked = stacked_params(jc, tc, seed=0)
    batch = tbatch(train_batch(jc, b=2, s=S, seed=1))
    assert torch.equal(TM.loss_fn(stacked, batch, tc, tp=one),
                       TM.loss_fn(stacked, batch, tc))
