"""Top-level model assembly: init, forward, training loss, prefill,
decode.

The parameter definitions are the reference's tree, layers stacked
along a leading "layers" axis (``param_defs``).  The training state
keeps that stacked tree (``init_stacked_params``,
``train_state_from_arrays``; ``loss_fn`` takes it apart inside each
call).  The serving entry points take the tree with the stacked axes
taken apart into lists of per-layer dicts, which the forward runs in a
Python loop:

  * ``params["layers"]``: one dict a layer;
  * ``params["groups"]`` (VLM ``cross_attn_every``, MoE ``moe_every >
    1``): one dict a group, ``{"plain": [dict, ...], "cross" | "moe":
    dict}``;
  * ``params["encoder"]`` (Whisper): one dict an encoder layer;
  * the interleaved stack (``config.InterleavedConfig``, Granite 4.0-H):
    ``params["layers"]`` holds what every layer has (its norms and
    MLP), and each kind's mixers are stacked apart, ``params["attn"]``
    over the attention layers and ``params["mamba"]`` over the Mamba2
    layers, in layer order; either a list of per-layer dicts or the
    stacked tree (taken apart a call).  Its decode state holds KV for
    the attention layers and the SSM state and conv tail for the Mamba2
    layers.  It has no sharded step.

Weights keep the reference's ``[in, out]`` layout (``x @ w``).  Every
call casts the parameters to the compute dtype first (``tree_cast``),
as the reference's ``_cast_tree`` does.  The decode state keeps the
reference's stacked layout ([L, B, S, KH, hd] caches, [G, per, ...] in
the grouped models); ``prefill`` and ``decode_step`` write its caches
in place.  The reference's ``shard_constraint`` calls sit at its
sites; on plain tensors they return their argument.

The sharded train step (``launch/steps.py``) passes ``gather``: the
parameters are then this rank's shards, and ``gather(section, tree)``
returns a tree's leaves as the forward reads them.  The top-level
leaves are gathered once a call, each layer's (group's) inside its
body, so that a rematerialized body gathers again.  It passes ``tp``
(``collectives.TPShard``), the tensor-parallel split over ``model``:
the self- and cross-attention, the SSM and the MLP sublayers compute
this rank's heads, query rows or ``d_ff`` columns, the embedding, the
head and the loss its vocabulary rows (``_embed``, ``_logits``,
``vocab_parallel_nll``);
``tp_reads`` says which part of each leaf that is, and those leaves
stay split over ``model``.  The unsharded model is the split of one
rank (``NO_TP``).  For the MoE family it also passes ``moe_shard``
(``moe.MoEShard``): the expert leaves then stay split over ``model``
and the MoE block computes this rank's rows of the global micro-batch
on its experts.  The sharded serving steps pass the same three to
``_forward_cached``, with the state split as its trees place it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.distributed.collectives import NO_TP, TPShard
from repro_torch.distributed.sharding import shard_constraint
from repro_torch.kernels.common import resolve_device
from repro_torch.models import blocks
from repro_torch.models.attention import KVCache, cache_pos_update
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ParamDef,
    logical_axes_tree,
    materialize,
    rms_norm,
    tree_paths,
)
from repro_torch.models.ssm import SSMState, ssm_split
from repro_torch.optimizer import OptState, Q8State
from repro_torch.utils.tracing import span
from repro_torch.utils.trees import tree_cast


# ----------------------------------------------------------------------
# parameter trees
# ----------------------------------------------------------------------
def _stack_defs(defs, n: int):
    if isinstance(defs, ParamDef):
        return ParamDef((n,) + defs.shape, ("layers",) + defs.logical_axes,
                        defs.init, defs.scale)
    return {k: _stack_defs(v, n) for k, v in defs.items()}


def _layer_kind(cfg: ModelConfig) -> str:
    return {"dense": "dense", "moe": "moe", "ssm": "ssm",
            "hybrid": "hybrid", "audio": "dec_cross", "vlm": "dense",
            "interleaved": "interleaved"}[cfg.family]


def _interleaved(cfg: ModelConfig) -> bool:
    return cfg.family == "interleaved"


# an interleaved stack's layer kind -> the key of its mixers' stack
MIXERS = {"attention": "attn", "mamba": "mamba"}


def _vlm_groups(cfg: ModelConfig) -> bool:
    return cfg.family == "vlm" and cfg.cross_attn_every > 0


def _moe_groups(cfg: ModelConfig) -> bool:
    return cfg.family == "moe" and cfg.moe_every > 1


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter tree of ParamDefs (stacked layers)."""
    d, v = cfg.d_model, cfg.vocab_size
    out: Dict[str, Any] = {
        "tok_emb": ParamDef((v, d), ("vocab", "fsdp")),
        "final_norm": ParamDef((d,), ("d_model",), init="ones"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((d, v), ("fsdp", "vocab"))

    kind = _layer_kind(cfg)
    if _vlm_groups(cfg):
        n_groups = cfg.n_layers // cfg.cross_attn_every
        plain_per = cfg.cross_attn_every - 1
        out["groups"] = {
            "plain": _stack_defs(_stack_defs(blocks.block_defs(cfg, "dense"),
                                             plain_per), n_groups),
            "cross": _stack_defs(blocks.block_defs(cfg, "cross"), n_groups),
        }
    elif _moe_groups(cfg):
        # interleaved dense/MoE (maverick): groups of (moe_every-1 dense
        # + 1 moe), dense first
        n_groups = cfg.n_layers // cfg.moe_every
        dense_per = cfg.moe_every - 1
        out["groups"] = {
            "plain": _stack_defs(_stack_defs(blocks.block_defs(cfg, "dense"),
                                             dense_per), n_groups),
            "moe": _stack_defs(blocks.block_defs(cfg, "moe"), n_groups),
        }
    else:
        out["layers"] = _stack_defs(blocks.block_defs(cfg, kind), cfg.n_layers)
    if _interleaved(cfg):
        out["attn"] = _stack_defs(blocks.attn_defs(cfg),
                                  cfg.count("attention"))
        out["mamba"] = _stack_defs(blocks.mamba2_defs(cfg),
                                   cfg.count("mamba"))

    if cfg.is_encdec:
        out["encoder"] = _stack_defs(blocks.block_defs(cfg, "encoder"),
                                     cfg.encoder_layers)
        out["enc_final_norm"] = ParamDef((d,), ("d_model",), init="ones")
        out["dec_pos_emb"] = ParamDef((cfg.max_seq_len, d), (None, "fsdp"),
                                      scale=0.02)
    return out


def logical_axes(cfg: ModelConfig):
    return logical_axes_tree(param_defs(cfg))


def _unstack(tree) -> list:
    """A tree whose leaves share a leading axis -> one tree per index
    (views, no copy).  ``torch.unbind`` takes each leaf apart in one
    op, whose backward stacks the per-layer gradients into the stacked
    leaf's gradient once (a view a layer would add a zero-filled
    stacked-size gradient per layer)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _unstack_params(tree: dict) -> dict:
    """The reference's stacked tree -> the port's per-layer lists."""
    out = dict(tree)
    for name in ("layers", "encoder", *MIXERS.values()):
        if name in out:
            out[name] = _unstack(out[name])
    if "groups" in out:
        groups = _unstack(out["groups"])
        for gp in groups:
            gp["plain"] = _unstack(gp["plain"])
        out["groups"] = groups
    return out


def init_stacked_params(cfg: ModelConfig,
                        generator: Optional[torch.Generator] = None,
                        device: "torch.device | str | None" = None) -> dict:
    """Parameters drawn from ``generator`` (seed 0 on the device when
    None) with the reference's initializers, on ``device`` (CUDA unless
    named), in the reference's stacked layout (``param_defs``): the
    training state's layout (``loss_fn``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return materialize(param_defs(cfg), generator, cfg.dtypes.params_dtype,
                       dev)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: "torch.device | str | None" = None) -> dict:
    """``init_stacked_params`` in the port's per-layer layout (the
    serving entry points')."""
    return _unstack_params(init_stacked_params(cfg, generator, device))


def _as_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' numpy bfloat16
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.tensor(a, device=dev)      # a copy: JAX's buffers are read-only


def _stacked_from_arrays(cfg: ModelConfig, tree: dict,
                         dev: torch.device) -> dict:
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _as_tensor(t, dev)

    expect = {"/".join(p) for p, _ in tree_paths(param_defs(cfg))}
    got = {"/".join(p) for p, _ in tree_paths(tree)}
    if expect != got:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {sorted(expect - got)}, "
                         f"extra {sorted(got - expect)}")
    return conv(tree)


def model_from_arrays(cfg: ModelConfig, tree: dict,
                      device: "torch.device | str | None" = None) -> dict:
    """The port's parameters on ``device`` (CUDA unless named) from the
    JAX package's parameter tree as nested dicts of numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``): the stacked
    ``layers`` / ``groups`` / ``encoder`` axes are taken apart, the
    ``[in, out]`` weight layout is kept."""
    return _unstack_params(_stacked_from_arrays(cfg, tree,
                                                resolve_device(device)))


def train_state_from_arrays(cfg: ModelConfig, params: dict,
                            opt_state=None,
                            device: "torch.device | str | None" = None):
    """The training state ``(params, opt_state)`` on ``device`` (CUDA
    unless named) from the JAX package's, as numpy
    (``jax.tree_util.tree_map(np.asarray, (params, opt_state))``), in
    the reference's stacked layout, which the weight-decay rule and the
    q8 blocks read: ``params`` as ``param_defs``; ``opt_state`` an
    ``OptState(step, m, v)`` whose moment leaves are arrays or
    ``Q8State(codes, scales, size)`` (or None: the second item is then
    None)."""
    dev = resolve_device(device)
    stacked = _stacked_from_arrays(cfg, params, dev)
    if opt_state is None:
        return stacked, None

    def moments(tree):
        if isinstance(tree, dict):
            return {k: moments(v) for k, v in tree.items()}
        if hasattr(tree, "codes"):
            return Q8State(_as_tensor(tree.codes, dev),
                           _as_tensor(tree.scales, dev), int(tree.size))
        return _as_tensor(tree, dev)

    step = torch.tensor(np.asarray(opt_state.step, np.int32), device=dev)
    return stacked, OptState(step, moments(opt_state.m),
                             moments(opt_state.v))


# ----------------------------------------------------------------------
# forward (no cache)
# ----------------------------------------------------------------------
def _save_weight_matmuls():
    """The "selective" policy: save the weight matmuls' outputs
    (``x @ w``, one ``aten.mm`` on the folded rows; the counterpart of
    ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    return create_selective_checkpoint_contexts([torch.ops.aten.mm.default])


def _maybe_remat(fn: Callable, remat: str) -> Callable:
    """``fn`` under the activation-checkpoint policy ``remat``, as the
    reference's ``_maybe_remat`` applies ``cfg.remat`` to a layer (or
    group) body: "none" saves everything, "full" nothing, "selective"
    the weight matmuls' outputs.  The body runs in a ``model.layer``
    span inside the checkpoint, so that its recomputation in the
    backward opens the span again."""
    def layer(*args):
        with span("model.layer"):
            return fn(*args)
    if remat == "none" or not torch.is_grad_enabled():
        return layer
    extra = {} if remat == "full" else {"context_fn": _save_weight_matmuls}

    def run(*args):
        return checkpoint(layer, *args, use_reentrant=False, **extra)
    return run


def _run_encoder(params, frames: torch.Tensor, cfg: ModelConfig,
                 remat: str = "none", gather=None,
                 tp: TPShard = NO_TP) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings [B, T, d]."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device)

    def body(lp, h):
        if gather is not None:
            lp = gather("encoder", lp)
        return blocks.apply_block(lp, h, cfg, "encoder", positions=positions,
                                  causal=False, tp=tp)[0]

    body = _maybe_remat(body, remat)
    for lp in params["encoder"]:
        x = body(lp, x)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _interleaved_layers(cparams, cfg: ModelConfig):
    """(kind, index in its kind's stack, the layer's dict with its mixer
    under ``attn`` or ``mamba``) of each layer of an interleaved stack,
    in order."""
    mixers = {k: cparams[k] if isinstance(cparams[k], list)
              else _unstack(cparams[k]) for k in MIXERS.values()}
    seen = dict.fromkeys(MIXERS, 0)
    for lp, kind in zip(cparams["layers"], cfg.layer_types):
        j = seen[kind]
        seen[kind] += 1
        yield kind, j, {**lp, MIXERS[kind]: mixers[MIXERS[kind]][j]}


def _embed_scaled(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """An interleaved stack's embeddings times its multiplier (in
    float32, rounded once); others' as they are."""
    if not _interleaved(cfg):
        return x
    return (x.float() * cfg.embedding_multiplier).to(x.dtype)


def _logits_scaled(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """An interleaved stack's logits over its ``logits_scaling``."""
    return logits / cfg.logits_scaling if _interleaved(cfg) else logits


def _head(cparams, cfg: ModelConfig) -> torch.Tensor:
    return cparams["tok_emb"].T if cfg.tie_embeddings else cparams["lm_head"]


def _embed(tok_emb: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
           tp: TPShard) -> torch.Tensor:
    """The token embeddings.  Where ``tp`` splits the vocabulary, the
    rank looks up the ids of its row range (zero for the others) and
    the partials are summed over the split."""
    v = cfg.vocab_size
    if not tp.splits(v):
        return tok_emb[tokens]
    n = v // tp.size
    local = tokens - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = tp.part(tok_emb, 0, v)[local.clamp(0, n - 1)]
    return tp.region_out(torch.where(mine[..., None], rows,
                                     rows.new_zeros(())))


def _logits(x: torch.Tensor, cparams, cfg: ModelConfig,
            tp: TPShard) -> torch.Tensor:
    """``x @ head``: this rank's vocabulary columns where ``tp`` splits
    the vocabulary (``x`` entering through ``region_in``)."""
    head = _head(cparams, cfg)
    if not tp.splits(cfg.vocab_size):
        return x @ head
    return tp.region_in(x) @ tp.part(head, 1, cfg.vocab_size)


def tp_reads(cfg: ModelConfig, size: int, seq: int, enc_seq: int = 0,
             serve: bool = False):
    """How a tensor-parallel split of ``size`` ranks reads each
    parameter, as a tree of ``param_defs``' shape: the dim (of the
    per-layer leaf, the stacked dims dropped) whose rank chunk the
    compute reads, "partial" where it reads the leaf whole and its
    gradient is a partial over the split (a query-row split attention,
    over ``seq`` rows, or ``enc_seq`` in the encoder; ``in_proj`` under
    the SSM's split, whose columns a rank reads are not contiguous), or
    "whole".  The forward's choices: ``_embed`` / ``_logits`` over
    ``vocab``, the MLPs over ``d_ff`` (``layers.swiglu``), the self- and
    cross-attention by ``attention.attention_split`` (the cross over
    the decoder's ``seq`` rows), the SSM by ``ssm.ssm_split``.  With
    ``serve`` (the sharded prefill and decode) the self-attention reads
    its weights whole: a cached attention splits the cache's slots and
    the query rows, never the heads."""
    from repro_torch.models.attention import attention_split
    from repro_torch.models.ssm import ssm_split
    tp = TPShard.simulated(0, size)
    ssm = ssm_split(cfg, size)

    def read(path, d: ParamDef):
        names = d.logical_axes
        while names and names[0] == "layers":
            names = names[1:]
        parent = path[-2] if len(path) > 1 else None
        axis = None
        if path[0] in ("tok_emb", "lm_head"):
            axis = "vocab" if tp.splits(cfg.vocab_size) else None
        elif parent == "mlp":
            axis = "d_ff" if tp.splits(cfg.d_ff) else None
        elif parent == "ssm" and ssm is not None:
            if path[-1] == "in_proj":
                return "partial"
            axis = "ssm_heads" if "ssm_heads" in names else "d_inner"
        elif (parent == "attn" and not serve) or (
                parent == "cross" and path[-1] in ("wq", "wk", "wv", "wo")):
            split = attention_split(
                cfg, size, enc_seq if path[0] == "encoder" else seq)
            if split == "seq":
                return "partial"
            axis = split and ("q_dim" if "q_dim" in names else "kv_dim")
        return names.index(axis) if axis is not None and axis in names \
            else "whole"

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return read(path, tree)
    return walk(param_defs(cfg))


def _forward_impl(
    params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    enc_inputs: Optional[torch.Tensor],
    want_aux: bool = False,
    remat: str = "none",
    gather=None,
    moe_shard=None,
    tp: TPShard = NO_TP,
) -> Tuple[torch.Tensor, "torch.Tensor | float"]:
    """(logits, the MoE layers' summed load-balancing loss where
    ``want_aux``, else 0.0); the logits are this rank's vocabulary
    columns where ``tp`` splits the vocabulary.  ``remat`` is the
    activation-checkpoint policy of each layer body (each group's, in
    the grouped models; ``_maybe_remat``): the training loss passes
    ``cfg.remat``.  ``gather``, ``moe_shard``, ``tp``: see the module
    docstring."""
    compute = cfg.dtypes.compute_dtype
    cparams = tree_cast(params, compute)
    if gather is not None:
        cparams = gather("top", cparams)
    b, s = tokens.shape
    x = _embed_scaled(_embed(cparams["tok_emb"], tokens, cfg, tp), cfg)
    x = shard_constraint(x, "batch", "seq", "d_model")
    positions = torch.arange(s, device=x.device)

    enc = None
    if cfg.is_encdec:
        enc = _run_encoder(cparams, enc_inputs.to(compute), cfg, remat,
                           gather, tp)
        x = x + cparams["dec_pos_emb"][:s][None]
    elif cfg.family == "vlm":
        enc = enc_inputs.to(compute)

    def plain_layers(gp, h):
        for lp in gp["plain"]:
            h, _, _, _ = blocks.apply_block(lp, h, cfg, "dense",
                                            positions=positions, tp=tp)
        return h

    kind = _layer_kind(cfg)
    aux_total = 0.0
    if _vlm_groups(cfg):
        def body(gp, h):
            if gather is not None:
                gp = gather("groups", gp)
            h = plain_layers(gp, h)
            return blocks.apply_block(gp["cross"], h, cfg, "cross",
                                      positions=positions, enc=enc,
                                      tp=tp)[0]
        body = _maybe_remat(body, remat)
        for gp in cparams["groups"]:
            x = body(gp, x)
    elif _moe_groups(cfg):
        def body(gp, h):
            if gather is not None:
                gp = gather("groups", gp)
            h = plain_layers(gp, h)
            h, _, _, aux = blocks.apply_block(gp["moe"], h, cfg, "moe",
                                              positions=positions,
                                              want_aux=want_aux,
                                              moe_shard=moe_shard, tp=tp)
            return h, aux
        body = _maybe_remat(body, remat)
        for gp in cparams["groups"]:
            x, aux = body(gp, x)
            aux_total = aux_total + aux
    elif _interleaved(cfg):
        def body(lp, h):
            return blocks.apply_interleaved(lp, h, cfg,
                                            positions=positions)[0]
        body = _maybe_remat(body, remat)
        for _, _, lp in _interleaved_layers(cparams, cfg):
            x = body(lp, x)
    else:
        def body(lp, h):
            if gather is not None:
                lp = gather("layers", lp)
            h, _, _, aux = blocks.apply_block(lp, h, cfg, kind,
                                              positions=positions, enc=enc,
                                              want_aux=want_aux,
                                              moe_shard=moe_shard, tp=tp)
            return h, aux
        body = _maybe_remat(body, remat)
        for lp in cparams["layers"]:
            x, aux = body(lp, x)
            aux_total = aux_total + aux

    with span("model.head"):
        x = rms_norm(x, cparams["final_norm"], cfg.norm_eps)
        logits = _logits_scaled(_logits(x, cparams, cfg, tp), cfg)
    return shard_constraint(logits, "batch", "seq", "vocab"), aux_total


def forward(
    params,
    tokens: torch.Tensor,              # [B, S] int
    cfg: ModelConfig,
    *,
    enc_inputs: Optional[torch.Tensor] = None,   # audio frames / vision embeds
) -> torch.Tensor:
    """Full-sequence causal forward -> logits [B, S, vocab]."""
    logits, _ = _forward_impl(params, tokens, cfg, enc_inputs)
    return logits


class _VocabNLL(torch.autograd.Function):
    """The next-token cross-entropy of this rank's float32 vocabulary
    columns ``z``: log Σ exp(z - m) + m - z_label, the max ``m`` over
    the split (no gradient), the sum of exponentials and the label's
    logit (its rank's pick, zero on the others) summed over it.  Its
    gradient, exp(z - m) / Σ - onehot(label), is formed in one buffer
    from the saved exponentials (the collectives' backward is the
    identity: every rank holds the loss whole)."""

    @staticmethod
    def forward(ctx, z, labels, tp):
        n = z.shape[-1]
        m = tp.max(z.amax(dim=-1))
        local = labels.long() - tp.rank * n
        mine = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)[..., None]
        e = (z - m[..., None]).exp_()
        pick = torch.gather(z, -1, idx)[..., 0]
        sums = tp.region_out(torch.stack([e.sum(dim=-1),
                                          torch.where(mine, pick, 0.0)]),
                             "loss-all-reduce")
        ctx.save_for_backward(e, sums[0], idx, mine)
        return torch.log(sums[0]) + m - sums[1]

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        grad = e * (g / se)[..., None]
        return grad.scatter_add_(-1, idx, -(g * mine)[..., None]), None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       tp: TPShard = NO_TP) -> torch.Tensor:
    """[B, S] float32 next-token cross-entropy of ``labels`` from this
    rank's vocabulary columns ``logits`` (the whole vocabulary under a
    split of one rank), so that no rank holds the whole logits
    (``_VocabNLL``)."""
    return _VocabNLL.apply(logits.float(), labels, tp)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            aux_coef: float = 0.01, gather=None, moe_shard=None,
            tp: TPShard = NO_TP) -> torch.Tensor:
    """Masked next-token cross-entropy in fp32 (+ the MoE load-balance
    aux loss) of the *stacked* parameter tree (``param_defs``' layout,
    the training state).  The tree is cast to the compute dtype and
    taken apart into per-layer views inside every call, so each call
    builds its own autograd graph and the gradients land on the stacked
    leaves.  Each layer (group) body runs under ``cfg.remat``.
    ``gather``, ``moe_shard``, ``tp``: the sharded step's (see the
    module docstring); the cross-entropy is ``vocab_parallel_nll``."""
    with span("model.cast"):
        cast = tree_cast(params, cfg.dtypes.compute_dtype)
    logits, aux = _forward_impl(_unstack_params(cast), batch["tokens"], cfg,
                                batch.get("enc_inputs"),
                                want_aux=cfg.family == "moe",
                                remat=cfg.remat, gather=gather,
                                moe_shard=moe_shard, tp=tp)
    with span("model.loss"):
        nll = vocab_parallel_nll(logits, batch["labels"],
                                 tp if tp.splits(cfg.vocab_size) else NO_TP)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(nll)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        if cfg.family == "moe":
            loss = loss + aux_coef * aux
    return loss


forward_train = forward  # the reference's alias


# ----------------------------------------------------------------------
# serving: prefill + decode
# ----------------------------------------------------------------------
class DecodeState(NamedTuple):
    """The serving state.  ``length`` is a Python int (the host counts
    the tokens it feeds).  ``prefill`` / ``decode_step`` write the
    ``kv`` and ``ssm`` tensors in place and return a state with the new
    ``pos`` and ``length``: the state passed in is consumed."""
    kv: Any            # stacked (k, v) [L, B, S, KH, hd], or grouped
    ssm: Optional[Tuple[torch.Tensor, torch.Tensor]]  # stacked state/conv
    pos: Optional[torch.Tensor]                  # [S_cache] int32 ring positions
    length: int
    enc: Optional[torch.Tensor] = None           # encoder/vision context


def _cache_seq_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window > 0:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      enc: Optional[torch.Tensor] = None,
                      device: "torch.device | str | None" = None
                      ) -> DecodeState:
    """An empty state on ``device`` (CUDA unless named)."""
    with span("serve.init_state"):
        return _init_decode_state(cfg, batch, max_len, enc,
                                  resolve_device(device))


def _init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                       enc: Optional[torch.Tensor],
                       dev: torch.device) -> DecodeState:
    dt = cfg.dtypes.kv_cache_dtype

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def empty_pos(n):
        return torch.full((n,), -1, dtype=torch.int32, device=dev)

    kv, ssm, pos = None, None, None
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if _vlm_groups(cfg):
        n_groups = cfg.n_layers // cfg.cross_attn_every
        plain_per = cfg.cross_attn_every - 1
        kv = (zeros(n_groups, plain_per, *shape),
              zeros(n_groups, plain_per, *shape))
        pos = empty_pos(max_len)
    elif _moe_groups(cfg):
        n_groups = cfg.n_layers // cfg.moe_every
        dense_per = cfg.moe_every - 1
        kv = {"plain": (zeros(n_groups, dense_per, *shape),
                        zeros(n_groups, dense_per, *shape)),
              "moe": (zeros(n_groups, *shape), zeros(n_groups, *shape))}
        pos = empty_pos(max_len)
    elif _interleaved(cfg):
        kv = (zeros(cfg.count("attention"), *shape),
              zeros(cfg.count("attention"), *shape))
        pos = empty_pos(max_len)
        nm = cfg.count("mamba")
        ssm = (zeros(nm, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state, dtype=torch.float32),
               zeros(nm, batch, cfg.conv_dim - 1, cfg.conv_width))
    elif cfg.family != "ssm":
        s_len = _cache_seq_len(cfg, max_len)
        kv = (zeros(cfg.n_layers, batch, s_len, cfg.n_kv_heads, cfg.head_dim),
              zeros(cfg.n_layers, batch, s_len, cfg.n_kv_heads, cfg.head_dim))
        pos = empty_pos(s_len)
    if cfg.family in ("ssm", "hybrid"):
        ssm = (zeros(cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state, dtype=torch.float32),
               zeros(cfg.n_layers, batch, cfg.conv_dim - 1, cfg.d_inner))
    return DecodeState(kv=kv, ssm=ssm, pos=pos, length=0, enc=enc)


def _ssm_state_in(st: torch.Tensor, cv: torch.Tensor, cfg: ModelConfig,
                  tp: TPShard) -> SSMState:
    """A layer's SSM state as the mixer computes it from what the rank
    holds (``st`` [B, H?, hd, N], ``cv`` [B, k-1, d_inner?]): its chunks
    where the mixer splits (``ssm_split``), which must be what it holds;
    else each leaf whole, gathered over ``tp`` where the rank holds a
    chunk of it (hymba on 16 ranks: 50 heads keep the state whole, its
    ``d_inner`` 3200 splits the conv tail)."""
    h, di = cfg.ssm_heads, cfg.d_inner
    if ssm_split(cfg, tp.size) is not None:
        if st.shape[1] * tp.size != h or cv.shape[2] * tp.size != di:
            raise ValueError(f"the SSM splits its {h} heads over "
                             f"{tp.size} ranks; the rank holds a state of "
                             f"{st.shape[1]} heads and {cv.shape[2]} "
                             f"channels")
        return SSMState(st, cv)
    if st.shape[1] != h:
        st = tp.seq_gather(st, 1, "state-all-gather")
    if cv.shape[2] != di:
        cv = tp.seq_gather(cv, 2, "state-all-gather")
    if st.shape[1] != h or cv.shape[2] != di:
        raise ValueError(f"the SSM computes whole; the rank's state chunks "
                         f"({tuple(st.shape)}, {tuple(cv.shape)}) were not "
                         f"gathered whole over {tp.size} ranks")
    return SSMState(st, cv)


def _ssm_state_out(st: torch.Tensor, cv: torch.Tensor, new: SSMState,
                   tp: TPShard) -> None:
    """Write the mixer's new state into the rank's leaves, in place: of a
    leaf the rank holds a chunk of and the mixer computed whole, the
    rank's chunk."""
    for mine, got, dim in ((st, new.state, 1), (cv, new.conv, 2)):
        n = mine.shape[dim]
        mine.copy_(got if got.shape[dim] == n
                   else got.narrow(dim, tp.rank * n, n))


def _forward_cached(params, tokens: torch.Tensor, cfg: ModelConfig,
                    state: DecodeState, tp: TPShard = NO_TP, gather=None,
                    moe_shard=None):
    """Shared prefill/decode body: runs S tokens against the caches.
    The sharded serving step (``launch/steps.make_prefill_step(mesh=)``)
    passes ``tp``, ``gather`` and ``moe_shard`` as the train step does
    (module docstring), and this rank's part of the state: its rows of
    the batch and, where a leaf's spec splits it over ``model``, its
    chunk (the caches' slots: context-parallel attention; the SSM
    state's heads; the conv tail's channels; ``_ssm_state_in``).  The
    logits are this rank's rows, whole over the vocabulary (the
    columns gathered, ``logits-all-gather``)."""
    compute = cfg.dtypes.compute_dtype
    cparams = tree_cast(params, compute)
    if gather is not None:
        cparams = gather("top", cparams)
    b, s = tokens.shape
    x = _embed_scaled(_embed(cparams["tok_emb"], tokens, cfg, tp), cfg)
    x = shard_constraint(x, "batch", "seq", "d_model")
    length = state.length
    positions = torch.arange(length, length + s, device=x.device)
    enc = state.enc
    if enc is not None:
        enc = enc.to(compute)
    if cfg.is_encdec:
        # dynamic_slice clamps its start so that the slice fits
        start = max(0, min(length, cfg.max_seq_len - s))
        x = x + cparams["dec_pos_emb"][start:start + s][None]

    kind = _layer_kind(cfg)
    new_pos = (cache_pos_update(state.pos, length, s)
               if state.pos is not None else None)

    def layer(section: str, tree):
        return tree if gather is None else gather(section, tree)

    def run(lp, h, block_kind, k_l=None, v_l=None, ssm_l=None):
        """One block against the layer's cache views and SSM state,
        written in place."""
        cache = None if k_l is None else KVCache(k_l, v_l, state.pos, length)
        ssm_in = None if ssm_l is None else _ssm_state_in(*ssm_l, cfg, tp)
        y, _, new_ssm, _ = blocks.apply_block(
            lp, h, cfg, block_kind, positions=positions, cache=cache,
            ssm_state=ssm_in, enc=enc, moe_shard=moe_shard, tp=tp)
        if new_ssm is not None:
            _ssm_state_out(*ssm_l, new_ssm, tp)
        return y

    if _vlm_groups(cfg):
        k_all, v_all = state.kv
        for g, gp in enumerate(cparams["groups"]):
            gp = layer("groups", gp)
            for j, lp in enumerate(gp["plain"]):
                x = run(lp, x, "dense", k_all[g, j], v_all[g, j])
            x = run(gp["cross"], x, "cross")
    elif _moe_groups(cfg):
        kp, vp = state.kv["plain"]
        km, vm = state.kv["moe"]
        for g, gp in enumerate(cparams["groups"]):
            gp = layer("groups", gp)
            for j, lp in enumerate(gp["plain"]):
                x = run(lp, x, "dense", kp[g, j], vp[g, j])
            x = run(gp["moe"], x, "moe", km[g], vm[g])
    elif cfg.family == "ssm":
        st_all, cv_all = state.ssm
        for i, lp in enumerate(cparams["layers"]):
            x = run(layer("layers", lp), x, "ssm",
                    ssm_l=(st_all[i], cv_all[i]))
    elif _interleaved(cfg):
        k_all, v_all = state.kv
        st_all, cv_all = state.ssm
        for kind, j, lp in _interleaved_layers(cparams, cfg):
            if kind == "attention":
                x, _, _ = blocks.apply_interleaved(
                    lp, x, cfg, positions=positions,
                    cache=KVCache(k_all[j], v_all[j], state.pos, length))
            else:
                x, _, new_ssm = blocks.apply_interleaved(
                    lp, x, cfg, positions=positions,
                    ssm_state=SSMState(st_all[j], cv_all[j]))
                _ssm_state_out(st_all[j], cv_all[j], new_ssm, tp)
    elif cfg.family == "hybrid":
        k_all, v_all = state.kv
        st_all, cv_all = state.ssm
        for i, lp in enumerate(cparams["layers"]):
            x = run(layer("layers", lp), x, "hybrid", k_all[i], v_all[i],
                    (st_all[i], cv_all[i]))
    else:
        k_all, v_all = state.kv
        for i, lp in enumerate(cparams["layers"]):
            x = run(layer("layers", lp), x, kind, k_all[i], v_all[i])
    new_state = DecodeState(state.kv, state.ssm, new_pos, length + s,
                            state.enc)

    with span("model.head"):
        x = rms_norm(x, cparams["final_norm"], cfg.norm_eps)
        logits = _logits_scaled(_logits(x[:, -1, :], cparams, cfg, tp), cfg)
        if tp.splits(cfg.vocab_size):
            logits = tp.seq_gather(logits, 1, "logits-all-gather")
    return shard_constraint(logits, "batch", "vocab"), new_state


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            state: DecodeState):
    """Process the prompt; returns (last-token logits, filled state)."""
    if cfg.is_encdec and state.enc is None:
        raise ValueError("enc-dec prefill needs encoder output in state.enc")
    return _forward_cached(params, tokens, cfg, state)


def decode_step(params, token: torch.Tensor, cfg: ModelConfig,
                state: DecodeState):
    """One decode step. token: [B, 1] -> (logits [B, vocab], new state)."""
    return _forward_cached(params, token, cfg, state)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Public encoder entry (whisper): stub frames -> encoder states."""
    cparams = tree_cast(params, cfg.dtypes.compute_dtype)
    return _run_encoder(cparams, frames.to(cfg.dtypes.compute_dtype), cfg)
