"""Step functions and their sharding trees.

``make_train_step`` builds loss -> grad -> (micro-batched accumulation)
-> AdamW update; ``make_prefill_step`` / ``make_decode_step`` wrap the
model's serving entry points, sharded under a mesh.  The sharding trees
map every argument to ``NamedSharding``s derived from the logical
rules, legalized so that
every split dim divides (``legalize_sharding``), so launch code never
hand-writes specs per architecture.

**The sharded step** (``make_train_step(..., mesh=)``).  The state is
placed as shards (``distributed.sharding.place_tree`` by
``params_shardings`` / ``opt_state_shardings``); the model computes on
plain tensors, with the collectives run explicitly
(``distributed/collectives.py``):

  * the global batch is cut into micro-batches first (micro-batch i is
    rows [i b/mb, (i+1) b/mb)), then each is split over
    ``batch_axes(mesh, b // mb)``;
  * the ``model`` axis runs tensor parallelism (``TPShard``, passed to
    ``M.loss_fn``), the reference's plan at its constraint sites: each
    self- and cross-attention split by heads where both head counts
    divide the axis, else by query (decoder) rows (each rank its rows
    against every row's K/V, the output rows gathered); the SSM, and
    hymba's SSM branch, by heads where its heads and ``in_proj``'s
    width divide; each MLP over ``d_ff``; the embedding, the head and
    the cross-entropy over ``vocab``, where the dim divides.  The
    residual stream, the norms and the MoE router (replicated in the
    reference too) are computed whole on every ``model`` rank;
  * each parameter is gathered where the forward reads it: the
    top-level leaves once a micro-batch, each layer's slice inside its
    (rematerialized) body; the gather's backward reduce-scatters over
    the batch axes and slices over the others.  A leaf the split reads
    by its rank's chunk (``d_ff``; ``q_dim`` / ``kv_dim`` and the QKV
    biases under the head split; ``d_inner`` / ``ssm_heads`` under the
    SSM's; ``vocab``) keeps that dim split, not gathered over
    ``model``; a leaf read whole for a rank's part (the attention
    weights under the row split, ``in_proj`` under the SSM's split)
    sums its gradient over ``model`` (its gather there
    reduce-scatters).  Every other leaf is
    gathered whole (smollm's ``q_dim`` over 16 ranks, 60 columns a
    rank and not whole heads; Whisper's vocabulary 51865, left
    replicated);
  * a leaf's gradient is all-reduced over the batch axes it is not
    split on;
  * each rank's loss and gradients are weighted by its share of the
    mask count (all-reduced first; where the micro-batch has none,
    every rank weighs alike), so the weights sum to 1 and the loss is
    the reference's global mean plus its MoE aux loss whatever the
    masks;
  * the clipping norm sums each leaf's squares over the axes it is
    split on, then over the leaves;
  * AdamW runs on the local shards (its math is elementwise);
  * the MoE family runs expert-parallel: the expert leaves (logical
    axis "experts") are not gathered over the axes their expert dim is
    split on (``model``), and the MoE block (``models/moe.py``, passed
    a ``MoEShard``) routes this rank's rows over all experts with the
    global micro-batch's groups and capacity, computes its own experts
    and sums their outputs over ``model``; the load-balancing
    statistics are summed over the batch axes.

**Sharded serving** (``make_prefill_step(cfg, mesh)``,
``make_decode_step(cfg, mesh)``) follows the state's trees, not the
training split: the parameters placed by ``params_shardings(serve=True)``
(no ``fsdp``), the state by ``decode_state_shardings``, the tokens'
rows split over ``batch_axes``.  Each rank runs ``M._forward_cached``
on its rows with the leaves gathered as above (forward only).  The
caches hold the rank's slots where their sequence splits over
``model``, so the self-attention is context-parallel (a prefill splits
the query rows, a decode step joins the softmax over the slots by
log-sum-exp; ``models/attention.py``) and reads its weights whole; the
cross-attention, the SSM (its state's heads and conv channels), the
MLPs and the vocabulary split as in training, the MoE runs
expert-parallel; a leaf the rank holds split but the compute reads
whole (hymba's conv tail on 16 ranks) is gathered and its chunk
written back.  The logits come back whole, ``[B, vocab]`` on every
rank.

``make_sharded_grads`` is the step's part before AdamW (loss and
local gradients).  Axes of size 1 launch nothing and weigh nothing, and
a split of one rank is the unsharded model, so on a mesh of one device
the step is the unsharded step op for op.  Not
supported: q8 moments under a sharded mesh (their quantisation blocks
are the whole leaf's).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed.collectives import (
    NO_TP,
    CollectiveLog,
    MeshAxes,
    TPShard,
    gather_shards,
    shard_plan,
    split_axes,
)
from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    legalize_spec,
    logical_to_mesh_spec,
    mesh_shape,
    set_rules,
)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEShard
from repro_torch.optimizer.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
)
from repro_torch.optimizer.schedules import cosine_warmup_schedule
from repro_torch.utils.tracing import span
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


# ----------------------------------------------------------------------
# sharding trees
# ----------------------------------------------------------------------
def batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """The (pod, data) axes, in that order, taken while their product
    divides the batch."""
    sizes = mesh_shape(mesh)
    chosen: list = []
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and global_batch % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return tuple(chosen)


def legalize_sharding(sharding: NamedSharding,
                      shape: Tuple[int, ...]) -> NamedSharding:
    """Argument shardings must divide each dimension exactly: mesh axes
    that don't divide (kv_heads=8 on a 16-way model axis, Whisper's odd
    vocab 51865) are dropped, leaving that dim replicated."""
    return NamedSharding(sharding.mesh,
                         legalize_spec(sharding.spec, tuple(shape),
                                       sharding.mesh))


def legalize_tree(shardings, abstract):
    leaves = [legalize_sharding(sh, ab.shape)
              if isinstance(sh, NamedSharding) else sh
              for sh, ab in zip(tree_leaves(shardings), tree_leaves(abstract))]
    return tree_unflatten(shardings, leaves)


def _map_defs(fn, tree):
    """``fn`` over the leaves of a nested dict whose leaves are
    ``ParamDef``s or logical-axis tuples."""
    if isinstance(tree, dict):
        return {k: _map_defs(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_shardings(cfg: ModelConfig, mesh, serve: bool = False):
    """Parameter shardings.  ``serve=True`` drops the FSDP axis: with no
    optimizer state to shard, replicating params over ``data`` removes
    the per-layer gathers from every decode step at a small memory
    cost."""
    def build():
        return _map_defs(
            lambda ax: NamedSharding(mesh, logical_to_mesh_spec(ax, mesh)),
            M.logical_axes(cfg))
    if serve:
        with set_rules({"fsdp": None}):
            raw = build()
    else:
        raw = build()
    return legalize_tree(raw, abstract_params(cfg))


def opt_state_shardings(cfg: ModelConfig, mesh) -> OptState:
    p_sh = params_shardings(cfg, mesh)
    return OptState(step=NamedSharding(mesh, P()), m=p_sh, v=p_sh)


def batch_shardings(cfg: ModelConfig, mesh, global_batch: int,
                    with_enc: bool) -> dict:
    ba = batch_axes(mesh, global_batch)
    spec2 = NamedSharding(mesh, P(ba if ba else None, None))
    out = {"tokens": spec2, "labels": spec2, "mask": spec2}
    if with_enc:
        out["enc_inputs"] = NamedSharding(mesh, P(ba if ba else None,
                                                  None, None))
    return out


def decode_state_shardings(cfg: ModelConfig, mesh,
                           state_abstract: M.DecodeState,
                           global_batch: int) -> M.DecodeState:
    """Sharding tree matching a DecodeState: batch over (pod, data), the
    caches' sequence (their slots), the SSM state's heads and the conv
    tail's ``d_inner`` over model, everything else replicated.
    The port's ``length`` is a Python int; its slot holds a replicated
    spec, so the leaves line up with the reference's one for one."""
    ba = batch_axes(mesh, global_batch)
    b_ax = ba if ba else None

    def legal(spec, a):
        return legalize_sharding(NamedSharding(mesh, spec), a.shape)

    def kv_spec(a):
        # the cache's seq over "model" (context parallelism): kv-head
        # counts rarely divide a 16-way axis, 32k / 500k sequences do
        if a.ndim == 6:    # [G, per, B, S, KH, hd] (vlm / moe groups)
            return legal(P(None, None, b_ax, "model", None, None), a)
        return legal(P(None, b_ax, "model", None, None), a)   # [L, B, S, KH, hd]

    kv = (tree_map(kv_spec, state_abstract.kv)
          if state_abstract.kv is not None else None)
    ssm = None
    if state_abstract.ssm is not None:
        st, cv = state_abstract.ssm
        ssm = (legal(P(None, b_ax, "model", None, None), st),
               legal(P(None, b_ax, None, "model"), cv))
    pos = (NamedSharding(mesh, P(None))
           if state_abstract.pos is not None else None)
    enc = (legal(P(b_ax, None, None), state_abstract.enc)
           if state_abstract.enc is not None else None)
    return M.DecodeState(kv=kv, ssm=ssm, pos=pos,
                         length=NamedSharding(mesh, P()), enc=enc)


def abstract_params(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors (shape and dtype, no
    storage)."""
    dt = cfg.dtypes.params_dtype
    return _map_defs(lambda d: torch.empty(d.shape, dtype=dt, device="meta"),
                     M.param_defs(cfg))


def abstract_opt_state(cfg: ModelConfig, opt_cfg: AdamWConfig) -> OptState:
    return adamw_init(abstract_params(cfg), opt_cfg)


def abstract_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                          with_enc: bool) -> M.DecodeState:
    """``init_decode_state``'s tree as ``meta`` tensors (built under a
    ``FakeTensorMode``: nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        enc = None
        if with_enc:
            t = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
            enc = torch.zeros((batch, t, cfg.d_model),
                              dtype=cfg.dtypes.compute_dtype)
        state = M.init_decode_state(cfg, batch, max_len, enc=enc,
                                    device="cpu")
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta")
                    if isinstance(x, torch.Tensor) else x, state)


# ----------------------------------------------------------------------
# step functions
# ----------------------------------------------------------------------
def _value_and_grad(params, batch, cfg: ModelConfig, gather=None,
                    scale: Optional[torch.Tensor] = None, moe_shard=None,
                    tp: TPShard = NO_TP):
    """(loss, gradient tree of ``params``) of ``M.loss_fn`` (times
    ``scale`` where given); a leaf the loss does not reach gets a zero
    gradient, as JAX gives it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with span("train.forward"):
        loss = M.loss_fn(tree_unflatten(params, leaves), batch, cfg,
                         gather=gather, moe_shard=moe_shard, tp=tp)
        if scale is not None:
            loss = loss * scale
    with span("train.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _check_split(b: int, microbatches: int) -> None:
    if microbatches > 1 and b % microbatches:
        raise ValueError(f"a batch of {b} rows does not split into "
                         f"{microbatches} micro-batches")


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, total_steps: int = 10000,
                    warmup_steps: int = 200,
                    accum_dtype: Optional[torch.dtype] = None, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, metrics) over the stacked parameter tree.  With
    ``microbatches`` > 1 the batch is split along its first axis (which
    must divide; a ``ValueError`` otherwise) and the gradients are
    summed in ``accum_dtype`` (default fp32) in batch order, then
    divided by ``microbatches``; the loss is the mean of the
    micro-batches' losses.  The lr scale is the cosine-warmup schedule
    at ``opt_state.step`` before the update (so the first update of a
    run with ``warmup_steps`` > 0 has lr 0).  ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as 0-dim tensors on the device
    (reading one synchronises).

    With a ``DeviceMesh`` ``mesh`` the step is the sharded one (module
    docstring): ``params`` and ``opt_state`` are trees of DTensors
    placed by ``params_shardings`` / ``opt_state_shardings`` (or of
    this rank's local shards), the batch is the global batch on every
    rank, and the step's ``collectives`` attribute counts what it
    launched.  The MoE family trains expert-parallel there (its expert
    leaves stay split over ``model``); q8 moments under a mesh that
    splits a leaf raise ``ValueError``."""
    acc_dt = accum_dtype or torch.float32
    if mesh is not None:
        return _sharded_train_step(cfg, opt_cfg, microbatches, total_steps,
                                   warmup_steps, acc_dt, mesh)

    def train_step(params, opt_state, batch):
        _check_split(batch["tokens"].shape[0], microbatches)
        if microbatches <= 1:
            loss, grads = _value_and_grad(params, batch, cfg)
        else:
            def part(x, i):
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]
            acc = None
            losses = []
            for i in range(microbatches):
                mb = {k: part(v, i) for k, v in batch.items()}
                loss_i, g = _value_and_grad(params, mb, cfg)
                g = [x.to(acc_dt) for x in tree_leaves(g)]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                losses.append(loss_i)
            grads = tree_unflatten(params, [a / microbatches for a in acc])
            loss = torch.stack(losses).mean()
        with span("train.optimizer"):
            lr_scale = cosine_warmup_schedule(
                opt_state.step, warmup_steps=warmup_steps,
                total_steps=total_steps)
            params, opt_state, metrics = adamw_update(
                params, grads, opt_state, opt_cfg, lr_scale)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


_STACKED = ("layers", "encoder", "groups")


class _Gather:
    """The sharded step's ``gather(section, tree)`` (``models/model.py``):
    a tree of the per-layer views' leaves, each gathered whole by the
    plan of its stacked leaf's spec with the stacked dims dropped
    (they are never split: the "layers" rule is None), but for the dims
    the compute reads split:

      * an expert leaf (logical axis "experts") keeps its expert dim
        split;
      * a leaf that the tensor-parallel split ``tp`` reads by its
        rank's chunk of a dim (``M.tp_reads``) keeps that dim split:
        its spec must split it over ``tp``'s axes and nothing else;
      * a leaf read whole for a rank's query rows, whose gradient is a
        partial over ``tp``, sums it: its gather over ``tp``'s axes
        (which its spec must split) reduce-scatters in the backward.

    Each gather adds the leaf's name to ``log.gathered`` under each
    axis it gathers over."""

    def __init__(self, shardings: dict, logical: dict, axes: MeshAxes,
                 batch: set, reads: dict, tp: TPShard):
        self.axes = axes
        tp_axes = set(tp.names)

        def plan(sh, names, read, drop, name):
            if any(e is not None for e in sh.spec[:drop]):
                raise ValueError(f"a stacked axis is split: {sh.spec}")
            spec = sh.spec[drop:]
            kept = {i for i, n in enumerate(names[drop:]) if n == "experts"}
            if isinstance(read, int):
                if set(axes.live(split_axes((spec[read],)))) != tp_axes:
                    raise ValueError(f"{name}: the split reads dim {read} "
                                     f"over {sorted(tp_axes)}, its spec "
                                     f"splits it as {spec}")
                kept.add(read)
            out = tuple((d, a, b or (read == "partial" and a in tp_axes))
                        for d, a, b in shard_plan(spec, axes, batch)
                        if d not in kept)
            if read == "partial" and not tp_axes <= {a for _, a, _ in out}:
                raise ValueError(f"{name}: its gradient is a partial over "
                                 f"{sorted(tp_axes)}, which its spec {spec} "
                                 f"does not split")
            return name, out

        def plans(tree, names, read, drop, path):
            if isinstance(tree, dict):
                return {k: plans(v, names[k], read[k], drop, path + (k,))
                        for k, v in tree.items()}
            return plan(tree, names, read, drop, "/".join(path))

        self.log = axes.log
        self.plans = {"top": {k: plans(v, logical[k], reads[k], 0, (k,))
                              for k, v in shardings.items()
                              if k not in _STACKED}}
        for name in ("layers", "encoder"):
            if name in shardings:
                self.plans[name] = plans(shardings[name], logical[name],
                                         reads[name], 1, (name,))
        if "groups" in shardings:
            self.plans["groups"] = {
                k: plans(v, logical["groups"][k], reads["groups"][k],
                         2 if k == "plain" else 1, ("groups", k))
                for k, v in shardings["groups"].items()}

    def __call__(self, section: str, tree):
        return self._walk(tree, self.plans[section])

    def _walk(self, tree, plans):
        if isinstance(tree, list):
            return [self._walk(t, plans) for t in tree]
        if isinstance(tree, dict):
            return {k: self._walk(v, plans[k]) if k in plans else v
                    for k, v in tree.items()}
        name, plan = plans
        for _, a, _ in plan:
            self.log.gathered.setdefault(a, set()).add(name)
        return gather_shards(tree, self.axes, plan)


def _expert_axes(cfg: ModelConfig, shardings, axes: MeshAxes
                 ) -> Tuple[str, ...]:
    """The live mesh axes the MoE leaves' expert dim is split over (as
    legalized: none where they do not divide the expert count)."""
    moe = (shardings["groups"]["moe"] if "groups" in shardings
           else shardings["layers"])["moe"]
    entry = moe["w_gate"].spec[1]
    names = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    return axes.live(names)


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _like(new_tree, old_tree):
    """``new_tree``'s local tensors as DTensors placed as the leaves of
    ``old_tree`` are (plain leaves stay plain)."""
    from torch.distributed.tensor import DTensor

    def wrap(new, old):
        if not isinstance(old, DTensor):
            return new
        return DTensor.from_local(new, old.device_mesh, old.placements,
                                  run_check=False, shape=old.shape,
                                  stride=old.stride())
    return tree_unflatten(new_tree, [wrap(n, o) for n, o in zip(
        tree_leaves(new_tree), tree_leaves(old_tree))])


def _rows(mesh, axes: MeshAxes, b: int) -> Tuple[Tuple[str, ...], int, int]:
    """(the live batch axes a batch of ``b`` rows splits over, this
    rank's rows, its first row)."""
    batch_ax = axes.live(batch_axes(mesh, b))
    rows = b // math.prod(axes.size[a] for a in batch_ax)
    return batch_ax, rows, axes.linear_rank(batch_ax) * rows


def _mask_count(mb: dict) -> torch.Tensor:
    mask = mb.get("mask")
    if mask is None:
        return torch.tensor(float(mb["tokens"].numel()),
                            device=mb["tokens"].device)
    return mask.sum()


def _global_norm(grads: list, split: list, axes: MeshAxes) -> torch.Tensor:
    """``tree_global_norm`` of the whole gradient from local shards:
    each leaf's sum of squares is summed over the axes it is split on
    (one all-reduce per set of axes), then over the leaves in order."""
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    by_axes: dict = {}
    for i, names in enumerate(split):
        live = axes.live(names)
        if live:
            by_axes.setdefault(live, []).append(i)
    for live, idx in by_axes.items():
        v = axes.all_reduce(torch.stack([sq[i] for i in idx]), live)
        for j, i in enumerate(idx):
            sq[i] = v[j]
    return torch.sqrt(sum(sq))


def refuse_unsharded(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration with no sharded
    step: the interleaved stack (Granite 4.0-H) runs on one device."""
    if cfg.family == "interleaved":
        raise NotImplementedError(
            f"{cfg.name}: the interleaved stack has no sharded step (no "
            "sharding rules for its Mamba2 and attention stacks); run it "
            "on one device, make_train_step / make_prefill_step without "
            "a mesh")


def make_sharded_grads(cfg: ModelConfig, mesh, microbatches: int = 1,
                       accum_dtype: Optional[torch.dtype] = None):
    """The sharded step's loss and gradients (module docstring), the
    part before AdamW: ``grads(params, batch) -> (loss, [local
    gradient leaves])``, ``params`` a tree of DTensors or local shards
    and ``batch`` the global batch.  Its ``collectives`` attribute
    counts what it launched, ``split`` lists each leaf's split mesh
    axes and ``axes`` is its ``MeshAxes``."""
    refuse_unsharded(cfg)
    acc_dt = accum_dtype or torch.float32
    shardings = params_shardings(cfg, mesh)
    sizes = mesh_shape(mesh)
    split = [split_axes(sh.spec) for sh in tree_leaves(shardings)]
    log = CollectiveLog()
    axes = MeshAxes(mesh, log)
    tp = TPShard.over(axes)
    experts = _expert_axes(cfg, shardings, axes) \
        if cfg.family == "moe" else ()

    def grads(params, batch):
        b = batch["tokens"].shape[0]
        _check_split(b, microbatches)
        b_mb = b // microbatches
        batch_ax, rows, first = _rows(mesh, axes, b_mb)
        if set(batch_ax) & set(experts):
            raise ValueError(f"the experts are split over a batch axis "
                             f"{experts}")
        mbs = [{k: v[i * b_mb + first:i * b_mb + first + rows]
                for k, v in batch.items()} for i in range(microbatches)]
        scales = [None] * microbatches
        if batch_ax:
            counts = torch.stack([_mask_count(mb) for mb in mbs])
            total = axes.all_reduce(counts.clone(), batch_ax)
            # a rank with no unmasked row weighs 0 (its cross-entropy is
            # 0, but the MoE aux loss, global, is the same on every
            # rank); a micro-batch with none weighs every rank alike
            scales = list(torch.where(
                total > 0, counts / torch.clamp(total, min=1.0),
                1.0 / math.prod(sizes[a] for a in batch_ax)))
        p_loc = tree_map(_local, params)
        enc = batch.get("enc_inputs")
        reads = M.tp_reads(cfg, tp.size, batch["tokens"].shape[1],
                           enc.shape[1] if enc is not None else 0)
        # a mesh of one device gathers nothing: no walk of the views
        gather = _Gather(shardings, M.logical_axes(cfg), axes,
                         set(batch_ax), reads, tp) if axes.groups else None
        moe_shard = MoEShard(axes, batch_ax, first, experts) \
            if cfg.family == "moe" else None

        acc, losses = None, []
        for mb, scale in zip(mbs, scales):
            loss_i, g = _value_and_grad(p_loc, mb, cfg, gather, scale,
                                        moe_shard, tp)
            g = tree_leaves(g)
            if microbatches > 1:
                g = [x.to(acc_dt) for x in g]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
            else:
                acc = g
            losses.append(loss_i)
        acc = [axes.all_reduce(x, [a for a in batch_ax if a not in names])
               for x, names in zip(acc, split)]
        out = [a / microbatches for a in acc] if microbatches > 1 else acc
        if batch_ax:
            lv = axes.all_reduce(torch.stack(losses), batch_ax)
            loss = lv.mean() if microbatches > 1 else lv[0]
        else:
            loss = torch.stack(losses).mean() if microbatches > 1 \
                else losses[0]
        return loss, out

    grads.collectives = log
    grads.split = split
    grads.axes = axes
    grads.tp = tp
    return grads


def _sharded_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                        microbatches: int, total_steps: int,
                        warmup_steps: int, acc_dt: torch.dtype, mesh):
    sizes = mesh_shape(mesh)
    grads_fn = make_sharded_grads(cfg, mesh, microbatches, acc_dt)
    split = grads_fn.split
    if opt_cfg.state_dtype == "q8" and any(
            sizes[a] > 1 for names in split for a in names):
        raise ValueError(
            "q8 moments under a mesh that splits a leaf: a local shard's "
            "quantisation blocks are not the whole leaf's; use float32 "
            "or bfloat16 moments")

    def train_step(params, opt_state, batch):
        loss, grads = grads_fn(params, batch)
        p_loc = tree_map(_local, params)
        o_loc = tree_map(_local, opt_state)
        with span("train.optimizer"):
            lr_scale = cosine_warmup_schedule(
                o_loc.step, warmup_steps=warmup_steps,
                total_steps=total_steps)
            new_p, new_o, metrics = adamw_update(
                p_loc, tree_unflatten(p_loc, grads), o_loc, opt_cfg,
                lr_scale, gnorm=_global_norm(grads, split, grads_fn.axes))
        metrics["loss"] = loss
        return _like(new_p, params), _like(new_o, opt_state), metrics

    train_step.collectives = grads_fn.collectives
    return train_step


def _sharded_serve_step(cfg: ModelConfig, mesh):
    """``step(params, tokens, state) -> (logits, state)`` of the sharded
    prefill and decode (``make_prefill_step``)."""
    refuse_unsharded(cfg)
    shardings = params_shardings(cfg, mesh, serve=True)
    log = CollectiveLog()
    axes = MeshAxes(mesh, log)
    tp = TPShard.over(axes)
    experts = _expert_axes(cfg, shardings, axes) \
        if cfg.family == "moe" else ()
    logical = M.logical_axes(cfg)

    def step(params, tokens, state):
        b, s = tokens.shape
        batch_ax, rows, first = _rows(mesh, axes, b)
        local = tree_map(_local, state)
        if cfg.is_encdec and local.enc is None:
            raise ValueError("enc-dec serving needs encoder output in "
                             "state.enc")
        gather = _Gather(shardings, logical, axes, set(batch_ax),
                         M.tp_reads(cfg, tp.size, s, serve=True), tp) \
            if axes.groups else None
        moe_shard = MoEShard(axes, batch_ax, first, experts) \
            if cfg.family == "moe" else None
        logits, new = M._forward_cached(
            M._unstack_params(tree_map(_local, params)),
            tokens[first:first + rows], cfg, local, tp, gather, moe_shard)
        if batch_ax:
            logits = axes.all_gather_axes(logits, batch_ax,
                                          "logits-all-gather").reshape(b, -1)
        return logits, _like(new, state)

    step.collectives = log
    step.axes = axes
    step.tp = tp
    return step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, tokens, state) -> (logits, state)``:
    ``M.prefill``.  With a ``DeviceMesh`` ``mesh`` it is the sharded
    prefill (module docstring, "Sharded serving"): ``params`` the
    stacked tree placed by ``params_shardings(cfg, mesh, serve=True)``
    (DTensors or this rank's shards), ``tokens`` the global batch on
    every rank, ``state`` placed by ``decode_state_shardings``
    (``place_tree``); the logits [B, vocab] come back whole on
    every rank, the state placed as it came.  Its ``collectives``
    attribute counts what it launched."""
    if mesh is not None:
        return _sharded_serve_step(cfg, mesh)

    def prefill_step(params, tokens, state):
        return M.prefill(params, tokens, cfg, state)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``decode_step(params, token, state) -> (logits, state)``:
    ``M.decode_step``; with a ``mesh`` the sharded decode (as
    ``make_prefill_step``'s)."""
    if mesh is not None:
        return _sharded_serve_step(cfg, mesh)

    def decode_step(params, token, state):
        return M.decode_step(params, token, cfg, state)
    return decode_step
