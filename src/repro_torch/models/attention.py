"""GQA attention: training (full sequence), prefill, and cached decode.

  * GQA is computed by reshaping query heads into [kv_heads, group] so
    the einsum contracts against un-repeated K/V (no repeat_kv).
  * ``attn_impl="chunked"`` is a flash-style lazy softmax over KV chunks
    (running max/denominator), a Python loop over the chunks; "dense"
    materializes [B, H, S, T].
  * A self-attention call on CUDA tensors that autograd does not record
    (a prefill) takes the fused kernel (``kernels/attention``), whatever
    ``attn_impl`` says: it is the chunked algorithm in one launch, and
    writes no scores.  A call that records a gradient (the train step)
    and CPU tensors keep the dense or chunked path.
  * Decode: one query token against a [B, S_max, kv, hd] ring buffer
    with a position mask.  The cache's ``length`` is a Python int (the
    host counts the tokens it feeds), so every slot index is known on
    the host and the ring buffer is written through slices, in place.
  * Context parallelism (serving under a split ``tp``): where the cache
    holds this rank's chunk of the slots (the sharded serving step
    places its sequence over ``model``), each rank writes the new
    tokens that land in its slots; a prefill splits the query rows
    where they divide (K/V of every row on every rank), and a decode
    step scores the rank's slots and joins the softmax over the split
    by log-sum-exp (``_decode_attention_slots``).  Never by heads: a
    head-split rank would lack the other heads' K/V for its slots.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.collectives import NO_TP, TPShard
from repro_torch.kernels.attention import kernel as fused
from repro_torch.kernels.attention.ops import takes_kernel
from repro_torch.kernels.attention.ref import (NEG_INF, _divisor,
                                               _gqa_out, _gqa_scores,
                                               dense_attention)
from repro_torch.models.layers import apply_rope, dot_bias


def _inv_sqrt_in(hd: int, dtype, scale: Optional[float] = None) -> float:
    """1 / sqrt(hd) in float32, rounded to ``dtype`` (the reference's
    weakly typed ``1.0 / jnp.sqrt(hd)`` takes the scores' dtype), or a
    stated score ``scale`` rounded to it."""
    if scale is not None:
        return float(torch.tensor(scale).to(dtype))
    return float((1.0 / torch.sqrt(torch.tensor(float(hd)))).to(dtype))


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    q_offset: int = 0,
    chunk: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-style lazy softmax over KV chunks: O(S * chunk) live scores;
    the scores times ``scale`` (None: 1 / sqrt(hd))."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, hd)
    n_chunks = (t + chunk - 1) // chunk
    pad = n_chunks * chunk - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = _inv_sqrt_in(hd, q.dtype, scale)
    dev = q.device
    qpos = torch.arange(s, device=dev)[:, None] + q_offset
    m = torch.full((b, kh, g, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, g, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kh, g, s, hd), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kci = k[:, ci * chunk:(ci + 1) * chunk]
        vci = v[:, ci * chunk:(ci + 1) * chunk]
        scores = torch.einsum("bskgd,btkd->bkgst", qg, kci) * scale
        kpos = ci * chunk + torch.arange(chunk, device=dev)[None, :]
        mask = kpos < t                        # drop the zero-padding
        if causal:
            mask = mask & (kpos <= qpos)
            if window > 0:
                mask = mask & (kpos > qpos - window)
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, vci.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


class KVCache(NamedTuple):
    """Ring-buffer KV cache.

    ``pos[s]`` is the absolute token position stored in slot ``s`` (-1 =
    empty).  Full-attention models allocate S_max >= total length, so the
    ring never wraps; sliding-window models allocate S_max = window and
    the ring gives an O(window) decode state."""
    k: torch.Tensor          # [B, S_max, KH, hd]
    v: torch.Tensor          # [B, S_max, KH, hd]
    pos: torch.Tensor        # [S_max] int32 absolute positions, -1 empty
    length: int              # tokens seen so far


def init_kv_cache(batch: int, max_seq: int, kv_heads: int, head_dim: int,
                  dtype, device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, max_seq, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, max_seq, kv_heads, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full((max_seq,), -1, dtype=torch.int32, device=device),
        length=0,
    )


def _ring_runs(length: int, s_new: int, s_max: int):
    """The slots of positions length .. length+s_new-1 (s_new < s_max)
    as at most two contiguous runs: (first slot, end slot, offset of
    the run's first token among the new ones)."""
    first = length % s_max
    head = min(s_new, s_max - first)
    runs = [(first, first + head, 0)]
    if head < s_new:
        runs.append((0, s_new - head, head))
    return runs


def cache_pos_update(pos: torch.Tensor, length: int,
                     s_new: int) -> torch.Tensor:
    """Position-buffer half of cache_update (shared across layers); a
    new tensor, ``pos`` is left as it was."""
    s_max = pos.shape[0]
    if s_new >= s_max:
        start = length + s_new - s_max
        tail_pos = torch.arange(start, start + s_max, dtype=torch.int32,
                                device=pos.device)
        return torch.roll(tail_pos, start % s_max)
    out = pos.clone()
    for a, e, off in _ring_runs(length, s_new, s_max):
        out[a:e] = torch.arange(length + off, length + off + (e - a),
                                dtype=torch.int32, device=pos.device)
    return out


def _slot_runs(length: int, s_new: int, s_max: int):
    """``_ring_runs`` of the tokens a ring of ``s_max`` slots keeps of
    ``s_new`` new ones: all of them where ``s_new < s_max``, else the
    last ``s_max`` (in at most two runs, slot == pos % s_max)."""
    if s_new < s_max:
        return _ring_runs(length, s_new, s_max)
    first = (length + s_new - s_max) % s_max
    runs = [(first, s_max, s_new - s_max)]
    if first:
        runs.append((0, first, s_new - first))
    return runs


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 lo: int = 0) -> KVCache:
    """Append S_new tokens starting at absolute position cache.length,
    writing ``cache.k`` / ``cache.v`` in place.  Slots wrap modulo
    S_max = ``pos.shape[0]`` (ring buffer); if S_new >= S_max only the
    last S_max tokens are kept, laid out so that slot == pos % S_max.
    A rank that holds a chunk of the ring (context parallelism) passes
    its first slot ``lo``: its ``cache.k`` / ``cache.v`` are slots
    ``[lo, lo + n)``, and only the new tokens that land there are
    written; ``pos`` (every slot's) is updated whole."""
    n, s_max = cache.k.shape[1], cache.pos.shape[0]
    s_new = k_new.shape[1]
    for a, e, off in _slot_runs(cache.length, s_new, s_max):
        a2, e2 = max(a, lo), min(e, lo + n)
        if a2 < e2:
            src = slice(off + a2 - a, off + e2 - a)
            cache.k[:, a2 - lo:e2 - lo] = k_new[:, src]
            cache.v[:, a2 - lo:e2 - lo] = v_new[:, src]
    pos = cache_pos_update(cache.pos, cache.length, s_new)
    return KVCache(cache.k, cache.v, pos, cache.length + s_new)


def holds_slot_chunk(cache: KVCache, tp: TPShard) -> bool:
    """Whether ``cache`` holds this rank's chunk of the slots (its k / v
    are ``1 / tp.size`` of ``pos``'s slots) rather than every slot."""
    n, s_max = cache.k.shape[1], cache.pos.shape[0]
    if n == s_max:
        return False
    if n * tp.size != s_max:
        raise ValueError(f"a cache chunk of {n} slots is not 1 / "
                         f"{tp.size} of the {s_max} slots")
    return True


def attention_split(cfg, size: int, s: int) -> Optional[str]:
    """How a tensor-parallel split of ``size`` ranks computes
    self-attention over ``s`` query rows, the reference's choice at its
    ``shard_constraint`` sites: "heads" when both head counts divide
    ``size`` (each rank its query and KV heads), else "seq" where
    ``s`` > 1 divides (each rank its ``s / size`` query rows against
    every row's K/V), else None (every rank computes it whole)."""
    if size <= 1:
        return None
    if cfg.n_heads % size == 0 and cfg.n_kv_heads % size == 0:
        return "heads"
    if s > 1 and s % size == 0:
        return "seq"
    return None


def _project(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor]) -> torch.Tensor:
    return x @ w if b is None else dot_bias(x, w, b)


def attention_apply(
    p: dict,                       # attn params
    x: torch.Tensor,               # [B, S, d_model]
    *,
    cfg,
    positions: torch.Tensor,       # [B, S] or [S]
    cache: Optional[KVCache] = None,
    causal: bool = True,
    window: int = 0,
    use_rope: bool = True,
    scale: Optional[float] = None,
    tp: TPShard = NO_TP,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention with optional KV cache (decode/prefill).  Under a
    tensor-parallel split ``tp`` with no cache the rank computes its
    part (``attention_split``): its heads' columns of ``wq`` / ``wk`` /
    ``wv`` (and biases) and rows of ``wo``, the partial output summed
    over the split; or its query rows (the causal and window masks at
    their offset) against K/V of every row, the output rows gathered
    over the split.  Either way ``x`` enters through ``region_in``: its
    gradient from this rank is a partial.  With a cache that holds the
    rank's chunk of the slots (``holds_slot_chunk``), the attention is
    context-parallel (module docstring; serving, no gradient across
    ranks); with a whole cache it is computed whole.  ``scale``: the
    scores' scale where a configuration states one (None: 1 / sqrt(hd),
    the reference's), on every path."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h, kh = cfg.n_heads, cfg.n_kv_heads
    w = {n: p[n] for n in ("wq", "wk", "wv", "wo")}
    bias = {n: p.get(n) if cfg.qkv_bias else None for n in ("bq", "bk", "bv")}
    if cache is None:
        split = attention_split(cfg, tp.size, s)
    elif holds_slot_chunk(cache, tp):
        split = "seq" if s > 1 and s % tp.size == 0 else "slots"
    else:
        split = None
    if split in ("heads", "seq"):
        x = tp.region_in(x)
    xq, q0 = x, 0
    if split == "heads":
        h, kh = h // tp.size, kh // tp.size
        for n, full in (("wq", cfg.q_dim), ("wk", cfg.kv_dim),
                        ("wv", cfg.kv_dim)):
            w[n] = tp.part(w[n], 1, full)
            if bias["b" + n[1]] is not None:
                bias["b" + n[1]] = tp.part(bias["b" + n[1]], 0, full)
        w["wo"] = tp.part(w["wo"], 0, cfg.q_dim)
    elif split == "seq":
        sq = s // tp.size
        q0 = tp.rank * sq
        xq = x[:, q0:q0 + sq]
    sq = xq.shape[1]
    q = _project(xq, w["wq"], bias["bq"]).reshape(b, sq, h, hd)
    k = _project(x, w["wk"], bias["bk"]).reshape(b, s, kh, hd)
    v = _project(x, w["wv"], bias["bv"]).reshape(b, s, kh, hd)
    if use_rope:
        if positions.ndim == 1:
            positions = positions[None, :]
        q = apply_rope(q, positions[:, q0:q0 + sq], cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if takes_kernel(q, k, v):
        attend = fused.fused_attention_kernel
    elif cfg.attn_impl == "chunked":
        attend = chunked_attention
    else:
        attend = dense_attention
    new_cache = None
    if cache is not None:
        lo = tp.rank * cache.k.shape[1] if split is not None else 0
        new_cache = cache_update(cache, k, v, lo)
    if cache is None or s > 1:
        # a prefill attends over the fresh K/V directly (the ring buffer
        # may hold only the window tail, which would be wrong for early
        # queries); the cache starts empty here
        # a configuration with no stated scale calls the attention as
        # before it had one
        extra = {} if scale is None else {"scale": scale}
        out = attend(q, k, v, causal=causal, window=window, q_offset=q0,
                     **extra)
    elif split is not None:
        out = _decode_attention_slots(q, new_cache, window=window, tp=tp,
                                      lo=lo, scale=scale)
    else:
        out = _decode_attention(q, new_cache, window=window, scale=scale)

    out = out.reshape(b, sq, h * hd) @ w["wo"]
    if split == "heads":
        out = tp.region_out(out)
    elif split == "seq":
        out = tp.seq_gather(out, 1)
    return out, new_cache


def _decode_attention(q: torch.Tensor, cache: KVCache, *, window: int,
                      scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against the ring buffer: slot validity and
    causality come from the stored absolute positions."""
    b, s, h, hd = q.shape
    kh = cache.k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, hd)
    scores = _gqa_scores(qg, cache.k.to(q.dtype)) / _divisor(hd, q.dtype,
                                                             scale)
    qpos = cache.length - 1                       # position of the new token
    kpos = cache.pos[None, :]                     # [1, S_max]
    mask = (kpos >= 0) & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = _gqa_out(p, cache.v.to(q.dtype))
    return out.reshape(b, s, h, hd)


def _decode_attention_slots(q: torch.Tensor, cache: KVCache, *, window: int,
                            tp: TPShard, lo: int,
                            scale: Optional[float] = None) -> torch.Tensor:
    """``_decode_attention`` of a rank that holds slots ``[lo, lo + n)``
    of the ring, joined over ``tp`` by log-sum-exp: the max of the
    masked scores over the split (``decode-max``), ``l = Σ exp(s - m)``
    summed over it (``decode-sum``), the probabilities ``exp(s - m) /
    l`` rounded to the compute dtype as the whole softmax rounds them,
    and their float32 products with the rank's values summed over the
    split (``decode-out``).  A rank with no valid slot scores NEG_INF
    everywhere; against the split's max (finite: the new token's slot
    is valid) its exponentials are exact zeros."""
    b, s, h, hd = q.shape
    n, kh = cache.k.shape[1], cache.k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, hd)
    scores = _gqa_scores(qg, cache.k.to(q.dtype)) / _divisor(hd, q.dtype,
                                                             scale)
    qpos = cache.length - 1
    kpos = cache.pos[None, lo:lo + n]
    mask = (kpos >= 0) & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask[None, None, None], scores, NEG_INF).float()
    m = tp.max(scores.amax(dim=-1, keepdim=True), "decode-max")
    e = torch.exp(scores - m)
    l = tp.region_out(e.sum(dim=-1, keepdim=True), "decode-sum")
    p = (e / l).to(q.dtype)
    out = tp.region_out(_gqa_out(p.float(), cache.v.float()), "decode-out")
    return out.to(q.dtype).reshape(b, s, h, hd)


def cross_attention_apply(
    p: dict,
    x: torch.Tensor,               # [B, S, d_model] decoder side
    enc: torch.Tensor,             # [B, T, d_model] encoder / vision side
    *,
    cfg,
    tp: TPShard = NO_TP,
) -> torch.Tensor:
    """Cross-attention of the decoder rows ``x`` over ``enc``.  Under a
    tensor-parallel split ``tp`` (``attention_split`` over the ``S``
    decoder rows) the rank computes its heads (its columns of ``wq`` /
    ``wk`` / ``wv`` and rows of ``wo``, the partial output summed) or
    its decoder rows against K/V of every encoder row (no mask; the
    output rows gathered).  Either way both ``x`` and ``enc`` enter
    through ``region_in``: their gradients from this rank are partials
    (Whisper's ``enc`` is the encoder's output)."""
    b, s, _ = x.shape
    t = enc.shape[1]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = {n: p[n] for n in ("wq", "wk", "wv", "wo")}
    split = attention_split(cfg, tp.size, s)
    if split is not None:
        x, enc = tp.region_in(x), tp.region_in(enc)
    xq = x
    if split == "heads":
        h, kh = h // tp.size, kh // tp.size
        for n, full in (("wq", cfg.q_dim), ("wk", cfg.kv_dim),
                        ("wv", cfg.kv_dim)):
            w[n] = tp.part(w[n], 1, full)
        w["wo"] = tp.part(w["wo"], 0, cfg.q_dim)
    elif split == "seq":
        sq = s // tp.size
        xq = x[:, tp.rank * sq:(tp.rank + 1) * sq]
    sq = xq.shape[1]
    q = (xq @ w["wq"]).reshape(b, sq, h, hd)
    k = (enc @ w["wk"]).reshape(b, t, kh, hd)
    v = (enc @ w["wv"]).reshape(b, t, kh, hd)
    out = dense_attention(q, k, v, causal=False)
    out = out.reshape(b, sq, h * hd) @ w["wo"]
    if split == "heads":
        out = tp.region_out(out)
    elif split == "seq":
        out = tp.seq_gather(out, 1)
    return out
