"""Mamba2 SSD (state-space duality) layer: chunked scan + O(1) decode.

The SSD recurrence (Dao & Gu 2024, arXiv:2405.21060) in its chunked
form: within a chunk the quadratic "attention-like" dual form runs as
dense einsums, for every chunk at once; across chunks a small state
[heads, head_dim, state] carries the recurrence, in a Python loop over
the chunks of two operations each.  The sequence
is padded to whole chunks (a decode step pads its one token to a chunk,
as the reference does); the cumulative sums and the state stay fp32.

Simplifications vs the full Mamba2 block (as in the reference): scalar
per-head A, single B/C group, depthwise conv on x only.  The published
mixer (``mamba2_apply``, Granite 4.0-H's) sits beside it on the same
scan: the conv over x, B and C with a bias, D, and the gated RMSNorm.

Tensor parallelism over ``model`` (``ssm_split``): a rank computes its
``ssm_heads / size`` heads, which are exactly its ``d_inner / size``
channels of x and z (the channels are head-major), the B / C columns
and ``cb = c b^T`` whole (they carry no head), and its rows of
``out_proj``; the partial outputs are summed over the split.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import NO_TP, TPShard
from repro_torch.distributed.sharding import shard_constraint
from repro_torch.models.layers import rms_norm, silu, softplus
from repro_torch.utils.tracing import span


class SSMState(NamedTuple):
    state: torch.Tensor       # [B, H, hd, N] inter-chunk SSD state
    conv: torch.Tensor        # [B, conv_dim-1, d_inner] depthwise conv tail


def init_ssm_state(batch: int, cfg, dtype, device) -> SSMState:
    return SSMState(
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_dim - 1, cfg.d_inner), dtype=dtype,
                         device=device),
    )


def proj_width(cfg) -> int:
    """``in_proj``'s columns: z and x (``d_inner`` each), B and C
    (``ssm_state`` each), dt (``ssm_heads``)."""
    return 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads


def ssm_split(cfg, size: int) -> Optional[str]:
    """How a tensor-parallel split of ``size`` ranks computes the mixer:
    "heads" where both ``ssm_heads`` and ``in_proj``'s width divide
    ``size`` (the width so that the leaf's spec splits it over
    ``model``, which sums its partial gradient), else None (every rank
    computes it whole)."""
    if size > 1 and cfg.ssm_heads % size == 0 \
            and proj_width(cfg) % size == 0:
        return "heads"
    return None


def _rank_in_proj(w: torch.Tensor, cfg, tp: TPShard) -> torch.Tensor:
    """This rank's columns of the whole ``in_proj`` [d, width], in
    ``_split_proj``'s order: its ``d_inner / size`` channels of z and of
    x, B and C whole, its ``ssm_heads / size`` entries of dt (the
    columns of z, x and dt are not contiguous, so ``TPShard.part``
    cannot cut them)."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dl, hl = di // tp.size, h // tp.size
    z0, h0 = tp.rank * dl, tp.rank * hl
    return torch.cat([w[:, z0:z0 + dl], w[:, di + z0:di + z0 + dl],
                      w[:, 2 * di:2 * di + 2 * n],
                      w[:, 2 * di + 2 * n + h0:2 * di + 2 * n + h0 + hl]], 1)


def _split_proj(p, x, cfg, tp: TPShard = NO_TP):
    """in_proj -> (z gate [.., d_inner], x [.., d_inner], B [.., N],
    C [.., N], dt [.., H]); under a split of ``tp`` z, x and dt are the
    rank's channels and heads."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    if tp.size == 1:
        zxbcdt = x @ p["in_proj"]
    else:
        zxbcdt = x @ _rank_in_proj(p["in_proj"], cfg, tp)
        di, h = di // tp.size, h // tp.size
    return torch.split(zxbcdt, [di, di, n, n, h], dim=-1)


def _conv1d(xin: torch.Tensor, w: torch.Tensor,
            tail: Optional[torch.Tensor],
            bias: Optional[torch.Tensor] = None):
    """Causal depthwise conv over seq, plus ``bias`` where given, then
    SiLU.  w: [conv_dim, channels].  Returns (y, new_tail)."""
    kdim = w.shape[0]
    if tail is None:
        pad = torch.zeros((xin.shape[0], kdim - 1, xin.shape[2]),
                          dtype=xin.dtype, device=xin.device)
    else:
        pad = tail.to(xin.dtype)
    xp = torch.cat([pad, xin], dim=1)                 # [B, S+k-1, di]
    y = sum(xp[:, i: i + xin.shape[1], :] * w[i] for i in range(kdim))
    if bias is not None:
        y = y + bias
    new_tail = xp[:, xp.shape[1] - (kdim - 1):, :]
    return silu(y), new_tail


def ssd_chunked(
    xin: torch.Tensor,       # [B, S, H, hd]  (post conv+silu, reshaped)
    dt: torch.Tensor,        # [B, S, H]      softplus'd step sizes
    a_log: torch.Tensor,     # [H]            log(-A)
    b: torch.Tensor,         # [B, S, N]
    c: torch.Tensor,         # [B, S, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # [B, H, hd, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward. Returns (y [B,S,H,hd], final_state [B,H,hd,N]).

    What does not depend on the carried state (each chunk's dual term
    and its own contribution to the state) is computed for every chunk
    at once; the Python loop over the chunks carries the state alone,
    two operations a chunk."""
    bsz, s, h, hd = xin.shape
    n = b.shape[-1]
    nc = (s + chunk - 1) // chunk
    pad = nc * chunk - s
    if pad:
        xin = F.pad(xin, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    a = -torch.exp(a_log.float())                              # [H], a < 0
    dt32 = dt.float()
    da = dt32 * a[None, None, :]                               # [B, S', H]
    xin_c = xin.reshape(bsz, nc, chunk, h, hd)
    dt_c = dt32.reshape(bsz, nc, chunk, h)
    da_c = da.reshape(bsz, nc, chunk, h)
    b_c = b.reshape(bsz, nc, chunk, n).float()
    c_c = c.reshape(bsz, nc, chunk, n).float()

    cum = torch.cumsum(da_c, dim=2)                            # [B,nc,L,H]
    seg_total = cum[:, :, -1, :]                               # [B,nc,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xin.device))
    # intra-chunk dual (attention-like) term
    # L[s,t] = exp(cum[s] - cum[t]) for s >= t
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [B,nc,L,L,H]
    # mask BEFORE exp: exp of the (large positive) acausal entries
    # overflows to inf, and inf * 0 is NaN
    rel = torch.where(causal[None, None, :, :, None], rel, -1e30)
    gamma = torch.exp(rel)
    cb = torch.einsum("bcln,bctn->bclt", c_c, b_c)             # [B,nc,L,L]
    w = cb[..., None] * gamma                                  # [B,nc,L,L,H]
    xdt = xin_c.float() * dt_c[..., None]                      # [B,nc,L,H,hd]
    y_intra = torch.einsum("bclth,bcthd->bclhd", w, xdt)
    # each chunk's own state: sum_t exp(tot-cum_t) * x_t dt_t b_t^T
    decay_out = torch.exp(seg_total[:, :, None, :] - cum)      # [B,nc,L,H]
    ds = torch.einsum("bclh,bclhd,bcln->bchdn", decay_out, xdt, b_c)
    # inter-chunk: the state carried into each chunk,
    # state' = exp(tot) * state + ds
    state = (init_state if init_state is not None
             else torch.zeros((bsz, h, hd, n), dtype=torch.float32,
                              device=xin.device))
    decay_tot = torch.exp(seg_total)[:, :, :, None, None]      # [B,nc,H,1,1]
    entering = []
    for i in range(nc):
        entering.append(state)
        state = decay_tot[:, i] * state + ds[:, i]
    decay_in = torch.exp(cum)                                  # [B,nc,L,H]
    y_inter = torch.einsum("bcln,bchdn,bclh->bclhd", c_c,
                           torch.stack(entering, dim=1), decay_in)
    y = (y_intra + y_inter).reshape(bsz, nc * chunk, h, hd)[:, :s]
    return y.to(xin.dtype), state


def ssm_apply(
    p: dict,
    x: torch.Tensor,            # [B, S, d_model]
    cfg,
    state: Optional[SSMState] = None,
    tp: TPShard = NO_TP,
) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full Mamba2 mixer.  With ``state`` the call is incremental
    (prefill appends S tokens; decode S=1) and returns the new state.
    Under a tensor-parallel split ``tp`` (``ssm_split``) the rank
    computes its heads from the whole ``in_proj`` (``_rank_in_proj``)
    and its chunks of the other leaves, ``x`` entering through
    ``region_in`` and the partial output summed by ``region_out``; a
    ``state`` is then the rank's heads of ``state`` and its channels of
    ``conv``, and so is the state returned."""
    bsz, s, _ = x.shape
    split = ssm_split(cfg, tp.size)
    if split is None:
        tp = NO_TP
    else:
        x = tp.region_in(x)
    di, h = cfg.d_inner // tp.size, cfg.ssm_heads // tp.size
    z, xin, b, c, dt = _split_proj(p, x, cfg, tp)
    xin = shard_constraint(xin, "batch", "seq", "d_inner")
    xin, new_conv = _conv1d(xin, tp.part(p["conv_w"], 1, cfg.d_inner),
                            state.conv if state is not None else None)
    dt = softplus(dt + tp.part(p["dt_bias"], 0, cfg.ssm_heads))
    hd = cfg.ssm_head_dim
    xin_h = xin.reshape(bsz, s, h, hd)
    y, new_state = ssd_chunked(
        xin_h, dt, tp.part(p["a_log"], 0, cfg.ssm_heads), b, c,
        cfg.ssm_chunk, init_state=state.state if state is not None else None)
    y = y + xin_h * tp.part(p["d_skip"], 0, cfg.ssm_heads)[None, None, :,
                                                          None]
    y = y.reshape(bsz, s, di)
    y = y * silu(z)                            # gated output
    out = tp.region_out(y @ tp.part(p["out_proj"], 0, cfg.d_inner))
    if state is not None:
        return out, SSMState(new_state, new_conv)
    return out, None


def mamba2_apply(
    p: dict,
    x: torch.Tensor,            # [B, S, d_model], normed
    cfg,
    state: Optional[SSMState] = None,
) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """The published Mamba2 mixer (mamba_ssm's ``Mamba2``; Granite
    4.0-H's ``GraniteMoeHybridMambaLayer``): ``in_proj`` to the gate z,
    xBC and dt; the causal depthwise conv over xBC (``conv_w`` [k,
    ``cfg.conv_width``]) with its bias ``conv_b``, then SiLU; x, B, C
    split from it (one group); dt = softplus(dt + ``dt_bias``), no
    clamp; A = -exp(``a_log``); the SSD scan (``ssd_chunked``, in
    float32) plus D x; the gated RMSNorm rms(y silu(z)) ``norm`` over
    all ``d_inner`` channels, in float32; ``out_proj``.  With ``state``
    the call is incremental (prefill appends S tokens, decode S = 1):
    ``state.conv`` [B, k-1, conv_width] holds the last xBC inputs of the
    conv, and the new state is returned.  The scan runs in an
    ``ssm.scan`` span."""
    bsz, s, _ = x.shape
    di, h, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    z, xbc, dt = torch.split(x @ p["in_proj"], [di, cfg.conv_width, h],
                             dim=-1)
    xbc, new_conv = _conv1d(xbc, p["conv_w"],
                            state.conv if state is not None else None,
                            bias=p["conv_b"])
    xin, b, c = torch.split(xbc, [di, n, n], dim=-1)
    dt = softplus(dt + p["dt_bias"])
    xin_h = xin.reshape(bsz, s, h, cfg.ssm_head_dim)
    with span("ssm.scan"):
        y, new_state = ssd_chunked(
            xin_h, dt, p["a_log"], b, c, cfg.ssm_chunk,
            init_state=state.state if state is not None else None)
    y = y + xin_h * p["d_skip"][None, None, :, None]
    g = y.reshape(bsz, s, di).float() * silu(z.float())
    out = rms_norm(g, p["norm"], cfg.norm_eps).to(x.dtype) @ p["out_proj"]
    if state is not None:
        return out, SSMState(new_state, new_conv)
    return out, None
