"""Plain float32 reference of IBM's Granite 4.0-H Micro, from its
published configuration and modeling code (``granitemoehybrid``, with no
experts).  Token embedding times ``embedding_multiplier``; per layer,
by ``layer_types``, a Mamba2 or a self-attention mixer on the RMS-normed
stream, its output times ``residual_multiplier`` added to the stream,
then a SwiGLU MLP on the RMS-normed stream, its output likewise scaled
and added; a final RMSNorm; the head tied to the embedding, divided by
``logits_scaling``.

  * Attention: GQA (query head h reads key/value head h // (H / KH)),
    head size hidden / heads, no position embedding (``nope``), scores
    times ``attention_multiplier``, causal softmax; computed a block of
    ``QUERY_BLOCK`` queries at a time so that long prompts fit.
  * Mamba2: ``in_proj`` to [z | xBC | dt]; a causal depthwise conv of
    width ``mamba_d_conv`` over xBC with its bias, then SiLU; x, B, C
    split from it (``mamba_n_groups`` groups of B and C, head h reading
    group h // (heads / groups)); dt = softplus(dt + dt_bias), no clamp;
    A = -exp(A_log); the SSD scan of the SSD paper's minimal listing
    (arXiv:2405.21060, Listing 1) at this file's own chunk length
    ``block``; plus D x; the gated RMSNorm rms(y silu(z)) times its
    weight over all ``d_inner`` channels; ``out_proj``.

Weights are ``x @ w`` matrices ([in, out]), stacked over the layers of
their kind, as the benchmark makes them:

  embed [V, d], final_norm [d],
  layers.norm1 / layers.norm2 [L, d], layers.w_gate / layers.w_up
  [L, d, ff], layers.w_down [L, ff, d] (every layer);
  attn.wq [La, d, H*hd], attn.wk / attn.wv [La, d, KH*hd],
  attn.wo [La, H*hd, d] (the attention layers, in order);
  mamba.in_proj [Lm, d, di + cw + H], mamba.conv_w [Lm, k, cw],
  mamba.conv_b [Lm, cw], mamba.dt_bias / mamba.a_log / mamba.d_skip
  [Lm, H], mamba.norm [Lm, di], mamba.out_proj [Lm, di, d] (the Mamba2
  layers, in order), cw = di + 2 G N the convolved channels.

Departures from the modeling code: float32 throughout (the modeling
code keeps the checkpoint's bfloat16 outside the scan and the norms);
the gated norm multiplies by its weight in float32 before any rounding;
the MLP's ``input_linear`` is two matrices, ``w_gate`` and ``w_up`` (its
two halves, in that order); the conv state is the last k - 1 xBC inputs
(the modeling code keeps k, the oldest of which no later step reads);
no padding mask (every prompt of a batch has the batch's length); no
dropout.  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from bench.reference import common as C

QUERY_BLOCK = 1024
SSD_BLOCK = 64


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Listing 1's segsum: [..., T] -> [..., T, T], entry (i, j) the sum
    of x[j+1 .. i] for j <= i, -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd(x, a, b, c, block: int, precision: str = "fp32",
        initial_state: Optional[torch.Tensor] = None):
    """Listing 1 (``ssd_minimal_discrete``): x [B, T, H, P] (already
    times dt), a [B, T, H] (A dt), b and c [B, T, H, N]; T a multiple of
    ``block``.  Returns (y [B, T, H, P], the final state [B, H, P, N])."""
    bsz, t, h, p = x.shape
    nc = t // block

    def chunks(u):
        return u.reshape(bsz, nc, block, *u.shape[2:])

    x, a, b, c = chunks(x), chunks(a), chunks(b), chunks(c)
    a = a.permute(0, 3, 1, 2)                            # b h c l
    a_cum = torch.cumsum(a, dim=-1)
    ell = torch.exp(segsum(a))                           # b h c l s
    y_diag = C.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", c, b, ell, x,
                      precision=precision)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)
    states = C.einsum("bclhn,bhcl,bclhp->bchpn", b, decay_states, x,
                      precision=precision)
    if initial_state is None:
        initial_state = torch.zeros_like(states[:, :1])
    else:
        initial_state = initial_state[:, None]
    states = torch.cat([initial_state, states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    new_states = C.einsum("bhzc,bchpn->bzhpn", decay_chunk, states,
                          precision=precision)
    states, final = new_states[:, :-1], new_states[:, -1]
    y_off = C.einsum("bclhn,bchpn,bhcl->bclhp", c, states, torch.exp(a_cum),
                     precision=precision)
    return (y_diag + y_off).reshape(bsz, t, h, p), final


class Model:
    def __init__(self, sizes: dict, weights: Dict[str, torch.Tensor],
                 precision: str = "fp32", block: int = SSD_BLOCK):
        self.w = weights
        self.p = precision
        self.block = block
        self.kinds = list(sizes["layer_types"])
        self.d = sizes["hidden_size"]
        self.heads = sizes["num_attention_heads"]
        self.kv_heads = sizes["num_key_value_heads"]
        self.head_dim = self.d // self.heads
        self.eps = sizes["rms_norm_eps"]
        self.emb_mult = sizes["embedding_multiplier"]
        self.res_mult = sizes["residual_multiplier"]
        self.logits_scaling = sizes["logits_scaling"]
        self.attn_scale = sizes["attention_multiplier"]
        self.m_heads = sizes["mamba_n_heads"]
        self.m_head_dim = sizes["mamba_d_head"]
        self.d_inner = sizes["mamba_expand"] * self.d
        self.n_state = sizes["mamba_d_state"]
        self.groups = sizes["mamba_n_groups"]
        self.k_conv = sizes["mamba_d_conv"]
        if sizes["position_embedding_type"] != "nope":
            raise ValueError("the reference has no position embedding")

    def _attention(self, a: torch.Tensor, j: int):
        w, p = self.w, self.p
        bsz, s, _ = a.shape
        h, kh, hd = self.heads, self.kv_heads, self.head_dim
        q = C.operand(C.mm(a, w["attn.wq"][j], p).view(bsz, s, h, hd), p)
        k = C.mm(a, w["attn.wk"][j], p).view(bsz, s, kh, hd)
        v = C.mm(a, w["attn.wv"][j], p).view(bsz, s, kh, hd)
        kk = C.operand(k.repeat_interleave(h // kh, dim=2), p)
        vv = C.operand(v.repeat_interleave(h // kh, dim=2), p)
        out = torch.empty_like(q)
        for q0 in range(0, s, QUERY_BLOCK):
            q1 = min(s, q0 + QUERY_BLOCK)
            sc = torch.einsum("bshd,bthd->bhst", q[:, q0:q1],
                              kk[:, :q1]) * self.attn_scale
            qpos = torch.arange(q0, q1, device=a.device)[:, None]
            kpos = torch.arange(q1, device=a.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, float("-inf"))
            att = C.operand(torch.softmax(sc, dim=-1), p)
            out[:, q0:q1] = torch.einsum("bhst,bthd->bshd", att, vv[:, :q1])
        y = C.mm(out.reshape(bsz, s, h * hd), w["attn.wo"][j], p)
        return y, k, v

    def _mamba(self, a: torch.Tensor, j: int):
        w, p = self.w, self.p
        bsz, s, _ = a.shape
        di, n, g, hh, hp = (self.d_inner, self.n_state, self.groups,
                            self.m_heads, self.m_head_dim)
        cw = di + 2 * g * n
        zxbcdt = C.mm(a, w["mamba.in_proj"][j], p)
        z, xbc, dt = torch.split(zxbcdt, [di, cw, hh], dim=-1)
        k = self.k_conv
        xp = F.pad(xbc, (0, 0, k - 1, 0))
        conv = w["mamba.conv_b"][j] + sum(
            xp[:, i:i + s] * w["mamba.conv_w"][j, i] for i in range(k))
        x, b, c = torch.split(C.silu(conv), [di, g * n, g * n], dim=-1)
        dt = F.softplus(dt + w["mamba.dt_bias"][j])
        big_a = -torch.exp(w["mamba.a_log"][j])
        x = x.reshape(bsz, s, hh, hp)
        b = b.reshape(bsz, s, g, n).repeat_interleave(hh // g, dim=2)
        c = c.reshape(bsz, s, g, n).repeat_interleave(hh // g, dim=2)
        pad = (-s) % self.block

        def padded(u):
            return F.pad(u, (0, 0) * (u.dim() - 2) + (0, pad))

        y, state = ssd(padded(x * dt[..., None]), padded(big_a * dt),
                       padded(b), padded(c), self.block, p)
        y = y[:, :s] + w["mamba.d_skip"][j][:, None] * x
        gate = y.reshape(bsz, s, di) * C.silu(z)
        gate = C.rms_norm(gate, w["mamba.norm"][j], self.eps)
        tail = F.pad(xbc, (0, 0, max(0, k - 1 - s), 0))[:, -(k - 1):]
        return C.mm(gate, w["mamba.out_proj"][j], p), state, tail

    def _layers(self, tokens: torch.Tensor, want_state: bool):
        w, p, r = self.w, self.p, self.res_mult
        x = w["embed"][tokens] * self.emb_mult
        st: Dict[str, list] = {"k": [], "v": [], "ssm": [], "conv": []}
        ja = jm = 0
        for i, kind in enumerate(self.kinds):
            a = C.rms_norm(x, w["layers.norm1"][i], self.eps)
            if kind == "attention":
                y, k, v = self._attention(a, ja)
                ja += 1
                parts = {"k": k, "v": v}
            else:
                y, ssm, conv = self._mamba(a, jm)
                jm += 1
                parts = {"ssm": ssm, "conv": conv}
            if want_state:
                for key, t in parts.items():
                    st[key].append(t.detach())
            x = x + r * y
            a = C.rms_norm(x, w["layers.norm2"][i], self.eps)
            f = C.silu(C.mm(a, w["layers.w_gate"][i], p)) \
                * C.mm(a, w["layers.w_up"][i], p)
            x = x + r * C.mm(f, w["layers.w_down"][i], p)
        x = C.rms_norm(x, w["final_norm"], self.eps)
        state = {k: torch.stack(v) for k, v in st.items()} \
            if want_state else None
        return x, state

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return C.mm(x, self.w["embed"].t(), self.p) / self.logits_scaling

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Every position's logits [B, S, V]."""
        x, _ = self._layers(tokens, False)
        return self.logits(x)

    def nll_sum(self, tokens: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
        return C.nll_sum(self.forward(tokens), labels)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, want_state: bool = False):
        """(last position's logits [B, V], state or None): the state is
        {"k", "v"} [La, B, S, KH, hd], {"ssm"} [Lm, B, H, P, N] (the
        scan's final state) and {"conv"} [Lm, B, k - 1, cw] (the last
        xBC inputs of the conv)."""
        x, state = self._layers(tokens, want_state)
        return self.logits(x[:, -1]), state
