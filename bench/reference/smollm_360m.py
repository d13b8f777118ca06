"""Plain float32 reference of SmolLM-360M (the Llama architecture), from
its published description: token embedding; per layer RMSNorm, GQA
self-attention with rotary position embeddings (rotate-half layout,
theta from the config) and a causal mask, a residual, RMSNorm, a
SwiGLU MLP and a residual; a final RMSNorm; the head tied to the
embedding.  Weights are ``x @ w`` matrices ([in, out]) stacked over
the layers, as the benchmark makes them:

  embed [V, d], final_norm [d], layers.norm1 / layers.norm2 [L, d],
  layers.wq [L, d, H*hd], layers.wk / layers.wv [L, d, KH*hd],
  layers.wo [L, H*hd, d], layers.w_gate / layers.w_up [L, d, ff],
  layers.w_down [L, ff, d].

Query head h reads key/value head h // (H / KH).  No bias, no
dropout.  Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from bench.reference import common as C


class Model:
    def __init__(self, sizes: dict, weights: Dict[str, torch.Tensor],
                 precision: str = "fp32"):
        self.w = weights
        self.p = precision
        self.n_layers = sizes["num_hidden_layers"]
        self.heads = sizes["num_attention_heads"]
        self.kv_heads = sizes["num_key_value_heads"]
        self.head_dim = sizes["hidden_size"] // self.heads \
            if "head_dim" not in sizes else sizes["head_dim"]
        self.eps = sizes["rms_norm_eps"]
        self.theta = sizes["rope_theta"]

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        hd = x.shape[-1]
        inv = 1.0 / (self.theta ** (torch.arange(0, hd, 2, device=x.device,
                                                 dtype=torch.float32) / hd))
        ang = pos[:, None].float() * inv[None, :]            # [S, hd/2]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def _layers(self, tokens: torch.Tensor, want_kv: bool):
        w, p = self.w, self.p
        b, s = tokens.shape
        h, kh, hd = self.heads, self.kv_heads, self.head_dim
        g = h // kh
        pos = torch.arange(s, device=tokens.device)
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=tokens.device).tril()
        x = w["embed"][tokens]
        ks, vs = [], []
        for i in range(self.n_layers):
            a = C.rms_norm(x, w["layers.norm1"][i], self.eps)
            q = C.mm(a, w["layers.wq"][i], p).view(b, s, h, hd)
            k = C.mm(a, w["layers.wk"][i], p).view(b, s, kh, hd)
            v = C.mm(a, w["layers.wv"][i], p).view(b, s, kh, hd)
            q, k = self._rope(q, pos), self._rope(k, pos)
            if want_kv:
                ks.append(k.detach())
                vs.append(v.detach())
            kk = k.repeat_interleave(g, dim=2)
            vv = v.repeat_interleave(g, dim=2)
            sc = C.einsum("bshd,bthd->bhst", q, kk, precision=p) \
                / math.sqrt(hd)
            sc = sc.masked_fill(~causal, float("-inf"))
            att = torch.softmax(sc, dim=-1)
            o = C.einsum("bhst,bthd->bshd", att, vv, precision=p)
            x = x + C.mm(o.reshape(b, s, h * hd), w["layers.wo"][i], p)
            a = C.rms_norm(x, w["layers.norm2"][i], self.eps)
            f = C.silu(C.mm(a, w["layers.w_gate"][i], p)) \
                * C.mm(a, w["layers.w_up"][i], p)
            x = x + C.mm(f, w["layers.w_down"][i], p)
        x = C.rms_norm(x, w["final_norm"], self.eps)
        kv = (torch.stack(ks), torch.stack(vs)) if want_kv else None
        return x, kv

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return C.mm(x, self.w["embed"].t(), self.p)

    def nll_sum(self, tokens: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
        x, _ = self._layers(tokens, False)
        return C.nll_sum(self.logits(x), labels)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, want_state: bool = False):
        """(last position's logits [B, V], state or None): the state is
        {"k", "v"}, each [L, B, S, KH, hd], keys after the rotation."""
        x, kv = self._layers(tokens, want_state)
        state: Optional[dict] = None
        if want_state:
            state = {"k": kv[0], "v": kv[1]}
        return self.logits(x[:, -1]), state
