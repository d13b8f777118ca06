"""Serving driver: batched prefill + decode with a KV/SSM cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --batch 4 --prompt-len 64 --gen 32            # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --smoke --device cpu

``serve`` is the body: parameters (drawn from a ``torch.Generator`` or
given), random prompts, one prefill, then greedy (or sampled) decode
steps.  The device is synchronised before every clock read, so each
wall covers the device work it names.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor         # [B, gen] generated token ids (CPU)
    prompts: torch.Tensor        # [B, prompt_len] the prompts (CPU)
    prefill_s: float             # wall of the prefill
    step_s: List[float]          # wall of each decode step, sampling included

    @property
    def decode_s(self) -> float:
        return sum(self.step_s)

    @property
    def tokens_per_s(self) -> float:
        """Decoded tokens a second over the decode steps (the batch's
        rows count one token each a step)."""
        return self.tokens.shape[0] * len(self.step_s) / max(self.decode_s, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _next_token(logits: torch.Tensor, temperature: float,
                generator: torch.Generator) -> torch.Tensor:
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(logits, dim=-1)[:, None]


def serve(cfg: ModelConfig, batch: int, prompt_len: int, gen: int, *,
          device: "torch.device | str | None" = None,
          generator: Optional[torch.Generator] = None,
          temperature: float = 0.0,
          params: Optional[dict] = None) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and
    generate ``gen`` tokens each, on ``device`` (CUDA unless named).
    ``generator`` (seed 0 on the device when None) draws the parameters
    (unless ``params`` are given), the prompts, the stub encoder inputs
    and the samples."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    max_len = prompt_len + gen + 8
    cfg = dataclasses.replace(cfg, max_seq_len=max(cfg.max_seq_len, max_len))
    if params is None:
        params = M.init_params(cfg, generator, dev)
    gdev = generator.device
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=generator, device=gdev).to(dev)
    enc = None
    if cfg.is_encdec:
        frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                             generator=generator, device=gdev).to(dev)
        enc = M.encode(params, frames, cfg)
    elif cfg.family == "vlm":
        enc = torch.randn((batch, cfg.vision_tokens, cfg.d_model),
                          generator=generator, device=gdev).to(dev)

    state = M.init_decode_state(cfg, batch, max_len, enc=enc, device=dev)
    prefill_fn = make_prefill_step(cfg)
    decode_fn = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill_fn(params, prompts, state)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    tok = _next_token(logits, temperature, generator)
    out_tokens = [tok]
    step_s = []
    for _ in range(gen - 1):
        t0 = time.perf_counter()
        logits, state = decode_fn(params, tok, state)
        tok = _next_token(logits, temperature, generator)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        out_tokens.append(tok)
    return ServeResult(tokens=torch.cat(out_tokens, dim=1).cpu(),
                       prompts=prompts.cpu(), prefill_s=prefill_s,
                       step_s=step_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    res = serve(cfg, args.batch, args.prompt_len, args.gen,
                device=args.device, temperature=args.temperature)
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prefill {args.prompt_len} tok in {res.prefill_s*1e3:.0f}ms; "
          f"decode {args.gen} tok in {res.decode_s*1e3:.0f}ms "
          f"({res.tokens_per_s:.0f} tok/s)")
    print(f"[serve] first sequence: {res.tokens[0][:16].tolist()} ...")


if __name__ == "__main__":
    main()
