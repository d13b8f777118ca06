"""``repro_torch.launch.serve`` on the CPU against the JAX package's
serving loop: the reference's parameters carried over, the port's
prompts handed to the reference, the reference's prefill and decode
steps jitted as its ``launch/serve.py`` jits them, and greedy tokens
equal, token for token (fp32 policy, dense and SSM).  Also the walls'
bookkeeping, the sampled path's repeatability from one generator, and
the command line."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import FP32, carried_params, configs
from repro.launch.steps import make_decode_step as jdecode_step
from repro.launch.steps import make_prefill_step as jprefill_step
from repro.models import model as JM
from repro_torch.launch import serve as tserve


def _reference_greedy(jc, jp, prompts: np.ndarray, gen: int) -> np.ndarray:
    state = JM.init_decode_state(jc, prompts.shape[0],
                                 prompts.shape[1] + gen + 8)
    prefill_fn = jax.jit(jprefill_step(jc))
    decode_fn = jax.jit(jdecode_step(jc))
    logits, state = prefill_fn(jp, jnp.asarray(prompts), state)
    tok = jnp.argmax(logits, axis=-1)[:, None]
    out = [tok]
    for _ in range(gen - 1):
        logits, state = decode_fn(jp, tok, state)
        tok = jnp.argmax(logits, axis=-1)[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_780m"])
def test_serve_greedy_tokens_equal_reference(arch):
    jc, tc = configs(arch, FP32)
    jp, tp = carried_params(jc, tc, seed=0)
    res = tserve.serve(tc, 3, 16, 10, device="cpu", params=tp,
                       generator=torch.Generator().manual_seed(1))
    assert res.tokens.shape == (3, 10) and res.prompts.shape == (3, 16)
    want = _reference_greedy(jc, jp, res.prompts.numpy().astype(np.int32), 10)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert len(res.step_s) == 9 and res.prefill_s > 0
    assert res.decode_s == pytest.approx(sum(res.step_s))
    assert res.tokens_per_s == pytest.approx(3 * 9 / res.decode_s)


def test_serve_draws_everything_from_its_generator():
    _, tc = configs("hymba_1_5b")
    runs = [tserve.serve(tc, 2, 8, 5, device="cpu", temperature=1.0,
                         generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(runs[0].prompts, runs[1].prompts)
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    other = tserve.serve(tc, 2, 8, 5, device="cpu", temperature=1.0,
                         generator=torch.Generator().manual_seed(5))
    assert not torch.equal(other.prompts, runs[0].prompts)


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b"])
def test_serve_command_line_on_the_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "6", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] arch=" in out and "tok/s" in out
    assert "first sequence" in out
