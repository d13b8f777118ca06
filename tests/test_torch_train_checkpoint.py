"""The port's checkpoints on the JAX package's layout.

A ``(params, opt_state)`` tree written by the JAX package's
``save_checkpoint`` restores in the port, and the port's restores in
the JAX package, bit for bit, with fp32, int8 (q8 codes) and int32 (the
step) leaves; bf16 leaves round-trip in the port bit for bit and are
written as the reference writes them (``|V2`` words, "bfloat16" in the
manifest).  Then the cases of ``tests/test_runtime.py``'s checkpoint
tests on the port: round trip, atomic commit, async writes with
``wait()`` and ``keep`` retention, chunked large leaves, a shape
mismatch that raises; and the CPU training driver run twice on one
directory, the second run resuming from the first's last step."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import configs
from repro.checkpoint import manager as JC
from repro.models import model as JM
from repro.optimizer import adamw as JA
from repro_torch.checkpoint import manager as TC
from repro_torch.models import model as TM
from repro_torch.optimizer import adamw as TA
from repro_torch.utils.trees import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_state(state_dtype: str):
    """The reference's (params, opt_state) of a 2-layer smollm after one
    update, with ``state_dtype`` moments."""
    jc, tc = configs("smollm_360m")
    jp = JM.init_params(jc, jax.random.PRNGKey(3))
    cfg = JA.AdamWConfig(state_dtype=state_dtype)
    grads = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.02), jp)
    jp, js, _ = jax.jit(JA.adamw_update, static_argnums=3)(
        jp, grads, jax.jit(JA.adamw_init, static_argnums=1)(jp, cfg), cfg)
    return tc, (jp, js)


def _port_like(tc, state_dtype: str):
    params = TM.init_stacked_params(tc, torch.Generator().manual_seed(9), "cpu")
    return params, TA.adamw_init(params, TA.AdamWConfig(state_dtype=state_dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("state_dtype", ["float32", "q8"])
def test_reference_checkpoint_restores_in_port(tmp_path, state_dtype):
    tc, jstate = _jax_state(state_dtype)
    JC.save_checkpoint(str(tmp_path), 7, jstate)
    like = _port_like(tc, state_dtype)
    assert TC.latest_step(str(tmp_path)) == 7
    got = TC.restore_checkpoint(str(tmp_path), 7, like)
    want = jax.tree_util.tree_leaves(jstate)
    leaves = tree_leaves(got)
    assert len(leaves) == len(want)
    dtypes = set()
    for g, w in zip(leaves, want):
        assert g.dtype == getattr(torch, str(np.asarray(w).dtype))
        np.testing.assert_array_equal(_np(g), np.asarray(w))
        dtypes.add(str(g.dtype))
    assert "torch.int32" in dtypes
    assert ("torch.int8" in dtypes) == (state_dtype == "q8")
    assert isinstance(got[1], TA.OptState) and int(got[1].step) == 1


@pytest.mark.parametrize("state_dtype", ["float32", "q8"])
def test_port_checkpoint_restores_in_reference(tmp_path, state_dtype):
    tc, jstate = _jax_state(state_dtype)
    tstate = TM.train_state_from_arrays(
        tc, *jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    mgr = TC.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(3, tstate)
    _, fresh = _jax_state(state_dtype)
    got = JC.restore_checkpoint(str(tmp_path), 3, fresh)
    for g, w in zip(jax.tree_util.tree_leaves(got), tree_leaves(tstate)):
        assert np.asarray(g).dtype == _np(w).dtype
        np.testing.assert_array_equal(np.asarray(g), _np(w))


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    _, tc = configs("smollm_360m")
    params, opt = _port_like(tc, "bfloat16")
    gen = torch.Generator().manual_seed(1)
    m = {k: torch.randn(v.shape, generator=gen).to(torch.bfloat16)
         for k, v in opt.m.items() if isinstance(v, torch.Tensor)}
    tree = {"p": params["tok_emb"].to(torch.bfloat16), "m": m,
            "opt": opt}
    TC.save_checkpoint(str(tmp_path), 1, tree)
    back = TC.restore_checkpoint(str(tmp_path), 1, tree)
    for g, w in zip(tree_leaves(back), tree_leaves(tree)):
        assert g.dtype == w.dtype
        if w.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w)
    with open(os.path.join(tmp_path, "step_1", "manifest.json")) as f:
        manifest = json.load(f)
    assert {e["dtype"] for e in manifest["leaves"]} == {"bfloat16", "int32"}
    raw = np.load(os.path.join(tmp_path, "step_1", "leaf_0_chunk_0.npy"))
    assert raw.dtype == np.dtype("V2")


def test_bf16_written_by_reference_restores(tmp_path):
    """The reference's bf16 leaf (ml_dtypes) restores as the same
    16-bit words."""
    x = jax.random.normal(jax.random.PRNGKey(0), (33, 8)).astype(jnp.bfloat16)
    JC.save_checkpoint(str(tmp_path), 2, {"m": x})
    got = TC.restore_checkpoint(str(tmp_path), 2,
                                {"m": torch.zeros((33, 8), dtype=torch.bfloat16)})
    want = np.asarray(x).view(np.int16)
    np.testing.assert_array_equal(got["m"].view(torch.int16).numpy(), want)


def test_checkpoint_roundtrip_and_atomic_commit(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4))}}
    path = TC.save_checkpoint(str(tmp_path), 5, tree)
    assert path == os.path.join(str(tmp_path), "step_5")
    assert TC.latest_step(str(tmp_path)) == 5
    restored = TC.restore_checkpoint(str(tmp_path), 5, tree)
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    # an uncommitted write is invisible
    os.makedirs(os.path.join(tmp_path, "step_9.tmp-deadbeef"))
    assert TC.latest_step(str(tmp_path)) == 5
    assert TC.latest_step(str(tmp_path / "missing")) is None
    # a second save of a step replaces it whole
    TC.save_checkpoint(str(tmp_path), 5, {"a": tree["a"] + 1, "b": tree["b"]})
    again = TC.restore_checkpoint(str(tmp_path), 5, tree)
    assert torch.equal(again["a"], tree["a"] + 1)
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith("step_5.tmp")]


def test_checkpoint_manager_async_and_gc(tmp_path):
    m = TC.CheckpointManager(str(tmp_path), keep=2, async_write=True)
    tree = {"w": torch.zeros((64,))}
    for step in (1, 2, 3, 4):
        m.save(step, tree)
        tree["w"] += 1          # the save snapshotted the tree before
    m.wait()
    assert TC.latest_step(str(tmp_path)) == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_3", "step_4"]
    step, r = m.restore_latest({"w": torch.zeros((64,))})
    assert step == 4 and torch.equal(r["w"], torch.full((64,), 3.0))


def test_checkpoint_chunked_large_leaf(tmp_path):
    big = torch.arange(2 << 20, dtype=torch.float32).reshape(1 << 11, -1)
    TC.save_checkpoint(str(tmp_path), 1, {"big": big}, chunk_elems=1 << 18)
    r = TC.restore_checkpoint(str(tmp_path), 1, {"big": big})
    assert torch.equal(r["big"], big)
    files = os.listdir(os.path.join(tmp_path, "step_1"))
    assert sum(1 for f in files if "chunk" in f) > 1
    # the reference reads the port's chunks
    j = JC.restore_checkpoint(str(tmp_path), 1, {"big": jnp.zeros(big.shape)})
    np.testing.assert_array_equal(np.asarray(j["big"]), big.numpy())


def test_checkpoint_shape_mismatch_raises(tmp_path):
    TC.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros((4,))})
    with pytest.raises(ValueError):
        TC.restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros((5,))})
    with pytest.raises(ValueError):
        TC.restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros((4,)),
                                                 "b": torch.zeros((4,))})


def test_async_write_error_raises_in_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    m = TC.CheckpointManager(str(blocker), async_write=True)
    m.save(1, {"w": torch.zeros(3)})
    with pytest.raises(OSError):
        m.wait()


def _train(ckpt: str, steps: int) -> str:
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "smollm-360m", "--smoke", "--device", "cpu",
           "--steps", str(steps), "--batch", "2", "--seq", "32",
           "--n-docs", "200", "--similarity-prompt", "1", "2", "3",
           "--ckpt-dir", ckpt, "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_train_driver_runs_and_resumes_on_cpu(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _train(ckpt, 4)
    assert "[train] similarity sampling over" in first
    assert "resumed" not in first
    losses = [float(l.split(" loss ")[1].split()[0])
              for l in first.splitlines() if " loss " in l]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert "[train] done: 4 steps" in first
    assert "s waiting for 4 batches" in first
    assert TC.latest_step(ckpt) == 4
    second = _train(ckpt, 6)
    assert "[train] resumed from step 4" in second
    assert "step 3 " not in second and "step 4 " in second
    assert TC.latest_step(ckpt) == 6
