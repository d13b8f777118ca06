"""A whole run at the tests' sizes, the look for a GPU skipped: sound,
it comes out correct; with the timed path broken underneath, not."""
import pytest
import torch

from benchtest import PREFILL, TRAIN, execute


def _wrap_train(monkeypatch, fault, after=0):
    """The train step with ``fault`` from its ``after``-th call on (a
    fault that the check's first steps do not see, where ``after`` is
    their number)."""
    from repro_torch.launch import steps
    real = steps.make_train_step

    def make(cfg, opt_cfg, **kw):
        step = real(cfg, opt_cfg, **kw)
        calls = [0]

        def faulty(params, opt_state, batch):
            calls[0] += 1
            if calls[0] <= after:
                return step(params, opt_state, batch)
            if fault == "unchanged":
                _, _, met = step(params, opt_state, batch)
                return params, opt_state, met
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(params, opt_state, half)
        return faulty
    monkeypatch.setattr(steps, "make_train_step", make)


def _wrap_prefill(monkeypatch, fault):
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    real = steps.make_prefill_step

    def make(cfg, mesh=None):
        step = real(cfg, mesh)

        def faulty(params, tokens, state):
            if fault == "token":
                logits, st = step(params, tokens, state)
                return logits.roll(1, dims=-1), st
            if fault == "cache":
                fresh = M.init_decode_state(cfg, tokens.shape[0],
                                            tokens.shape[1],
                                            device=tokens.device)
                logits, st = step(params, tokens, fresh)
                return logits, state._replace(pos=st.pos, length=st.length)
            n = max(1, tokens.shape[0] // 2)
            part = M.init_decode_state(cfg, n, tokens.shape[1],
                                       device=tokens.device)
            logits, st = step(params, tokens[:n], part)
            for mine, got in ((state.kv, st.kv), (state.ssm, st.ssm)):
                for a, b in zip(mine or (), got or ()):
                    a[:, :n] = b
            out = torch.zeros((tokens.shape[0], logits.shape[1]),
                              dtype=logits.dtype)
            out[:n] = logits
            return out, state._replace(pos=st.pos, length=st.length)
        return faulty
    monkeypatch.setattr(steps, "make_prefill_step", make)


@pytest.mark.parametrize("cell", TRAIN + PREFILL)
def test_a_sound_run_is_correct(cell, tmp_path):
    result, checks = execute(cell, tmp_path)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_train_step_is_not_correct(cell, fault, tmp_path,
                                            monkeypatch):
    _wrap_train(monkeypatch, fault)
    result, checks = execute(cell, tmp_path)
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_broken_after_set_up_is_not_correct(cell, fault, tmp_path,
                                                   monkeypatch):
    from benchtest import ctx
    _wrap_train(monkeypatch, fault, after=ctx(cell).traffic["check_steps"])
    result, checks = execute(cell, tmp_path)
    assert not result["correct"], checks
    late = [k for k, v in checks.items() if k.startswith("late_")
            and not v["value"] <= v["limit"]]
    assert late, checks


@pytest.mark.parametrize("fault", ["token", "half_batch", "cache"])
@pytest.mark.parametrize("cell", PREFILL)
def test_a_broken_prefill_is_not_correct(cell, fault, tmp_path,
                                         monkeypatch):
    _wrap_prefill(monkeypatch, fault)
    result, checks = execute(cell, tmp_path)
    assert not result["correct"], checks
