"""The model flops that ``mfu`` counts: the configurations' formulas
against hand counts at the tests' sizes, from the shapes alone."""
import dataclasses

import pytest

from benchtest import ctx
from bench.lib import core, spec


def test_smollm_formula_is_the_hand_count():
    cfg = spec.config_module("smollm-360m")
    s = cfg.sizes(True)      # L 2, d 64, H 4, KH 2, hd 16, ff 128, V 256
    per_layer = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128
    n = 2 * per_layer + 64 * 256
    assert cfg.train_flops_per_token(s, 32) == 6 * n + 6 * 2 * 64 * 32
    body = 2 * per_layer
    assert cfg.prefill_flops(s, 20) == (2 * body * 20 + 2 * 64 * 256
                                        + 2 * 2 * 64 * 20 * 20)


def test_published_sizes():
    sm = spec.config_module("smollm-360m")
    assert sm.train_flops_per_token(sm.sizes(), 2048) == pytest.approx(
        2.548e9, rel=1e-3)


@pytest.mark.parametrize("cell", ["smollm-360m.train"])
def test_mfu_ignores_remat_and_attention_implementation(cell, monkeypatch):
    drv = spec.driver_module("train")
    seen = []
    for remat, attn in (("none", "dense"), ("full", "chunked"),
                        ("selective", "dense")):
        cx = ctx(cell)
        base = cx.config.port_config

        def patched(smoke=False, base=base, remat=remat, attn=attn):
            return dataclasses.replace(base(smoke), remat=remat,
                                       attn_impl=attn)
        monkeypatch.setattr(cx.config, "port_config", patched)
        prog = drv.Program(cx)
        run = core.Run(cell=cell, kind="train")
        prog.window(run, 0.0)
        prog.close()
        seen.append(run.model_flops / run.units)
        monkeypatch.undo()
    assert seen[0] == seen[1] == seen[2]
