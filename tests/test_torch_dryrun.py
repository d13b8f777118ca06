"""``python -m repro_torch.launch.dryrun`` on the CPU: the smollm-360m
train_4k cell on the (16, 16) mesh (one rank's sharded step on fake
tensors over a fake 256-rank world, tensor-parallel over ``model``:
at most 3.4e13 flops a rank) and a skipped long_500k cell; the
per-device bytes equal the reference's ``NamedSharding.shard_shape``
sums over its abstract leaves; a second run without ``--force`` keeps
the cells written.  The MoE family's llama4-scout train_4k cell runs
expert-parallel with its bytes equal to the reference's as well.
mamba2's train_4k cell splits its SSM over ``model``; the serve cells
of smollm and mamba2 run the sharded prefill and decode steps, each
with a probe of flops, peak bytes and collectives."""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget
from repro.launch import specs as JSP
from repro.launch import steps as JST
from repro.optimizer.adamw import AdamWConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jbytes(shardings, abstract) -> int:
    leaves = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return sum(math.prod(sh.shard_shape(a.shape)) * a.dtype.itemsize
               for sh, a in zip(leaves, jax.tree_util.tree_leaves(abstract)))


def test_dryrun_cells(tmp_path):
    from repro_torch.launch import dryrun
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    argv = ["--arch", "smollm-360m", "--shape", "train_4k", "--multi-pod",
            "single", "--out", str(tmp_path)]
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *argv], env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    cell = json.loads((tmp_path / "smollm_360m__train_4k__single.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["n_devices"] == 256
    jc = jget("smollm-360m")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    mem = cell["memory"]
    assert mem["param_bytes"] == _jbytes(JST.params_shardings(jc, mesh),
                                         JST.abstract_params(jc))
    assert mem["opt_state_bytes"] == _jbytes(
        JST.opt_state_shardings(jc, mesh),
        JST.abstract_opt_state(jc, AdamWConfig()))
    assert cell["microbatches"] == JSP.microbatches_for(jc, "train_4k") == 8
    colls = cell["collectives"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(colls)
    assert all(c["count"] > 0 and c["bytes"] > 0 for c in colls.values())
    assert cell["flops"] > 0 and cell["peak_live_bytes"] > \
        mem["param_bytes"] + mem["opt_state_bytes"]
    assert cell["fits_80gb"] is True
    assert cell["probe"]["units"] == jc.n_layers
    # tensor-parallel over model: the MLPs, the q / o projections, the
    # scores and the logits split 16 ways (the k / v projections stay
    # whole under the query-sequence split); the whole layers read
    # 2.74e14 flops a rank
    assert cell["flops"] <= 3.4e13
    assert {"region-in", "region-out", "seq-all-gather", "max-all-reduce",
            "loss-all-reduce"} <= set(colls)

    # smollm is full attention: its 500k decode cell is skipped
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k",
                        "--multi-pod", "single", "--out", str(tmp_path)]) == 0
    skipped = json.loads((tmp_path / "smollm_360m__long_500k__single.json")
                         .read_text())
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == JSP.cell_is_supported(jc, "long_500k")[1]
    # resumable: the written cells are kept without --force
    stamp = (tmp_path / "smollm_360m__train_4k__single.json").stat().st_mtime_ns
    assert dryrun.main(argv) == 0
    assert (tmp_path / "smollm_360m__train_4k__single.json").stat() \
        .st_mtime_ns == stamp


def test_dryrun_moe_train_cell(tmp_path):
    """llama4-scout train_4k on the (16, 16) mesh: the sharded step
    trains the MoE family with the batch split (16 experts, one a
    ``model`` rank), its parameter and moment bytes are the reference's
    ``shard_shape`` sums, and it launches the expert region's
    collectives."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", "llama4-scout-17b-a16e", "--shape",
                          "train_4k", "--multi-pod", "single", "--out",
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    cell = json.loads((tmp_path / "llama4_scout_17b_a16e__train_4k__single"
                                  ".json").read_text())
    assert cell["status"] == "ok", cell.get("error")
    jc = jget("llama4-scout-17b-a16e")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    mem = cell["memory"]
    assert mem["param_bytes"] == _jbytes(JST.params_shardings(jc, mesh),
                                         JST.abstract_params(jc))
    assert mem["opt_state_bytes"] == _jbytes(
        JST.opt_state_shardings(jc, mesh),
        JST.abstract_opt_state(jc, AdamWConfig()))
    assert cell["microbatches"] == JSP.microbatches_for(jc, "train_4k")
    assert {"region-in", "region-out", "stat-all-reduce",
            "count-all-gather"} <= set(cell["collectives"])
    assert cell["flops"] > 0 and cell["peak_live_bytes"] > \
        mem["param_bytes"] + mem["opt_state_bytes"]
    assert cell["probe"]["units"] == jc.n_layers


# mamba2-780m train_4k on (16, 16), flops a rank before the SSM split
# over ``model`` (every rank computed the whole mixer):
# ``python -m repro_torch.launch.dryrun --arch mamba2-780m --shape
# train_4k --multi-pod single`` on the tree before it printed this
MAMBA2_TRAIN_FLOPS_WHOLE_SSM = 3.4630589743104e14


def test_dryrun_mamba2_train_cell_splits_the_ssm():
    """The SSM by heads (3 of 48 a rank), ``in_proj``'s z, x and dt
    columns, the SSD and ``out_proj`` split 16 ways: the flops a rank
    fall at least 4x (read 5.99x: 5.785e13), and no SSM leaf the split
    reads by its chunk is gathered whole."""
    from repro_torch.launch import dryrun
    cell = dryrun.run_cell("mamba2-780m", "train_4k", False)
    assert cell["status"] == "ok", cell.get("error")
    assert 0 < cell["flops"] <= MAMBA2_TRAIN_FLOPS_WHOLE_SSM / 4
    assert {"region-in", "region-out"} <= set(cell["collectives"])


SERVE_CELLS = [("smollm-360m", "prefill_32k"), ("smollm-360m", "decode_32k"),
               ("mamba2-780m", "prefill_32k"), ("mamba2-780m", "decode_32k"),
               ("mamba2-780m", "long_500k")]


@pytest.mark.parametrize("arch,shape", SERVE_CELLS,
                         ids=[f"{a}-{s}" for a, s in SERVE_CELLS])
def test_dryrun_serve_cell_has_a_probe(arch, shape):
    """One rank's sharded prefill or decode step on (16, 16): flops,
    peak live bytes and collectives from the two-point probe, within
    80 GB.  smollm's caches split their 32768 slots over ``model``
    (2048 a rank): a prefill gathers the query rows, a decode step joins
    its slots by log-sum-exp; both gather the logits.  smollm
    decode_32k reads 3.555e9 flops a rank (predicted 3.55e9), its
    prefill_32k 2.149e13 (predicted 2.0e13)."""
    from repro_torch.launch import dryrun
    cell = dryrun.run_cell(arch, shape, False)
    assert cell["status"] == "ok", cell.get("error")
    probe = cell["probe"]
    assert probe["units"] == jget(arch).n_layers
    assert cell["flops"] > 0 and probe["flops"]["per_layer_unit"] > 0
    assert cell["peak_live_bytes"] > cell["memory"]["decode_state_bytes"]
    assert cell["fits_80gb"] is True
    colls = cell["collectives"]
    assert colls and all(c["count"] > 0 and c["bytes"] > 0
                         for c in colls.values())
    assert "region-out" in colls
    if arch == "smollm-360m":
        assert "logits-all-gather" in colls
        kinds = {"seq-all-gather"} if shape == "prefill_32k" else \
            {"decode-max", "decode-sum", "decode-out"}
        assert kinds <= set(colls)
        if shape == "decode_32k":
            assert 3.0e9 <= cell["flops"] <= 4.0e9
        else:
            assert 1.8e13 <= cell["flops"] <= 2.4e13
