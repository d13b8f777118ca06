"""What the runner loads: no JAX, no JAX package; and the references
load nothing of the program."""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from benchtest import CELLS, ROOT

PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib.util
s = importlib.util.spec_from_file_location("bench_run_cli", {run!r})
m = importlib.util.module_from_spec(s); s.loader.exec_module(m)
from bench.lib import spec
for cell in {cells!r}:
    w = spec.cell(cell)
    spec.driver_module(spec.traffic(w["traffic"])["driver"])
    cfg = spec.config_module(w["config"])
    spec.reference_module(w["config"])
    cfg.port_config(True)
    for t in (False, True):
        for me in spec.metrics_of(cell, t):
            spec.metric_module(me["name"])
import repro_torch.launch.steps, repro_torch.models.model
import repro_torch.data.pipeline, repro_torch.data.store
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_the_runner_loads_no_jax_and_no_jax_package():
    tops = _modules(PROBE.format(
        root=ROOT, src=os.path.join(ROOT, "src"), cells=CELLS,
        run=os.path.join(ROOT, "bench", "run.py")))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, \
        tops & {"jax", "jaxlib", "flax", "repro"}


REFS = sorted(glob.glob(os.path.join(ROOT, "bench", "reference", "*.py")))


@pytest.mark.parametrize("path", REFS, ids=os.path.basename)
def test_the_references_load_nothing_of_the_program(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("repro_torch", "repro", "jax"), n
    name = os.path.splitext(os.path.basename(path))[0]
    tops = _modules(
        f"import json, sys; sys.path[:0] = [{ROOT!r}]\n"
        f"import bench.reference.{name}\n"
        "print(json.dumps(sorted(sys.modules)))")
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
