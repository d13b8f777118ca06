"""The run's last line, its exit without a GPU or with JAX loaded, and
the reading of a device trace."""
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchtest import CELLS, ROOT, execute
from bench.lib import core, spec
from bench.lib import trace as tr


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_exactly_the_keys(trace, tmp_path, capsys):
    result, checks = execute("smollm-360m.prefill", tmp_path, trace=trace)
    core.emit(result, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(line) == keys + ["checks"]
    assert set(line["checks"]) == set(spec.limits("smollm-360m.prefill"))
    tail = err.strip().splitlines()[-len(checks):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
    want = {m["name"] for m in spec.metrics_of("smollm-360m.prefill", trace)}
    assert set(line["metrics"]) <= want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_without_a_gpu_it_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_with_only_the_benchmark_it_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', "
            f"'{CELLS[0]}', '--seed', '1', '--seconds', '1', '--trace', '0'];"
            " import torch; torch.cuda.is_available = lambda: True;"
            " torch.cuda.device_count = lambda: 1;"
            " runpy.run_path('bench/run.py', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_jax_loaded_after_the_window_stops_the_run(tmp_path, monkeypatch):
    loaded = {n for n in sys.modules if n.split(".")[0] != "jax"}
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        execute("smollm-360m.prefill", tmp_path, loaded=loaded)
    assert e.value.code != 0


@pytest.mark.parametrize("where", ["check", "metric"])
def test_jax_loaded_by_the_check_or_a_metric_stops_the_run(
        where, tmp_path, monkeypatch):
    """The look for JAX comes after the reference and the metric
    readers have run: a module either of them loads is seen."""
    loaded = set(sys.modules)
    cell = "smollm-360m.prefill"

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if where == "check":
        drv = spec.driver_module("prefill")
        real = drv.check

        def check(ctx, outputs):
            load_jax()
            return real(ctx, outputs)
        monkeypatch.setattr(drv, "check", check)
    else:
        name = spec.metrics_of(cell, False)[0]["name"]
        mod = spec.metric_module(name)
        real = mod.read

        def read(run):
            load_jax()
            return real(run)
        monkeypatch.setattr(mod, "read", read)
    with pytest.raises(SystemExit) as e:
        execute(cell, tmp_path, loaded=loaded - {"jax"})
    assert e.value.code != 0


def test_the_port_is_not_mistaken_for_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x",
                        types.ModuleType("repro_torch_x"))
    assert "repro_torch_x" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert "repro.core" in core.forbidden_modules()


def test_trace_summary():
    ev = [{"ph": "X", "cat": "user_annotation", "name": tr.WINDOW,
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 20, "dur": 30},
          {"ph": "X", "cat": "gpu_memset", "name": "fill", "ts": 70,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 50},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 50,
           "dur": 15},
          {"ph": "X", "cat": "user_annotation", "name": "bench.step",
           "ts": 0, "dur": 99}]
    s = tr.summarize(ev, units=2)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((40 + 10 + 5) * 1e-6)
    assert s["device_ops"] == 4
    assert s["top_ops"][0] == ["gemm", pytest.approx(60e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(20e-6)
    assert gaps["bench.step"] == pytest.approx(25e-6)


def test_weighted_quantile():
    assert core.quantile_weighted([1.0, 2.0, 3.0], [8, 1, 1], 0.9) == 2.0
    assert core.quantile_weighted([1.0, 2.0, 3.0], [8, 1, 1], 0.8) == 1.0
    assert core.quantile_weighted([5.0], [3], 0.9) == 5.0
