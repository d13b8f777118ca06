"""Helpers of the benchmark's CPU tests: the harness at the CPU tests'
sizes (each configuration's ``smoke`` sizes, each mix's ``smoke``
parameters), with no look for a GPU."""
from __future__ import annotations

import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from bench.lib import core, spec  # noqa: E402

CPU = torch.device("cpu")
CELLS = [w["name"] for w in spec.manifest()["workloads"]]
TRAIN = [c for c in CELLS if spec.traffic(spec.cell(c)["traffic"])["driver"]
         == "train"]
PREFILL = [c for c in CELLS if c not in TRAIN]
SEED = 2 ** 31 + 12345


def run_module():
    """``bench/run.py`` as a module."""
    name = "bench_run_cli"
    if name not in sys.modules:
        s = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "bench", "run.py"))
        mod = importlib.util.module_from_spec(s)
        sys.modules[name] = mod
        s.loader.exec_module(mod)
    return sys.modules[name]


def execute(cell: str, tmp_path, seed: int = SEED, trace: bool = False,
            seconds: float = 0.3, loaded=None):
    """(result, checks) of one run of ``cell`` at the tests' sizes on
    the CPU.  The test process may hold JAX from other test files, so
    the run's look for it counts only modules not in ``loaded`` (by
    default, those loaded before the call)."""
    loaded = set(sys.modules) if loaded is None else loaded
    real = core.forbidden_modules
    core.forbidden_modules = lambda: [n for n in real() if n not in loaded]
    try:
        return run_module().execute(
            cell, seed, seconds, trace, CPU, smoke=True,
            t0=time.perf_counter(), trace_file=str(tmp_path / "trace.json"))
    finally:
        core.forbidden_modules = real


def ctx(cell: str, seed: int = SEED):
    return core.context(cell, seed, CPU, smoke=True)
