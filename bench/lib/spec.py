"""The manifest and the files it names.

Everything that belongs to one configuration, one traffic mix, one
metric or one cell sits in a file of its own, found by its name in
``BENCHMARK.json``:

  * ``bench/configs/<config>.json``   the sizes as run (the manifest's
    ``file``), with ``bench/configs/<module>.py`` beside it: the port's
    configuration, the weights made from the seed, the model flops;
  * ``bench/reference/<module>.py``  the plain float32 reference;
  * ``bench/traffic/<traffic>.json`` the mix's parameters, which name
    the driver (``bench/drivers/<driver>.py``) that runs them;
  * ``bench/metrics/<metric>.py``    the reader of one metric;
  * ``bench/limits/<cell>.json``     the limits of the cell's check.

``<module>`` is the configuration's name with ``-`` and ``.`` written
``_`` (an importable file name).  This module imports neither torch
nor the program.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def module_name(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def load_module(path: Path, tag: str):
    """The Python file ``path`` as a module named ``bench_<tag>``
    (registered in ``sys.modules``, so that a second load returns the
    first)."""
    name = "bench_" + module_name(tag)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def cell(name: str, man: dict | None = None) -> dict:
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {MANIFEST.name}")


def config_entry(name: str, man: dict | None = None) -> dict:
    man = man or manifest()
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in {MANIFEST.name}")


def config_sizes(name: str, man: dict | None = None) -> dict:
    return json.loads((ROOT / config_entry(name, man)["file"]).read_text())


def config_module(name: str):
    return load_module(BENCH / "configs" / f"{module_name(name)}.py",
                       "config_" + name)


def reference_module(name: str):
    return load_module(BENCH / "reference" / f"{module_name(name)}.py",
                       "reference_" + name)


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def driver_module(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py", "driver_" + name)


def metric_module(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py", "metric_" + name)


def limits(cell_name: str, smoke: bool = False) -> dict:
    """{number: limit} of the cell's check: the file's ``limits``, or
    at the CPU tests' sizes its ``smoke_limits``."""
    data = json.loads((BENCH / "limits" / f"{cell_name}.json").read_text())
    return data["smoke_limits" if smoke else "limits"]


def metrics_of(cell_name: str, trace: bool, man: dict | None = None) -> list:
    """The manifest's metrics a run of the cell reports: its end-to-end
    metrics untraced, its per-layer metrics traced.  A metric without
    ``workloads`` belongs to every cell; a per-layer one without it to
    every cell that reports the end-to-end metric it moves."""
    man = man or manifest()
    e2e = [m for m in man["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in names]
