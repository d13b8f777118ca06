"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import math
import os
import re

import pytest

from benchtest import CELLS, ROOT
from bench.lib import spec

MAN = spec.manifest()
E2E = {m["name"]: m for m in MAN["end_to_end"]}
PER = {m["name"]: m for m in MAN["per_layer"]}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert list(MAN) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024
    for word in MAN["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [w["config"] for w in MAN["workloads"]]
             + [w["traffic"] for w in MAN["workloads"]]
             + list(E2E) + list(PER)
             + [k for c in MAN["configs"] for k in c["reduced"]])
    for n in names:
        assert spec.NAME.match(n), n
    for m in list(E2E.values()) + list(PER.values()):
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in MAN[group]]
        assert len(seen) == len(set(seen))
    assert not set(E2E) & set(PER)


@pytest.mark.parametrize("key,entries,allowed", [
    ("configs", MAN["configs"], {"name", "source", "file", "reduced", "why"}),
    ("workloads", MAN["workloads"],
     {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", MAN["end_to_end"],
     {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", MAN["per_layer"],
     {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_only_their_keys(key, entries, allowed):
    for e in entries:
        assert set(e) <= allowed, (key, set(e) - allowed)
        for field in ("why", "layer", "source"):
            if field in e and key in ("configs", "workloads", "per_layer"):
                assert LINE.match(e[field]), (key, field)


def test_bounds_and_sources():
    assert "setup_s" in E2E
    for m in E2E.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in PER.values():
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(MAN["workloads"])
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    layers = {}
    for m in PER.values():
        assert m["moves"] in E2E
        cells = m.get("workloads", CELLS)
        assert cells
        for c in cells:
            assert c in CELLS
            assert c in E2E[m["moves"]].get("workloads", CELLS), (m, c)
        layers.setdefault(m["layer"], m["layer"])
    for c in CELLS:
        e2e = [m for m in E2E.values() if c in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert spec.metrics_of(c, True), c


@pytest.mark.parametrize("cell", CELLS)
def test_each_cells_files_are_found_by_name(cell):
    w = spec.cell(cell)
    conf = spec.config_entry(w["config"])
    path = os.path.join(ROOT, conf["file"])
    assert conf["file"].startswith(MAN["paths"][0] + "/")
    assert os.path.isfile(path)
    sizes = json.load(open(path))
    assert sizes["source"] == conf["source"]
    assert sizes["reduced"] == conf["reduced"]
    cfg = spec.config_module(w["config"])
    assert cfg.NAME == w["config"]
    ref = spec.reference_module(w["config"])
    assert hasattr(ref, "Model")
    traffic = spec.traffic(w["traffic"])
    drv = spec.driver_module(traffic["driver"])
    assert hasattr(drv, "Program") and hasattr(drv, "check")
    lim = spec.limits(cell)
    assert lim and all(math.isfinite(v) and v > 0 for v in lim.values())
    for m in spec.metrics_of(cell, False) + spec.metrics_of(cell, True):
        assert hasattr(spec.metric_module(m["name"]), "read")


def test_config_files_name_every_cut():
    for c in MAN["configs"]:
        sizes = spec.config_sizes(c["name"])
        for key in c["reduced"]:
            assert key in sizes["published"]
            assert not key.endswith(("_dim", "_rank", "_size"))
        assert sizes["name"] == c["name"]
