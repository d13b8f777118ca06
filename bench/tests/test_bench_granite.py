"""The Granite cell's pieces: the attribution of device time to any
named span (``bench/lib/named_spans.py``) on a hand-built trace, the
two readers of the Mamba2 mixer's spans and their silence on a trace of
the other cells, of another run or of none; the configuration's flops
and weights; a traced run of the cell at the tests' sizes."""
import json
import math

import pytest

from benchtest import execute
from bench.lib import core, named_spans, spans, spec
from bench.lib import trace as tr

CELL = "granite-4.0-h-micro.prefill"
READERS = {"ssm_ms.prefill": "layer.ssm", "ssm_scan_ms.prefill": "ssm.scan"}
MAIN, OTHER = 1, 2
UNITS = 2


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _launch(c, tid, ts):
    return _x("cuda_runtime", "cudaLaunchKernel", tid, ts, 1, correlation=c)


def _kernel(c, a, b, ext=None):
    args = {"correlation": c}
    if ext is not None:
        args["External id"] = ext
    return _x("kernel", f"k{c}", 7, a, b - a, **args)


def hand_trace(with_ssm: bool = True):
    """Two prefill batches in one 1000 us window (times in us): in each,
    a Mamba2 layer (a projection, the scan's two kernels, the norm) and
    an attention layer; a scan nested in a second ``ssm.scan`` (counted
    once); one kernel found by its operator's External id; one cut by
    the window's end; a kernel launched from another thread outside any
    span; one after the window.  Without ``with_ssm``: the other cells'
    trace, no Mamba2 spans."""
    ssm = "layer.ssm" if with_ssm else "layer.mlp"
    scan = "ssm.scan" if with_ssm else "layer.mlp.inner"
    ev = [_x("user_annotation", tr.WINDOW, MAIN, 0, 1000)]
    for u, t0 in enumerate((10, 500)):
        c = 100 * (u + 1)
        ev += [_x("user_annotation", "bench.prefill_batch", MAIN, t0, 480),
               _x("user_annotation", ssm, MAIN, t0 + 10, 200),
               _launch(c + 1, MAIN, t0 + 12), _kernel(c + 1, t0 + 15, t0 + 35),
               _x("user_annotation", scan, MAIN, t0 + 40, 120),
               _x("user_annotation", scan, MAIN, t0 + 50, 60),
               _launch(c + 2, MAIN, t0 + 55), _kernel(c + 2, t0 + 60, t0 + 90),
               _x("cpu_op", "aten::bmm", MAIN, t0 + 130, 5,
                  **{"External id": c + 50}),
               _kernel(c + 3, t0 + 140, t0 + 150, ext=c + 50),
               _launch(c + 4, MAIN, t0 + 180), _kernel(c + 4, t0 + 185, t0 + 195),
               _x("user_annotation", "layer.attention", MAIN, t0 + 250, 100),
               _launch(c + 5, MAIN, t0 + 260), _kernel(c + 5, t0 + 265, t0 + 305)]
    ev += [_launch(900, OTHER, 300), _kernel(900, 400, 404),
           _x("user_annotation", "layer.attention", MAIN, 960, 30),
           _launch(901, MAIN, 970), _kernel(901, 990, 1010),
           _launch(902, MAIN, 980), _kernel(902, 1020, 1030)]
    return ev


# by hand, us over the window: layer.ssm 20 + 30 + 10 + 10 a batch;
# ssm.scan 30 + 10 a batch; layer.attention 40 a batch and 10 of the cut
# kernel; the batch span 110 a batch and the cut kernel; the other
# thread's 4 under no span
WANT_S = {"layer.ssm": 140e-6, "ssm.scan": 80e-6,
          "layer.attention": 90e-6, "bench.prefill_batch": 230e-6}


def test_attribution_by_hand():
    got = named_spans.attribute(hand_trace())
    for name, s in WANT_S.items():
        assert got["sums"][name] == pytest.approx(s, abs=1e-12), name
    s = tr.summarize(hand_trace(), UNITS)
    assert (got["window_s"], got["device_ops"]) == (s["window_s"],
                                                    s["device_ops"])
    assert got["device_ops"] == 12


def _run(events, path, monkeypatch, kind="prefill", cell=CELL):
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(spans, "TRACE_FILE", path)
    run = core.Run(cell=cell, kind=kind)
    run.traced = tr.summarize(events, UNITS)
    return run


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_by_hand(name, tmp_path, monkeypatch):
    run = _run(hand_trace(), tmp_path / "trace.json", monkeypatch)
    want = 1e3 * WANT_S[READERS[name]] / UNITS
    assert spec.metric_module(name).read(run) == pytest.approx(want,
                                                                abs=1e-12)


@pytest.mark.parametrize("case", ["other_cells", "train", "untraced",
                                  "another_run", "absent", "no_window"])
@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_is_silent(name, case, tmp_path, monkeypatch):
    """The other cells' trace (no Mamba2 span: SmolLM, or a program
    without the spans), a train run, no traced segment, another run's
    trace, no file, a trace without the window: no value, no error."""
    events = hand_trace(with_ssm=case != "other_cells")
    run = _run(events, tmp_path / "trace.json", monkeypatch,
               kind="train" if case == "train" else "prefill",
               cell="smollm-360m.prefill" if case == "other_cells" else CELL)
    if case == "untraced":
        run.traced = None
    elif case == "another_run":
        run.traced = dict(run.traced, window_s=run.traced["window_s"] * 2)
    elif case == "absent":
        monkeypatch.setattr(spans, "TRACE_FILE", tmp_path / "absent.json")
    elif case == "no_window":
        (tmp_path / "trace.json").write_text(json.dumps(
            {"traceEvents": [e for e in events if e["name"] != tr.WINDOW]}))
    assert spec.metric_module(name).read(run) is None


def test_the_trace_is_parsed_once_a_run(tmp_path, monkeypatch):
    calls = []
    real = tr.read_chrome_trace
    monkeypatch.setattr(tr, "read_chrome_trace",
                        lambda p: calls.append(p) or real(p))
    run = _run(hand_trace(), tmp_path / "trace.json", monkeypatch)
    got = [spec.metric_module(n).read(run) for n in sorted(READERS)]
    assert len(calls) == 1 and None not in got


def test_the_readers_are_in_the_manifest():
    per = {m["name"]: m for m in spec.manifest()["per_layer"]}
    for name in READERS:
        m = per[name]
        assert m["workloads"] == [CELL] and m["layer"] == "ssm mixer"
        assert m["moves"] == "prefill_tokens_per_s"
        assert name in {x["name"] for x in spec.metrics_of(CELL, True)}
        assert name not in {x["name"] for x in
                            spec.metrics_of("smollm-360m.prefill", True)}


def test_a_traced_run_reports_every_prefill_span_metric(tmp_path,
                                                        monkeypatch):
    """At the tests' sizes on the CPU (no device operations: each span's
    time reads 0) the cell reports the SSM readers and the prefill's
    span metrics, and comes out correct."""
    monkeypatch.setattr(spans, "TRACE_FILE", tmp_path / "trace.json")
    result, _ = execute(CELL, tmp_path, trace=True)
    want = set(READERS) | {"attention_ms.prefill",
                           "init_state_idle_ms.prefill"}
    assert want <= set(result["metrics"])
    assert result["correct"]


# ----------------------------------------------------------------------
# the configuration
# ----------------------------------------------------------------------
def test_weights_and_flops_follow_the_published_sizes():
    cfgm = spec.config_module("granite-4.0-h-micro")
    s = cfgm.sizes()
    n = sum(math.prod(shape) for _, shape, _ in cfgm.leaves(s))
    assert n == 3_191_396_096
    body, head = cfgm._matmul_weights(s)
    # every weight but the embedding's, the norms' and the mixers'
    # vectors (conv, its bias, dt_bias, A_log, D, the gated norm)
    small = 2048 + 40 * 2 * 2048 + 36 * (4 * 4352 + 4352 + 3 * 64 + 4096)
    assert body == n - head - small
    t = 4096
    want = (2 * body * t + 2 * head + 2 * 4 * 2048 * t * t
            + 6 * 36 * 4096 * 128 * t)
    assert cfgm.prefill_flops(s, t) == want
    assert cfgm.prefill_flops(s, t) / t == pytest.approx(6.15e9, rel=1e-3)
    inits = {name: init for name, _, init in cfgm.leaves(s)}
    assert inits["mamba.a_log"] == ("uniform", 0.0, math.log(64.0))
    assert inits["mamba.dt_bias"][0] == "uniform"
    assert inits["mamba.d_skip"] == inits["mamba.norm"] == ("const", 1.0)
